"""GEMM backend registry and the one matmul entry point (port of ``repro/core/gemm.py``).

Every matmul of the models goes through ``dot(a, b, policy, layer=...)``. The
policy selects, per layer, which arithmetic executes it:

* ``exact``      — a float matmul (bf16/f32).
* ``mxu_int8``   — int8 quantize -> exact int8 GEMM (the CUDA kernel
                   ``kernels/systolic_gemm``) -> dequantize.
* ``approx_lut`` — int8 quantize -> approximate GEMM through the PE product
                   table at factor k (``kernels/approx_gemm``) -> dequantize.

``approx_oracle``, ``approx_onehot`` and ``approx_delta`` are accepted as
names and raise ``NotImplementedError`` until their slices are ported; so do
grouped (MoE) GEMMs, operands prepared for the left side, and the ABFT
guard (``guard != "none"``).

``dot`` accepts raw floats (quantize -> integer GEMM -> dequantize), raw
integers (int32 out), or a right-hand ``PreparedOperand``: the paper's
weight-stationary dataflow, where the fixed operand is quantized once and
every call pays only for the moving operand. ``bind(params, policy)`` prepares
a whole parameter tree. Bound and unbound calls give the same bits: the
moving operand is quantized per row in both, the weights per output channel,
and ``_dequant``/``_round_to`` pin the order of the float arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels import ops
from . import quant

BACKENDS = ("exact", "mxu_int8", "approx_lut", "approx_oracle", "approx_onehot",
            "approx_delta")
GUARDS = ("none", "detect", "recompute")     # GemmPolicy.guard modes


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """Which backend executes each layer's matmuls.

    `backend` is the default; `overrides` maps layer-name prefixes to backends
    (longest prefix wins; the empty prefix matches every layer), mirroring the
    paper's hybrid early-approx/late-exact BDCN. `k` is the approximation
    factor for approximate backends. `guard` selects ABFT checking, which
    waits for a later slice (only ``"none"`` runs). The ``approx_delta``
    tuning fields (``delta_rank``, ``delta_tol``, ``delta_adaptive``) come
    with that backend's slice.
    """
    backend: str = "exact"
    k: int = 4
    n_bits: int = 8
    acc_bits: int = 24
    overrides: Optional[Dict[str, str]] = None
    guard: str = "none"

    def resolve(self, layer: str = "") -> str:
        choice = self.backend
        best = None
        for prefix, be in (self.overrides or {}).items():
            if layer.startswith(prefix) and (best is None
                                             or len(prefix) > len(best)):
                best, choice = prefix, be
        return choice


EXACT = GemmPolicy(backend="exact")


def as_policy(policy=None, *, backend: str = "approx_lut",
              k: Optional[int] = None) -> GemmPolicy:
    """Coerce ``None`` / a backend name / a GemmPolicy into a GemmPolicy."""
    if policy is None:
        policy = GemmPolicy(backend=backend)
    elif isinstance(policy, str):
        if policy not in BACKENDS:
            raise ValueError(f"unknown backend {policy!r}; one of {BACKENDS}")
        policy = GemmPolicy(backend=policy)
    elif not isinstance(policy, GemmPolicy):
        raise TypeError(f"policy must be None, a backend name or a GemmPolicy,"
                        f" got {type(policy).__name__}")
    if k is not None and policy.k != k:
        policy = dataclasses.replace(policy, k=k)
    if policy.guard not in GUARDS:
        raise ValueError(f"unknown guard {policy.guard!r}; "
                         "one of ('none', 'detect', 'recompute')")
    if policy.guard != "none":
        raise NotImplementedError(
            "ABFT guards (core/abft.py) are not ported yet, see ROADMAP.md")
    return policy


def _int_gemm(x_q, w_q, backend: str, policy: GemmPolicy):
    if backend == "mxu_int8":
        return ops.systolic_matmul(x_q, w_q)
    if backend == "approx_lut":
        return ops.approx_matmul(x_q, w_q, k=policy.k, n_bits=policy.n_bits,
                                 acc_bits=policy.acc_bits)
    if backend in ops.LATER_BACKENDS:
        raise ops.not_ported(backend)
    raise ValueError(f"unknown integer backend {backend!r}")


def _check_prepared(prep, backend: str, policy: GemmPolicy, layer: str) -> None:
    mismatches = []
    if prep.backend != backend:
        mismatches.append(f"backend {prep.backend!r} != {backend!r}")
    if prep.k != policy.k:
        mismatches.append(f"k {prep.k} != {policy.k}")
    if (prep.n_bits, prep.acc_bits) != (policy.n_bits, policy.acc_bits):
        mismatches.append("n_bits/acc_bits differ")
    if mismatches:
        raise ValueError(
            f"prepared operand is stale for layer {layer!r}: "
            + "; ".join(mismatches)
            + " — re-run prepare_weights under the current policy")


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return isinstance(x, float)


def _dequant(acc, x_scale, w_scale):
    """acc * (x_scale * w_scale): the two f32 scales are combined first, then
    applied in one multiply — the reference's pinned evaluation order."""
    scale = x_scale.to(torch.float32) * w_scale.to(torch.float32)
    return acc.to(torch.float32) * scale


def _round_to(out_f32, dtype):
    """Cast the f32 dequantized output to `dtype` (round to nearest even, as
    the reference's ``reduce_precision``)."""
    return out_f32.to(dtype)


# ---------------------------------------------------------------------------
# The unified entry point
# ---------------------------------------------------------------------------

def dot(a, b, policy: GemmPolicy = EXACT, *, layer: str = "",
        grouped: bool = False) -> torch.Tensor:
    """One GEMM entry point for the whole stack.

    * **raw floats** — the model path: the 2-D right-hand weight is quantized
      per output channel, the moving activations per row (one scale per
      token, so a token's bits never depend on what shares its batch), the
      integer GEMM runs under the layer's backend, and the result is
      dequantized to the activations' dtype. ``exact`` is a float matmul.
    * **raw integers** — integer-in / int32-out under the layer's backend,
      batched operands flattened onto the 2-D kernels.
    * **a right-hand ``PreparedOperand``** — the weight-stationary path
      (``prepare_weights`` / ``bind``). With a ``scale`` (prepared from
      floats) the call is float-in / float-out with only the moving operand
      quantized per call; without one it is integer-in / int32-out.
    """
    policy = as_policy(policy, backend="exact")
    backend = policy.resolve(layer)
    if grouped:
        raise NotImplementedError("grouped (MoE) GEMMs come with the MoE "
                                  "slice, see ROADMAP.md")
    if isinstance(a, ops.PreparedOperand):
        raise NotImplementedError("operands prepared for the left side come "
                                  "with the apps slice, see ROADMAP.md")
    if isinstance(b, ops.PreparedOperand):
        prep = b
        if prep.side != "right":
            raise ValueError(f"operand prepared for side {prep.side!r} passed "
                             "as the right operand")
        _check_prepared(prep, backend, policy, layer)
        if prep.scale is not None and not _is_float(a):
            raise ValueError(
                f"layer {layer!r}: operand prepared from float weights "
                "needs a float moving operand (got integer input)")
        if prep.scale is None and _is_float(a):
            raise ValueError(
                f"layer {layer!r}: operand prepared from integer weights "
                "used with float input — prepare from the float weights "
                "instead so a dequantization scale is attached")
        if prep.scale is not None:
            return _dot_float_prepared(a, prep, policy)
        mm = lambda aa, _: ops.prepared_matmul(aa, prep)      # noqa: E731
        return ops.batched_app_matmul(mm, a, prep.values)

    if not (_is_float(a) or _is_float(b)):
        if backend == "exact":
            return ops.batched_app_matmul(ops.exact_int_matmul, a, b)
        mm = lambda aa, bb: _int_gemm(aa, bb, backend, policy)    # noqa: E731
        return ops.batched_app_matmul(mm, a, b)

    if backend == "exact":
        return torch.matmul(a, b)
    if b.dim() != 2:
        raise ValueError(
            f"layer {layer!r}: the float path needs a 2-D right-hand weight "
            f"(got {tuple(a.shape)} x {tuple(b.shape)})")
    lead = a.shape[:-1]
    x2 = a.reshape(-1, a.shape[-1])
    xq = quant.quantize(x2, n_bits=policy.n_bits, axis=-1)  # per-row (token)
    wq = quant.quantize(b, n_bits=policy.n_bits, axis=0)   # per-output-channel
    acc = _int_gemm(xq.values, wq.values, backend, policy)
    out = _dequant(acc, xq.scale, wq.scale)
    return _round_to(out.reshape(*lead, b.shape[-1]), a.dtype)


def _dot_float_prepared(x, prep, policy: GemmPolicy) -> torch.Tensor:
    """Float-in/float-out against a float-prepared right-hand operand.

    Mirrors the unprepared float path bit for bit: the moving operand is
    quantized per row exactly as there, the integer GEMM is the same kernel,
    and the dequantization multiplies the same two scales.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq = quant.quantize(x2, n_bits=policy.n_bits, axis=-1)        # per-row
    acc = ops.prepared_matmul(xq.values, prep)
    out = _dequant(acc, xq.scale, prep.scale)             # (R, 1) x (1, N)
    return _round_to(out.reshape(*lead, prep.values.shape[-1]), x.dtype)


# ---------------------------------------------------------------------------
# Weight preparation + bound parameter trees
# ---------------------------------------------------------------------------

def prepare_weights(w, policy: GemmPolicy, *, layer: str = "",
                    side: str = "right"):
    """Precompute the backend-specific form of a fixed 2-D weight matrix.

    Returns a ``kernels.ops.PreparedOperand`` that ``dot`` accepts in place of
    the raw matrix. Integer weights prepare as they are (integer-in/int32-out
    calls); **float** weights are quantized per output channel first and the
    scale is attached, so ``dot`` quantizes only the moving activations.
    """
    if side != "right":
        raise NotImplementedError("operands prepared for the left side come "
                                  "with the apps slice, see ROADMAP.md")
    backend = policy.resolve(layer)
    scale = None
    if _is_float(w):
        if backend == "exact":
            raise ValueError(
                f"layer {layer!r} resolves to the exact float backend — "
                "nothing to prepare; pass the raw weights to dot()")
        wq = quant.quantize(w, n_bits=policy.n_bits, axis=-2)
        w, scale = wq.values, wq.scale
    prep = ops.prepare_operand(w, backend=backend, k=policy.k,
                               n_bits=policy.n_bits, acc_bits=policy.acc_bits,
                               side=side)
    return dataclasses.replace(prep, scale=scale) if scale is not None else prep


class BoundParams(dict):
    """A model parameter tree whose weight leaves are policy-prepared.

    Behaves like the raw params dict (same keys, same nesting) so the models
    accept it in place of raw params, but every GEMM weight that ``bind``
    recognized is a ``PreparedOperand``: quantized once, no per-call weight
    work on the decode path.
    """


# Path components that are pure structure; dropped when deriving a leaf's
# layer name so bind-time names match the `layer=` strings of `dot` calls.
STRUCTURAL_KEYS = frozenset({
    "layers", "groups", "tail", "mlstm_blocks", "slstm_blocks", "shared_attn",
})

# Leaf names that are 2-D GEMM weights consumed through `dot` (embeddings,
# routers, norms stay raw).
BINDABLE_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "w1", "w2", "w3", "up", "down", "w_in", "out",
    "in_proj", "out_proj", "lm_head", "patch_proj",
})


def default_layer_name(path) -> Optional[str]:
    """Map a key path to the `layer=` name its `dot` call site uses.

    ``path`` is the tuple of dict keys and list indices from the root, e.g.
    ``("layers", 3, "attn", "wq") -> "attn/wq"``. Structural keys and list
    indices are dropped. Returns ``None`` for leaves that are not bindable
    GEMM weights.
    """
    keys = [p for p in path if isinstance(p, str)]
    if not keys or keys[-1] not in BINDABLE_LEAVES:
        return None
    return "/".join(k for k in keys if k not in STRUCTURAL_KEYS)


def _map_tree(tree, fn: Callable, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def bind(params, policy: GemmPolicy, *, tie_lm_head: bool = True) -> Any:
    """Bind a parameter tree to a policy: weight-stationary serving.

    Replaces every float 2-D weight leaf whose layer name resolves to a
    non-exact backend with a ``PreparedOperand``, quantized per output
    channel once. Other leaves and already-prepared leaves pass through, so
    ``bind`` is idempotent. The port keeps per-layer weights as a list of
    dicts, so each layer's leaf is prepared on its own (the reference
    prepares the stacked leaf in one pass: the same values and scales).

    With ``tie_lm_head``, a model with tied embeddings gets a prepared
    ``lm_head`` entry built from ``embed.T`` when ``"lm_head"`` resolves
    non-exact: the vocab projection is the largest decode GEMM.
    """
    def leaf(path, w):
        name = (None if isinstance(w, ops.PreparedOperand)
                else default_layer_name(path))
        if (name is None or not isinstance(w, torch.Tensor) or w.dim() != 2
                or not w.is_floating_point()
                or policy.resolve(name) == "exact"):
            return w
        return prepare_weights(w, policy, layer=name)

    out = BoundParams(_map_tree(params, leaf))
    if (tie_lm_head and "embed" in out and "lm_head" not in out
            and policy.resolve("lm_head") != "exact"
            and _is_float(out["embed"])):
        out["lm_head"] = prepare_weights(out["embed"].T, policy,
                                         layer="lm_head")
    return out
