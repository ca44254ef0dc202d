"""GEMM backend registry and the one matmul entry point (port of ``repro/core/gemm.py``).

Every matmul of the models goes through ``dot(a, b, policy, layer=...)``. The
policy selects, per layer, which arithmetic executes it:

* ``exact``      — a float matmul (bf16/f32).
* ``mxu_int8``   — int8 quantize -> exact int8 GEMM (the CUDA kernel
                   ``kernels/systolic_gemm``) -> dequantize.
* ``approx_lut`` — int8 quantize -> approximate GEMM through the PE product
                   table at factor k (``kernels/approx_gemm``) -> dequantize.
* ``approx_oracle`` — int8 quantize -> the bit-level fused-MAC PE chain
                   (``core.emulate.matmul_oracle``, torch ops).
* ``approx_onehot`` — the one-hot rewrite: the approximate GEMM as an exact
                   f32 matrix product (``core.lut.onehot_matmul``).
* ``approx_delta`` — exact int8 GEMM + rank-r error correction
                   (``core/error_delta.py``): the fused kernel
                   ``kernels/delta_gemm`` unbound; bound, the exact kernel
                   ``kernels/systolic_gemm`` plus one f32 correction product.
                   Bit-identical to ``approx_lut`` at the default (exact) rank.

Grouped (MoE) GEMMs and the ABFT guard (``guard != "none"``) raise
``NotImplementedError`` until their slices are ported.

``dot`` accepts raw floats (quantize -> integer GEMM -> dequantize), raw
integers (int32 out), or a ``PreparedOperand`` on either side: the paper's
weight-stationary dataflow, where the fixed operand is quantized and its
backend factors (delta factor, one-hot table) built once, and every call pays
only for the moving operand. ``bind(params, policy)`` prepares a whole
parameter tree. Bound and unbound calls give the same bits: the moving
operand is quantized per row in both, the weights per output channel, and
``_dequant``/``_round_to`` pin the order of the float arithmetic.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from . import emulate, error_delta, lut, quant

BACKENDS = ops.BACKENDS
GUARDS = ("none", "detect", "recompute")     # GemmPolicy.guard modes


@dataclasses.dataclass(frozen=True)
class GemmPolicy:
    """Which backend executes each layer's matmuls.

    `backend` is the default; `overrides` maps layer-name prefixes to backends
    (longest prefix wins; the empty prefix matches every layer), mirroring the
    paper's hybrid early-approx/late-exact BDCN. `k` is the approximation
    factor for approximate backends. `delta_rank` / `delta_tol` tune the
    ``approx_delta`` correction rank (None = exact rank, bit-identical to
    ``approx_lut``). `delta_adaptive` picks the correction form per prepared
    layer: when a layer's weight-restricted rank exceeds its output width,
    ``resolve`` (given those hints by ``prepare_weights``) falls back to the
    bit-identical ``approx_lut``. `guard` selects ABFT checking, which waits
    for a later slice (only ``"none"`` runs).
    """
    backend: str = "exact"
    k: int = 4
    n_bits: int = 8
    acc_bits: int = 24
    overrides: Optional[Dict[str, str]] = None
    delta_rank: Optional[int] = None
    delta_tol: Optional[float] = None
    delta_adaptive: bool = False
    guard: str = "none"

    def resolve(self, layer: str = "", *, out_width: Optional[int] = None,
                delta_rank: Optional[int] = None) -> str:
        choice = self.backend
        best = None
        for prefix, be in (self.overrides or {}).items():
            if layer.startswith(prefix) and (best is None
                                             or len(prefix) > len(best)):
                best, choice = prefix, be
        if (choice == "approx_delta" and self.delta_adaptive
                and out_width is not None and delta_rank is not None
                and delta_rank > out_width):
            return "approx_lut"
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
    if backend == "approx_oracle":
        return emulate.matmul_oracle(x_q, w_q, n_bits=policy.n_bits,
                                     k=policy.k, acc_bits=policy.acc_bits)
    if backend == "approx_onehot":
        t_b = lut.build_onehot_weights(w_q, n_bits=policy.n_bits, k=policy.k,
                                       acc_bits=policy.acc_bits)
        return lut.onehot_matmul(x_q, t_b, n_bits=policy.n_bits)
    if backend == "approx_delta":
        return ops.approx_delta_matmul(x_q, w_q, k=policy.k,
                                       n_bits=policy.n_bits,
                                       acc_bits=policy.acc_bits,
                                       rank=policy.delta_rank,
                                       tol=policy.delta_tol)
    raise ValueError(f"unknown integer backend {backend!r}")


def _check_prepared(prep, backend: str, policy: GemmPolicy, layer: str) -> None:
    mismatches = []
    # the adaptive form: prepare_weights may prepare an approx_delta layer
    # for the bit-identical gather path; accepted only at the exact rank
    adaptive_ok = (policy.delta_adaptive and backend == "approx_delta"
                   and prep.backend == "approx_lut"
                   and policy.delta_rank is None and policy.delta_tol is None)
    if prep.backend != backend and not adaptive_ok:
        mismatches.append(f"backend {prep.backend!r} != {backend!r}")
    if prep.k != policy.k:
        mismatches.append(f"k {prep.k} != {policy.k}")
    if (prep.n_bits, prep.acc_bits) != (policy.n_bits, policy.acc_bits):
        mismatches.append("n_bits/acc_bits differ")
    if (backend == "approx_delta" and not adaptive_ok
            and (prep.rank, prep.tol) != (policy.delta_rank,
                                          policy.delta_tol)):
        mismatches.append("delta_rank/delta_tol differ")
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
    * **a ``PreparedOperand``** on either side — the weight-stationary path
      (``prepare_weights`` / ``bind``); its position must match the side it
      was prepared for. With a ``scale`` (prepared from floats) the call is
      float-in / float-out with only the moving operand quantized per call;
      without one it is integer-in / int32-out.
    """
    policy = as_policy(policy, backend="exact")
    backend = policy.resolve(layer)
    if grouped:
        raise NotImplementedError("grouped (MoE) GEMMs come with the MoE "
                                  "slice, see ROADMAP.md")
    a_prep = isinstance(a, ops.PreparedOperand)
    b_prep = isinstance(b, ops.PreparedOperand)
    if a_prep and b_prep:
        raise ValueError("at most one operand may be prepared")
    if a_prep or b_prep:
        prep = a if a_prep else b
        want_side = "left" if a_prep else "right"
        if prep.side != want_side:
            raise ValueError(f"operand prepared for side {prep.side!r} passed "
                             f"as the {want_side} operand")
        _check_prepared(prep, backend, policy, layer)
        x = b if a_prep else a
        if prep.scale is not None and not _is_float(x):
            raise ValueError(
                f"layer {layer!r}: operand prepared from float weights "
                "needs a float moving operand (got integer input)")
        if prep.scale is None and _is_float(x):
            raise ValueError(
                f"layer {layer!r}: operand prepared from integer weights "
                "used with float input — prepare from the float weights "
                "instead so a dequantization scale is attached")
        if prep.scale is not None:
            return _dot_float_prepared(x, prep, policy)
        if a_prep:
            mm = lambda _, bb: ops.prepared_matmul(bb, prep)  # noqa: E731
            return ops.batched_app_matmul(mm, prep.values, x)
        mm = lambda aa, _: ops.prepared_matmul(aa, prep)      # noqa: E731
        return ops.batched_app_matmul(mm, x, prep.values)

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
            f"(got {tuple(a.shape)} x {tuple(b.shape)}); use "
            "prepare_weights(side='left') for fixed left operands")
    lead = a.shape[:-1]
    x2 = a.reshape(-1, a.shape[-1])
    xq = quant.quantize(x2, n_bits=policy.n_bits, axis=-1)  # per-row (token)
    wq = quant.quantize(b, n_bits=policy.n_bits, axis=0)   # per-output-channel
    acc = _int_gemm(xq.values, wq.values, backend, policy)
    out = _dequant(acc, xq.scale, wq.scale)
    return _round_to(out.reshape(*lead, b.shape[-1]), a.dtype)


def _dot_float_prepared(x, prep, policy: GemmPolicy) -> torch.Tensor:
    """Float-in/float-out against a float-prepared fixed operand.

    Mirrors the unprepared float path bit for bit: the moving operand is
    quantized per row (per column when the fixed operand is on the left)
    exactly as there, the integer GEMM is the same backend, and the
    dequantization multiplies the same two scales.
    """
    if prep.side == "right":
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        xq = quant.quantize(x2, n_bits=policy.n_bits, axis=-1)    # per-row
        acc = ops.prepared_matmul(xq.values, prep)
        out = _dequant(acc, xq.scale, prep.scale)         # (R, 1) x (1, N)
        return _round_to(out.reshape(*lead, prep.values.shape[-1]), x.dtype)
    # fixed left operand W (M, K) x moving (..., K, N)
    xq = quant.quantize(x, n_bits=policy.n_bits, axis=-2)         # per-column
    mm = lambda _, bb: ops.prepared_matmul(bb, prep)              # noqa: E731
    acc = ops.batched_app_matmul(mm, prep.values, xq.values)
    out = _dequant(acc, xq.scale, prep.scale)         # (M, 1) x (..., 1, N)
    return _round_to(out, x.dtype)


# ---------------------------------------------------------------------------
# Weight preparation + bound parameter trees
# ---------------------------------------------------------------------------

def prepare_weights(w, policy: GemmPolicy, *, layer: str = "",
                    side: str = "right", restrict: bool = True):
    """Precompute the backend-specific form of a fixed 2-D weight matrix.

    Returns a ``kernels.ops.PreparedOperand`` that ``dot`` accepts in place of
    the raw matrix. Integer weights prepare as they are (integer-in/int32-out
    calls); **float** weights are quantized per output channel first (the
    second-to-last axis for ``side="right"``, the last for ``side="left"``)
    and the scale is attached, so ``dot`` quantizes only the moving operand.

    ``approx_delta`` builds the rank-r ``G_B`` (``F_A`` on the left) once,
    weight-restricted unless ``restrict=False``; ``approx_onehot`` the
    ``T_B`` table. Under ``policy.delta_adaptive`` (exact rank, restricted
    preparation only) an ``approx_delta`` layer whose restricted rank exceeds
    its output width is prepared for the bit-identical ``approx_lut``.
    """
    backend = policy.resolve(layer)
    scale = None
    if _is_float(w):
        if backend == "exact":
            raise ValueError(
                f"layer {layer!r} resolves to the exact float backend — "
                "nothing to prepare; pass the raw weights to dot()")
        axis = -2 if side == "right" else -1
        wq = quant.quantize(w, n_bits=policy.n_bits, axis=axis)
        w, scale = wq.values, wq.scale
    if (backend == "approx_delta" and policy.delta_adaptive and restrict
            and policy.delta_rank is None and policy.delta_tol is None):
        r_eff = error_delta.restricted_rank(
            w, side=side, n_bits=policy.n_bits, k=policy.k,
            acc_bits=policy.acc_bits)
        out_w = w.shape[-1] if side == "right" else w.shape[-2]
        backend = policy.resolve(layer, out_width=out_w, delta_rank=r_eff)
    prep = ops.prepare_operand(w, backend=backend, k=policy.k,
                               n_bits=policy.n_bits, acc_bits=policy.acc_bits,
                               side=side, rank=policy.delta_rank,
                               tol=policy.delta_tol, restrict=restrict)
    return dataclasses.replace(prep, scale=scale) if scale is not None else prep


_PREPARED_CACHE: "OrderedDict[tuple, Any]" = OrderedDict()
_PREPARED_CACHE_MAX = 256


def prepare_weights_cached(w: torch.Tensor, policy: GemmPolicy, *,
                           layer: str = "", side: str = "right",
                           restrict: bool = True):
    """``prepare_weights`` memoized by weight value and policy fields.

    For fixed matrices met again and again (the DCT matrix, convolution
    kernels): keys hold a 16-byte BLAKE2b digest of the weight bytes with
    their shape, dtype and device, so repeated calls reuse the preparation.
    Eviction is LRU.
    """
    w_np = np.ascontiguousarray(w.detach().cpu().numpy())
    digest = hashlib.blake2b(w_np.tobytes(), digest_size=16).digest()
    key = (digest, w_np.shape, w_np.dtype.str, str(w.device),
           policy.resolve(layer), policy.k, policy.n_bits, policy.acc_bits,
           policy.delta_rank, policy.delta_tol, policy.delta_adaptive, side,
           restrict)
    hit = _PREPARED_CACHE.get(key)
    if hit is not None:
        _PREPARED_CACHE.move_to_end(key)
        return hit
    hit = prepare_weights(w, policy, layer=layer, side=side,
                          restrict=restrict)
    _PREPARED_CACHE[key] = hit
    while len(_PREPARED_CACHE) > _PREPARED_CACHE_MAX:
        _PREPARED_CACHE.popitem(last=False)
    return hit


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
    prepares the stacked leaf in one pass: the same values and scales). As
    there, the layer leaves take ``approx_delta``'s generic rank
    (``restrict=False``) and the other 2-D leaves (``lm_head``) the
    weight-restricted one.

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
        # the reference prepares the stacked layer leaves with the generic
        # (unrestricted) delta rank and 2-D leaves with the restricted one
        return prepare_weights(w, policy, layer=name,
                               restrict=path[:1] != ("layers",))

    out = BoundParams(_map_tree(params, leaf))
    if (tie_lm_head and "embed" in out and "lm_head" not in out
            and policy.resolve("lm_head") != "exact"
            and _is_float(out["embed"])):
        out["lm_head"] = prepare_weights(out["embed"].T, policy,
                                         layer="lm_head")
    return out
