"""The port's ``core.gemm`` (dot, prepare_weights, bind, GemmPolicy) held
bit for bit against the JAX package.

Inputs are made from a seed with numpy and fed to both packages; the port
runs on the CPU (its kernel wrappers take their plain versions), the JAX GEMM
wrappers run their Pallas kernels in interpret mode. The dequantized f32/bf16
outputs of ``dot`` are compared exactly: ``_dequant``/``_round_to`` pin the
evaluation order in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core import gemm as j_gemm
from repro.models import get_model as j_get_model
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core import gemm
from repro_torch.kernels import ops


def _floats(shape, dtype, seed):
    """f32 or bf16 inputs as (jax array, torch tensor) with identical bits."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[0] = 0.0                      # an all-zero row exercises the eps floor
    jx = jnp.asarray(x, dtype)
    return jx, tensor_from_numpy(np.asarray(jx))


def _ints(shape, seed):
    x = np.random.default_rng(seed).integers(-127, 128, size=shape).astype(np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    """Torch tensor -> numpy, bf16 as its f32 value (exact)."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_dot_float_path_bit_exact(backend, dtype):
    jx, tx = _floats((3, 5, 40), getattr(jnp, dtype), seed=7)
    jw, tw = _floats((40, 24), getattr(jnp, dtype), seed=8)
    jpol = j_gemm.GemmPolicy(backend=backend)
    pol = gemm.GemmPolicy(backend=backend)
    want = np.asarray(jax.jit(lambda a, b: j_gemm.dot(a, b, jpol))(jx, jw)
                      .astype(jnp.float32))
    got = gemm.dot(tx, tw, pol)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(want, _np(got))
    prep = gemm.prepare_weights(tw, pol)
    np.testing.assert_array_equal(want, _np(gemm.dot(tx, prep, pol)))


@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_dot_int_path_bit_exact(backend):
    ja, ta = _ints((2, 6, 19), seed=9)
    jb, tb = _ints((19, 7), seed=10)
    jpol = j_gemm.GemmPolicy(backend=backend, k=6)
    pol = gemm.GemmPolicy(backend=backend, k=6)
    np.testing.assert_array_equal(np.asarray(j_gemm.dot(ja, jb, jpol)),
                                  gemm.dot(ta, tb, pol).numpy())


@pytest.fixture(scope="module")
def small_params():
    cfg = reduced(ARCHS["smollm-360m"])
    model = j_get_model(cfg)
    jp = model.init_params(jax.random.PRNGKey(0))
    return cfg, model, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_bind_matches_reference_per_layer(backend, small_params):
    cfg, model, jp, tp = small_params
    jbound = model.bind_params(jp, j_gemm.GemmPolicy(backend=backend))
    tbound = gemm.bind(tp, gemm.GemmPolicy(backend=backend))
    assert isinstance(tbound, gemm.BoundParams)
    leaves = [("attn", n) for n in ("wq", "wk", "wv", "wo")] + \
             [("mlp", n) for n in ("w1", "w2", "w3")]
    for i in range(cfg.n_layers):
        for grp, name in leaves:
            jprep = jbound["layers"][grp][name]
            tprep = tbound["layers"][i][grp][name]
            assert isinstance(tprep, ops.PreparedOperand)
            assert tprep.backend == backend and tprep.side == "right"
            np.testing.assert_array_equal(np.asarray(jprep.values[i]),
                                          tprep.values.numpy())
            np.testing.assert_array_equal(np.asarray(jprep.scale[i]),
                                          tprep.scale.numpy())
    # tied head: prepared from embed.T
    np.testing.assert_array_equal(np.asarray(jbound["lm_head"].values),
                                  tbound["lm_head"].values.numpy())
    np.testing.assert_array_equal(np.asarray(jbound["lm_head"].scale),
                                  tbound["lm_head"].scale.numpy())
    # norms and the embedding stay raw; bind is idempotent
    assert isinstance(tbound["embed"], torch.Tensor)
    again = gemm.bind(tbound, gemm.GemmPolicy(backend=backend))
    assert again["layers"][0]["attn"]["wq"] is tbound["layers"][0]["attn"]["wq"]


@pytest.mark.parametrize("overrides", [
    None, {"attn": "approx_lut", "attn/wq": "mxu_int8"},
    {"": "mxu_int8", "attn": "approx_lut"}, {"ab": "mxu_int8", "ax": "exact"}])
def test_policy_resolve_matches_reference(overrides):
    """Longest prefix wins; the empty prefix matches every layer."""
    jpol = j_gemm.GemmPolicy(backend="exact", overrides=overrides)
    pol = gemm.GemmPolicy(backend="exact", overrides=overrides)
    for layer in ("", "a", "ab/w", "ax/w", "attn/wq", "attn/wk", "mlp/w1"):
        assert pol.resolve(layer) == jpol.resolve(layer), layer


def test_policy_rejects_unported_paths():
    x = torch.ones((2, 8))
    w = torch.ones((8, 4))
    for backend in ("approx_delta", "approx_onehot", "approx_oracle"):
        with pytest.raises(NotImplementedError, match="not ported"):
            gemm.dot(x, w, gemm.GemmPolicy(backend=backend))
    with pytest.raises(NotImplementedError, match="ABFT"):
        gemm.dot(x, w, gemm.GemmPolicy(backend="mxu_int8", guard="detect"))
    pol = gemm.GemmPolicy(backend="mxu_int8")
    stale = gemm.prepare_weights(w, dataclasses.replace(pol, k=6))
    with pytest.raises(ValueError, match="stale"):
        gemm.dot(x, stale, pol)
