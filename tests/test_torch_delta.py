"""The port's ``approx_delta`` stack (``core/error_delta.py``, the fused
kernel's plain version, ``ops.approx_delta_matmul``, the prepared operands on
both sides, ``bind``), ``approx_onehot`` and ``approx_oracle`` held bit for
bit against the JAX package.

Inputs are made from a seed with numpy and fed to both packages; the port
runs on the CPU (its kernel wrappers take their plain versions), the JAX
wrappers run their Pallas kernels in interpret mode, as the JAX package's
own tests do. Every integer result is compared exactly. At a truncated rank
without the residual the per-block rounding depends on the block size, so
there K is a multiple of the reference's block (``delta_gemm.plain_bk``).
The reduced model's logits are held within the 4-ulp tolerance of
``test_torch_model.py`` against JAX's, and bit for bit against the port's
own ``approx_lut``.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import dct as j_dct
from repro.apps import edge as j_edge
from repro.configs import ARCHS, reduced
from repro.core import emulate as j_emulate
from repro.core import error_delta as j_ed
from repro.core import gemm as j_gemm
from repro.core import lut as j_lut
from repro.kernels import delta_gemm as j_dg
from repro.kernels import ops as j_ops
from repro.launch import serve as j_serve
from repro.models import get_model as j_get_model
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import emulate, error_delta, gemm, lut
from repro_torch.kernels import delta_gemm, ops
from repro_torch.kernels.ref import delta_matmul_fused_ref
from repro_torch.launch import serve
from repro_torch.models import get_model

LOGIT_ATOL = 0.125            # 4 bf16 ulps at |logit| < 8 (test_torch_model)
LOGIT_MEAN_ATOL = 0.03125
BATCH, PROMPT, GEN = 4, 16, 6
EXACT_RANKS = (0, 1, 2, 4, 7, 12, 21, 37, 62)
# (M, K, N) odd shapes
SHAPES = [(1, 1, 1), (3, 37, 13), (7, 130, 5), (2, 9, 33)]


def _ints(shape, seed, lo=-128, hi=128):
    x = np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        np.int32)
    return x, torch.from_numpy(x)


def _eq(want, got, what=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=what)


# --- tables, ranks, factors -------------------------------------------------

def test_error_table_and_ranks_match_reference():
    for k in range(9):
        np.testing.assert_array_equal(j_ed.error_table(8, k),
                                      error_delta.error_table(8, k))
        assert error_delta.rank_for_exact(8, k) == j_ed.rank_for_exact(8, k)
    assert tuple(error_delta.rank_for_exact(8, k)
                 for k in range(9)) == EXACT_RANKS
    for k, tol in ((4, 0.5), (6, 2.0), (8, 0.9), (8, 10.0), (2, 0.0)):
        assert (error_delta.rank_for_tol(tol, 8, k)
                == j_ed.rank_for_tol(tol, 8, k)), (k, tol)
    with pytest.raises(ValueError):
        error_delta.rank_for_tol(-1.0)
    # n_bits 4 and an unsigned array, too
    for n_bits, signed in ((4, True), (6, False)):
        assert (error_delta.rank_for_exact(n_bits, 3, signed)
                == j_ed.rank_for_exact(n_bits, 3, signed))


@pytest.mark.parametrize("k", [2, 4, 6, 8])
def test_delta_factors_bit_equal(k):
    for rank, tol in ((None, None), (2, None), (None, 1.5), (0, None)):
        want = j_ed.delta_factors(8, k, rank=rank, tol=tol)
        got = error_delta.delta_factors(8, k, rank=rank, tol=tol)
        assert got.rank == want.rank and got.exact == want.exact
        for name in ("f", "g", "residual", "defect"):
            np.testing.assert_array_equal(getattr(want, name),
                                          getattr(got, name), err_msg=name)
        assert got.max_err == want.max_err


def test_restricted_factors_and_ranks():
    """At k = 6 the T8 DCT matrix needs rank 11 on the left and 10 on the
    right, the Laplacian rank 2 (against the generic 21); factors
    bit-equal."""
    cases = [(j_dct.T8, "left", 11), (j_dct.T8.T.copy(), "right", 10),
             (j_edge.LAPLACIAN.reshape(-1, 1), "right", 2)]
    for w, side, want_rank in cases:
        assert j_ed.restricted_rank(w, side=side, k=6) == want_rank
        assert error_delta.restricted_rank(torch.from_numpy(w), side=side,
                                           k=6) == want_rank
        jp = j_ed.prepare_delta(w, side=side, k=6)
        tp = error_delta.prepare_delta(torch.from_numpy(w), side=side, k=6)
        assert tp.rank == jp.rank == want_rank
        for name in ("w_u", "gather_tab", "factor"):
            np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                          getattr(tp, name).numpy(),
                                          err_msg=f"{side} {name}")
        np.testing.assert_array_equal(np.asarray(jp.w_s),
                                      tp.w_s.to(torch.int32).numpy())
    # more patterns than RESTRICT_MAX_PATTERNS: the generic rank
    _, w = _ints((40, 30), 3)
    assert error_delta.restricted_rank(w, k=8) == 62


# --- GEMM paths -------------------------------------------------------------

@pytest.mark.parametrize("m,kd,n", SHAPES)
def test_delta_matmul_ref_and_ops_exact_rank(m, kd, n):
    """Every k at the exact rank: the plain reference, the kernel route of
    ``ops.approx_delta_matmul`` and ``lut_matmul`` agree with JAX's bit for
    bit (and with each other). JAX's kernel route (its Pallas kernel in
    interpret mode, bit-identical to its ``lut_matmul`` at the exact rank)
    runs at every other k to keep the file fast."""
    a, ta = _ints((m, kd), m + 10 * kd)
    b, tb = _ints((kd, n), n + 7 * kd)
    for k in range(9):
        want = np.asarray(j_lut.lut_matmul(a, b, k=k))
        _eq(want, lut.lut_matmul(ta, tb, k=k), f"lut k={k}")
        _eq(j_ed.delta_matmul_ref(a, b, k=k),
            error_delta.delta_matmul_ref(ta, tb, k=k), f"ref k={k}")
        got = ops.approx_delta_matmul(ta, tb, k=k)
        _eq(want, got, f"ops vs lut k={k}")
        if k % 2 == 0:
            _eq(j_ops.approx_delta_matmul(jnp.asarray(a), jnp.asarray(b),
                                          k=k), got, f"ops k={k}")


@pytest.mark.parametrize("k", [4, 6, 8])
def test_truncated_rank_paths_match_reference(k):
    """Truncated rank/tol, with the residual (exact again: the kernel at
    rank 0 plus correction + defect rounded once) and without (per-block
    rounding; K a multiple of the reference's block)."""
    a, ta = _ints((5, 64), k)
    b, tb = _ints((64, 9), k + 1)
    exact = np.asarray(j_lut.lut_matmul(a, b, k=k))
    for rank, tol in ((1, None), (3, None), (None, 0.7)):
        for res in (True, False):
            kw = dict(k=k, rank=rank, tol=tol, apply_residual=res)
            want = np.asarray(j_ops.approx_delta_matmul(
                jnp.asarray(a), jnp.asarray(b), **kw))
            _eq(want, ops.approx_delta_matmul(ta, tb, **kw), str(kw))
            _eq(j_ed.delta_matmul_ref(a, b, **kw),
                error_delta.delta_matmul_ref(ta, tb, **kw), str(kw))
            if res:
                np.testing.assert_array_equal(want, exact)
    # unsigned operands take the plain reference
    ua, tua = _ints((3, 20), 5, 0, 256)
    ub, tub = _ints((20, 4), 6, 0, 256)
    _eq(j_ops.approx_delta_matmul(jnp.asarray(ua), jnp.asarray(ub), k=k,
                                  signed=False),
        ops.approx_delta_matmul(tua, tub, k=k, signed=False))


def test_fused_plain_version_matches_pallas_kernel():
    """``delta_matmul_fused_ref`` against the Pallas kernel in interpret mode
    at the reference's block sizes, exact and truncated ranks."""
    for (m, kd, n, k, rank, bk) in ((8, 64, 16, 4, None, 32),
                                    (8, 96, 8, 6, 5, 32),
                                    (16, 256, 8, 8, 9, 64),
                                    (8, 16, 8, 0, None, 16)):
        a, ta = _ints((m, kd), kd + (rank or 0))
        b, tb = _ints((kd, n), kd + 1)
        fac = j_ed.delta_factors(8, k, rank=rank)
        jf, jg = j_ed.factor_tables_jnp(8, k, rank=rank)
        want = j_dg.delta_matmul_fused(jnp.asarray(a), jnp.asarray(b), jf, jg,
                                       rank=fac.rank, bm=8, bn=8, bk=bk,
                                       interpret=True)
        tf, tg = error_delta.factor_tables(
            error_delta.delta_factors(8, k, rank=rank), "cpu")
        got = delta_matmul_fused_ref(ta.to(torch.int8), tb.to(torch.int8), tf,
                                     tg, rank=fac.rank, bk=bk)
        _eq(want, got, f"k={k} rank={rank}")
        # the wrapper on CPU tensors takes the plain version
        if bk == delta_gemm.plain_bk(kd):
            _eq(want, delta_gemm.delta_matmul_fused(
                ta.to(torch.int8), tb.to(torch.int8), tf, tg, rank=fac.rank))


@pytest.mark.parametrize("side", ["right", "left"])
def test_delta_prepared_both_sides(side):
    """``delta_matmul_prepared`` (restrict on and off, truncated ranks with
    the residual) against JAX's, and the prepared stationary factors."""
    w, tw = _ints((11, 6) if side == "right" else (6, 11), 20)
    x, tx = _ints((5, 11) if side == "right" else (11, 7), 21)
    for k in (0, 2, 4, 6, 8):
        for restrict in (True, False):
            for rank, tol in ((None, None), (2, None), (None, 1.0)):
                kw = dict(side=side, k=k, rank=rank, tol=tol,
                          restrict=restrict)
                jp = j_ed.prepare_delta(w, **kw)
                tp = error_delta.prepare_delta(tw, **kw)
                assert tp.rank == jp.rank, kw
                np.testing.assert_array_equal(np.asarray(jp.factor),
                                              tp.factor.numpy())
                _eq(j_ed.delta_matmul_prepared(x, jp),
                    error_delta.delta_matmul_prepared(tx, tp), str(kw))


@pytest.mark.parametrize("backend", ["approx_delta", "approx_onehot",
                                     "approx_oracle"])
def test_dot_paths_match_reference(backend):
    """``gemm.dot`` under each new backend: raw int (batched), raw float
    (f32 and bf16), right- and left-prepared from ints and floats."""
    k = 4
    jpol = j_gemm.GemmPolicy(backend=backend, k=k)
    pol = gemm.GemmPolicy(backend=backend, k=k)
    a, ta = _ints((2, 3, 10), 30)
    b, tb = _ints((10, 6), 31)
    _eq(j_gemm.dot(a, b, jpol), gemm.dot(ta, tb, pol), "raw int")
    for side, w, x in (("right", b, a), ("left", b.T.copy(), a)):
        tw, tx = torch.from_numpy(w), torch.from_numpy(x)
        jprep = j_gemm.prepare_weights(w, jpol, side=side)
        prep = gemm.prepare_weights(tw, pol, side=side)
        args = ((x, jprep), (tx, prep)) if side == "right" else \
            ((jprep, x.transpose(0, 2, 1)), (prep, tx.transpose(1, 2)))
        _eq(j_gemm.dot(*args[0], jpol), gemm.dot(*args[1], pol), side)
    rng = np.random.default_rng(32)
    xf = rng.normal(size=(3, 5, 24)).astype(np.float32)
    wf = rng.normal(size=(24, 8)).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        jx, jw = jnp.asarray(xf, dtype), jnp.asarray(wf, dtype)
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        tx, tw = torch.from_numpy(xf).to(tdt), torch.from_numpy(wf).to(tdt)
        want = np.asarray(j_gemm.dot(jx, jw, jpol).astype(jnp.float32))
        np.testing.assert_array_equal(want, gemm.dot(tx, tw, pol).float())
        prep = gemm.prepare_weights(tw, pol)
        np.testing.assert_array_equal(want, gemm.dot(tx, prep, pol).float())
        # a float weight fixed on the left, the moving operand quantized per
        # column
        jl = j_gemm.prepare_weights(jw.T, jpol, side="left")
        tl = gemm.prepare_weights(tw.T, pol, side="left")
        np.testing.assert_array_equal(
            np.asarray(j_gemm.dot(jl, jx.transpose(0, 2, 1), jpol)
                       .astype(jnp.float32)),
            gemm.dot(tl, tx.transpose(1, 2), pol).float())


def test_oracle_onehot_lut_match_reference():
    a, ta = _ints((4, 9), 40)
    b, tb = _ints((9, 5), 41)
    for k in (0, 3, 6, 8):
        _eq(j_emulate.matmul_oracle(a, b, k=k),
            emulate.matmul_oracle(ta, tb, k=k), f"oracle k={k}")
        jt = j_lut.build_onehot_weights(b, k=k)
        tt = lut.build_onehot_weights(tb, k=k)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        _eq(j_lut.onehot_matmul(a, jt), lut.onehot_matmul(ta, tt), f"k={k}")
        _eq(j_lut.lut_matmul(a, b, k=k), lut.lut_matmul(ta, tb, k=k))
    # the oracle's unsigned and narrow configurations
    _eq(j_emulate.matmul_oracle(a & 15, b & 15, n_bits=4, k=2, signed=False,
                                acc_bits=12),
        emulate.matmul_oracle(ta & 15, tb & 15, n_bits=4, k=2, signed=False,
                              acc_bits=12))


def test_pe_mac_torch_equals_numpy_on_every_pair():
    """The torch word ops of the PE chain against the numpy ones on all
    65536 operand pairs, at several accumulator inputs and k."""
    av = np.arange(256)
    pa, pb = np.repeat(av, 256), np.tile(av, 256)
    for k in (0, 1, 4, 7, 8):
        for c in (0, 1, 12345, -777, (1 << 23) - 1):
            want = emulate.pe_mac(pa, pb, c, k=k)
            got = emulate.pe_mac_t(torch.from_numpy(pa), torch.from_numpy(pb),
                                   torch.tensor(c), k=k)
            np.testing.assert_array_equal(want, got.numpy())


# --- policy, bind -----------------------------------------------------------

def test_resolve_with_adaptive_hints_matches_reference():
    for adaptive in (False, True):
        for overrides in (None, {"dct": "approx_lut", "edge": "mxu_int8"}):
            kw = dict(backend="approx_delta", delta_adaptive=adaptive,
                      overrides=overrides)
            jpol, pol = j_gemm.GemmPolicy(**kw), gemm.GemmPolicy(**kw)
            for layer in ("", "dct.fwd", "edge.conv", "mlp/w1"):
                for hint in ({}, {"out_width": 8, "delta_rank": 10},
                             {"out_width": 8, "delta_rank": 8},
                             {"out_width": 1, "delta_rank": 2}):
                    assert (pol.resolve(layer, **hint)
                            == jpol.resolve(layer, **hint)), (kw, layer, hint)
    # the adaptive preparation of the DCT matrix at k = 6 (rank 11 > 8)
    jpol = j_gemm.GemmPolicy(backend="approx_delta", k=6, delta_adaptive=True)
    pol = gemm.GemmPolicy(backend="approx_delta", k=6, delta_adaptive=True)
    jprep = j_gemm.prepare_weights(j_dct.T8, jpol, side="left")
    prep = gemm.prepare_weights(torch.from_numpy(j_dct.T8), pol, side="left")
    assert prep.backend == jprep.backend == "approx_lut"
    x, tx = _ints((8, 12), 50)
    _eq(j_gemm.dot(jprep, x, jpol), gemm.dot(prep, tx, pol))
    stale = gemm.prepare_weights(torch.from_numpy(j_dct.T8),
                                 dataclasses.replace(pol, delta_rank=3),
                                 side="left")
    with pytest.raises(ValueError, match="stale"):
        gemm.dot(stale, tx, pol)


def test_prepare_weights_cached_reuses_and_keys_policy():
    pol = gemm.GemmPolicy(backend="approx_delta", k=4)
    w = torch.from_numpy(j_dct.T8)
    p1 = gemm.prepare_weights_cached(w, pol, side="left")
    assert gemm.prepare_weights_cached(w.clone(), pol, side="left") is p1
    assert gemm.prepare_weights_cached(w, pol, side="right") is not p1
    assert gemm.prepare_weights_cached(
        w, dataclasses.replace(pol, k=6), side="left").k == 6


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(ARCHS["smollm-360m"])
    jm = j_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = t_reduced(T_ARCHS["smollm-360m"])
    tm = get_model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return cfg, jm, jp, tcfg, tm, tp, prompts


@pytest.mark.parametrize("k", [2, 4, 6, 8])
def test_bind_ranks_per_leaf_match_reference(setup, k):
    """Generic rank for the layer leaves (the reference prepares them as one
    stacked leaf), the restricted rank for the tied ``lm_head`` where its
    low-k patterns are eligible; stationary factors bit-equal."""
    cfg, jm, jp, tcfg, tm, tp, _ = setup
    jb = jm.bind_params(jp, j_gemm.GemmPolicy(backend="approx_delta", k=k))
    tb = tm.bind_params(tp, gemm.GemmPolicy(backend="approx_delta", k=k))
    for i in range(cfg.n_layers):
        for grp, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w2")):
            jd, td = jb["layers"][grp][name].delta, tb["layers"][i][grp][name].delta
            assert td.rank == jd.rank == EXACT_RANKS[k]
            np.testing.assert_array_equal(np.asarray(jd.factor[i]),
                                          td.factor.numpy())
    jd, td = jb["lm_head"].delta, tb["lm_head"].delta
    assert td.rank == jd.rank
    np.testing.assert_array_equal(np.asarray(jd.factor), td.factor.numpy())
    if k < 8:       # at most 128 low-k patterns: restricted
        assert td.rank == error_delta.restricted_rank(
            tb["lm_head"].values, k=k)


def _logits_check(want, got, what):
    d = np.abs(np.asarray(want, np.float32) - got.numpy())
    assert d.max() <= LOGIT_ATOL, f"{what}: max |diff| {d.max()}"
    assert d.mean() <= LOGIT_MEAN_ATOL, f"{what}: mean |diff| {d.mean()}"


def test_reduced_model_approx_delta(setup):
    """Reduced smollm-360m under approx_delta (k = 4), bound and unbound:
    prefill and decode logits within tolerance of JAX's and bit-equal to the
    port's approx_lut; greedy streams equal JAX's (ties flagged)."""
    cfg, jm, jp, tcfg, tm, tp, prompts = setup
    jpol = j_gemm.GemmPolicy(backend="approx_delta")
    pol = gemm.GemmPolicy(backend="approx_delta")
    lut_pol = gemm.GemmPolicy(backend="approx_lut")
    t = torch.from_numpy(prompts).long()
    jbound = jm.bind_params(jp, jpol)
    jl, _ = jax.jit(lambda p, x, c: jm.prefill(p, {"tokens": x}, c,
                                               policy=jpol))(
        jbound, jnp.asarray(prompts), jm.init_cache(BATCH, PROMPT))
    lut_l, _ = tm.prefill(tm.bind_params(tp, lut_pol), {"tokens": t},
                          tm.init_cache(BATCH, PROMPT), policy=lut_pol)
    for params in (tp, tm.bind_params(tp, pol)):
        tl, _ = tm.prefill(params, {"tokens": t},
                           tm.init_cache(BATCH, PROMPT), policy=pol)
        _logits_check(jl, tl, "approx_delta prefill")
        assert torch.equal(tl, lut_l)
    want = j_serve.lockstep_generate(cfg, jm, jbound, jnp.asarray(prompts),
                                     GEN, policy=jpol)
    streams = [serve.lockstep_generate(tcfg, tm, p, t, GEN, policy=pol)
               for p in (tp, tm.bind_params(tp, pol))]
    np.testing.assert_array_equal(streams[0], streams[1])
    np.testing.assert_array_equal(
        streams[0], serve.lockstep_generate(tcfg, tm, tp, t, GEN,
                                            policy=lut_pol))
    for r in range(BATCH):
        diff = np.nonzero(want[r] != streams[0][r])[0]
        if diff.size:
            margins = []
            serve.lockstep_generate(tcfg, tm, tp, t, GEN, policy=pol,
                                    margins=margins)
            margin = float(margins[int(diff[0])][r])
            assert margin <= LOGIT_ATOL, (r, int(diff[0]), margin)
            warnings.warn(f"flagged tie at row {r} step {int(diff[0])}")


def test_serve_cli_new_backends_on_cpu():
    """``serve --backend approx_delta|approx_onehot`` runs (no new flags),
    bound == unbound == approx_lut."""
    argv = ["--debug", "--device", "cpu", "--gen-len", "3"]
    want = serve.main(argv + ["--backend", "approx_lut"])
    for backend in ("approx_delta", "approx_onehot"):
        for bind in ([], ["--no-bind"]):
            np.testing.assert_array_equal(
                want, serve.main(argv + ["--backend", backend] + bind))
