"""The port's paged cache held against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages: the paged-gather
``chunked_attention`` (the plain version of the paged-attention kernel), the
int8 cache payload, the block tables and pool helpers, ``chunk_step`` on
``reduced(smollm-360m)`` with params crossed by ``convert.params_from_numpy``,
and greedy sampling. The kernel wrapper is checked to take its plain version
for CPU tensors without a launch; the kernel itself is held against that
plain version on the card (``tests/test_torch_cuda.py``).

Attention tolerance: both sides compute in f32 and differ only in the order
of the sums (XLA's einsums against PyTorch's), so outputs of magnitude below
a few units agree within ``ATTN_ATOL`` = 1e-5. With bf16 queries and pools
the output is rounded to bf16 on both sides, so it may differ by one bf16
ulp where the f32 values straddle a rounding boundary: ``BF16_ATOL`` = 2^-7
for |out| < 2. Logits: 4 bf16 ulps, as in ``tests/test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core import gemm as j_gemm
from repro.launch import sampling as j_sampling
from repro.models import api as j_api
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import gemm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.launch import sampling
from repro_torch.models import api, get_model
from repro_torch.models import layers as L

ATTN_ATOL = 1e-5
BF16_ATOL = 2.0 ** -7
LOGIT_ATOL = 0.125
H, KH, D, BS = 6, 2, 16, 8          # G = 3 query heads per KV head, as smollm

# (name, Sq, kv_valid_len per row, table width, chunk, window, softcap, dtype)
CASES = [
    ("decode", 1, [13, 0, 40, 1], 6, 1024, 0, 0.0, "f32"),
    ("prefill_chunk", 8, [8, 0, 37, 48], 6, 1024, 0, 0.0, "f32"),
    ("multi_chunk", 8, [8, 33, 0, 40], 5, 16, 0, 0.0, "f32"),
    ("window", 8, [20, 0, 47, 9], 6, 16, 5, 0.0, "f32"),
    ("softcap", 1, [3, 30, 0, 48], 6, 1024, 0, 2.0, "f32"),
    ("int8_pool", 8, [8, 0, 40, 25], 6, 16, 0, 0.0, "int8"),
    ("bf16", 8, [9, 48, 0, 31], 6, 1024, 0, 0.0, "bf16"),
]


def _paged_inputs(seed, sq, kvl, width, dtype):
    """Random q, pools with a dump row, a permuted fragmented table per row
    (the dump index past each row's live blocks), and query positions that
    end at each row's live length (a prefill chunk's last token at
    kvl - 1; every query sees at least one valid key)."""
    rng = np.random.default_rng(seed)
    b = len(kvl)
    n_blocks = b * width + 3
    q = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((n_blocks + 1, BS, KH, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks + 1, BS, KH, D)).astype(np.float32)
    perm = rng.permutation(n_blocks)[:b * width].reshape(b, width)
    tables = np.where(np.arange(width)[None, :] * BS
                      < np.asarray(kvl)[:, None], perm, n_blocks)
    qpos = np.maximum(np.asarray(kvl)[:, None] - sq
                      + np.arange(sq)[None, :], 0)
    if dtype == "int8":
        k = np.clip(np.round(k * 32), -127, 127).astype(np.int8)
        v = np.clip(np.round(v * 32), -127, 127).astype(np.int8)
    return (q, k, v, tables.astype(np.int32), np.asarray(kvl, np.int32),
            qpos.astype(np.int32))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_paged_gather_matches_reference(case):
    name, sq, kvl, width, chunk, window, softcap, dtype = case
    q, k, v, tables, kvl_a, qpos = _paged_inputs(len(name), sq, kvl, width,
                                                 dtype)
    if dtype == "bf16":
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v))
    else:
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        if dtype == "int8":     # the reference's gather path reads dequantized pools
            jk, jv = j_layers.cache_load(jk), j_layers.cache_load(jv)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = j_layers.chunked_attention(
        jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kvl_a), window=window,
        softcap=softcap, chunk=chunk, block_tables=jnp.asarray(tables))
    got = L.chunked_attention(
        tq, tk, tv, torch.from_numpy(qpos), torch.from_numpy(kvl_a),
        window=window, softcap=softcap, chunk=chunk,
        block_tables=torch.from_numpy(tables))
    assert got.shape == (len(kvl), sq, H, D) and got.dtype == tq.dtype
    live = kvl_a > 0                    # kv_valid_len == 0 rows are not read
    want = np.asarray(want, np.float32)[live]
    got = got.to(torch.float32).numpy()[live]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_ATOL if dtype == "bf16"
                               else ATTN_ATOL)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """CPU tensors: the wrapper returns the gather path's result (split
    count and all) and launches nothing."""
    q, k, v, tables, kvl, qpos = _paged_inputs(1, 8, [8, 0, 37, 48], 6,
                                               "f32")
    args = [torch.from_numpy(x) for x in (q, k, v, tables, kvl, qpos)]
    before = pa.launches
    for n_splits in (1, 3):
        got = pa.paged_attention(*args, chunk=16, n_splits=n_splits)
        assert torch.equal(got, paged_attention_ref(*args, chunk=16))
    assert pa.launches == before


def test_cache_payload_and_tables_match_reference():
    x = np.random.default_rng(2).standard_normal((3, 5, 2, 16)).astype(
        np.float32) * 3
    for dt, jdt in ((torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        got = L.cache_store(torch.from_numpy(x), dt)
        want = j_layers.cache_store(jnp.asarray(x), jdt)
        np.testing.assert_array_equal(
            L.cache_load(got).to(torch.float32).numpy(),
            np.asarray(j_layers.cache_load(want), np.float32))
    np.testing.assert_array_equal(
        L.init_block_tables(3, 21, 17, 8).numpy(),
        np.asarray(j_layers.init_block_tables(3, 21, 17, 8)))
    assert L.CACHE_INT8_SCALE == j_layers.CACHE_INT8_SCALE
    assert api.PAGED_POOL_LEAVES == j_api.PAGED_POOL_LEAVES


@pytest.fixture(scope="module")
def models():
    cfg = reduced(ARCHS["smollm-360m"])
    jm = j_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = t_reduced(T_ARCHS["smollm-360m"])
    return cfg, jm, jp, tcfg, get_model(tcfg), params_from_numpy(
        jax.tree.map(np.asarray, jp))


def test_paged_cache_helpers_match_reference(models):
    cfg, jm, _, tcfg, tm, _ = models
    jc = jm.init_paged_cache(3, 20, 9, 4)
    tc = tm.init_paged_cache(3, 20, 9, 4)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
    rng = np.random.default_rng(3)
    for key in ("k", "v"):
        tc[key].copy_(torch.from_numpy(rng.standard_normal(
            tc[key].shape).astype(np.float32)))
    jc = {k: jnp.asarray(v.to(torch.float32).numpy()).astype(jc[k].dtype)
          for k, v in tc.items()}
    src, dst = np.array([1, 4, 7], np.int32), np.array([2, 0, 8], np.int32)
    want = j_api.copy_pool_blocks(jc, jnp.asarray(src), jnp.asarray(dst))
    got = api.copy_pool_blocks(tc, torch.from_numpy(src).long(),
                               torch.from_numpy(dst).long())
    assert got is tc                                   # in place
    want = j_api.reset_slot(want, 1)
    api.reset_slot(got, 1)
    for key in want:
        np.testing.assert_array_equal(got[key].to(torch.float32).numpy(),
                                      np.asarray(want[key], np.float32))


@pytest.mark.parametrize("backend", ["exact", "mxu_int8", "approx_lut"])
def test_chunk_step_matches_reference(models, backend):
    """A mixed step (prefill chunks of 5 and 3 tokens, a decode row, an idle
    row) then a decode step, through the same block tables in both
    packages: the last-valid-token logits within 4 bf16 ulps."""
    cfg, jm, jp, tcfg, tm, tp = models
    jpol, pol = j_gemm.GemmPolicy(backend=backend), gemm.GemmPolicy(
        backend=backend)
    if backend != "exact":
        jp, tp = jm.bind_params(jp, jpol), tm.bind_params(tp, pol)
    b, max_len, n_blocks, bs = 4, 24, 14, 4
    jc = jm.init_paged_cache(b, max_len, n_blocks, bs)
    tc = tm.init_paged_cache(b, max_len, n_blocks, bs)
    tables = np.full((b, max_len // bs), n_blocks, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :2] = [0, 11]
    tables[2, :3] = [7, 3, 1]
    jc["block_tables"] = jnp.asarray(tables)
    tc["block_tables"].copy_(torch.from_numpy(tables))
    rng = np.random.default_rng(4)
    steps = [(rng.integers(0, cfg.vocab_size, (b, 5)), [0, 4, 0, 0],
              [5, 3, 1, 0]),
             (rng.integers(0, cfg.vocab_size, (b, 1)), [5, 7, 1, 0],
              [1, 1, 1, 0])]
    for i, (tokens, pos, q_len) in enumerate(steps):
        pos, q_len = np.asarray(pos, np.int32), np.asarray(q_len, np.int32)
        jl, jc = jm.chunk_step(jp, jnp.asarray(tokens, jnp.int32), jc,
                               jnp.asarray(pos), jnp.asarray(q_len),
                               policy=jpol)
        tl, tc = tm.chunk_step(tp, torch.from_numpy(tokens), tc,
                               torch.from_numpy(pos), torch.from_numpy(q_len),
                               policy=pol)
        assert tl.shape == (b, 1, cfg.vocab_size)
        live = q_len > 0
        d = np.abs(np.asarray(jl, np.float32)[live] - tl.numpy()[live])
        assert d.max() <= LOGIT_ATOL, f"step {i}: max |diff| {d.max()}"


def test_greedy_sampling_matches_reference():
    logits = np.random.default_rng(5).standard_normal((6, 300)).astype(
        np.float32)
    logits[2, [10, 20]] = 9.0                       # a tie: the first index wins
    want = j_sampling.sample_tokens(
        jnp.asarray(logits), jnp.zeros(6), jnp.zeros(6, jnp.int32),
        jnp.ones(6), jnp.zeros((6, 2), jnp.uint32))
    got = sampling.sample_tokens(torch.from_numpy(logits), np.zeros(6),
                                 np.zeros(6), np.ones(6), [0] * 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_sampling_is_deterministic_per_key():
    """Sampled tokens depend on (seed, rid, token index) only: the same key
    gives the same token whatever shares the batch, greedy rows keep the
    argmax, and top-k = 1 is greedy."""
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 64)).astype(np.float32))
    key = sampling.fold_in(sampling.request_key(7, 3), 2)
    temp, top_k, top_p = [1.0, 0.0, 1.0, 0.7], [0, 0, 1, 5], [1.0, 1.0, 1.0,
                                                             0.9]
    keys = [key, 0, sampling.fold_in(key, 1), sampling.fold_in(key, 2)]
    full = sampling.sample_tokens(logits, temp, top_k, top_p, keys)
    assert torch.equal(full, sampling.sample_tokens(logits, temp, top_k,
                                                    top_p, keys))
    alone = sampling.sample_tokens(logits[:1], temp[:1], top_k[:1],
                                   top_p[:1], keys[:1])
    assert int(alone[0]) == int(full[0])
    argmax = torch.argmax(logits, dim=-1)
    assert int(full[1]) == int(argmax[1]) and int(full[2]) == int(argmax[2])
    top5 = torch.topk(logits[3], 5).indices.tolist()
    assert int(full[3]) in top5
    draws = {int(sampling.sample_tokens(logits[:1], [1.0], [0], [1.0],
                                        [sampling.fold_in(key, i)])[0])
             for i in range(40)}
    assert len(draws) > 1                   # the key moves the draw
