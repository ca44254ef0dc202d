"""The port's flash attention held against the JAX package, on the CPU.

The wrapper ``kernels.flash_attention.flash_attention`` takes its plain
version (``ref.flash_attention_ref``) for CPU tensors. It is held against
JAX's ``repro.models.layers.chunked_attention``, the oracle that the JAX
package's own flash-kernel tests use, on the cases of
``tests/test_flash_kernel.py`` (block sizes, causal skips, ragged and
per-batch ``kv_valid_len``, the non-causal padding case, window, softcap,
bidirectional), plus GQA, tails that are not a multiple of the tile, and the
window skip the CUDA kernel makes. The kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``). Inputs come from
numpy seeds.

Tolerance ``rtol = atol = 2e-4`` in f32, as ``tests/test_flash_kernel.py``:
both sides compute in f32 and differ in the order of their sums.

The route: on a reduced model, ``transformer.prefill`` sends every layer's
attention through the wrapper and ``decode_step``/``chunk_step`` never do;
on the CPU the prefill's logits and cache equal, bit for bit, those of the
``layers.chunked_attention`` call the model made before the route.

The CUDA kernel's bf16 arithmetic (bf16 products summed in f32, p split into
bf16 halves, 64-key tiles) is emulated in torch and held against the plain
version within the card's gate, one bf16 ulp plus 1e-4; one bf16 p, the
control, must break that gate.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention as j_chunked_attention
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import get_model
from repro_torch.models import layers as L

RTOL = ATOL = 2e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _flash(q, k, v, **kw):
    before = fa.launches
    out = fa.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert fa.launches == before          # CPU tensors never launch
    assert out.shape == q.shape and out.dtype == torch.float32
    return out.numpy()


def _ref(q, k, v, *, causal, window=0, softcap=0.0, kv_valid_len=None):
    """JAX's chunked attention on the (B, S, H, D) layout, KV heads
    broadcast to the query heads as the reference's flash callers do."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    k, v = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    kvl = k.shape[2] if kv_valid_len is None else kv_valid_len
    out = _j_attention(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(np.arange(s)),
        jnp.int32(kvl), causal=causal, window=window, softcap=softcap)
    return np.asarray(out).transpose(0, 2, 1, 3)


# jitted with the live length traced: one compile per shape and mask kind
_j_attention = jax.jit(
    functools.partial(j_chunked_attention, chunk=16, q_chunk=16),
    static_argnames=("causal", "window", "softcap"))


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _padded(rng, b, h, s_live, s_pad, d, sq, kh=None):
    q = _normal(rng, b, h, sq, d)
    k = np.zeros((b, kh or h, s_pad, d), np.float32)
    v = np.zeros((b, kh or h, s_pad, d), np.float32)
    k[:, :, :s_live] = rng.normal(size=(b, kh or h, s_live, d))
    v[:, :, :s_live] = rng.normal(size=(b, kh or h, s_live, d))
    return q, k, v


def test_flash_matches_reference_cases():
    """test_flash_kernel.py's block-size, window, softcap and bidirectional
    cases, then GQA and ragged tails."""
    cases = [  # (s, bq, bk, causal, window, softcap)
        (32, 8, 8, True, 0, 0.0), (32, 16, 8, True, 0, 0.0),
        (64, 16, 16, True, 12, 0.0), (32, 8, 8, True, 0, 30.0),
        (32, 8, 16, False, 0, 0.0)]
    for s, bq, bk, causal, window, softcap in cases:
        rng = np.random.default_rng(s + bq)
        q, k, v = (_normal(rng, 2, 3, s, 16) for _ in range(3))
        got = _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                     bq=bq, bk=bk)
        want = _ref(q, k, v, causal=causal, window=window, softcap=softcap)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=str((s, bq, bk, causal, window)))


def test_flash_gqa_reads_kv_head_of_each_group():
    """k/v with KH < H heads: query head h reads KV head h // (H // KH),
    as the reference's callers broadcast."""
    for h, kh, causal, window, softcap in ((6, 2, True, 0, 0.0),
                                           (8, 1, True, 9, 0.0),
                                           (4, 2, False, 0, 5.0),
                                           (15, 5, True, 0, 0.0)):
        rng = np.random.default_rng(h * 10 + kh)
        q = _normal(rng, 2, h, 24, 16)
        k, v = _normal(rng, 2, kh, 24, 16), _normal(rng, 2, kh, 24, 16)
        got = _flash(q, k, v, causal=causal, window=window, softcap=softcap,
                     bq=8, bk=8)
        want = _ref(q, k, v, causal=causal, window=window, softcap=softcap)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=str((h, kh)))


def test_flash_tails_not_multiple_of_tile():
    """Sq and Skv off the tile grid: causal over 37 rows, a non-causal
    query block of 21 rows over 45 keys of which 40 are live, and rows of
    unequal length (Sq < Skv, causal)."""
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, 1, 4, 37, 16) for _ in range(3))
    np.testing.assert_allclose(_flash(q, k, v, causal=True, bq=16, bk=16),
                               _ref(q, k, v, causal=True), rtol=RTOL,
                               atol=ATOL)
    q, k, v = _padded(rng, 2, 4, 40, 45, 16, 21, kh=2)
    np.testing.assert_allclose(
        _flash(q, k, v, causal=False, kv_valid_len=40, bq=16, bk=16),
        _ref(q, k, v, causal=False, kv_valid_len=40), rtol=RTOL, atol=ATOL)
    q = _normal(rng, 2, 4, 13, 16)
    k, v = _normal(rng, 2, 2, 29, 16), _normal(rng, 2, 2, 29, 16)
    np.testing.assert_allclose(_flash(q, k, v, causal=True, bq=8, bk=8),
                               _ref(q, k, v, causal=True), rtol=RTOL,
                               atol=ATOL)


def test_flash_causal_skips_are_exact():
    """Other block sizes give the same result (the kernel's causal early
    exit over K blocks must not change results)."""
    rng = np.random.default_rng(9)
    q, k, v = (_normal(rng, 1, 2, 64, 8) for _ in range(3))
    a = _flash(q, k, v, bq=16, bk=16)
    b = _flash(q, k, v, bq=64, bk=8)
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(a, _ref(q, k, v, causal=True), rtol=RTOL,
                               atol=ATOL)


def test_flash_ragged_kv_valid_len():
    """Zero-padded K/V with kv_valid_len == the reference on the live keys,
    causal and not, at live lengths on and off the block grid."""
    for causal in (False, True):
        for live in (1, 7, 8, 9, 15, 17, 31, 32):
            rng = np.random.default_rng(live * 2 + causal)
            q, k, v = _padded(rng, 2, 2, live, 32, 16, 32)
            got = _flash(q, k, v, kv_valid_len=live, causal=causal, bq=8,
                         bk=8)
            want = _ref(q, k, v, causal=causal, kv_valid_len=live)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=str((causal, live)))


def test_flash_noncausal_padding_is_masked():
    """Non-causal padded keys: the masked result matches the reference on
    the live keys; without kv_valid_len the padded keys carry softmax mass."""
    rng = np.random.default_rng(3)
    q, k, v = _padded(rng, 1, 2, 11, 16, 8, 16)
    masked = _flash(q, k, v, kv_valid_len=11, causal=False, bq=8, bk=8)
    unmasked = _flash(q, k, v, causal=False, bq=8, bk=8)
    want = _ref(q, k, v, causal=False, kv_valid_len=11)
    np.testing.assert_allclose(masked, want, rtol=RTOL, atol=ATOL)
    assert np.abs(unmasked - want).max() > 1e-3


def test_flash_per_batch_kv_valid_len():
    """(B,) lengths: each batch row masks at its own live length."""
    rng = np.random.default_rng(17)
    lens = np.array([5, 19, 32], np.int32)
    q = _normal(rng, 3, 2, 16, 16)
    k = np.zeros((3, 2, 32, 16), np.float32)
    v = np.zeros((3, 2, 32, 16), np.float32)
    for i, n in enumerate(lens):
        k[i, :, :n] = rng.normal(size=(2, n, 16))
        v[i, :, :n] = rng.normal(size=(2, n, 16))
    got = _flash(q, k, v, kv_valid_len=_t(lens), causal=False, bq=8, bk=8)
    for i, n in enumerate(lens):
        want = _ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=False,
                    kv_valid_len=int(n))
        np.testing.assert_allclose(got[i:i + 1], want, rtol=RTOL, atol=ATOL)


def test_flash_ragged_property():
    """Live lengths across [1, 64] at block sizes 8/16/32: padded ==
    the reference on the live keys (test_flash_kernel.py's property, on a
    fixed sample)."""
    rng = np.random.default_rng(0)
    for _ in range(16):
        live, causal = int(rng.integers(1, 65)), bool(rng.integers(2))
        bk = int(rng.choice([8, 16, 32]))
        r = np.random.default_rng(live * 7 + bk + causal)
        q, k, v = _padded(r, 1, 2, live, 64, 8, 32)
        got = _flash(q, k, v, kv_valid_len=live, causal=causal, bq=16, bk=bk)
        want = _ref(q, k, v, causal=causal, kv_valid_len=live)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=str((live, causal, bk)))


def test_flash_window_skip_is_exact():
    """The CUDA kernel starts each q-tile's K loop at the first tile a row
    of the q-tile can see (q0 - window + 1). That equals the full loop: the
    keys before the window carry no weight in any row (garbage K/V there
    leaves the output bit-identical), and attention of the tile's rows over
    the keys from the skip tile on, positions shifted, equals the full
    computation's rows."""
    rng = np.random.default_rng(11)
    s, window, bq, bk = 96, 20, 32, 16
    q, k, v = (_normal(rng, 1, 4, s, 16) for _ in range(3))
    kw = dict(causal=True, window=window, bq=bq, bk=bk)
    full = _flash(q, k, v, **kw)
    np.testing.assert_allclose(full, _ref(q, k, v, causal=True,
                                          window=window),
                               rtol=RTOL, atol=ATOL)
    for q0 in range(0, s, bq):
        k0 = max(0, q0 - window + 1) // bk * bk
        if not k0:
            continue
        kg, vg = k.copy(), v.copy()          # garbage before the window
        kg[:, :, :k0] = 1e4 * _normal(rng, 1, 4, k0, 16)
        vg[:, :, :k0] = 1e4 * _normal(rng, 1, 4, k0, 16)
        got = _flash(q, kg, vg, **kw)
        assert np.array_equal(got[:, :, q0:q0 + bq], full[:, :, q0:q0 + bq])
        # from the skip tile on: queries q0.., keys k0.. at shifted positions
        sub = L.chunked_attention(
            _t(q[:, :, q0:q0 + bq]).transpose(1, 2),
            _t(k[:, :, k0:]).transpose(1, 2), _t(v[:, :, k0:]).transpose(1, 2),
            torch.arange(q0 - k0, q0 - k0 + bq), s - k0, window=window,
            chunk=bk, q_chunk=bq).transpose(1, 2).numpy()
        np.testing.assert_allclose(sub, full[:, :, q0:q0 + bq], rtol=1e-6,
                                   atol=1e-6)


# The tensor-core kernel's tiles: 64 query rows a warpgroup, 64 keys a tile
TC_BQ = TC_BK = 64
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4     # chip_smoke.py's kernel gate


def _tc_emulation(q, k, v, *, kv_valid_len, causal, window, softcap,
                  split=True):
    """The bf16 tensor-core kernel's arithmetic in torch on the CPU: q scaled
    in bf16, q k^T as f32 sums of exact bf16 products, softcap and masks,
    the online recurrence over TC_BK-key tiles from the first tile each
    TC_BQ-row q-tile's window reaches to its causal frontier, and p v as
    hi v + lo v with hi = bf16(p), lo = bf16(p - hi), summed in f32 (or,
    ``split=False``, one bf16 p). Returns (B, H, Sq, D) in bf16."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    qs = (q.float() * d ** -0.5).to(torch.bfloat16).float()
    pad = -skv % TC_BK                       # rows past Skv are zero-filled
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    kf = kf.repeat_interleave(h // kh, dim=1)
    vf = vf.repeat_interleave(h // kh, dim=1)
    lens = kv_valid_len if isinstance(kv_valid_len, list) else [
        skv if kv_valid_len is None else kv_valid_len] * b
    win = window if window > 0 else 1 << 30
    out = torch.zeros(b, h, sq, d)
    for bi, n in enumerate(lens):
        n = min(n, skv)
        for w0 in range(0, sq, TC_BQ):
            rows = torch.arange(w0, min(w0 + TC_BQ, sq))
            kt0, kt1 = 0, -(-n // TC_BK)
            if causal:
                kt1 = min(kt1, int(rows[-1]) // TC_BK + 1)
                if window > 0:
                    kt0 = max(0, w0 - window + 1) // TC_BK
            m = torch.full((h, len(rows)), L.BIG_NEG)
            acc_l = torch.zeros(h, len(rows))
            acc = torch.zeros(h, len(rows), d)
            for kt in range(kt0, kt1):
                keys = torch.arange(kt * TC_BK, (kt + 1) * TC_BK)
                s = qs[bi][:, rows] @ kf[bi][:, keys].transpose(1, 2)
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                live = (keys < n)[None, :].expand(len(rows), -1)
                if causal:
                    delta = rows[:, None] - keys[None, :]
                    live = live & (delta >= 0) & (delta < win)
                s = torch.where(live, s, L.BIG_NEG)
                m_new = torch.maximum(m, s.max(-1).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                acc_l = acc_l * corr + p.sum(-1)
                hi = p.to(torch.bfloat16).float()
                if split:
                    lo = (p - hi).to(torch.bfloat16).float()
                    pv = hi @ vf[bi][:, keys] + lo @ vf[bi][:, keys]
                else:
                    pv = hi @ vf[bi][:, keys]
                acc = acc * corr[..., None] + pv
                m = m_new
            out[bi][:, rows] = acc / acc_l.clamp_min(1e-30)[..., None]
    return out.to(torch.bfloat16)


# (B, H, KH, Sq, Skv, causal, window, softcap, kv_valid_len): off the tile
# grid and GQA throughout; a window whose last q-tile (rows 128-199) starts
# at key tile 1; softcap 50; ragged live lengths non-causal; a 512-token
# causal prompt
TC_CASES = [(2, 4, 2, 200, 200, True, 0, 0.0, None),
            (1, 4, 2, 200, 200, True, 48, 0.0, None),
            (2, 4, 2, 130, 130, True, 32, 50.0, None),
            (3, 6, 2, 40, 96, False, 0, 0.0, [5, 70, 96]),
            (1, 4, 2, 512, 512, True, 0, 0.0, None)]


def test_flash_tensor_core_split_p_within_one_bf16_ulp():
    """The tensor-core kernel's arithmetic (``_tc_emulation``) within one
    bf16 ulp plus 1e-4 of the plain version at head dims 16-256 on every
    TC_CASES case; with one bf16 p instead of the two halves, the same gate
    fails on some case (so the test tells the two apart)."""
    control_out = []
    for d in fa.HEAD_DIMS:
        for i, (b, h, kh, sq, skv, causal, window, softcap,
                kvl) in enumerate(TC_CASES):
            rng = np.random.default_rng(100 * d + i)
            q = _t(_normal(rng, b, h, sq, d)).to(torch.bfloat16)
            k = _t(_normal(rng, b, kh, skv, d)).to(torch.bfloat16)
            v = _t(_normal(rng, b, kh, skv, d)).to(torch.bfloat16)
            kw = dict(kv_valid_len=kvl, causal=causal, window=window,
                      softcap=softcap)
            want = fa.flash_attention(
                q, k, v, **{**kw, "kv_valid_len": None if kvl is None
                            else torch.tensor(kvl)}).float()
            bound = BF16_RTOL * want.abs() + BF16_ATOL
            err = (_tc_emulation(q, k, v, **kw).float() - want).abs()
            assert (err <= bound).all(), (d, i, float(err.max()))
            if d == 128:
                one = _tc_emulation(q, k, v, split=False, **kw).float()
                control_out.append(float(((one - want).abs() > bound)
                                         .float().mean()))
    assert max(control_out) > 0, control_out


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks the wrapper makes before a launch (CPU tensors never get
    that far: they take the plain version)."""
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        fa._check(q, q, q, None)
    with pytest.raises(ValueError, match="CUDA device"):
        fa._check(q, q, q, torch.tensor([8]))
    d32 = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa._check(d32, d32, d32, None)
    with pytest.raises(ValueError, match="KV heads"):
        fa._check(torch.zeros(1, 3, 8, 16), q, q, None)
    with pytest.raises(TypeError):
        fa._check(q.half(), q, q, None)
    with pytest.raises(TypeError):
        fa._check(q, q, q.bfloat16(), None)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(torch.zeros(1, 2, 16, 8).transpose(2, 3), q, q, None)
    with pytest.raises(ValueError, match="kv_valid_len"):
        fa._check(q, q, q, torch.tensor([8, 8]))


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-12b"])
def test_prefill_routes_through_flash(monkeypatch, arch):
    """One wrapper call per layer in prefill, none in decode_step or
    chunk_step; the prefill's logits and cache equal, bit for bit, those of
    the chunked_attention call the model made before the route (gemma3: a
    windowed=False cache past the 8-token window, 4-token KV chunks)."""
    cfg = reduced(ARCHS[arch])
    model = get_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    plen = 24 if cfg.window_size else 16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, plen)))
    calls = []
    real = L.flash_attention

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    def parent(q, k, v, *, kv_valid_len, causal, window, softcap, bq, bk):
        assert bq == 1024
        return L.chunked_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            torch.arange(q.shape[2]), kv_valid_len, causal=causal,
            window=window, softcap=softcap, chunk=bk).transpose(1, 2)

    from repro_torch.models import transformer as T
    out = {}
    for name, fn in (("route", spy), ("parent", parent)):
        monkeypatch.setattr(L, "flash_attention", fn)
        cache = model.init_cache(2, plen + 2, windowed=False)
        logits, cache = T.prefill(params, cfg, tokens, cache, attn_chunk=4)
        out[name] = (logits, cache["k"], cache["v"])
    assert len(calls) == cfg.n_layers
    assert [c["window"] for c in calls] == T.layer_windows(cfg)
    for a, b in zip(out["route"], out["parent"]):
        assert torch.equal(a, b)
    monkeypatch.setattr(L, "flash_attention", spy)
    calls.clear()
    logits, cache = model.decode_step(params, tokens[:, :1], cache, plen)
    paged = model.init_paged_cache(2, plen + 2, 8, 8, windowed=False)
    paged["block_tables"] = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    model.chunk_step(params, tokens[:, :8], paged,
                     torch.zeros(2, dtype=torch.int32),
                     torch.full((2,), 8, dtype=torch.int32))
    assert not calls
