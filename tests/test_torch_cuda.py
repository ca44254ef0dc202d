"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips without a card; whether one exists is
decided inside the ``device`` fixture, never at import, so every test process
collects the same tests. This file imports no JAX (the machine with the card
has none); run it there without the JAX package's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The GEMM kernels are held bit-exact against their plain versions: both
compute integer sums exactly (the delta kernel at the exact rank, where each
block's f32 correction rounds to an integer whatever the summation order; at
a truncated rank without the residual within one per K-block). The paged-attention kernel sums in another
order than its plain version (the gather path on cuBLAS f32 einsums, TF32
off), so it is held to a tolerance: with f32 q and pools within
``F32_ATOL``; with bf16 outputs within one bf16 ulp (``BF16_RTOL`` = 2^-7 of
the value) plus ``BF16_ATOL`` for sums that cancel near zero. The
flash-attention kernel likewise (its plain version is the chunked attention
on cuBLAS f32 einsums): bf16 outputs within one bf16 ulp plus ``BF16_ATOL``,
f32 outputs within ``F32_ATOL`` plus ``F32_ATOL`` of the value (sums over up
to a few hundred keys in another order, and ``expf`` against PyTorch's exp).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import error_delta
from repro_torch.kernels import (approx_gemm, delta_gemm, flash_attention,
                                 ops, paged_attention, systolic_gemm)
from repro_torch.kernels.ref import (approx_matmul_ref, delta_matmul_fused_ref,
                                     flash_attention_ref, paged_attention_ref,
                                     systolic_matmul_ref)

pytestmark = pytest.mark.cuda
F32_ATOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4

# (M, K, N): the slice's decode/prefill shapes for smollm-360m and odd shapes
SHAPES = [(4, 960, 960), (4, 960, 320), (64, 960, 2560), (64, 2560, 960),
          (4, 960, 49152), (1, 1, 1), (3, 37, 130), (17, 131, 67),
          (65, 259, 333)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int8(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=device,
                         dtype=torch.int8)


@pytest.mark.parametrize("m,kd,n", SHAPES)
def test_systolic_gemm_matches_plain(device, m, kd, n):
    a, b = _int8((m, kd), 1, device), _int8((kd, n), 2, device)
    before = systolic_gemm.launches
    got = systolic_gemm.systolic_matmul(a, b)
    torch.cuda.synchronize()
    assert systolic_gemm.launches == before + 1
    assert torch.equal(got, systolic_matmul_ref(a, b))


@pytest.mark.parametrize("m,kd,n", SHAPES[:2] + SHAPES[5:])
def test_approx_gemm_matches_plain(device, m, kd, n):
    a, b = _int8((m, kd), 3, device), _int8((kd, n), 4, device)
    for k in (0, 2, 4, 6, 8):
        table = approx_gemm.make_table(k, device=device)
        before = approx_gemm.launches
        got = approx_gemm.approx_matmul_lut(a, b, table)
        torch.cuda.synchronize()
        assert approx_gemm.launches == before + 1
        assert torch.equal(got, approx_matmul_ref(a, b, table.flat,
                                                  span=table.span)), k


def test_approx_gemm_small_table(device):
    """n_bits = 4: 16 x 16 table; operands keep only their low 4 bits."""
    a, b = _int8((5, 70), 5, device), _int8((70, 9), 6, device)
    table = approx_gemm.make_table(2, n_bits=4, device=device)
    got = approx_gemm.approx_matmul_lut(a, b, table)
    torch.cuda.synchronize()
    assert torch.equal(got, approx_matmul_ref(a, b, table.flat, span=16))


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    a, b = _int8((4, 32), 7, device), _int8((32, 8), 8, device)
    with pytest.raises(ValueError, match="int16"):
        approx_gemm.approx_matmul_lut(
            a, b, approx_gemm.make_table(4, signed=False, device=device))
    with pytest.raises(TypeError):
        systolic_gemm.systolic_matmul(a.to(torch.int32), b)
    with pytest.raises(ValueError, match="contiguous"):
        systolic_gemm.systolic_matmul(a, _int8((8, 32), 9, device).T)
    with pytest.raises(ValueError):
        systolic_gemm.systolic_matmul(a, b.cpu())


def test_cpu_tensors_never_launch(device):
    before = (systolic_gemm.launches, approx_gemm.launches)
    a = torch.randint(-128, 128, (3, 16), dtype=torch.int8)
    b = torch.randint(-128, 128, (16, 5), dtype=torch.int8)
    ops.systolic_matmul(a, b)
    ops.approx_matmul(a, b)
    assert (systolic_gemm.launches, approx_gemm.launches) == before


@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_reduced_server_on_card(device, backend):
    """The lockstep server on the card: kernels launched for every GEMM,
    bound == unbound, tokens in range."""
    from repro_torch.launch import serve
    mod = systolic_gemm if backend == "mxu_int8" else approx_gemm
    before = mod.launches
    argv = ["--debug", "--backend", backend, "--gen-len", "4"]
    bound = serve.main(argv)
    # reduced smollm: 2 layers x 7 GEMMs + lm_head, 4 forwards
    assert mod.launches - before == 4 * (7 * 2 + 1)
    np.testing.assert_array_equal(bound, serve.main(argv + ["--no-bind"]))
    assert ((bound >= 0) & (bound < 256)).all()



def _delta(a, b, k, rank=None):
    """delta_gemm at factor k against its plain version (the kernel's block)
    and, at the exact rank, against the product-table kernel's plain version."""
    fac = error_delta.delta_factors(8, k, rank=rank)
    f, g = error_delta.factor_tables(fac, a.device)
    before = delta_gemm.launches
    got = delta_gemm.delta_matmul_fused(a, b, f, g, rank=fac.rank)
    torch.cuda.synchronize()
    assert delta_gemm.launches == before + 1
    want = delta_matmul_fused_ref(a, b, f, g, rank=fac.rank,
                                  bk=delta_gemm.KERNEL_BK)
    return fac, got, want


@pytest.mark.parametrize("m,kd,n", SHAPES)
def test_delta_gemm_matches_plain(device, m, kd, n):
    a, b = _int8((m, kd), 11, device), _int8((kd, n), 12, device)
    for k in (0, 2, 4, 6, 8):
        fac, got, want = _delta(a, b, k)
        assert torch.equal(got, want), k
        table = approx_gemm.make_table(k, device=device)
        assert torch.equal(got, approx_matmul_ref(a, b, table.flat,
                                                  span=table.span)), k
    # truncated rank, no residual: per-block rounding of a non-integer sum
    n_blocks = -(-kd // delta_gemm.KERNEL_BK)
    for k, rank in ((6, 3), (8, 10)):
        _, got, want = _delta(a, b, k, rank)
        assert (got.long() - want.long()).abs().max().item() <= n_blocks


def test_delta_gemm_tables_from_global_memory(device):
    """Rank 120 at k = 8 (exact: the rank passes 62) needs 240 KB of f and
    g, more than a block's shared memory: the kernel reads them through the
    L2 and stays bit-exact."""
    b = _int8((300, 70), 14, device)
    for m in (6, 40):
        fac, got, want = _delta(_int8((m, 300), 13 + m, device), b, 8, 120)
        assert fac.exact and torch.equal(got, want)


def test_approx_delta_routes_on_card(device):
    """The exact rank and the truncated rank with residual (the kernel at
    rank 0, then correction + defect rounded once) equal the table GEMM."""
    a, b = _int8((5, 200), 16, device), _int8((200, 33), 17, device)
    want = ops.approx_matmul(a, b, k=6)
    for rank in (None, 4, 0):
        before = delta_gemm.launches
        assert torch.equal(ops.approx_delta_matmul(a, b, k=6, rank=rank), want)
        assert delta_gemm.launches == before + 1
    prep = ops.prepare_operand(b, backend="approx_delta", k=6)
    before = (delta_gemm.launches, systolic_gemm.launches)
    assert torch.equal(ops.prepared_matmul(a, prep), want)
    assert (delta_gemm.launches, systolic_gemm.launches) == (before[0],
                                                             before[1] + 1)


@pytest.mark.parametrize("bind", [True, False])
def test_reduced_server_approx_delta_on_card(device, bind):
    """approx_delta on the card: unbound every GEMM through delta_gemm,
    bound through the exact kernel plus the f32 correction; streams and
    prefill logits equal approx_lut's bit for bit."""
    from repro_torch.launch import serve
    flag = [] if bind else ["--no-bind"]
    argv = ["--debug", "--gen-len", "4"] + flag
    before = (delta_gemm.launches, systolic_gemm.launches)
    got = serve.main(argv + ["--backend", "approx_delta"])
    n = 4 * (7 * 2 + 1)
    assert (delta_gemm.launches - before[0],
            systolic_gemm.launches - before[1]) == ((0, n) if bind else (n, 0))
    np.testing.assert_array_equal(got, serve.main(argv + ["--backend",
                                                          "approx_lut"]))
    args = serve.build_parser().parse_args(argv + ["--backend",
                                                    "approx_delta"])
    cfg, model, params, policy, prompts = serve.setup(args)
    logits = {}
    for backend in ("approx_delta", "approx_lut"):
        args.backend = backend
        _, _, params, policy, _ = serve.setup(args)
        logits[backend], _ = model.prefill(
            params, {"tokens": prompts},
            model.init_cache(*prompts.shape, device=device), policy=policy)
    assert torch.equal(logits["approx_delta"], logits["approx_lut"])


def paged_inputs(seed, *, b, sq, h, kh, d, bs, width, kvl, q_dtype, kv_dtype,
                 device):
    """Random q and pools, a permuted fragmented table per row (dump index
    past the live blocks) and query positions ending at each row's live
    length, so every query of a row with kvl > 0 sees a valid key."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * width + 5
    q = torch.randn((b, sq, h, d), generator=g).to(q_dtype)
    k = torch.randn((n_blocks + 1, bs, kh, d), generator=g)
    v = torch.randn((n_blocks + 1, bs, kh, d), generator=g)
    if kv_dtype == torch.int8:
        k, v = (torch.clamp(torch.round(x * 32), -127, 127).to(torch.int8)
                for x in (k, v))
    else:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    perm = torch.randperm(n_blocks, generator=g)[:b * width].reshape(b, width)
    kvl_t = torch.tensor(kvl, dtype=torch.int32)
    tables = torch.where(torch.arange(width)[None, :] * bs < kvl_t[:, None],
                         perm, n_blocks).to(torch.int32)
    qpos = torch.clamp_min(kvl_t[:, None] - sq + torch.arange(sq)[None, :],
                           0).to(torch.int32)
    return [t.to(device) for t in (q, k, v, tables, kvl_t, qpos)]


# (Sq, H, KH, D, block size, table width, kv_valid_len, chunk, window, softcap)
PAGED = [(1, 15, 5, 64, 8, 8, [0, 13, 40, 64], 1024, 0, 0.0),
         (8, 15, 5, 64, 8, 8, [8, 0, 40, 64], 1024, 0, 0.0),
         (8, 15, 5, 64, 8, 32, [0, 70, 200, 256], 64, 0, 0.0),
         (1, 15, 5, 64, 8, 32, [9, 70, 0, 256], 64, 24, 30.0),
         (5, 4, 2, 16, 4, 6, [5, 24, 0, 11], 8, 0, 0.0),
         (3, 8, 1, 128, 16, 4, [64, 3, 0, 40], 32, 7, 0.0),
         (2, 4, 4, 32, 8, 5, [2, 33, 40, 0], 16, 0, 5.0),
         # gemma3-12b's engine: 16/8 heads at head dim 256
         (1, 16, 8, 256, 8, 8, [0, 13, 40, 64], 1024, 0, 0.0),
         (8, 16, 8, 256, 8, 8, [8, 0, 41, 64], 1024, 0, 0.0),
         (8, 16, 8, 256, 8, 32, [9, 150, 0, 256], 64, 24, 0.0),
         # the engine's decode rows, every row live, at both served head dims
         (1, 15, 5, 64, 8, 8, [17, 33, 49, 64], 1024, 0, 0.0),
         (1, 16, 8, 256, 8, 8, [17, 33, 49, 64], 1024, 0, 0.0),
         # 4096-position decode rows: the kernel splits them on its own
         (1, 15, 5, 64, 8, 512, [4096] * 4, 1024, 0, 0.0),
         (1, 16, 8, 256, 8, 512, [4096] * 4, 1024, 0, 0.0),
         # rows whose live range is shorter than one split (and one empty)
         (1, 15, 5, 64, 8, 512, [4096, 5, 0, 300], 1024, 0, 0.0)]


@pytest.mark.parametrize("case", PAGED)
def test_paged_attention_matches_plain(device, case):
    """f32, bf16 and int8 pools (q in f32, bf16, bf16), n_splits 1 and 3
    (a floor: the kernel splits long rows further on its own, and merges the
    splits inside the one launch)."""
    for q_dtype, kv_dtype in ((torch.float32, torch.float32),
                              (torch.bfloat16, torch.bfloat16),
                              (torch.bfloat16, torch.int8)):
        _check_paged_case(device, case, q_dtype, kv_dtype)


def _check_paged_case(device, case, q_dtype, kv_dtype):
    sq, h, kh, d, bs, width, kvl, chunk, window, softcap = case
    q, k, v, tables, kvl_t, qpos = paged_inputs(
        sum(kvl) + sq, b=len(kvl), sq=sq, h=h, kh=kh, d=d, bs=bs, width=width,
        kvl=kvl, q_dtype=q_dtype, kv_dtype=kv_dtype, device=device)
    want = paged_attention_ref(q, k, v, tables, kvl_t, qpos, window=window,
                               softcap=softcap, chunk=chunk).float()
    live = kvl_t > 0
    for n_splits in (1, 3):
        before = paged_attention.launches
        got = paged_attention.paged_attention(
            q, k, v, tables, kvl_t, qpos, window=window, softcap=softcap,
            chunk=chunk, n_splits=n_splits)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        # the in-kernel split merge leaves its counters at 0
        assert not any(c.any() for c in paged_attention._counters.values())
        assert got.shape == q.shape and got.dtype == q.dtype
        assert not got[~live].any()          # kv_valid_len == 0: zeros
        err = (got.float() - want)[live].abs()
        what = (q_dtype, kv_dtype, n_splits, err.max().item())
        if q_dtype == torch.float32:
            assert err.max().item() <= F32_ATOL, what
        else:
            bound = BF16_RTOL * want[live].abs() + BF16_ATOL
            assert (err <= bound).all(), what


def test_paged_attention_refuses_what_the_kernel_does_not_take(device):
    q, k, v, tables, kvl, qpos = paged_inputs(
        0, b=2, sq=1, h=4, kh=2, d=16, bs=4, width=3, kvl=[3, 5],
        q_dtype=torch.float32, kv_dtype=torch.float32, device=device)
    with pytest.raises(ValueError, match="multiple of the KV block"):
        paged_attention.paged_attention(q, k, v, tables, kvl, qpos, chunk=6)
    with pytest.raises(ValueError, match="head dim"):
        paged_attention.paged_attention(q[..., :8].contiguous(),
                                        k[..., :8].contiguous(),
                                        v[..., :8].contiguous(), tables, kvl,
                                        qpos)
    with pytest.raises(TypeError):
        paged_attention.paged_attention(q.half(), k, v, tables, kvl, qpos)
    with pytest.raises(ValueError):
        paged_attention.paged_attention(q, k.cpu(), v, tables, kvl, qpos)


@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_reduced_engine_on_card(device, backend):
    """The engine on the card: paged attention through the kernel (2 layers
    per chunk step), GEMMs through the backend's kernel, streams equal to
    the card's lockstep for the same prompts (a differing token only at a
    top-2 margin within 4 bf16 ulps)."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--debug", "--engine", "--backend", backend, "--requests", "6",
         "--gen-len", "6", "--prompt-len", "12"])
    cfg, model, params, policy, _ = serve.setup(args)
    reqs = serve.engine_requests(args, cfg)
    mod = systolic_gemm if backend == "mxu_int8" else approx_gemm
    before = (paged_attention.launches, mod.launches)
    finished, eng = serve.run_engine(args, cfg, params, policy, requests=reqs)
    steps = eng.stats["host_syncs"]
    assert paged_attention.launches - before[0] == 2 * steps
    assert mod.launches - before[1] == (7 * 2 + 1) * steps
    for r in reqs:
        margins = []
        want = serve.lockstep_generate(
            cfg, model, params, torch.from_numpy(r.prompt[None]).long().to(
                device), r.max_new_tokens, policy=policy, margins=margins)[0]
        got = finished[r.rid].tokens
        diff = np.nonzero(got != want)[0]
        if diff.size:
            assert float(margins[int(diff[0])][0]) <= 0.125, r.rid


# (B, H, KH, Sq, Skv, causal, window, softcap, kv_valid_len, layout)
# kv_valid_len: None, an int, or a list (per batch row); layout "bshd" hands
# the kernel transposed views of (B, S, H, D) tensors, as the model's route
FLASH = [(2, 4, 4, 64, 64, True, 0, 0.0, None, "bhsd"),
         (2, 15, 5, 16, 16, True, 0, 0.0, None, "bshd"),        # smollm
         (1, 16, 8, 200, 200, True, 48, 0.0, None, "bshd"),     # window
         (2, 8, 4, 130, 130, True, 32, 50.0, None, "bhsd"),     # softcap
         (3, 6, 2, 40, 96, False, 0, 0.0, [5, 70, 96], "bhsd"),  # ragged
         (2, 4, 1, 77, 77, True, 0, 0.0, 50, "bshd"),
         (2, 4, 2, 33, 70, False, 0, 0.0, None, "bhsd"),
         (1, 4, 2, 333, 333, True, 100, 0.0, None, "bshd")]   # K/V ring wraps


def flash_inputs(seed, *, b, h, kh, sq, skv, d, dtype, layout, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g)
    k = torch.randn((b, skv, kh, d), generator=g)
    v = torch.randn((b, skv, kh, d), generator=g)
    q, k, v = (t.to(dtype).to(device) for t in (q, k, v))
    if layout == "bshd":
        return [t.transpose(1, 2) for t in (q, k, v)]
    return [t.transpose(1, 2).contiguous() for t in (q, k, v)]


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
def test_flash_attention_matches_plain(device, d):
    """Every FLASH case in f32 (the SIMT kernel) and bf16 (the tensor-core
    kernel) at head dim d, TF32 off: Sq and Skv off the tile grid, GQA, a
    window whose later q-tiles skip their first K tiles, softcap, ragged
    and non-causal, a K loop long enough to wrap the K/V ring. Each bf16
    launch counts in ``tc_launches``, each f32 one does not. (A row whose
    kv_valid_len is 0 admits no key: out of contract, not tested.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert flash_attention.variant(torch.bfloat16, torch.bfloat16) == \
        "tensor_core"
    for dt in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32)):
        assert flash_attention.variant(*dt) == "simt"
    for i, case in enumerate(FLASH):
        b, h, kh, sq, skv, causal, window, softcap, kvl, layout = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(i + d, b=b, h=h, kh=kh, sq=sq, skv=skv,
                                   d=d, dtype=dtype, layout=layout,
                                   device=device)
            if isinstance(kvl, list):
                kvl = torch.tensor(kvl, dtype=torch.int32, device=device)
            kw = dict(kv_valid_len=kvl, causal=causal, window=window,
                      softcap=softcap)
            before = (flash_attention.launches, flash_attention.tc_launches)
            got = flash_attention.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert (flash_attention.launches, flash_attention.tc_launches) \
                == (before[0] + 1, before[1] + (dtype == torch.bfloat16))
            assert got.shape == q.shape and got.dtype == dtype
            want = flash_attention_ref(q, k, v, **kw).float()
            err = (got.float() - want).abs()
            if dtype == torch.float32:
                bound = F32_ATOL * want.abs() + F32_ATOL
            else:
                bound = BF16_RTOL * want.abs() + BF16_ATOL
            assert (err <= bound).all(), (case, dtype, err.max().item())


def test_flash_attention_refuses_what_the_kernel_does_not_take(device):
    q, k, v = flash_inputs(0, b=1, h=4, kh=2, sq=8, skv=8, d=32,
                           dtype=torch.float32, layout="bhsd", device=device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, k, v)
    q, k, v = flash_inputs(0, b=1, h=4, kh=2, sq=8, skv=8, d=16,
                           dtype=torch.float32, layout="bhsd", device=device)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q.half(), k, v)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def test_reduced_prefill_through_flash_on_card(device):
    """The lockstep server's prefill launches the flash kernel once per
    layer and nothing else of the attention kernels; decode launches none.
    Reduced gemma3 with a uniform cache past its window: the card's prefill
    logits are within 4 bf16 ulps of the same prefill with the route's
    entry replaced by the plain version."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    before = (flash_attention.launches, paged_attention.launches)
    serve.main(["--debug", "--gen-len", "4"])
    assert (flash_attention.launches - before[0],
            paged_attention.launches - before[1]) == (2, 0)
    cfg = reduced(ARCHS["gemma3-12b"])
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0),
                               device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40))).to(device)
    logits = {}
    for name, fn in (("kernel", flash_attention.flash_attention),
                     ("plain", flash_attention_ref)):
        real, L.flash_attention = L.flash_attention, fn
        try:
            before = flash_attention.launches
            logits[name], _ = model.prefill(
                params, {"tokens": tokens},
                model.init_cache(2, 40, device=device, windowed=False))
            torch.cuda.synchronize()
            launched = flash_attention.launches - before
        finally:
            L.flash_attention = real
        assert launched == (cfg.n_layers if name == "kernel" else 0)
    d = (logits["kernel"] - logits["plain"]).abs().max().item()
    assert d <= 0.125, d
