#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (five
   sources, one ``nvcc`` each, in parallel) and print the card's name and
   power limit, and each flash instantiation's registers, spills and shared
   memory from ptxas' report (a tensor-core instantiation that spills
   fails), and the same of the served paged-attention instantiations (bf16
   q over bf16 and int8 pools at head dims 64 and 256; one that spills
   fails).
2. Hold each kernel bit-exact against its plain PyTorch version on the card,
   at every GEMM shape of the served model (smollm-360m: K x N in
   {960x960, 960x320, 960x2560, 2560x960, 960x49152}, M in {4, 64}) and at
   odd shapes; the approximate kernel at k in {0, 2, 4, 6, 8}.
3. Serve smollm-360m at full width through the user's entry point
   ``repro_torch.launch.serve.main`` (CLI defaults: batch 4, prompt 16,
   gen 16, bound) under ``mxu_int8`` and ``approx_lut``: one warm-up run,
   then the bound run and an unbound run, each with the launch counters set
   to 0 just before and read just after: the backend's kernel must run once
   per model GEMM, n_forwards * (7 * n_layers + 1) times, the flash-attention
   kernel once per layer of the prefill (n_layers times), every other kernel
   never, and the unbound streams must equal the bound ones bit for bit.
   In every counted run (here and in phases 12-13; the models are bf16)
   each flash launch must have run the tensor-core variant
   (``flash_attention.tc_launches`` equal to its ``launches``).
4. Check outputs: tokens in range; full-width logits finite; on a small
   (reduced) model the card's logits agree with the CPU's plain versions.
5. Trace 4 decode steps of the same configuration with
   ``repro_torch.launch.trace_serve`` (host wall ms against device busy ms)
   under ``mxu_int8``, ``approx_lut``, ``exact`` and ``approx_delta`` (bound
   and unbound).
6. Time each kernel, its plain version and (for the exact GEMM) the PyTorch
   call ``torch._int_mm`` with CUDA events at the main path's shapes, beside
   the card's bound for the same work.
7. Hold the paged-attention kernel against its plain version (the gather
   path) at smollm-360m's attention shapes (KH = 5, G = 3, D = 64, block 8):
   bf16 and int8 pools, permuted and fragmented tables, ragged
   kv_valid_len including 0 and rows past one chunk, Sq = 1 (decode) and
   Sq = 8 (a prefill chunk), window and softcap cases, n_splits 1 and 3;
   and at 4096-position decode rows (smollm-360m's and gemma3-12b's heads,
   D = 64 and 256, 512-page tables, which the kernel splits over blocks on
   its own), with rows whose live range is shorter than one split; within
   one bf16 ulp (``ATTN_RTOL``) plus ``ATTN_ATOL``, rows with kv_valid_len
   == 0 zero.
8. Serve smollm-360m at full width through the engine
   (``serve.run_engine``, 4 slots, block 8, prefill chunk 8, prefix cache
   on) under ``mxu_int8`` and ``approx_lut``, bound: 16 requests with
   prompts of 16-48 tokens, 16 new tokens each, half of them behind a shared
   16-token system prompt. Counters set to 0 just before and read just
   after: ``paged_attention`` must run 32 times per chunk step and each
   backend's GEMM kernel 225 times per chunk step; ``prefix_hits`` and COW
   copies must be > 0; each request's greedy stream must equal the
   lockstep stream of its prompt alone, except at a flagged tie (the
   lockstep's top-2 margin at the first differing token within
   ``LOGIT_ATOL``). Then the same trace again, untraced with per-step wall
   times, and a third time with the profiler on a window of steps: the
   device's idle share of the engine step.
9. Time ``paged_attention`` at every chunk step of the served trace (the
   step's real tables, live lengths and positions), its plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` over the same K/V
   gathered into contiguous tensors beforehand (the gather is not timed),
   with the same mask, beside the bound (live KV bytes over the memory
   rate); totals per served batch, 32 layers per step. Then one
   long-context decode row timed the same way, on its own line: batch 4,
   Sq 1, each row live to 4096 positions through a permuted table of block
   8 (21 MB of bf16 K/V).
10. The ``approx_delta`` slice. The fused delta kernel bit-exact against its
   plain version (its own K-block) and against the product-table kernel at
   every served shape and odd shapes, k in {0, 2, 4, 6, 8} at the exact
   rank; a truncated rank through the exact_cancel route (bit-exact), and
   without the residual (within one per K-block, differing entries
   counted). Lockstep serving under ``approx_delta`` (k = 4) bound (every
   GEMM through ``systolic_gemm`` plus the f32 correction, no
   ``delta_gemm``) and unbound (every GEMM through ``delta_gemm``), streams
   equal to ``approx_lut``'s; full-width prefill and decode logits bit-equal
   to ``approx_lut``'s bound and unbound. The engine phase (8) under
   ``approx_delta``, bound. The paper's apps at 256 px: DCT (k 2-8) and edge
   (k 2, 4) under ``approx_lut`` and ``approx_delta``, outputs bit-identical,
   PSNR at or above the Table-VI floors less 0.5 dB; DCT under
   ``approx_oracle`` and BDCN (k = 2, hybrid policy). The delta kernel timed
   with phase 6, beside the product-table kernel and the bound path
   (``systolic_gemm`` + cuBLAS f32 correction) on the same products.
11. The flash-attention kernel against its plain version (the chunked
   attention) within ``ATTN_RTOL`` plus ``ATTN_ATOL``, bf16, at the served
   shapes (``FLASH_SHAPES``): smollm-360m's prefill (batch 4, 16 tokens,
   15/5 heads, head dim 64), gemma3-12b's 2048-token prefill on a local
   (window 1024) and a global layer (16/8 heads, head dim 256), gemma2-27b's
   attention (32/16 heads, head dim 128, softcap 50, window 4096) at 4608
   tokens, ragged per-batch live lengths causal and not. Then timed there
   with its plain version and ``scaled_dot_product_attention`` (same
   inputs and mask; none with a softcap), beside the bound (4 D flops per
   live pair and head at the bf16 tensor-core peak, or the bytes read and
   written once, whichever take longer), and once the former f32-priced
   bound (p v at the f32 peak).
12. gemma3-12b at its full published width (48 layers, d_model 3840, 16/8
   heads, head dim 256, d_ff 15360, vocab 262144, bf16, random weights from
   seed 0), bound under ``mxu_int8``: lockstep through ``serve.main``
   (flash kernel at every prefill layer, launches counted) and the engine on
   the 16-request trace of phase 8 (``paged_attention`` at head dim 256, 48
   launches per chunk step), every engine stream equal to the lockstep
   stream of its prompt or a flagged tie; the engine's idle share (as in
   phase 8) and ``paged_attention`` timed at every chunk step of that trace
   (as in phase 9, 48 layers per step), and its long-context decode row
   (134 MB of bf16 K/V).
13. gemma3-12b's 2048-token prefill (batch 1) over a ``windowed=False``
   cache, past the 1024-token window: 48 flash launches; its last-position
   logits within ``LOGIT_ULPS`` bf16 ulps at the largest |logit|
   (``LOGIT_ATOL``'s 4 ulps, which it states for |logit| < 8), or twice
   the drift of the plain attention's logits under another order of its
   sums (``WINDOW_REORDER_BK``), whichever is larger, of the same
   prefill with the route's entry
   (``models.layers.flash_attention``) replaced by the plain version, argmax
   equal or a flagged tie. Two controls show that the gate sees the window
   mask: the same prefill with the plain version stripped of the window
   must move the logits past that tolerance; and the first local layer's
   kernel output at the queries past the window is held to the plain
   version on the same inputs within ``ATTN_RTOL`` plus ``ATTN_ATOL``,
   which the unwindowed plain version must break.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. ``launches`` in it counts
the kernel's launches over every counted main-path run (lockstep and engine,
both backends, and gemma3-12b's). The GEMM kernels' times are totals over
one lockstep served batch (each shape's time times its number of calls),
the paged-attention kernel's over one engine served batch, the
flash-attention kernel's over gemma3-12b's 2048-token prefill (40 local and
8 global layers). ``torch._int_mm`` refuses M <= 16, so
at the decode GEMMs (M = 4) it multiplies the moving operand zero-padded to
32 rows (padded outside the timed call) and its first M rows, held equal to
the kernel's output, are the product. No PyTorch call computes the table
GEMM or the delta GEMM: their ``library_ms`` are null.
"""
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.apps import bdcn, dct, edge, images  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import error_delta, gemm  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import (_build, approx_gemm,  # noqa: E402
                                 delta_gemm, flash_attention, ops,
                                 paged_attention, systolic_gemm)
from repro_torch.kernels.ref import (approx_matmul_ref,  # noqa: E402
                                     delta_matmul_fused_ref,
                                     flash_attention_ref, paged_attention_ref,
                                     systolic_matmul_ref)
from repro_torch.launch import engine, serve, trace_serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.layers import cache_load  # noqa: E402
from repro_torch.models.transformer import layer_windows  # noqa: E402

ARCH = "smollm-360m"
BATCH, PROMPT, GEN = 4, 16, 16          # serve.main's CLI defaults
INT_MM_MIN_M = 32    # torch._int_mm needs M > 16; smaller M is zero-padded
KS = (0, 2, 4, 6, 8)
ODD = [(1, 1, 1), (3, 37, 130), (17, 131, 67), (65, 259, 333)]
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12                # dense int8 tensor-core peak
SMEM_LOOKUPS_PER_CLOCK = 32             # shared-memory accesses per SM per clock
SPIN_CYCLES = 2_000_000                 # ~1 ms at the H100's SM clock
BF16_FLOPS_PER_S = 989e12               # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12                 # f32 outside the tensor cores
DELTA_K = 4                             # serve's --k default
# (k, truncated rank) of the truncated-rank checks of the delta kernel
DELTA_TRUNCATED = ((6, 3), (8, 10))
# Table VI (tests/test_quality_regression.py): k -> PSNR floor, less TOL_DB
PAPER_DCT_PSNR = {2: 45.97, 4: 38.21, 6: 35.67, 8: 28.43}
PAPER_EDGE_PSNR = {2: 30.45, 4: 20.51}
TOL_DB = 0.5
APP_SIZE = 256
LOGIT_ATOL = 0.125   # 4 bf16 ulps at |logit| < 8: float ops round differently
LOGIT_ULPS = 4       # the same 4 bf16 ulps where logits are larger
# gemma3-12b's window prefill is held to the larger of LOGIT_ULPS ulps at its
# top logit and twice the drift of the plain attention's own logits when only
# the order of its f32 sums changes (keys in chunks of this many instead of
# the route's 1024): outputs one bf16 ulp apart move int8 activation levels,
# and 48 layers amplify those moves, whatever computes the attention
WINDOW_REORDER_BK = 256
# paged attention against the gather path: both round the f32 result to bf16
# once, after sums taken in another order, so one bf16 ulp (2^-7 of the
# value) plus an absolute term for sums that cancel near zero
ATTN_RTOL, ATTN_ATOL = 2.0 ** -7, 1e-4
ATTN_CHUNK = 1024                       # the engine's attn_chunk
# the long-context decode row: each of 4 rows live to 4096 positions through
# a permuted 512-page table of block 8
LONG_LEN, LONG_PAGES = 4096, 512
GEMMA3 = "gemma3-12b"
GEMMA3_WINDOW_PROMPT = 2048      # 2x gemma3-12b's 1024-token window
ENGINE_ARGS = ["--engine", "--batch", "4", "--prompt-len", "48",
               "--gen-len", "16", "--block-size", "8", "--prefill-chunk", "8"]
N_REQUESTS, SYSTEM_LEN = 16, 16
TRACE_WINDOW = (8, 16)                  # chunk steps traced by the profiler
TRACE_DECODE_STEPS = 4                  # lockstep decode steps traced
KERNELS = {
    "systolic_gemm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/systolic_gemm.cu",
        replaces="src/repro/kernels/systolic_gemm.py:80", module=systolic_gemm),
    "approx_gemm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/approx_gemm.cu",
        replaces="src/repro/kernels/approx_gemm.py:93", module=approx_gemm),
    "paged_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:323",
        module=paged_attention),
    "delta_gemm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/delta_gemm.cu",
        replaces="src/repro/kernels/delta_gemm.py:123", module=delta_gemm),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:148",
        module=flash_attention),
}
# the kernel that runs every model GEMM of a backend, bound and unbound
GEMM_KERNEL = {
    (True, "mxu_int8"): "systolic_gemm", (False, "mxu_int8"): "systolic_gemm",
    (True, "approx_lut"): "approx_gemm", (False, "approx_lut"): "approx_gemm",
    (True, "approx_delta"): "systolic_gemm",
    (False, "approx_delta"): "delta_gemm"}


def flash_build_report():
    """Registers, spills and shared memory of each instantiation of the
    flash kernel, from ptxas' report in its build log; raises if a
    tensor-core instantiation spills."""
    log = _build.library_path("flash_attention").with_suffix(".log")
    for entry in log.read_text().split("Compiling entry function '")[1:]:
        name = entry.split("'")[0]
        d = int(re.search(r"Li(\d+)E", name).group(1))
        regs = int(re.search(r"Used (\d+) registers", entry).group(1))
        spill = [int(x) for x in re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            entry).groups()]
        tc = "flash_tc_kernel" in name
        dt = torch.bfloat16 if tc else torch.float32
        print(f"flash_attention {'tensor-core' if tc else 'SIMT'} "
              f"instantiation at D {d}: {regs} registers, spill stores/"
              f"loads {spill[0]}/{spill[1]} B, "
              f"{flash_attention.smem_bytes(dt, dt, d)} B dynamic shared "
              f"memory", flush=True)
        if tc and any(spill):
            raise AssertionError(f"flash tensor-core kernel spills at D {d}")


# the served paged-attention instantiations: (q dtype code, pool dtype code,
# head dim) of bf16 q over bf16 and int8 pools at smollm's and gemma3-12b's
# head dims
PAGED_SERVED = {(1, kv, d) for kv in (1, 2) for d in (64, 256)}
DTYPE_NAMES = {0: "f32", 1: "bf16", 2: "int8"}


def paged_build_report():
    """Registers, spills and shared memory of the served instantiations of
    the paged-attention kernel, from ptxas' report in its build log; raises
    if one spills."""
    log = _build.library_path("paged_attention").with_suffix(".log")
    seen = set()
    for entry in log.read_text().split("Compiling entry function '")[1:]:
        key = tuple(int(x) for x in re.search(
            r"paged_attention_kernelILi(\d)ELi(\d)ELi(\d+)EE",
            entry).groups())
        if key not in PAGED_SERVED:
            continue
        seen.add(key)
        regs = int(re.search(r"Used (\d+) registers", entry).group(1))
        spill = [int(x) for x in re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            entry).groups()]
        smem = int(re.search(r"(\d+) bytes smem", entry).group(1))
        print(f"paged_attention q {DTYPE_NAMES[key[0]]}, pools "
              f"{DTYPE_NAMES[key[1]]}, D {key[2]}, {paged_attention.ROWS} "
              f"rows a block: "
              f"{regs} registers, spill "
              f"stores/loads {spill[0]}/{spill[1]} B, {smem} B static and "
              f"{paged_attention.SMEM_BYTES} B dynamic shared memory at most",
              flush=True)
        if any(spill):
            raise AssertionError(f"paged_attention spills at {key}")
    if seen != PAGED_SERVED:
        raise AssertionError(f"no ptxas report of {PAGED_SERVED - seen}")


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def slice_gemms(cfg, batch=BATCH, prompt=PROMPT, gen=GEN):
    """{(M, K, N): calls} of one lockstep served batch: prefill runs the
    layer GEMMs on batch*prompt rows and the vocab projection on the last
    position; each of the gen-1 decode steps runs all on `batch` rows."""
    d, hd = cfg.d_model, cfg.hd
    layer = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
             (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
             (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    calls = {}
    for m, steps in ((batch * prompt, 1), (batch, gen - 1)):
        for kd, n in layer:
            calls[(m, kd, n)] = calls.get((m, kd, n), 0) + steps * cfg.n_layers
    head = (batch, d, cfg.vocab_size)
    calls[head] = calls.get(head, 0) + gen
    return calls


def _int8(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=device,
                         dtype=torch.int8)


def check_kernels(cfg, device):
    """Phase 2: bit-exact against the plain versions; returns max |err|."""
    shapes = sorted({(m, kd, n) for (_, kd, n) in slice_gemms(cfg)
                     for m in (BATCH, BATCH * PROMPT)}) + ODD
    err = {"systolic_gemm": 0, "approx_gemm": 0}
    for i, (m, kd, n) in enumerate(shapes):
        a, b = _int8((m, kd), 2 * i, device), _int8((kd, n), 2 * i + 1, device)
        got = systolic_gemm.systolic_matmul(a, b)
        torch.cuda.synchronize()
        want = systolic_matmul_ref(a, b)
        e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        err["systolic_gemm"] = max(err["systolic_gemm"], e)
        if e:
            raise AssertionError(f"systolic_gemm != plain at {(m, kd, n)}: {e}")
        for k in KS:
            table = approx_gemm.make_table(k, device=device)
            got = approx_gemm.approx_matmul_lut(a, b, table)
            torch.cuda.synchronize()
            want = approx_matmul_ref(a, b, table.flat, span=table.span)
            e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            err["approx_gemm"] = max(err["approx_gemm"], e)
            if e:
                raise AssertionError(
                    f"approx_gemm != plain at {(m, kd, n)}, k={k}: {e}")
    print(f"kernels bit-exact vs plain versions at {len(shapes)} shapes "
          f"(approx_gemm at k={list(KS)})", flush=True)
    return err


def _counted(fn):
    """fn() with every launch counter set to 0 just before and read just
    after: (result, {kernel: launches}). The counted runs serve bf16 models,
    so every flash launch in them must have run the tensor-core variant
    (``flash_attention.tc_launches``)."""
    for k in KERNELS.values():
        k["module"].launches = 0
    flash_attention.tc_launches = 0
    out = fn()
    launches = {name: k["module"].launches for name, k in KERNELS.items()}
    if flash_attention.tc_launches != launches["flash_attention"]:
        raise AssertionError(f"{flash_attention.tc_launches} of "
                             f"{launches['flash_attention']} flash launches "
                             "ran the tensor-core kernel")
    return out, launches


def _check_launches(what, launches, counts):
    """launches must equal ``counts`` ({kernel: n}) and be 0 elsewhere."""
    expect = {name: counts.get(name, 0) for name in KERNELS}
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches}, expected {expect}")


def serve_full_width(cfg, backend):
    """Phase 3 for one backend: the bound main-path run, then an unbound run
    that must match it bit for bit, each with its launch counts. Returns
    (launches of both runs, bound stream)."""
    argv = ["--arch", ARCH, "--backend", backend]
    serve.main(argv)             # warm-up: first-call set-up stays out
    want = GEN * (7 * cfg.n_layers + 1)
    bound, launches = _counted(lambda: serve.main(argv))
    # every model GEMM through the backend's kernel; the prefill's attention
    # through the flash kernel, once per layer
    _check_launches(f"{backend} bound", launches,
                    {GEMM_KERNEL[True, backend]: want,
                     "flash_attention": cfg.n_layers})
    if bound.shape != (BATCH, GEN) or not ((bound >= 0)
                                           & (bound < cfg.vocab_size)).all():
        raise AssertionError(f"{backend}: bad token stream {bound}")
    unbound, un_launches = _counted(lambda: serve.main(argv + ["--no-bind"]))
    if not np.array_equal(bound, unbound):
        raise AssertionError(f"{backend}: bound != unbound streams\n{bound}\n"
                             f"{unbound}")
    _check_launches(f"{backend} unbound", un_launches,
                    {GEMM_KERNEL[False, backend]: want,
                     "flash_attention": cfg.n_layers})
    launches = {n: launches[n] + un_launches[n] for n in KERNELS}
    print(f"{backend}: {launches} launches in the counted runs; bound == "
          f"unbound", flush=True)
    return launches, bound


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def check_outputs(cfg, device):
    """Phase 4: finite full-width logits; approx_delta's prefill and first
    decode logits bit-equal to approx_lut's, bound and unbound; reduced
    model card == CPU logits."""
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT))).to(device)
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0),
                               device)
    runs = {}
    for backend, bind in (("mxu_int8", True), ("approx_lut", True),
                          ("approx_delta", True), ("approx_delta", False)):
        pol = gemm.GemmPolicy(backend=backend, k=DELTA_K)
        p = model.bind_params(params, pol) if bind else params
        cache = model.init_cache(BATCH, PROMPT + 1, device=device)
        logits, cache = model.prefill(p, {"tokens": prompts}, cache,
                                      policy=pol)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        step, _ = model.decode_step(p, tok, cache, PROMPT, policy=pol)
        del p, cache
        if logits.shape != (BATCH, 1, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all() & torch.isfinite(step).all()):
            raise AssertionError(f"{backend}: full-width logits not finite "
                                 f"or of shape {tuple(logits.shape)}")
        runs[backend, bind] = (logits, step)
    for bind in (True, False):
        for a, b in zip(runs["approx_delta", bind], runs["approx_lut", True]):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"approx_delta ({'bound' if bind else 'unbound'}) "
                    f"full-width logits != approx_lut's: max |diff| "
                    f"{(a.float() - b.float()).abs().max().item()}")
    print("approx_delta full-width prefill and decode logits bit-equal to "
          "approx_lut's, bound and unbound", flush=True)
    del params, runs
    small = reduced(cfg)
    sm = get_model(small)
    cpu_params = sm.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab_size, (BATCH, PROMPT)))
    for backend in ("mxu_int8", "approx_lut", "approx_delta"):
        pol = gemm.GemmPolicy(backend=backend)
        out = {}
        for dev in ("cpu", device):
            p = sm.bind_params(_tree_to(cpu_params, dev), pol)
            out[str(dev)], _ = sm.prefill(p, {"tokens": toks.to(dev)},
                                          sm.init_cache(BATCH, PROMPT,
                                                        device=dev),
                                          policy=pol)
        d = (out["cpu"] - out[str(device)].cpu()).abs().max().item()
        if not d <= LOGIT_ATOL:
            raise AssertionError(f"{backend}: reduced-model logits on the "
                                 f"card differ from the CPU's by {d}")
        print(f"{backend}: reduced-model logits card vs CPU max |diff| {d}",
              flush=True)


def trace_decode():
    """Phase 5: device busy time and idle share of a decode step (and
    approx_delta unbound: the delta kernel's share of the step), over
    TRACE_DECODE_STEPS steps at the served batch and prompt."""
    for flags in (["--backend", "mxu_int8"], ["--backend", "approx_lut"],
                  ["--backend", "exact"], ["--backend", "approx_delta"],
                  ["--backend", "approx_delta", "--no-bind"]):
        trace_serve.main(["--arch", ARCH, "--gen-len",
                          str(TRACE_DECODE_STEPS + 1)] + flags)


def _time_ms(fn, flush):
    """Mean device ms of fn() by CUDA events, L2 flushed before every call.

    After the flush the device spins for about a millisecond, so the host
    has queued the start event, fn's launches and the end event before the
    device reaches them: the events time the device's work, not the host's
    launch latency (which a decode GEMM of a few microseconds would hide
    behind)."""
    fn()
    torch.cuda.synchronize()
    total, reps = 0.0, 0
    while reps < 3 or (reps < 30 and total < 200.0):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        reps += 1
    return total / reps


def _int_mm_ms(a, b, flush):
    """ms of one ``torch._int_mm`` computing a @ b, on ``a`` zero-padded to
    INT_MM_MIN_M rows where it has fewer; its first rows must equal the
    exact kernel's output."""
    m = a.shape[0]
    if m < INT_MM_MIN_M:
        a = torch.cat([a, a.new_zeros(INT_MM_MIN_M - m, a.shape[1])])
    got = torch._int_mm(a, b)[:m]
    if not torch.equal(got, systolic_gemm.systolic_matmul(a[:m], b)):
        raise AssertionError(f"torch._int_mm != systolic_gemm at "
                             f"{(m, *b.shape)}")
    return _time_ms(lambda: torch._int_mm(a, b), flush)


def time_kernels(cfg, device, sm_clock_hz):
    """Phase 6: per-shape times and bounds; totals over one served batch.
    Beside ``delta_gemm``, the bound path of the same product (the exact
    kernel plus the f32 correction against the weight-stationary factor,
    ``ops.prepared_matmul``) is timed as a comparison (``bound_path_ms``)."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device=device)
    sms = _build.sm_count(device)
    lookups_per_s = sms * SMEM_LOOKUPS_PER_CLOCK * sm_clock_hz
    table = approx_gemm.make_table(DELTA_K, device=device)
    fac = error_delta.delta_factors(8, DELTA_K)
    f_flat, g_flat = error_delta.factor_tables(fac, device)
    tot = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_s=0.0, ops_s=0.0,
                   library_ms=0.0 if n == "systolic_gemm" else None)
           for n in KERNELS if n != "paged_attention"}
    tot["delta_gemm"]["bound_path_ms"] = 0.0
    print("shape (M,K,N) calls | kernel ms | plain ms | bound ms (by) | "
          "torch._int_mm ms or delta bound path ms", flush=True)
    for (m, kd, n), calls in sorted(slice_gemms(cfg).items()):
        a, b = _int8((m, kd), 7, device), _int8((kd, n), 8, device)
        io = m * kd + kd * n + 4 * m * n
        prep = ops.prepare_operand(b, backend="approx_delta", k=DELTA_K,
                                   restrict=False)
        if not torch.equal(ops.prepared_matmul(a, prep),
                           delta_gemm.delta_matmul_fused(
                               a, b, f_flat, g_flat, rank=fac.rank)):
            raise AssertionError(f"bound delta path != delta_gemm at "
                                 f"{(m, kd, n)}")
        runs = {
            "systolic_gemm": (lambda: systolic_gemm.systolic_matmul(a, b),
                              lambda: systolic_matmul_ref(a, b),
                              io / HBM_BYTES_PER_S,
                              2 * m * n * kd / INT8_OPS_PER_S),
            "approx_gemm": (lambda: approx_gemm.approx_matmul_lut(a, b, table),
                            lambda: approx_matmul_ref(a, b, table.flat,
                                                      span=table.span),
                            (io + 2 * table.flat.numel()) / HBM_BYTES_PER_S,
                            m * n * kd / lookups_per_s),
            "delta_gemm": (lambda: delta_gemm.delta_matmul_fused(
                               a, b, f_flat, g_flat, rank=fac.rank),
                           lambda: delta_matmul_fused_ref(
                               a, b, f_flat, g_flat, rank=fac.rank,
                               bk=delta_gemm.KERNEL_BK),
                           (io + 2 * f_flat.numel() * 4) / HBM_BYTES_PER_S,
                           2 * m * n * kd * fac.rank / F32_FLOPS_PER_S
                           + 2 * m * n * kd / INT8_OPS_PER_S),
        }
        for name, (kern, plain, bytes_s, ops_s) in runs.items():
            k_ms, p_ms = _time_ms(kern, flush), _time_ms(plain, flush)
            bound = max(bytes_s, ops_s) * 1e3
            t = tot[name]
            lib = "n/a"
            if name == "systolic_gemm":
                lib_ms = _int_mm_ms(a, b, flush)
                t["library_ms"] += calls * lib_ms
                lib = f"{lib_ms:.4f}" + (f" (M padded to {INT_MM_MIN_M})"
                                         if m < INT_MM_MIN_M else "")
            if name == "delta_gemm":
                bp_ms = _time_ms(lambda: ops.prepared_matmul(a, prep), flush)
                t["bound_path_ms"] += calls * bp_ms
                lib = f"bound path {bp_ms:.4f}"
            print(f"{name} ({m},{kd},{n}) x{calls} | {k_ms:.4f} | {p_ms:.4f} "
                  f"| {bound:.4f} ({'bytes' if bytes_s >= ops_s else 'ops'})"
                  f" | {lib}", flush=True)
            t["ms"] += calls * k_ms
            t["plain_ms"] += calls * p_ms
            t["bound_ms"] += calls * bound
            t["bytes_s"] += calls * bytes_s
            t["ops_s"] += calls * ops_s
        del prep
    del flush
    d = tot["delta_gemm"]
    print(f"delta_gemm per served batch (k={DELTA_K}, rank {fac.rank}): "
          f"kernel {d['ms']:.4f} ms, plain {d['plain_ms']:.4f} ms, bound "
          f"{d['bound_ms']:.4f} ms ({'bytes' if d['bytes_s'] >= d['ops_s'] else 'f32 operations at 67 TFLOP/s'}); "
          f"approx_gemm kernel {tot['approx_gemm']['ms']:.4f} ms, bound path "
          f"(systolic_gemm + cuBLAS f32 correction) {d['bound_path_ms']:.4f} "
          f"ms", flush=True)
    return tot


def paged_inputs(seed, *, b, sq, width, kvl, kv_dtype, device, bs=8,
                 arch=ARCH):
    """One layer's attention of ``arch`` (smollm-360m: q (b, sq, 15, 64)
    bf16, pools (n_blocks + 1, 8, 5, 64)) with pools in ``kv_dtype`` (int8
    payloads at scale 32), a permuted table per row with the dump index
    past its live blocks, and query positions ending at each row's live
    length."""
    cfg = ARCHS[arch]
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * width + 7
    q = torch.randn((b, sq, h, d), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((n_blocks + 1, bs, kh, d), generator=g)
            for _ in range(2))
    if kv_dtype == torch.int8:
        k, v = (torch.clamp(torch.round(x * 32), -127, 127).to(torch.int8)
                for x in (k, v))
    perm = torch.randperm(n_blocks, generator=g)[:b * width].reshape(b, width)
    kvl_t = torch.tensor(kvl, dtype=torch.int32)
    tables = torch.where(torch.arange(width)[None, :] * bs < kvl_t[:, None],
                         perm, n_blocks).to(torch.int32)
    qpos = torch.clamp_min(kvl_t[:, None] - sq + torch.arange(sq)[None, :],
                           0).to(torch.int32)
    return [t.to(device) for t in (q, k.to(kv_dtype), v.to(kv_dtype), tables,
                                   kvl_t, qpos)]


def check_paged(device):
    """Phase 7: the paged-attention kernel against its plain version;
    returns max |err| over the live rows."""
    # (arch, Sq, table width, kv_valid_len per row, chunk, window,
    # softcap): the engine's tables (8 blocks, one chunk), then 32-block
    # tables in 64-wide chunks (4 chunks: rows past one chunk, 3 splits),
    # then the long-context rows (512 blocks of 8) at both served head dims,
    # then gemma3-12b's engine tables (D 256: decode and a prefill chunk)
    cases = [(ARCH, 1, 8, [0, 13, 40, 64], ATTN_CHUNK, 0, 0.0),
             (ARCH, 8, 8, [8, 0, 41, 64], ATTN_CHUNK, 0, 0.0),
             (ARCH, 1, 32, [70, 0, 200, 256], 64, 0, 0.0),
             (ARCH, 8, 32, [0, 77, 130, 256], 64, 0, 0.0),
             (ARCH, 8, 32, [9, 150, 0, 256], 64, 24, 0.0),
             (ARCH, 1, 32, [250, 0, 65, 8], 64, 0, 30.0),
             (ARCH, 1, LONG_PAGES, [LONG_LEN] * 4, ATTN_CHUNK, 0, 0.0),
             (GEMMA3, 1, LONG_PAGES, [LONG_LEN] * 4, ATTN_CHUNK, 0, 0.0),
             (ARCH, 1, LONG_PAGES, [LONG_LEN, 5, 0, 300], ATTN_CHUNK, 0,
              0.0),
             (GEMMA3, 1, 8, [0, 13, 40, 64], ATTN_CHUNK, 0, 0.0),
             (GEMMA3, 8, 8, [8, 0, 41, 64], ATTN_CHUNK, 0, 0.0)]
    worst, n = 0.0, 0
    for i, (arch, sq, width, kvl, chunk, window, softcap) in enumerate(cases):
        for kv_dtype in (torch.bfloat16, torch.int8):
            q, k, v, tables, kvl_t, qpos = paged_inputs(
                i, b=len(kvl), sq=sq, width=width, kvl=kvl,
                kv_dtype=kv_dtype, device=device, arch=arch)
            want = paged_attention_ref(q, k, v, tables, kvl_t, qpos,
                                       window=window, softcap=softcap,
                                       chunk=chunk).float()
            live = kvl_t > 0
            for n_splits in (1, 3):
                got = paged_attention.paged_attention(
                    q, k, v, tables, kvl_t, qpos, window=window,
                    softcap=softcap, chunk=chunk, n_splits=n_splits)
                torch.cuda.synchronize()
                err = (got.float() - want)[live].abs()
                ok = bool((err <= ATTN_RTOL * want[live].abs()
                           + ATTN_ATOL).all()) and not got[~live].any()
                worst = max(worst, float(err.max()))
                n += 1
                if not ok:
                    raise AssertionError(
                        f"paged_attention != plain at case {i} "
                        f"({kv_dtype}, n_splits={n_splits}): max |err| "
                        f"{float(err.max())}")
    print(f"paged_attention within {ATTN_RTOL} * |plain| + {ATTN_ATOL} of "
          f"its plain version in {n} checks (bf16/int8 pools, Sq 1/8, "
          f"window, softcap, n_splits 1/3, the engine's tables and "
          f"{LONG_LEN}-position rows at D 64 and 256): max |err| {worst}",
          flush=True)
    return worst


def engine_trace(vocab):
    """The served trace: 16 requests, 16 new tokens each, prompts of 16-48
    tokens, two arriving per step. The even ones start with one 16-token
    system prompt (request 4 is exactly it, so its whole prompt is cached
    and its recomputed last position copies a shared block on write)."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, SYSTEM_LEN)
    reqs = []
    for rid in range(N_REQUESTS):
        if rid % 2:
            prompt = rng.integers(0, vocab, int(rng.integers(16, 49)))
        else:
            tail = 0 if rid == 4 else int(rng.integers(1, 33))
            prompt = np.concatenate([system, rng.integers(0, vocab, tail)])
        reqs.append(engine.Request(rid=rid, prompt=prompt.astype(np.int32),
                                   max_new_tokens=GEN, arrival=rid // 2))
    return reqs


def _fresh(reqs):
    return [engine.Request(**{**r.__dict__, "preempt_count": 0})
            for r in reqs]


def _streams_vs_lockstep(what, cfg, model, params, policy, reqs, finished):
    """Each request's engine stream against the lockstep stream of its
    prompt alone: equal, or a flagged tie at the first differing token.
    Returns the number of flagged ties."""
    ties = 0
    for r in reqs:
        margins = []
        want = serve.lockstep_generate(
            cfg, model, params,
            torch.from_numpy(r.prompt[None].astype(np.int64)).to(
                params["embed"].device), r.max_new_tokens, policy=policy,
            margins=margins)[0]
        got = finished[r.rid].tokens
        if got.shape != want.shape or not ((got >= 0)
                                           & (got < cfg.vocab_size)).all():
            raise AssertionError(f"{what}: bad stream {got}")
        diff = np.nonzero(got != want)[0]
        if diff.size:
            margin = float(margins[int(diff[0])][0])
            if margin > LOGIT_ATOL:
                raise AssertionError(
                    f"{what}: rid {r.rid} differs from lockstep at token "
                    f"{int(diff[0])} with top-2 margin {margin}")
            ties += 1
            print(f"{what}: flagged tie, rid {r.rid} token {int(diff[0])} "
                  f"(lockstep top-2 margin {margin})", flush=True)
    return ties


def serve_engine_full_width(cfg, backend):
    """Phase 8 for one backend. Returns (launches, stats, recorded chunk-step
    inputs, idle share)."""
    args = serve.build_parser().parse_args(
        ["--arch", ARCH, "--backend", backend] + ENGINE_ARGS)
    cfg, model, params, policy, _ = serve.setup(args)
    reqs = engine_trace(cfg.vocab_size)
    for k in KERNELS.values():
        k["module"].launches = 0
    finished, eng = serve.run_engine(args, cfg, params, policy,
                                     requests=_fresh(reqs))
    launches = {name: k["module"].launches for name, k in KERNELS.items()}
    st = eng.stats
    steps = st["host_syncs"]                      # chunk steps (one sync each)
    print(f"{backend} engine stats: {json.dumps(st)}", flush=True)
    gemm_kernel = GEMM_KERNEL[True, backend]
    expect = {name: (cfg.n_layers if name == "paged_attention" else
                     (7 * cfg.n_layers + 1) if name == gemm_kernel else 0)
              * steps for name in KERNELS}
    if launches != expect:
        raise AssertionError(f"{backend} engine: launches {launches}, "
                             f"expected {expect} over {steps} chunk steps")
    if not (st["prefix_hits"] > 0 and st["prefix_cow_copies"] > 0
            and st["finished"] == N_REQUESTS):
        raise AssertionError(f"{backend} engine: no prefix hit or COW copy, "
                             f"or unfinished requests: {st}")
    ties = _streams_vs_lockstep(f"{backend} engine", cfg, model, params,
                                policy, reqs, finished)
    print(f"{backend} engine: {N_REQUESTS} streams equal to lockstep "
          f"({ties} flagged ties); launches {launches} over {steps} chunk "
          f"steps", flush=True)
    idle, recorded = engine_idle_share(args, cfg, params, policy, reqs)
    print(f"{backend} engine: device idle share {idle['idle_share']:.3f} "
          f"over chunk steps {TRACE_WINDOW} (busy {idle['busy_ms']:.3f} ms/"
          f"step, wall {idle['wall_ms']:.3f} ms/step, "
          f"{idle['events']:.0f} device events/step)", flush=True)
    return launches, st, recorded, idle


def engine_idle_share(args, cfg, params, policy, reqs):
    """The trace again, untraced: each chunk step's wall time (a step ends
    in its token sync) and its paged-attention inputs. Then again with the
    profiler on chunk steps TRACE_WINDOW: device busy against the untraced
    wall time of the same steps (scheduling is deterministic)."""
    recorded = []

    def run(traced):
        eng = serve.make_engine(args, cfg, params, policy)
        chunk = eng._chunk

        def record(p, tokens, cache, pos, q_len):
            if not traced:
                recorded.append((tokens.shape[1], pos.clone(), q_len.clone(),
                                 cache["block_tables"].clone()))
            return chunk(p, tokens, cache, pos, q_len)
        eng._chunk = record
        for r in _fresh(reqs):
            eng.submit(r)
        walls, prof = [], None
        while eng.queue or eng.active.any():
            n = eng.host_syncs
            if traced and n == TRACE_WINDOW[0] and prof is None:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
            if traced and n == TRACE_WINDOW[1]:
                torch.cuda.synchronize()
                prof.stop()
                return eng, prof
            t0 = time.perf_counter()
            eng.step()
            if eng.host_syncs > n:
                walls.append(time.perf_counter() - t0)
        return eng, walls

    eng, walls = run(traced=False)
    _, prof = run(traced=True)
    events = trace_serve._device_events(prof)
    n = TRACE_WINDOW[1] - TRACE_WINDOW[0]
    busy = sum(us for _, us in events.values()) / 1e3 / n
    wall = sum(walls[TRACE_WINDOW[0]:TRACE_WINDOW[1]]) * 1e3 / n
    return dict(busy_ms=busy, wall_ms=wall, idle_share=max(0.0, 1 - busy / wall),
                events=sum(c for c, _ in events.values()) / n,
                step_wall_ms=sum(walls) * 1e3 / len(walls)), (eng, recorded)


def _sdpa_inputs(q, k_pool, v_pool, tables, kvl, qpos):
    """SDPA's inputs for the same attention: K/V gathered through the tables
    into contiguous (B, KH, S, D) tensors and the boolean mask (valid and
    causal), built before timing."""
    b, sq, h, d = q.shape
    kh = k_pool.shape[2]
    k = cache_load(k_pool[tables.long()]).reshape(b, -1, kh, d)
    v = cache_load(v_pool[tables.long()]).reshape(b, -1, kh, d)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = ((kpos[None, None, :] < kvl[:, None, None])
            & (kpos[None, None, :] <= qpos[:, :, None]))[:, None]
    return (q.transpose(1, 2).contiguous(),
            k.transpose(1, 2).to(q.dtype).contiguous(),
            v.transpose(1, 2).to(q.dtype).contiguous(), mask)


def time_paged(cfg, device, recorded):
    """Phase 9: paged_attention at each recorded chunk step (layer 0's
    pools, the step's tables, live lengths and positions), its plain
    version and SDPA on pre-gathered K/V; totals per served batch (32
    layers per step) beside the bound: live KV + q + output bytes over the
    memory rate, or 4 * D flops per valid (query, key, head) over the bf16
    peak, whichever is larger."""
    eng, steps = recorded
    kp, vp = eng.cache["k"][0], eng.cache["v"][0]
    flush = torch.empty(256 << 20, dtype=torch.int8, device=device)
    h, d = cfg.n_heads, cfg.hd
    g = torch.Generator(device="cpu").manual_seed(3)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               bytes_s=0.0, ops_s=0.0)
    lib_err = 0.0
    for t, pos, q_len, tables in steps:
        b = pos.shape[0]
        q = torch.randn((b, t, h, d), generator=g).to(torch.bfloat16).to(
            device)
        kvl = (pos + q_len).to(torch.int32)
        qpos = (pos[:, None] + torch.arange(t, device=device)[None, :]).to(
            torch.int32)
        row, err = _time_paged_call((q, kp, vp, tables, kvl, qpos),
                                    (q_len > 0) & (kvl > 0), flush)
        lib_err = max(lib_err, err)
        for key in tot:
            tot[key] += cfg.n_layers * row[key]
    print(f"paged_attention per served batch ({len(steps)} chunk steps x "
          f"{cfg.n_layers} layers): kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.4f} ms, SDPA on pre-gathered K/V "
          f"{tot['library_ms']:.4f} ms (max |SDPA - kernel| {lib_err}), "
          f"bound {tot['bound_ms']:.4f} ms", flush=True)
    del eng, steps, kp, vp
    args = paged_inputs(5, b=4, sq=1, width=LONG_PAGES, kvl=[LONG_LEN] * 4,
                        kv_dtype=torch.bfloat16, device=device,
                        arch=cfg.name)
    row, err = _time_paged_call(args, args[4] > 0, flush)
    del flush, args
    print(f"paged_attention long-context decode row ({cfg.name}: batch 4, "
          f"Sq 1, {LONG_LEN} live positions a row, {cfg.n_kv_heads} KV heads"
          f" at D {d}, {row['kv_bytes'] / 1e6:.1f} MB of bf16 K/V): kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA on "
          f"pre-gathered K/V {row['library_ms']:.4f} ms (max |SDPA - kernel| "
          f"{err}), bound {row['bound_ms']:.4f} ms (bytes), "
          f"{row['kv_bytes'] / row['ms'] / 1e9:.3f} TB/s of K/V",
          flush=True)
    return tot


def _time_paged_call(args, live, flush):
    """One paged-attention call (q, pools, tables, kv_valid_len, positions)
    timed: the kernel, its plain version and SDPA on K/V gathered before
    timing, with the bound (live KV + q + output + table bytes over the
    memory rate, or 4 * D flops per valid (query, key, head) over the bf16
    peak); and max |SDPA - kernel| over the ``live`` rows."""
    q, kp, vp, tables, kvl, qpos = args
    kern = lambda: paged_attention.paged_attention(  # noqa: E731
        *args, chunk=ATTN_CHUNK)
    plain = lambda: paged_attention_ref(*args, chunk=ATTN_CHUNK)  # noqa: E731
    sq_, sk, sv, mask = _sdpa_inputs(*args)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        sq_, sk, sv, attn_mask=mask, enable_gqa=True)
    err = 0.0
    if live.any():
        diff = (lib().transpose(1, 2).float() - kern().float())[live]
        err = float(diff.abs().max())
    h, d = q.shape[2], q.shape[3]
    kv_pos = int(torch.clamp(kvl, max=tables.shape[1] * kp.shape[1]).sum())
    kv_bytes = 2 * kv_pos * kp.shape[2] * d * kp.element_size()
    io = kv_bytes + 2 * q.numel() * q.element_size() + tables.numel() * 4
    pairs = torch.clamp(torch.minimum(qpos + 1, kvl[:, None]), min=0)
    ops = 4 * d * h * int(pairs.sum())
    row = dict(ms=_time_ms(kern, flush), plain_ms=_time_ms(plain, flush),
               library_ms=_time_ms(lib, flush),
               bytes_s=io / HBM_BYTES_PER_S, ops_s=ops / BF16_FLOPS_PER_S)
    row["bound_ms"] = max(row["bytes_s"], row["ops_s"]) * 1e3
    return dict(row, kv_bytes=kv_bytes), err


def check_delta(cfg, device):
    """Phase 10: delta_gemm against its plain version (the kernel's K-block)
    and the product-table kernel, bit for bit at the exact rank; the
    truncated-rank routes. Returns max |err| of the exact-rank checks."""
    shapes = sorted({(m, kd, n) for (_, kd, n) in slice_gemms(cfg)
                     for m in (BATCH, BATCH * PROMPT)}) + ODD
    worst, differing, n_checks = 0, 0, 0
    for i, (m, kd, n) in enumerate(shapes):
        a, b = _int8((m, kd), 2 * i, device), _int8((kd, n), 2 * i + 1, device)
        for k in KS:
            fac = error_delta.delta_factors(8, k)
            f, g = error_delta.factor_tables(fac, device)
            got = delta_gemm.delta_matmul_fused(a, b, f, g, rank=fac.rank)
            torch.cuda.synchronize()
            want = delta_matmul_fused_ref(a, b, f, g, rank=fac.rank,
                                          bk=delta_gemm.KERNEL_BK)
            table = approx_gemm.make_table(k, device=device)
            lut = approx_gemm.approx_matmul_lut(a, b, table)
            e = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            worst = max(worst, e)
            n_checks += 1
            if e or not torch.equal(got, lut):
                raise AssertionError(f"delta_gemm != plain or approx_gemm at "
                                     f"{(m, kd, n)}, k={k} (rank {fac.rank})")
        n_blocks = -(-kd // delta_gemm.KERNEL_BK)
        for k, rank in DELTA_TRUNCATED:
            table = approx_gemm.make_table(k, device=device)
            # exact_cancel: the kernel at rank 0, correction + defect once
            if not torch.equal(ops.approx_delta_matmul(a, b, k=k, rank=rank),
                               approx_gemm.approx_matmul_lut(a, b, table)):
                raise AssertionError(f"exact_cancel route != approx_gemm at "
                                     f"{(m, kd, n)}, k={k}, rank {rank}")
            fac = error_delta.delta_factors(8, k, rank=rank)
            f, g = error_delta.factor_tables(fac, device)
            got = ops.approx_delta_matmul(a, b, k=k, rank=rank,
                                          apply_residual=False)
            want = delta_matmul_fused_ref(a, b, f, g, rank=rank,
                                          bk=delta_gemm.KERNEL_BK)
            d = (got.to(torch.int64) - want.to(torch.int64)).abs()
            differing += int((d > 0).sum())
            if int(d.max()) > n_blocks:
                raise AssertionError(f"truncated delta_gemm off its plain "
                                     f"version by {int(d.max())} > {n_blocks} "
                                     f"K-blocks at {(m, kd, n)}, k={k}")
    print(f"delta_gemm bit-exact vs its plain version and approx_gemm in "
          f"{n_checks} checks ({len(shapes)} shapes, k={list(KS)}); "
          f"exact_cancel route bit-exact at (k, rank) {list(DELTA_TRUNCATED)};"
          f" without residual {differing} entries differ from the plain "
          f"version (each within one per K-block)", flush=True)
    return worst


def check_apps(device):
    """Phase 10: the paper's apps at 256 px. DCT and edge outputs
    bit-identical under approx_lut and approx_delta, PSNR at or above the
    Table-VI floors less TOL_DB; DCT under approx_oracle (the paper's PE
    chain) and BDCN at k = 2 with its hybrid policy reported."""
    img = images.test_image(APP_SIZE, 0)
    blocks = images.to_blocks(img)
    out = {}
    for backend in ("approx_lut", "approx_delta"):
        coeffs = {k: dct.forward_dct_blocks(blocks, k, policy=backend,
                                            device=device)
                  for k in (0, *PAPER_DCT_PSNR)}
        resp = {k: edge.conv_gemm(img, edge.LAPLACIAN, k, policy=backend,
                                  device=device)
                for k in (0, *PAPER_EDGE_PSNR)}
        out[backend] = coeffs, resp
        res = dct.run(size=APP_SIZE, ks=tuple(PAPER_DCT_PSNR),
                      policy=backend, device=device)
        eres = edge.run(size=APP_SIZE, ks=tuple(PAPER_EDGE_PSNR),
                        policy=backend, device=device)
        for k, floor in PAPER_DCT_PSNR.items():
            if not res[k]["psnr"] >= floor - TOL_DB:
                raise AssertionError(f"DCT {backend} k={k}: PSNR "
                                     f"{res[k]['psnr']} < {floor} - {TOL_DB}")
        for k, floor in PAPER_EDGE_PSNR.items():
            if not eres[k]["psnr"] >= floor - TOL_DB:
                raise AssertionError(f"edge {backend} k={k}: PSNR "
                                     f"{eres[k]['psnr']} < {floor} - {TOL_DB}")
        print(f"{backend} at {APP_SIZE} px: DCT PSNR/SSIM "
              + ", ".join(f"k{k} {v['psnr']:.2f} dB/{v['ssim']:.4f}"
                          for k, v in res.items())
              + "; edge " + ", ".join(f"k{k} {v['psnr']:.2f} dB/"
                                      f"{v['ssim']:.4f}"
                                      for k, v in eres.items()), flush=True)
    for part, name in ((0, "DCT coefficients"), (1, "edge responses")):
        for k, v in out["approx_lut"][part].items():
            if not np.array_equal(v, out["approx_delta"][part][k]):
                raise AssertionError(f"{name} differ between approx_lut and "
                                     f"approx_delta at k={k}")
    # The card's app outputs equal the CPU plain versions' bit for bit: the
    # PE chain (torch word ops) and both kernel backends on the same image.
    cpu = torch.device("cpu")
    card = {"approx_oracle": dct.forward_dct_blocks(
        blocks, 4, policy="approx_oracle", device=device)}
    card.update({b: out[b][0][4] for b in ("approx_lut", "approx_delta")})
    for backend, v in card.items():
        ref = dct.forward_dct_blocks(blocks, 4, policy=backend, device=cpu)
        if not np.array_equal(v, ref):
            raise AssertionError(f"DCT {backend} k=4: card and CPU differ in "
                                 f"{int((v != ref).sum())} of {v.size}")
    for backend in ("approx_lut", "approx_delta"):
        ref = edge.conv_gemm(img, edge.LAPLACIAN, 2, policy=backend,
                             device=cpu)
        if not np.array_equal(out[backend][1][2], ref):
            raise AssertionError(f"edge {backend} k=2: card and CPU differ")
    print(f"{APP_SIZE} px DCT at k=4 ({', '.join(card)}) and edge at k=2 "
          f"(approx_lut, approx_delta): card == CPU bit for bit", flush=True)
    res = dct.run(size=APP_SIZE, ks=tuple(PAPER_DCT_PSNR), device=device)
    print(f"DCT under approx_oracle (the PE chain) at {APP_SIZE} px: "
          + ", ".join(f"k{k} {v['psnr']:.2f} dB/{v['ssim']:.4f}"
                      for k, v in res.items()), flush=True)
    for backend in ("approx_lut", "approx_delta"):
        res = bdcn.run(size=APP_SIZE, ks=(2,), policy=backend, device=device)
        if np.isnan(res[2]["psnr"]) or not 0.0 <= res[2]["ssim"] <= 1.0:
            raise AssertionError(f"BDCN {backend}: PSNR/SSIM {res[2]}")
        print(f"BDCN hybrid ({backend} blocks 0-1, exact 2-3) at {APP_SIZE} "
              f"px, k=2: PSNR {res[2]['psnr']:.2f} dB, SSIM "
              f"{res[2]['ssim']:.4f}", flush=True)


# Flash attention at the served shapes: (name, B, H, KH, Sq, Skv, D, causal,
# window, softcap, kv_valid_len). smollm-360m's lockstep prefill; gemma3-12b's
# 2048-token prefill on a local (window 1024) and a global layer;
# gemma2-27b's attention (softcap 50, window 4096) at 4608 tokens; ragged
# per-batch live lengths, causal and not.
FLASH_SHAPES = [
    ("smollm-360m prefill", BATCH, 15, 5, PROMPT, PROMPT, 64, True, 0, 0.0,
     None),
    ("gemma3-12b local", 1, 16, 8, 2048, 2048, 256, True, 1024, 0.0, None),
    ("gemma3-12b global", 1, 16, 8, 2048, 2048, 256, True, 0, 0.0, None),
    ("gemma2-27b local", 1, 32, 16, 4608, 4608, 128, True, 4096, 50.0, None),
    ("ragged causal", 3, 15, 5, 96, 128, 64, True, 0, 0.0, [40, 97, 128]),
    ("ragged non-causal", 3, 16, 8, 300, 512, 256, False, 0, 0.0,
     [100, 400, 512]),
]


def _flash_inputs(seed, b, h, kh, sq, skv, d, kvl, device):
    """bf16 q/k/v as the model's route hands them over: (B, H, S, D)
    transposed views of (B, S, H, D) tensors; kv_valid_len on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=device).to(
        torch.bfloat16).transpose(1, 2) for s, n in ((sq, h), (skv, kh),
                                                    (skv, kh)))
    if isinstance(kvl, list):
        kvl = torch.tensor(kvl, dtype=torch.int32, device=device)
    return q, k, v, kvl


def check_flash(device):
    """The flash-attention kernel against its plain version at
    FLASH_SHAPES; returns max |err|."""
    worst = 0.0
    for i, (name, b, h, kh, sq, skv, d, causal, window, softcap,
            kvl) in enumerate(FLASH_SHAPES):
        q, k, v, kvl = _flash_inputs(i, b, h, kh, sq, skv, d, kvl, device)
        kw = dict(kv_valid_len=kvl, causal=causal, window=window,
                  softcap=softcap)
        got = flash_attention.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, **kw).float()
        err = (got.float() - want).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= ATTN_RTOL * want.abs() + ATTN_ATOL).all()):
            raise AssertionError(f"flash_attention != plain at {name}: max "
                                 f"|err| {float(err.max())}")
        print(f"flash_attention at {name} (B {b}, H {h}/{kh}, Sq {sq}, Skv "
              f"{skv}, D {d}): max |err| {float(err.max())}", flush=True)
    print(f"flash_attention within {ATTN_RTOL} * |plain| + {ATTN_ATOL} of its "
          f"plain version at {len(FLASH_SHAPES)} shapes: max |err| {worst}",
          flush=True)
    return worst


def _live_pairs(b, sq, skv, causal, window, kvl):
    """(query, key) pairs the masks leave live, summed over the batch."""
    kvl = [skv] * b if kvl is None else (
        kvl if isinstance(kvl, list) else [kvl] * b)
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    total = 0
    for n in kvl:
        live = (kpos < min(n, skv)).expand(sq, skv)
        if causal:
            live = live & (qpos >= kpos)
            if window > 0:
                live = live & (qpos - kpos < window)
        total += int(live.sum())
    return total


def _sdpa(q, k, v, *, kv_valid_len, causal, window, softcap):
    """A call of ``torch.nn.functional.scaled_dot_product_attention`` that
    computes the same attention, or None with a softcap (SDPA has none): the
    causal flag alone where no key is masked otherwise, else a boolean mask
    built here, before timing."""
    if softcap:
        return None
    sq, skv = q.shape[2], k.shape[2]
    F = torch.nn.functional
    if kv_valid_len is None and window == 0 and causal and sq == skv:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    n = skv if kv_valid_len is None else kv_valid_len
    n = torch.as_tensor(n, device=q.device).reshape(-1, 1, 1, 1)
    mask = kpos[None, None] < n
    if causal:
        mask = mask & (qpos >= kpos)[None, None]
        if window > 0:
            mask = mask & (qpos - kpos < window)[None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def time_flash(device):
    """Flash-attention kernel, plain version and SDPA (where one call
    computes the same attention) at FLASH_SHAPES, with the bound: the
    operations or q, k, v and the output read or written once at the memory
    rate, whichever take longer. Each live (query, key) pair and head costs
    4 D flops (2 D of q k^T, 2 D of p v), all of which a tensor-core kernel
    can run at the bf16 peak (the kernel's split of p into two bf16 halves
    makes it 6 D; the bound counts the function's 4 D). Beside it the
    former f32-priced bound, which put p v at the f32 peak outside the
    tensor cores (q k^T at the bf16 peak, the longer of the two), is
    printed once. Returns per-shape rows and the totals of gemma3-12b's
    2048-token prefill (40 local + 8 global layers)."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device=device)
    rows = {}
    for i, (name, b, h, kh, sq, skv, d, causal, window, softcap,
            kvl) in enumerate(FLASH_SHAPES):
        q, k, v, kvl_t = _flash_inputs(i, b, h, kh, sq, skv, d, kvl, device)
        kw = dict(kv_valid_len=kvl_t, causal=causal, window=window,
                  softcap=softcap)
        kern = lambda: flash_attention.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: flash_attention_ref(q, k, v, **kw)  # noqa: E731
        lib = _sdpa(q, k, v, **kw)
        half = 2 * d * h * _live_pairs(b, sq, skv, causal, window, kvl)
        flops = 2 * half
        io = 2 * (2 * b * h * sq * d + 2 * b * kh * skv * d)
        row = dict(ms=_time_ms(kern, flush), plain_ms=_time_ms(plain, flush),
                   library_ms=None, ops_s=flops / BF16_FLOPS_PER_S,
                   bytes_s=io / HBM_BYTES_PER_S)
        row["bound_ms"] = max(row["ops_s"], row["bytes_s"]) * 1e3
        row["f32_bound_ms"] = max(half / BF16_FLOPS_PER_S,
                                  half / F32_FLOPS_PER_S, row["bytes_s"]) * 1e3
        lib_err = None
        if lib is not None:
            row["library_ms"] = _time_ms(lib, flush)
            lib_err = float((lib().float() - kern().float()).abs().max())
        rows[name] = row
        sdpa = ("n/a (softcap)" if lib is None
                else f"{row['library_ms']:.4f} ms")
        print(f"flash_attention {name}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, SDPA {sdpa}"
              f" (max |SDPA - kernel| {lib_err}), bound "
              f"{row['bound_ms']:.4f} ms ({'bytes' if row['bytes_s'] >= row['ops_s'] else 'operations: 4 D flops per live pair at the bf16 tensor-core peak'}; "
              f"{flops / 1e9:.2f} GFLOP live), "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    del flush
    cfg = ARCHS[GEMMA3]
    n_global = sum(1 for w in layer_windows(cfg) if w == 0)
    per = {"gemma3-12b local": cfg.n_layers - n_global,
           "gemma3-12b global": n_global}
    tot = {key: sum(n * rows[name][key] for name, n in per.items())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "ops_s",
                       "bytes_s", "f32_bound_ms")}
    print(f"flash_attention per gemma3-12b {GEMMA3_WINDOW_PROMPT}-token "
          f"prefill ({per}): kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.4f} ms, SDPA {tot['library_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms (operations: 4 D flops per live pair at "
          f"the bf16 tensor-core peak; the former f32-priced bound, p v at "
          f"the f32 peak: {tot['f32_bound_ms']:.4f} ms)", flush=True)
    return tot


def _logit_tol(top):
    """LOGIT_ULPS bf16 ulps at magnitude ``top`` (the largest |logit|):
    LOGIT_ATOL's bound carried to logits of any size; LOGIT_ATOL itself
    below 8."""
    return max(LOGIT_ATOL, LOGIT_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7))


def check_window_layer(qkv, kw, out):
    """The window mask on served data: the first local layer's attention
    output, as the kernel gave it in gemma3-12b's window prefill, against
    the plain version on the same q, k and v, within ``ATTN_RTOL`` plus
    ``ATTN_ATOL`` at the queries whose window leaves keys out (positions
    ``window`` on); and the plain version without the mask (the control)
    outside that tolerance there."""
    w = kw["window"]
    want = flash_attention_ref(*qkv, **kw).float()[:, :, w:]
    tol = ATTN_RTOL * want.abs() + ATTN_ATOL
    err = (out.float()[:, :, w:] - want).abs()
    ctrl = (flash_attention_ref(*qkv, **{**kw, "window": 0}).float()[:, :, w:]
            - want).abs()
    beyond = float((ctrl > tol).float().mean())
    if not bool((err <= tol).all()):
        raise AssertionError(f"{GEMMA3} first local layer past its window: "
                             f"kernel != plain, max |err| {float(err.max())}")
    if not beyond > 0:
        raise AssertionError(f"{GEMMA3} first local layer: the plain version "
                             f"without the window is within tolerance too")
    print(f"{GEMMA3} first local layer (window {w}), queries {w}-"
          f"{qkv[0].shape[2] - 1}: kernel vs plain max |err| "
          f"{float(err.max())} within {ATTN_RTOL} * |plain| + {ATTN_ATOL}; "
          f"without the window mask max |diff| {float(ctrl.max())}, "
          f"{beyond:.4f} of the outputs outside that tolerance", flush=True)


def serve_gemma3(device):
    """gemma3-12b at full width, bound under ``mxu_int8``: lockstep through
    ``serve.main`` (CLI defaults: batch 4, prompt 16, gen 16) with the flash
    kernel at every prefill layer; the engine on the 16-request trace with
    ``paged_attention`` at head dim 256; every engine stream against the
    lockstep stream of its prompt; then the 2048-token prefill over a
    ``windowed=False`` cache (past the 1024-token window) against the same
    prefill with the route's flash entry replaced by its plain version,
    with the controls of ``check_window_layer`` and the unwindowed plain
    version. Returns the launches of the counted runs."""
    cfg = ARCHS[GEMMA3]
    argv = ["--arch", GEMMA3, "--backend", "mxu_int8"]
    t0 = time.perf_counter()
    out, launches = _counted(lambda: serve.main(argv))
    _check_launches(f"{GEMMA3} lockstep", launches,
                    {"systolic_gemm": GEN * (7 * cfg.n_layers + 1),
                     "flash_attention": cfg.n_layers})
    if out.shape != (BATCH, GEN) or not ((out >= 0)
                                         & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{GEMMA3}: bad lockstep stream {out}")
    print(f"{GEMMA3} lockstep (serve.main, set-up included) "
          f"{time.perf_counter() - t0:.1f}s; launches {launches}", flush=True)
    args = serve.build_parser().parse_args(argv + ENGINE_ARGS)
    cfg, model, params, policy, _ = serve.setup(args)
    reqs = engine_trace(cfg.vocab_size)
    (finished, eng), e_launches = _counted(lambda: serve.run_engine(
        args, cfg, params, policy, requests=_fresh(reqs)))
    steps = eng.stats["host_syncs"]
    _check_launches(f"{GEMMA3} engine", e_launches,
                    {"paged_attention": cfg.n_layers * steps,
                     "systolic_gemm": (7 * cfg.n_layers + 1) * steps})
    if eng.stats["finished"] != N_REQUESTS:
        raise AssertionError(f"{GEMMA3} engine: {eng.stats}")
    ties = _streams_vs_lockstep(f"{GEMMA3} engine", cfg, model, params,
                                policy, reqs, finished)
    print(f"{GEMMA3} engine: {N_REQUESTS} streams equal to lockstep ({ties} "
          f"flagged ties); launches {e_launches} over {steps} chunk steps",
          flush=True)
    for name, n in e_launches.items():
        launches[name] += n
    idle, recorded = engine_idle_share(args, cfg, params, policy, reqs)
    print(f"{GEMMA3} engine: device idle share {idle['idle_share']:.3f} over "
          f"chunk steps {TRACE_WINDOW} (busy {idle['busy_ms']:.3f} ms/step, "
          f"wall {idle['wall_ms']:.3f} ms/step, {idle['events']:.0f} device "
          f"events/step)", flush=True)
    time_paged(cfg, device, recorded)      # paged_attention at head dim 256
    del recorded
    # the window on the path: a 2048-token prompt over the uniform cache
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, GEMMA3_WINDOW_PROMPT))).to(device)
    def plain_reordered(*a, **kw):      # the plain version, 256-key chunks
        return flash_attention_ref(*a, **{**kw, "bk": WINDOW_REORDER_BK})

    def plain_unwindowed(*a, **kw):     # the control: no window mask at all
        return flash_attention_ref(*a, **{**kw, "window": 0})

    local = {}

    def kernel_kept(q, k, v, **kw):     # the kernel; keeps the first local call
        out = flash_attention.flash_attention(q, k, v, **kw)
        if kw["window"] > 0 and not local:
            local.update(qkv=(q.clone(), k.clone(), v.clone()), kw=kw,
                         out=out.clone())
        return out

    logits = {}
    for name, entry in (("kernel", kernel_kept),
                        ("plain", flash_attention_ref),
                        ("reordered plain", plain_reordered),
                        ("unwindowed plain", plain_unwindowed)):
        real, layers.flash_attention = layers.flash_attention, entry
        try:
            cache = model.init_cache(1, GEMMA3_WINDOW_PROMPT, device=device,
                                     windowed=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (out, _), n_launch = _counted(lambda: model.prefill(
                params, {"tokens": tokens}, cache, policy=policy))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        finally:
            layers.flash_attention = real
        logits[name] = out[0, -1]
        del cache
        print(f"{GEMMA3} {GEMMA3_WINDOW_PROMPT}-token prefill, attention by "
              f"the {name} version: {wall:.1f} ms wall; launches {n_launch}",
              flush=True)
        if name == "kernel":
            _check_launches(f"{GEMMA3} window prefill", n_launch,
                            {"systolic_gemm": 7 * cfg.n_layers + 1,
                             "flash_attention": cfg.n_layers})
            for k, n in n_launch.items():
                launches[k] += n
    check_window_layer(**local)
    a, b = logits["kernel"], logits["plain"]
    diff = float((a - b).abs().max())
    spread = float((logits["reordered plain"] - b).abs().max())
    control = float((logits["unwindowed plain"] - b).abs().max())
    top = float(b.abs().max())
    tol = max(_logit_tol(top), 2 * spread)
    if not control > tol:
        raise AssertionError(f"{GEMMA3} window prefill: without the window "
                             f"mask the logits move only {control} <= {tol}:"
                             f" the logit gate cannot see the mask")
    top2 = torch.topk(b, 2).values
    margin = float(top2[0] - top2[1])
    tie = int(a.argmax()) != int(b.argmax())
    what = (f"max |logit| {top}, {LOGIT_ULPS} bf16 ulps there "
            f"{_logit_tol(top)}; the plain version's own drift under "
            f"{WINDOW_REORDER_BK}-key chunks {spread}")
    if not (torch.isfinite(a).all() and diff <= tol) or (tie and margin > tol):
        raise AssertionError(f"{GEMMA3} window prefill: kernel logits off the "
                             f"plain attention's by {diff} > {tol} ({what}; "
                             f"argmax {int(a.argmax())} vs {int(b.argmax())},"
                             f" plain top-2 margin {margin})")
    print(f"{GEMMA3} window prefill: last-position logits kernel vs plain "
          f"attention max |diff| {diff} <= {tol} ({what}); argmax "
          f"{'a flagged tie' if tie else 'equal'} (plain top-2 margin "
          f"{margin}); without the window mask the plain version's logits "
          f"move {control} > {tol}", flush=True)
    del params, eng, model
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {list(KERNELS)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    flash_build_report()
    paged_build_report()
    name_power = _smi("name,power.limit")
    sm_clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"device: {torch.cuda.get_device_name(0)}; max SM clock "
          f"{sm_clock_hz / 1e6:.0f} MHz", flush=True)
    cfg = ARCHS[ARCH]

    def phase(name):
        print(f"[{time.perf_counter() - t0:.1f}s] {name}", flush=True)

    err = check_kernels(cfg, device)
    err["paged_attention"] = check_paged(device)
    phase("delta kernel checks")
    err["delta_gemm"] = check_delta(cfg, device)
    phase("flash kernel checks")
    err["flash_attention"] = check_flash(device)
    launches = {name: 0 for name in KERNELS}
    streams = {}
    phase("lockstep serving")
    for backend in ("mxu_int8", "approx_lut", "approx_delta"):
        n_launch, streams[backend] = serve_full_width(cfg, backend)
        for name, n in n_launch.items():
            launches[name] += n
    if not np.array_equal(streams["approx_delta"], streams["approx_lut"]):
        raise AssertionError("approx_delta streams != approx_lut streams")
    print("approx_delta lockstep streams == approx_lut's, bound and unbound",
          flush=True)
    recorded = None
    for backend in ("mxu_int8", "approx_lut", "approx_delta"):
        phase(f"engine {backend}")
        n_launch, st, rec, idle = serve_engine_full_width(cfg, backend)
        for name, n in n_launch.items():
            launches[name] += n
        recorded = recorded or rec
    phase("outputs")
    check_outputs(cfg, device)
    phase("apps")
    check_apps(device)
    phase("decode traces")
    trace_decode()
    phase("GEMM timings")
    tot = time_kernels(cfg, device, sm_clock_hz)
    phase("paged-attention timings")
    tot["paged_attention"] = time_paged(cfg, device, recorded)
    del recorded
    phase("flash-attention timings")
    tot["flash_attention"] = time_flash(device)
    phase(f"{GEMMA3} lockstep, engine and window prefill")
    for name, n in serve_gemma3(device).items():
        launches[name] += n

    entries = []
    for name, k in KERNELS.items():
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        t = tot[name]
        entries.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": float(err[name]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_s"] >= t["ops_s"] else "operations",
            "library_ms": t["library_ms"]})
    print(f"flash_attention: all {launches['flash_attention']} launches of "
          f"the counted runs ran the tensor-core kernel", flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(name_power)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
