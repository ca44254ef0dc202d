#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the card's name and power limit.
2. Hold each kernel bit-exact against its plain PyTorch version on the card,
   at every GEMM shape of the served model (smollm-360m: K x N in
   {960x960, 960x320, 960x2560, 2560x960, 960x49152}, M in {4, 64}) and at
   odd shapes; the approximate kernel at k in {0, 2, 4, 6, 8}.
3. Serve smollm-360m at full width through the user's entry point
   ``repro_torch.launch.serve.main`` (CLI defaults: batch 4, prompt 16,
   gen 16, bound) under ``mxu_int8`` and ``approx_lut``: one warm-up run,
   then the run with the launch counters set to 0 just before and read just
   after: each backend's kernel must run once per model GEMM,
   n_forwards * (7 * n_layers + 1) times. Then an unbound run must give the
   same streams bit for bit.
4. Check outputs: tokens in range; full-width logits finite; on a small
   (reduced) model the card's logits agree with the CPU's plain versions.
5. Trace the decode step of the same configuration with
   ``repro_torch.launch.trace_serve`` (host wall ms against device busy ms)
   under ``mxu_int8``, ``approx_lut`` and ``exact``.
6. Time each kernel, its plain version and (for the exact GEMM) the PyTorch
   call ``torch._int_mm`` with CUDA events at the main path's shapes, beside
   the card's bound for the same work.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Per-kernel times in it are
totals over the main path's launches of one served batch (each shape's time
times its number of calls). ``torch._int_mm`` refuses M <= 16, so at the
decode GEMMs (M = 4) it multiplies the moving operand zero-padded to 32 rows
(padded outside the timed call) and its first M rows, held equal to the
kernel's output, are the product. No PyTorch call computes the table GEMM:
its ``library_ms`` is null.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import gemm  # noqa: E402
from repro_torch.kernels import _build, approx_gemm, systolic_gemm  # noqa: E402
from repro_torch.kernels.ref import (approx_matmul_ref,  # noqa: E402
                                     systolic_matmul_ref)
from repro_torch.launch import serve, trace_serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

ARCH = "smollm-360m"
BATCH, PROMPT, GEN = 4, 16, 16          # serve.main's CLI defaults
INT_MM_MIN_M = 32    # torch._int_mm needs M > 16; smaller M is zero-padded
KS = (0, 2, 4, 6, 8)
ODD = [(1, 1, 1), (3, 37, 130), (17, 131, 67), (65, 259, 333)]
HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12                # dense int8 tensor-core peak
SMEM_LOOKUPS_PER_CLOCK = 32             # shared-memory accesses per SM per clock
SPIN_CYCLES = 2_000_000                 # ~1 ms at the H100's SM clock
LOGIT_ATOL = 0.125   # 4 bf16 ulps at |logit| < 8: float ops round differently
KERNELS = {
    "systolic_gemm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/systolic_gemm.cu",
        replaces="src/repro/kernels/systolic_gemm.py:80", backend="mxu_int8",
        module=systolic_gemm),
    "approx_gemm": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/approx_gemm.cu",
        replaces="src/repro/kernels/approx_gemm.py:93", backend="approx_lut",
        module=approx_gemm),
}


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


def serve_full_width(cfg, backend):
    """Phase 3 for one backend: the bound main-path run with its launch
    counts, then an unbound run that must match bit for bit."""
    argv = ["--arch", ARCH, "--backend", backend]
    serve.main(argv)             # warm-up: first-call set-up stays out
    for k in KERNELS.values():
        k["module"].launches = 0
    bound = serve.main(argv)
    launches = {name: k["module"].launches for name, k in KERNELS.items()}
    want = GEN * (7 * cfg.n_layers + 1)
    for name, k in KERNELS.items():
        expect = want if k["backend"] == backend else 0
        if launches[name] != expect:
            raise AssertionError(f"{backend}: {name} launched "
                                 f"{launches[name]} times, expected {expect}")
    if bound.shape != (BATCH, GEN) or not ((bound >= 0)
                                           & (bound < cfg.vocab_size)).all():
        raise AssertionError(f"{backend}: bad token stream {bound}")
    unbound = serve.main(argv + ["--no-bind"])
    if not np.array_equal(bound, unbound):
        raise AssertionError(f"{backend}: bound != unbound streams\n{bound}\n"
                             f"{unbound}")
    print(f"{backend}: {launches} launches in the bound run; bound == unbound",
          flush=True)
    return launches


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def check_outputs(cfg, device):
    """Phase 4: finite full-width logits; reduced model card == CPU logits."""
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT))).to(device)
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0),
                               device)
    for backend in ("mxu_int8", "approx_lut"):
        pol = gemm.GemmPolicy(backend=backend)
        logits, _ = model.prefill(model.bind_params(params, pol),
                                  {"tokens": prompts},
                                  model.init_cache(BATCH, PROMPT,
                                                   device=device), policy=pol)
        if logits.shape != (BATCH, 1, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{backend}: full-width logits not finite "
                                 f"or of shape {tuple(logits.shape)}")
    del params
    small = reduced(cfg)
    sm = get_model(small)
    cpu_params = sm.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, small.vocab_size, (BATCH, PROMPT)))
    for backend in ("mxu_int8", "approx_lut"):
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
    """Phase 5: device busy time and idle share of a decode step."""
    for backend in ("mxu_int8", "approx_lut", "exact"):
        trace_serve.main(["--arch", ARCH, "--backend", backend])


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
    """Phase 5: per-shape times and bounds; totals over one served batch."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device=device)
    sms = _build.sm_count(device)
    lookups_per_s = sms * SMEM_LOOKUPS_PER_CLOCK * sm_clock_hz
    table = approx_gemm.make_table(4, device=device)      # the CLI's --k 4
    tot = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_s=0.0, ops_s=0.0,
                   library_ms=0.0 if n == "systolic_gemm" else None)
           for n in KERNELS}
    print("shape (M,K,N) calls | kernel ms | plain ms | bound ms (by) | "
          "torch._int_mm ms", flush=True)
    for (m, kd, n), calls in sorted(slice_gemms(cfg).items()):
        a, b = _int8((m, kd), 7, device), _int8((kd, n), 8, device)
        io = m * kd + kd * n + 4 * m * n
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
            print(f"{name} ({m},{kd},{n}) x{calls} | {k_ms:.4f} | {p_ms:.4f} "
                  f"| {bound:.4f} ({'bytes' if bytes_s >= ops_s else 'ops'})"
                  f" | {lib}", flush=True)
            t["ms"] += calls * k_ms
            t["plain_ms"] += calls * p_ms
            t["bound_ms"] += calls * bound
            t["bytes_s"] += calls * bytes_s
            t["ops_s"] += calls * ops_s
    del flush
    return tot


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
    name_power = _smi("name,power.limit")
    sm_clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"device: {torch.cuda.get_device_name(0)}; max SM clock "
          f"{sm_clock_hz / 1e6:.0f} MHz", flush=True)
    cfg = ARCHS[ARCH]

    err = check_kernels(cfg, device)
    launches = {}
    for backend in ("mxu_int8", "approx_lut"):
        for name, n in serve_full_width(cfg, backend).items():
            launches[name] = launches.get(name, 0) + n
    check_outputs(cfg, device)
    trace_decode()
    tot = time_kernels(cfg, device, sm_clock_hz)

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
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(name_power)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
