"""Where a lockstep decode step spends its time: host wall clock against
device busy time, from one ``torch.profiler`` trace.

    PYTHONPATH=src python -m repro_torch.launch.trace_serve \
        --arch smollm-360m --backend approx_lut

Takes ``launch/serve.py``'s flags and builds what it builds
(``serve.setup``: random weights from seed 0, bound for non-exact backends).
Runs the prefill and one warm decode step, then ``--gen-len`` - 1 decode
steps twice: untraced, then traced by the profiler. Prints, per decode step:
host wall ms of the untraced run (ended by a device synchronize) and of the
traced run, device busy ms (the sum of the traced kernels' device time: one
stream, so kernels do not overlap), the device's idle share against the
untraced wall time, the number of device events (kernels, memsets), and the
eight kernels with the most device time. On the CPU there is no device
time, and the device numbers print as "not measured".
"""
from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import serve

TOP = 8                                  # kernels listed, by device time


def _device_events(prof):
    """name -> (calls, total µs) over the events that ran on the device
    (kernels, memsets, copies), not the host-side ops that launched them."""
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = out.get(e.name, (0, 0.0))
            out[e.name] = (calls + 1, us + e.device_time_total)
    return out


def main(argv=None):
    args = serve.build_parser().parse_args(argv)
    cfg, model, params, policy, prompts = serve.setup(args)
    device = prompts.device
    b, pl = prompts.shape
    n_steps = max(1, args.gen_len - 1)
    cache = model.init_cache(b, pl + n_steps + 1, device=device)
    logits, cache = model.prefill(params, {"tokens": prompts}, cache,
                                  policy=policy)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    logits, cache = model.decode_step(params, tok, cache, pl, policy=policy)
    tok = torch.argmax(logits[:, -1:], dim=-1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def steps():
        """n_steps decode steps (rewriting the same cache positions);
        returns host wall ms per step, ended by a synchronize."""
        nonlocal tok, logits
        sync()
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, _ = model.decode_step(params, tok, cache, pl + 1 + i,
                                          policy=policy)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        sync()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    wall_ms = steps()                        # untraced: the step's own time
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced_ms = steps()
    kernels = _device_events(prof)
    busy_ms = sum(us for _, us in kernels.values()) / 1e3 / n_steps
    launches = sum(calls for calls, _ in kernels.values()) / n_steps
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    result = {"arch": cfg.name, "backend": args.backend, "device": name,
              "decode_wall_ms": wall_ms, "traced_wall_ms": traced_ms}
    if busy_ms > 0:
        result.update(device_busy_ms=busy_ms,
                      device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                      device_events=launches)
    else:
        result.update(device_busy_ms="not measured",
                      device_idle_share="not measured",
                      device_events="not measured")
    print(json.dumps(result))
    for kname, (calls, us) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][1])[:TOP]:
        print(f"  {us / 1e3 / n_steps:9.3f} ms/step "
              f"{calls / n_steps:7.1f} calls/step  {kname[:90]}")
    return result


if __name__ == "__main__":
    main()
