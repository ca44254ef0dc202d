"""Serving entry point, lockstep mode (port of ``repro/launch/serve.py``).

* **lockstep** (default) — batched prefill + greedy decode with one shared
  position: every request padded to the same prompt/gen length. It is the
  bit-parity reference the continuous-batching engine is held against.
* ``--engine`` — the continuous-batching engine is not ported yet and exits
  with a message; it does not fall back to lockstep.

``--backend`` routes every model GEMM through that ``GemmPolicy`` backend;
``--bind`` (the default for non-exact backends) binds the parameters first
(``core.gemm.bind``), so decode runs weight-stationary. ``--device`` (default
``cuda``) picks the device; without a card it raises rather than run on the
CPU, unless ``--device cpu`` is given. Parameters are random, drawn from a
``torch.Generator`` seeded with 0; prompts come from ``--seed`` through
numpy, as in the reference.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
          --backend approx_lut
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import gemm
from repro_torch.models import get_model

PARAM_SEED = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lockstep_generate(cfg, model, params, prompts: torch.Tensor, gen_len: int,
                      *, policy=gemm.EXACT, stats: dict | None = None
                      ) -> np.ndarray:
    """The lockstep reference: batched prefill + greedy decode, one position
    shared by the whole batch. prompts: (B, P) integer tensor on the params'
    device. Returns (B, gen_len) int32 tokens.

    Tokens stay on the device between steps; the host reads them once at the
    end. With ``stats`` given, the device is synchronized after prefill and
    at the end, and ``prefill_s`` / ``decode_s`` are recorded there.
    """
    b, pl = prompts.shape
    device = prompts.device
    cache = model.init_cache(b, pl + gen_len, device=device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts}, cache,
                                  policy=policy)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out_tokens = [tok]
    if stats is not None:
        _sync(device)
        t1 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, tok, cache, pl + i,
                                          policy=policy)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out_tokens.append(tok)
    out = torch.cat(out_tokens, dim=1).to(torch.int32).cpu().numpy()
    if stats is not None:
        t2 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = t2 - t1
    return out


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's flags (``launch/trace_serve.py`` reads the same)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--debug", action="store_true",
                    help="serve the reduced (smoke-test) config of the arch")
    ap.add_argument("--batch", type=int, default=4, help="lockstep batch size")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--backend", default="exact", choices=gemm.BACKENDS,
                    help="GemmPolicy backend for every model GEMM")
    ap.add_argument("--k", type=int, default=4, help="approximation factor")
    ap.add_argument("--guard", default="none", choices=gemm.GUARDS,
                    help="ABFT integrity checking (not ported yet: only "
                         "'none' runs)")
    ap.add_argument("--bind", action="store_true",
                    help="bind params to the policy (weight-stationary decode)")
    ap.add_argument("--no-bind", dest="bind", action="store_false")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.set_defaults(bind=None)
    return ap


def setup(args):
    """What serving needs from the parsed flags: ``(cfg, model, params,
    policy, prompts)``, with the params random from ``PARAM_SEED`` (bound
    for non-exact backends unless ``--no-bind``) and the (batch, prompt-len)
    prompts drawn from ``--seed`` through numpy, all on ``--device``."""
    if args.engine:
        raise SystemExit("engine: not ported yet, see ROADMAP")
    device = resolve_device(args.device)
    # float32 matmuls and convolutions in full float32, as in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ARCHS[args.arch]
    if args.debug:
        cfg = reduced(cfg)
    policy = gemm.GemmPolicy(backend=args.backend, k=args.k, guard=args.guard)
    do_bind = (args.backend != "exact") if args.bind is None else args.bind
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(PARAM_SEED)
    params = model.init_params(gen, device)
    if do_bind:
        t0 = time.perf_counter()
        params = model.bind_params(params, policy)
        _sync(device)
        print(f"bound params to backend={args.backend} in "
              f"{time.perf_counter() - t0:.2f}s (weight-stationary decode)")
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int64)
    ).to(device)
    return cfg, model, params, policy, prompts


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, model, params, policy, prompts = setup(args)
    device = prompts.device
    b, gl = args.batch, args.gen_len
    stats = {}
    out = lockstep_generate(cfg, model, params, prompts, gl, policy=policy,
                            stats=stats)
    dt = stats["prefill_s"] + stats["decode_s"]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"generated {out.shape} tokens in {dt:.3f}s ({b * gl / dt:.1f} tok/s) "
          f"on {name}: prefill {stats['prefill_s'] * 1e3:.2f} ms, decode "
          f"{stats['decode_s'] * 1e3 / max(1, gl - 1):.2f} ms/step; "
          f"first row: {out[0][:12]}")
    return out


if __name__ == "__main__":
    main()
