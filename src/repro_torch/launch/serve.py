"""Serving entry point: lockstep reference loop + continuous-batching engine
CLI (port of ``repro/launch/serve.py``).

* **lockstep** (default) — batched prefill + greedy decode with one shared
  position: every request padded to the same prompt/gen length. It is the
  parity reference the continuous-batching engine is held against.
* ``--engine`` — the paged continuous-batching engine (``launch.engine``):
  admission queue, chunked prefill, per-slot ragged decode, EOS/budget
  retirement, slot reuse, prefix caching, deadlines, per-slot sampling. Give
  it a ragged workload with ``--requests/--poisson-rate`` (synthetic Poisson
  trace) or replay a trace with ``--trace FILE`` (JSON lines:
  ``{"arrival": 3, "prompt_len": 12, "gen_len": 16, "temperature": 0.7}``;
  missing lengths fall back to --prompt-len/--gen-len). On a card every
  attention read goes through the paged-attention kernel
  (``--paged-kernel N``: a floor on its split count; 0 or 1 = its own).
  ``--contiguous`` and ``--multi-step N > 1`` are not ported yet and exit
  with a message.

``--backend`` routes every model GEMM through that ``GemmPolicy`` backend;
``--bind`` (the default for non-exact backends) binds the parameters first
(``core.gemm.bind``), so decode runs weight-stationary. ``--device`` (default
``cuda``) picks the device; without a card it raises rather than run on the
CPU, unless ``--device cpu`` is given. Parameters are random, drawn from a
``torch.Generator`` seeded with 0; prompts come from ``--seed`` through
numpy, as in the reference.

``--arch`` takes any dense config of the registry (smollm-360m,
gemma3-12b, gemma2-27b, qwen2.5-14b) at its full published width; a cache
longer than a windowed config's window needs the two-tier ring cache, which
is not ported yet (``init_cache`` raises).

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
          --backend approx_lut [--engine --requests 16]
      PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
          --backend mxu_int8 [--engine --requests 16]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import gemm
from repro_torch.models import get_model
from . import engine as engine_mod
from . import sampling

PARAM_SEED = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lockstep_generate(cfg, model, params, prompts: torch.Tensor, gen_len: int,
                      *, policy=gemm.EXACT, stats: dict | None = None,
                      margins: list | None = None) -> np.ndarray:
    """The lockstep reference: batched prefill + greedy decode, one position
    shared by the whole batch. prompts: (B, P) integer tensor on the params'
    device. Returns (B, gen_len) int32 tokens.

    Tokens stay on the device between steps; the host reads them once at the
    end. With ``stats`` given, the device is synchronized after prefill and
    at the end, and ``prefill_s`` / ``decode_s`` are recorded there. With
    ``margins`` given (a list), it receives each step's top-2 logit margin,
    a (B,) f32 tensor per step: where a stream compared with this one first
    differs, a margin within the logits' tolerance flags a tie.
    """
    b, pl = prompts.shape
    device = prompts.device
    cache = model.init_cache(b, pl + gen_len, device=device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts}, cache,
                                  policy=policy)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out_tokens = [tok]

    def margin(logits):
        if margins is not None:
            top2 = torch.topk(logits[:, -1], 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])

    margin(logits)
    if stats is not None:
        _sync(device)
        t1 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, tok, cache, pl + i,
                                          policy=policy)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out_tokens.append(tok)
        margin(logits)
    out = torch.cat(out_tokens, dim=1).to(torch.int32).cpu().numpy()
    if stats is not None:
        t2 = time.perf_counter()
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = t2 - t1
    return out


def load_trace(path, vocab_size, default_prompt_len, default_gen_len, *,
               seed=0):
    """Replay a recorded request trace (JSON lines) as engine Requests."""
    rng = np.random.default_rng(seed)
    requests = []
    with open(path) as f:
        for rid, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            plen = int(rec.get("prompt_len", default_prompt_len))
            requests.append(engine_mod.Request(
                rid=rid,
                prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
                max_new_tokens=int(rec.get("gen_len", default_gen_len)),
                params=sampling.SamplingParams(
                    temperature=float(rec.get("temperature", 0.0)),
                    top_k=int(rec.get("top_k", 0)),
                    top_p=float(rec.get("top_p", 1.0)),
                    seed=int(rec.get("seed", 0))),
                arrival=int(rec.get("arrival", 0))))
    return requests


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's flags (``launch/trace_serve.py`` reads the same)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--debug", action="store_true",
                    help="serve the reduced (smoke-test) config of the arch")
    ap.add_argument("--batch", type=int, default=4,
                    help="lockstep batch size / engine slot count")
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
                    help="continuous-batching engine instead of lockstep")
    ap.add_argument("--requests", type=int, default=0,
                    help="engine: synthetic Poisson trace of N requests "
                         "(default 2 x --batch)")
    ap.add_argument("--poisson-rate", type=float, default=2.0,
                    help="engine: mean arrivals per step")
    ap.add_argument("--trace", default=None,
                    help="engine: replay a JSONL request trace")
    ap.add_argument("--max-len", type=int, default=0,
                    help="engine: per-slot cache length (default: "
                         "prompt-len + gen-len)")
    ap.add_argument("--paged", dest="paged", action="store_true", default=True,
                    help="engine: paged KV cache + chunked prefill (default)")
    ap.add_argument("--contiguous", dest="paged", action="store_false",
                    help="engine: contiguous per-slot caches (not ported yet)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="engine: paged KV block size in tokens")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="engine: KV pool size in blocks (default: every "
                         "slot can hold max-len tokens)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="engine: prompt tokens per slot per chunked-prefill "
                         "step")
    ap.add_argument("--paged-kernel", type=int, default=0, metavar="N",
                    help="engine: floor on the paged-attention kernel's "
                         "split count (0 or 1 = the kernel's own choice, "
                         "N > 1 = at least N blocks per row's KV range); CPU "
                         "runs take its plain version")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="engine: share KV blocks across requests with equal "
                         "prompt prefixes (default)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="engine: disable prefix caching")
    ap.add_argument("--multi-step", type=int, default=1, metavar="N",
                    help="engine: fused N-step decode horizons (not ported "
                         "yet: only 1 runs)")
    ap.add_argument("--queue-limit", type=int, default=0,
                    help="engine: bound the admission queue; overflow is "
                         "rejected as 'rejected_queue_full' (0 = unbounded)")
    ap.add_argument("--ttft-deadline", type=int, default=0,
                    help="engine: retire requests without a first token "
                         "within N steps of arrival (0 = off)")
    ap.add_argument("--total-deadline", type=int, default=0,
                    help="engine: retire requests not finished within N "
                         "steps of arrival (0 = off)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.set_defaults(bind=None)
    return ap


def setup(args):
    """What serving needs from the parsed flags: ``(cfg, model, params,
    policy, prompts)``, with the params random from ``PARAM_SEED`` (bound
    for non-exact backends unless ``--no-bind``) and the (batch, prompt-len)
    lockstep prompts drawn from ``--seed`` through numpy, all on
    ``--device``."""
    if args.engine and not args.paged:
        raise SystemExit("engine --contiguous: not ported yet, see ROADMAP")
    if args.engine and args.multi_step > 1:
        raise SystemExit("engine --multi-step > 1: not ported yet, see "
                         "ROADMAP")
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


def engine_requests(args, cfg):
    """The engine's workload from the flags: a replayed ``--trace`` or a
    synthetic Poisson trace of ``--requests`` (default 2 x ``--batch``),
    with the deadlines applied."""
    sp = sampling.SamplingParams(temperature=args.temperature,
                                 top_k=args.top_k, top_p=args.top_p,
                                 seed=args.seed)
    if args.trace:
        requests = load_trace(args.trace, cfg.vocab_size, args.prompt_len,
                              args.gen_len, seed=args.seed)
    else:
        requests = engine_mod.make_poisson_trace(
            args.requests or 2 * args.batch, rate=args.poisson_rate,
            vocab_size=cfg.vocab_size, prompt_lens=(args.prompt_len,),
            gen_lens=(args.gen_len,), seed=args.seed, params=sp)
    for r in requests:
        r.ttft_deadline = args.ttft_deadline or None
        r.total_deadline = args.total_deadline or None
    return requests


def make_engine(args, cfg, params, policy):
    """A ``ServeEngine`` configured by the flags."""
    return engine_mod.ServeEngine(
        cfg, params, policy=policy, max_slots=args.batch,
        max_len=args.max_len or (args.prompt_len + args.gen_len),
        eos_id=args.eos_id, block_size=args.block_size,
        n_blocks=args.n_blocks or None, prefill_chunk=args.prefill_chunk,
        paged_kernel=args.paged_kernel or None,
        queue_limit=args.queue_limit or None, multi_step=args.multi_step,
        prefix_cache=args.prefix_cache)


def run_engine(args, cfg, params, policy, requests=None):
    """Serve ``requests`` (default: the flags' workload) through the engine
    and print its report. Returns (finished, engine)."""
    device = params["embed"].device
    requests = engine_requests(args, cfg) if requests is None else requests
    eng = make_engine(args, cfg, params, policy)
    _sync(device)
    t0 = time.perf_counter()
    finished = eng.run(requests)
    _sync(device)
    dt = time.perf_counter() - t0
    st = eng.stats
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"engine: {st['finished']} requests, {st['generated_tokens']} "
          f"tokens in {dt:.2f}s ({st['generated_tokens'] / dt:.1f} tok/s) "
          f"over {st['steps']} steps ({st['decode_steps']} with decode rows) "
          f"on {name}")
    print(f"host syncs: {st['host_syncs']} ({st['syncs_per_token']:.3f}/token, "
          f"multi_step={st['multi_step']})")
    tok_total = max(1, st["prefill_tokens"] + st["decode_tokens"])
    print(f"occupancy: slots {st['slot_utilization']:.1%} "
          f"(peak {st['peak_active_slots']}/{args.batch}), "
          f"cache blocks {st['block_utilization']:.1%} "
          f"(peak {st['peak_allocated_blocks']}/{eng.pool.spec.n_blocks}), "
          f"token split {st['prefill_tokens']}/{st['decode_tokens']} "
          f"prefill/decode ({st['prefill_tokens'] / tok_total:.0%} prefill)")
    if eng.prefix_cache:
        print(f"prefix cache: {st['prefix_hits']} hits, "
              f"{st['prefix_tokens_skipped']} prompt tokens skipped, "
              f"{st['prefix_shared_blocks']} blocks shared, "
              f"{st['prefix_cow_copies']} COW copies, "
              f"{st['prefix_evicted_blocks']} evicted, "
              f"{st['prefix_cached_blocks']} cached now")
    rel = {k: st[k] for k in (engine_mod.REJECTED_QUEUE_FULL, "cancelled",
                              "deadline_ttft", "deadline_total",
                              "preemptions")}
    if any(rel.values()):
        print("reliability: " + ", ".join(f"{k}={v}" for k, v in rel.items()))
    for rid in sorted(finished)[:4]:
        f = finished[rid]
        print(f"  rid={rid} [{f.finish_reason}] "
              f"tokens={f.tokens[:8].tolist()}...")
    return finished, eng


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, model, params, policy, prompts = setup(args)
    if args.engine:
        finished, _ = run_engine(args, cfg, params, policy)
        return finished
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
