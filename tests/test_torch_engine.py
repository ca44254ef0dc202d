"""The port's paged continuous-batching engine held against the JAX package,
on the CPU.

``reduced(smollm-360m)`` with the JAX package's ``init_params(PRNGKey(0))``
crossed into the port (``convert.params_from_numpy``); traces from numpy
seeds. The reference for every stream is JAX's ``lockstep_generate`` (and
the port's own lockstep): the JAX ``ServeEngine`` is not run here, since JAX
pins its engine to its lockstep itself. On the CPU the engine's
paged-attention reads take the kernel's plain version (the gather path).

Greedy streams must be equal; where one differs from the reference, the
reference's top-2 logit margin at the first differing token must be within
4 bf16 ulps (``LOGIT_ATOL``, as in ``tests/test_torch_model.py``), and the
tie is flagged with a warning instead of failing.
"""
import collections
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core import gemm as j_gemm
from repro.launch import paged as j_paged
from repro.launch import serve as j_serve
from repro.models import get_model as j_get_model
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import gemm
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import engine, paged, serve
from repro_torch.models import get_model

LOGIT_ATOL = 0.125
PROMPT_LENS = (5, 11)
MAX_LEN = 24


# --- BlockPool: the same random trace through both copies -----------------

def _pool_state(pool):
    return (pool.tables.tolist(), list(pool._free), list(pool._lru),
            dict(pool._index), pool._ref.tolist(), pool._fresh.tolist(),
            pool._written.tolist(), pool._reserved.tolist(),
            [list(o) for o in pool._owned], pool.peak_allocated,
            pool.cow_copies, pool.evicted_blocks, pool.shared_attached,
            pool.invalidations, pool.free_blocks, pool.cached_blocks)


def _check_result(pool):
    try:
        pool.check()
        return "ok"
    except AssertionError as e:
        return f"failed: {e}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_matches_reference(seed):
    """Admit (with prefix hits), ensure, ensure_horizon, publish, release
    with keys, invalidate and COW drains, chosen at random: identical
    tables, free lists, LRU, index, refcounts, chain keys and check()."""
    rng = np.random.default_rng(seed)
    n_slots, max_len, bs = 4, 32, 4
    spec_t, spec_j = paged.PagedSpec(20, bs), j_paged.PagedSpec(20, bs)
    pools = (paged.BlockPool(spec_t, n_slots, max_len),
             j_paged.BlockPool(spec_j, n_slots, max_len))
    seed_bytes = b"chain-seed-%d" % seed
    prefixes = [rng.integers(0, 50, 16).astype(np.int32) for _ in range(3)]
    slots = {}                                # slot -> (tokens, written)
    for _ in range(200):
        op = rng.integers(0, 6)
        free = [s for s in range(n_slots) if s not in slots]
        if op <= 1 and free:
            toks = np.concatenate([prefixes[rng.integers(0, 3)][
                :rng.integers(0, 17)], rng.integers(0, 50, rng.integers(1, 9))
            ]).astype(np.int32)[:max_len - 4]
            keys = [m.chain_keys(seed_bytes, toks, bs) for m in (paged,
                                                                j_paged)]
            assert keys[0] == keys[1]
            hits = [p.match_prefix(keys[0]) for p in pools]
            assert hits[0] == hits[1]
            need = -(-(len(toks) + 3) // bs)
            cached = len(hits[0]) * bs
            resume = min(cached, len(toks) - 1)
            extra = 1 if cached >= len(toks) else 0
            fresh = need - len(hits[0]) + extra
            ok = [p.can_admit(fresh, hits[0]) for p in pools]
            assert ok[0] == ok[1]
            if ok[0]:
                s = free[0]
                for p in pools:
                    p.reserve(s, need, hits=hits[0], extra_cow=extra,
                              written=resume)
                slots[s] = (toks, resume, need)
        elif op == 2 and slots:
            s = list(slots)[rng.integers(0, len(slots))]
            toks, w, need = slots[s]
            upto = min(need * bs, w + int(rng.integers(1, 6)))
            fn = "ensure" if rng.integers(0, 2) else "ensure_horizon"
            changed = [getattr(p, fn)(s, upto) for p in pools]
            assert changed[0] == changed[1]
            slots[s] = (toks, max(w, upto), need)
            assert pools[0].drain_copies() == pools[1].drain_copies()
        elif op == 3 and slots:
            s = list(slots)[rng.integers(0, len(slots))]
            toks, w, _ = slots[s]
            keys = paged.chain_keys(seed_bytes, toks, bs, min(w, len(toks))
                                    // bs)
            for p in pools:
                p.publish(s, keys)
        elif op == 4 and slots:
            s = list(slots)[rng.integers(0, len(slots))]
            toks, w, _ = slots.pop(s)
            keys = paged.chain_keys(seed_bytes, toks, bs, min(w, len(toks))
                                    // bs)
            for p in pools:
                p.release(s, keys=keys)
        elif op == 5 and rng.integers(0, 8) == 0:
            for p in pools:
                p.invalidate()
        assert _pool_state(pools[0]) == _pool_state(pools[1])
        assert _check_result(pools[0]) == _check_result(pools[1]) == "ok"
    spec = paged.default_spec(4, 30, 8)
    want = j_paged.default_spec(4, 30, 8)
    assert (spec.n_blocks, spec.block_size, spec.dump) == (
        want.n_blocks, want.block_size, want.dump)
    assert paged.cache_seed("cfg", "policy") == j_paged.cache_seed("cfg",
                                                                   "policy")


# --- engine streams against lockstep ---------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg = reduced(ARCHS["smollm-360m"])
    jm = j_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = t_reduced(T_ARCHS["smollm-360m"])
    return cfg, jm, jp, tcfg, get_model(tcfg), params_from_numpy(
        jax.tree.map(np.asarray, jp))


def ragged_trace(seed=0, n=6, gen=(4, 7, 9)):
    """n requests of two prompt lengths and three budgets, arriving two per
    step."""
    rng = np.random.default_rng(seed)
    return [engine.Request(
        rid=i, prompt=rng.integers(0, 256, PROMPT_LENS[i % 2]).astype(
            np.int32), max_new_tokens=gen[i % len(gen)], arrival=i // 2)
            for i in range(n)]


def _copy(reqs):
    return [engine.Request(**{**r.__dict__, "preempt_count": 0})
            for r in reqs]


def lockstep_refs(reqs, gen_fn):
    """rid -> (stream, top-2 margins) from one lockstep call per prompt
    length (rows are independent: activations are quantized per row), each
    row cut to its request's budget."""
    out = {}
    for plen in sorted({len(r.prompt) for r in reqs}):
        rs = [r for r in reqs if len(r.prompt) == plen]
        stream, margin = gen_fn(np.stack([r.prompt for r in rs]),
                                max(r.max_new_tokens for r in rs))
        for i, r in enumerate(rs):
            out[r.rid] = (stream[i, :r.max_new_tokens],
                          margin[i, :r.max_new_tokens])
    return out


def port_lockstep(tcfg, tm, tp, pol):
    def gen(prompts, gl):
        margins = []
        out = serve.lockstep_generate(tcfg, tm, tp,
                                      torch.from_numpy(prompts).long(), gl,
                                      policy=pol, margins=margins)
        return out, torch.stack(margins, dim=1).numpy()
    return gen


def assert_streams_match(finished, refs, what):
    """Equal streams, or a flagged tie at the first differing token."""
    assert sorted(finished) == sorted(refs), what
    for rid, (want, margin) in refs.items():
        got = finished[rid].tokens
        if np.array_equal(got, want):
            continue
        diff = np.nonzero(got[:len(want)] != want[:len(got)])[0]
        assert diff.size, f"{what}: rid {rid} stream length {len(got)} != " \
                          f"{len(want)}"
        t = int(diff[0])
        assert margin[t] <= LOGIT_ATOL, (
            f"{what}: rid {rid} differs at token {t} with top-2 margin "
            f"{margin[t]}")
        warnings.warn(f"{what}: flagged tie, rid {rid} token {t} (top-2 "
                      f"margin {margin[t]})")


_JAX_REFS = {}


def jax_refs(models, backend, reqs):
    """JAX lockstep streams of the ragged trace (no margins: a tie against
    JAX is judged on the port's lockstep margins). Cached per backend: JAX
    pins its bound and unbound streams equal itself."""
    if backend not in _JAX_REFS:
        cfg, jm, jp, *_ = models
        pol = j_gemm.GemmPolicy(backend=backend)

        def gen(prompts, gl):
            out = j_serve.lockstep_generate(cfg, jm, jp, jnp.asarray(prompts),
                                            gl, policy=pol)
            return np.asarray(out), np.zeros(out.shape, np.float32)
        _JAX_REFS[backend] = lockstep_refs(reqs, gen)
    return _JAX_REFS[backend]


@pytest.mark.parametrize("backend,bound", [
    ("exact", False), ("mxu_int8", False), ("mxu_int8", True),
    ("approx_lut", False), ("approx_lut", True)])
def test_engine_streams_match_lockstep(models, backend, bound):
    """The engine on a ragged trace (4 slots, block 8, chunk 8, prefix cache
    on) equals the port's lockstep and JAX's lockstep, bound and unbound."""
    _, _, _, tcfg, tm, tp = models
    pol = gemm.GemmPolicy(backend=backend)
    if bound:
        tp = tm.bind_params(tp, pol)
    reqs = ragged_trace()
    eng = engine.ServeEngine(tcfg, tp, policy=pol, max_len=MAX_LEN,
                             validate_pool=True)
    before = pa.launches
    finished = eng.run(_copy(reqs))
    assert pa.launches == before        # CPU tensors never launch the kernel
    assert all(f.finish_reason == "length" for f in finished.values())
    assert eng.stats["peak_active_slots"] == 4
    port = lockstep_refs(reqs, port_lockstep(tcfg, tm, tp, pol))
    assert_streams_match(finished, port, f"{backend} vs port lockstep")
    want = jax_refs(models, backend, reqs)
    assert_streams_match(finished, {rid: (s, port[rid][1])
                                    for rid, (s, _) in want.items()},
                         f"{backend} vs JAX lockstep")


def _serve(models, reqs, backend="mxu_int8", **kw):
    _, _, _, tcfg, tm, tp = models
    pol = gemm.GemmPolicy(backend=backend)
    kw.setdefault("max_len", MAX_LEN)
    eng = engine.ServeEngine(tcfg, tm.bind_params(tp, pol), policy=pol,
                             validate_pool=True, **kw)
    return eng.run(_copy(reqs)), eng


def _tokens(finished):
    return {rid: f.tokens.tolist() for rid, f in finished.items()}


@pytest.mark.parametrize("chunk", [1, 3])
def test_prefill_chunk_sizes_give_equal_streams(models, chunk):
    reqs = ragged_trace(seed=1)
    base, _ = _serve(models, reqs, prefill_chunk=8)
    got, eng = _serve(models, reqs, prefill_chunk=chunk)
    assert _tokens(got) == _tokens(base)
    assert eng.stats["prefill_tokens"] == sum(len(r.prompt) for r in reqs)


def test_prefix_cache_warm_equals_cold(models):
    """Requests sharing a 16-token system prompt, one of them exactly the
    system prompt (its whole prompt cached: a COW copy): streams with the
    prefix cache equal those without it, with hits and skipped tokens."""
    rng = np.random.default_rng(2)
    system = rng.integers(0, 256, 16).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 256, n)]).astype(
        np.int32) for n in (3, 0, 5, 2)]
    prompts[3] = rng.integers(0, 256, 9).astype(np.int32)   # no shared prefix
    reqs = [engine.Request(rid=i, prompt=p, max_new_tokens=5, arrival=3 * i)
            for i, p in enumerate(prompts)]
    cold, cold_eng = _serve(models, reqs, max_len=32, prefix_cache=False)
    warm, warm_eng = _serve(models, reqs, max_len=32)
    assert _tokens(warm) == _tokens(cold)
    st = warm_eng.stats
    assert st["prefix_hits"] == 2 and st["prefix_tokens_skipped"] == 31
    assert st["prefix_cow_copies"] == 1
    assert cold_eng.stats["prefix_hits"] == 0
    assert st["prefill_tokens"] == cold_eng.stats["prefill_tokens"] - 31


def test_preemption_replays_bit_identically(models):
    """A small pool: a high-priority arrival preempts the most recently
    admitted low-priority request, which is requeued, replayed from its
    prompt and ends with the stream it has alone."""
    reqs = ragged_trace(seed=3, n=4, gen=(9,))
    reqs.append(engine.Request(rid=9, prompt=reqs[0].prompt, max_new_tokens=9,
                               arrival=3, priority=5))
    got, eng = _serve(models, reqs, n_blocks=10, block_size=4)
    assert eng.events["preemptions"] >= 1
    assert any(f.preemptions for f in got.values())
    alone = {r.rid: _serve(models, [r], n_blocks=10, block_size=4)[0][r.rid]
             for r in reqs}
    assert _tokens(got) == _tokens(alone)
    order = sorted(got.values(), key=lambda f: f.admitted_step)
    assert got[9].admitted_step <= order[-1].admitted_step


def test_cancel_deadlines_and_queue_limit(models):
    reqs = ragged_trace(seed=4, n=6, gen=(9,))
    for r in reqs:
        r.arrival = 0
    reqs[4].ttft_deadline = 1            # queued behind 4 slots: no token yet
    reqs[1].total_deadline = 5
    _, _, _, tcfg, tm, tp = models
    pol = gemm.GemmPolicy(backend="mxu_int8")
    eng = engine.ServeEngine(tcfg, tm.bind_params(tp, pol), policy=pol,
                             max_len=MAX_LEN, queue_limit=5,
                             validate_pool=True)
    accepted = [eng.submit(r) for r in _copy(reqs)]
    assert accepted == [True] * 5 + [False]
    eng.step()
    eng.step()
    assert eng.cancel(reqs[2].rid)       # live: frees its slot and blocks
    assert not eng.cancel(123)
    finished = eng.run()
    reasons = {rid: f.finish_reason for rid, f in finished.items()}
    assert reasons == {0: "length", 1: "deadline_total", 2: "cancelled",
                       3: "length", 4: "deadline_ttft",
                       5: engine.REJECTED_QUEUE_FULL}
    # rid 1 (11 prompt tokens): chunks at steps 0-1, tokens at steps 1-4,
    # retired before step 5; rid 2 (5 prompt tokens): tokens at steps 0-1
    assert len(finished[1].tokens) == 4
    assert len(finished[2].tokens) == 2 and len(finished[4].tokens) == 0
    st = eng.stats
    assert (st["cancelled"], st["deadline_ttft"], st["deadline_total"],
            st[engine.REJECTED_QUEUE_FULL]) == (1, 1, 1, 1)
    assert eng.pool.allocated_blocks == 0 and not eng.active.any()


def test_sampled_streams_do_not_depend_on_the_batch(models):
    """Temperature/top-k/top-p streams are a function of (seed, rid, token
    index): a request sampled alongside others equals it sampled alone."""
    sp = engine.sampling.SamplingParams(temperature=1.5, top_k=40, top_p=0.9,
                                        seed=11)
    reqs = ragged_trace(seed=5)
    for r in reqs:
        r.params = sp
    together, _ = _serve(models, reqs)
    for r in reqs[:3]:
        alone, _ = _serve(models, [r])
        assert alone[r.rid].tokens.tolist() == together[r.rid].tokens.tolist()
    greedy, _ = _serve(models, ragged_trace(seed=5))
    assert _tokens(greedy) != _tokens(together)


def test_unported_engine_paths_raise(models):
    _, _, _, tcfg, _, tp = models
    for kw, what in (({"paged": False}, "contiguous"),
                     ({"multi_step": 4}, "multi-step"),
                     ({"policy": gemm.GemmPolicy(backend="mxu_int8",
                                                 guard="detect")}, "ABFT")):
        with pytest.raises(NotImplementedError, match=what):
            engine.ServeEngine(tcfg, tp, **kw)


def test_serve_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--debug", "--engine"])


def test_poisson_trace_matches_reference():
    from repro.launch import engine as j_engine
    want = j_engine.make_poisson_trace(12, rate=1.5, vocab_size=100,
                                       seed=3)
    got = engine.make_poisson_trace(12, rate=1.5, vocab_size=100, seed=3)
    for w, g in zip(want, got):
        assert (w.rid, w.max_new_tokens, w.arrival) == (g.rid,
                                                        g.max_new_tokens,
                                                        g.arrival)
        np.testing.assert_array_equal(w.prompt, g.prompt)


def test_serve_engine_cli_on_cpu(capsys):
    finished = serve.main(["--debug", "--device", "cpu", "--engine",
                           "--requests", "6", "--backend", "approx_lut",
                           "--gen-len", "5"])
    assert len(finished) == 6
    assert all(len(f.tokens) == 5 for f in finished.values())
    out = capsys.readouterr().out
    assert "engine: 6 requests, 30 tokens" in out
    assert "occupancy: slots" in out and "prefix cache:" in out
    counts = collections.Counter(f.finish_reason for f in finished.values())
    assert counts == {"length": 6}


def test_serve_engine_replays_a_trace(tmp_path):
    """``--trace`` replays JSON lines: arrival, lengths and sampling per
    request, missing lengths from --prompt-len/--gen-len."""
    trace = tmp_path / "trace.jsonl"
    trace.write_text('{"arrival": 0, "prompt_len": 6, "gen_len": 3}\n\n'
                     '{"arrival": 2, "temperature": 0.8, "top_k": 5}\n'
                     '{"arrival": 2, "prompt_len": 9, "gen_len": 2}\n')
    finished = serve.main(["--debug", "--device", "cpu", "--engine",
                           "--trace", str(trace), "--prompt-len", "4",
                           "--gen-len", "5", "--max-len", "16"])
    assert {rid: (f.prompt_len, len(f.tokens))
            for rid, f in finished.items()} == {0: (6, 3), 2: (4, 5),
                                                3: (9, 2)}
    assert finished[2].admitted_step >= 2
