"""Continuous-batching serve engine, paged mode (port of ``repro/launch/engine.py``).

A fixed pool of **slots** (the batch rows of one chunk step) is kept busy
under ragged traffic:

* **admission queue** — submitted requests wait; the one with the highest
  effective priority among those that have arrived (FIFO among equals) is
  admitted as soon as a slot is free and the block pool can hold it.
* **paged KV cache** — KV lives in a shared block pool
  (``launch.paged.BlockPool``): admission reserves a request's worst-case
  block footprint, blocks are allocated on first write and freed (or parked
  in the prefix cache) at retirement.
* **chunked prefill** — prompts stream through the same batched step as
  decode, ``prefill_chunk`` tokens at a time: a step mixes prompt chunks and
  single decode tokens (per-slot ``q_len``). The final chunk samples the
  request's first token.
* **prefix caching** — admission matches the prompt's chain keys against
  resident blocks, attaches the leading hits to the slot's table and
  prefills only the uncached tail; writes into shared blocks copy-on-write.
* **retirement & slot reuse** — a slot retires on EOS, on its token budget,
  on a TTFT or total deadline (counted in engine steps from arrival), or on
  cancellation, and is free for the next admission at once.
* **preemption** — a higher-priority arrival that does not fit evicts the
  most recently admitted lower-priority slots; their requests are requeued
  (aged up one priority level each time) and replayed from the prompt.

Per-request determinism: activations are quantized per row
(``core.gemm.dot``), attention and caches are per slot, and sampling keys
are per request, so a request's greedy stream equals running it alone
through the lockstep loop (``launch.serve.lockstep_generate``) up to float
rounding in attention: on the card the engine reads through the
paged-attention kernel, lockstep through the contiguous plain path.

PyTorch runs eagerly, so the per-slot state the reference keeps on the
device (positions, counters, sampling parameters) lives on the host here;
each step uploads one packed (B, T + 2) integer block (tokens, positions,
q_len), the block tables when they changed, and syncs the sampled tokens
once. On a CUDA device every paged-attention read goes through the
paged-attention kernel (``paged_kernel`` is a floor on its split count);
on the CPU the kernel's wrapper runs its plain version (the gather path).

Not ported yet, raising ``NotImplementedError``: the contiguous engine
(``paged=False``), multi-step decode (``multi_step > 1``), ABFT guards and
fault recovery (``policy.guard != "none"``, the quarantine and retry paths)
and families other than the dense one.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gemm import EXACT, GemmPolicy
from repro_torch.models import api as model_api
from . import paged as paged_mod
from . import sampling
from . import steps as steps_mod

PyTree = Any

# Retirement status code for requests bounced by a full admission queue.
REJECTED_QUEUE_FULL = "rejected_queue_full"

# Engine default for the retirement-time BlockPool.check() invariant sweep
# (O(pool) asserts per retirement); tests turn it on per engine.
VALIDATE_POOL_DEFAULT = False


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{where}, see ROADMAP.md")


@dataclasses.dataclass
class Request:
    """One generation request.

    ``arrival`` is in engine *steps* (trace replay): the request becomes
    admissible once the engine has taken that many steps. ``eos_id``
    overrides the engine-level EOS token for this request (None = engine
    default). ``priority`` orders admission (higher wins; equal priorities
    keep FIFO order) and lets the request preempt strictly-lower-priority
    slots when the block pool is exhausted. ``ttft_deadline`` /
    ``total_deadline`` are budgets in engine steps from arrival.
    ``preempt_count`` is engine-maintained aging state.
    """
    rid: int
    prompt: np.ndarray                      # (P,) int32 prompt tokens
    max_new_tokens: int
    params: sampling.SamplingParams = sampling.GREEDY
    arrival: int = 0
    eos_id: Optional[int] = None
    priority: int = 0
    ttft_deadline: Optional[int] = None
    total_deadline: Optional[int] = None
    preempt_count: int = 0                  # engine-maintained (aging)


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    tokens: np.ndarray                      # (n,) int32 generated tokens
    prompt_len: int
    admitted_step: int                      # -1 if never admitted
    finished_step: int
    finish_reason: str    # "eos" | "length" | "deadline_ttft" |
    #                       "deadline_total" | "cancelled" |
    #                       "rejected_queue_full"
    preemptions: int = 0                    # times preempted before finishing


class ServeEngine:
    """Slot-based continuous batching over a paged KV cache.

    ``block_size`` tokens per block, ``n_blocks`` pool blocks (default: every
    slot can hold ``max_len`` tokens, ``max_slots * ceil(max_len /
    block_size)``), ``prefill_chunk`` prompt tokens per slot per step.
    ``paged_kernel``: a floor on the paged-attention kernel's split count
    (None, 0 or 1 = let the kernel choose; N > 1 = at least N blocks per
    row's KV range). ``prefix_cache``
    shares full KV blocks across requests with equal prompt prefixes.
    The cache lives on the device of ``params["embed"]``.
    """

    def __init__(self, cfg: ModelConfig, params: PyTree, *,
                 policy: GemmPolicy = EXACT, max_slots: int = 4,
                 max_len: int = 64, eos_id: Optional[int] = None,
                 paged: bool = True, block_size: int = 8,
                 n_blocks: Optional[int] = None, prefill_chunk: int = 8,
                 paged_kernel=None, queue_limit: Optional[int] = None,
                 validate_pool: Optional[bool] = None, multi_step: int = 1,
                 prefix_cache: bool = True):
        if cfg.family != "dense":
            raise _not_ported(f"serving family {cfg.family!r}",
                              "the slice of that family")
        if not paged:
            raise _not_ported("the contiguous engine (paged=False)",
                              "a later serving slice")
        if multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {multi_step}")
        if multi_step > 1:
            raise _not_ported("multi-step decode (multi_step > 1)",
                              "the multi-step slice (ROADMAP item 8)")
        if policy.guard != "none":
            raise _not_ported("ABFT-guarded serving (guard != 'none')",
                              "the reliability slice (ROADMAP item 10)")
        self.cfg = cfg
        self.params = params
        self.policy = policy
        self.device = params["embed"].device
        self.queue_limit = queue_limit
        self.validate_pool = (VALIDATE_POOL_DEFAULT if validate_pool is None
                              else validate_pool)
        self.multi_step = multi_step
        self.model = model_api.get_model(cfg)
        self.n_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.paged_kernel = max(1, int(paged_kernel or 0))

        spec = (paged_mod.PagedSpec(n_blocks, block_size)
                if n_blocks is not None
                else paged_mod.default_spec(max_slots, max_len, block_size))
        self.pool = paged_mod.BlockPool(spec, max_slots, max_len)
        self.cache = self.model.init_paged_cache(
            max_slots, max_len, spec.n_blocks, spec.block_size,
            device=self.device)
        self.prefill_chunk = max(1, prefill_chunk)
        # per-slot prefill cursor (None once the slot is decoding) and the
        # next cache write position
        self.slot_prefill_off: List[Optional[int]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int64)
        self._tables_dirty = True
        self.occ = {"slot_steps": 0, "slot_active_steps": 0,
                    "block_steps": 0, "block_alloc_steps": 0,
                    "prefill_tokens": 0, "decode_tokens": 0}
        # prefix caching is sound only when every cache leaf lives in the
        # shared pool (true of the dense family's pools + tables)
        pool_pure = all(key == "block_tables"
                        or key in model_api.PAGED_POOL_LEAVES
                        for key in self.cache)
        self.prefix_cache = bool(prefix_cache and pool_pure)
        self._prefix_seed = paged_mod.cache_seed(cfg, policy)
        self._copy_blocks = steps_mod.make_copy_blocks_step()
        self._chunk = steps_mod.make_chunk_step(
            cfg, policy, paged_kernel=self.paged_kernel)
        self.slot_chain: List[Sequence[bytes]] = [()] * max_slots
        self.slot_cacheable = [False] * max_slots
        self.prefix_events = {"prefix_hits": 0, "prefix_tokens_skipped": 0}

        b = max_slots
        # per-slot sampling state (host: the step syncs its tokens anyway)
        self.slot_temp = np.zeros(b, np.float32)
        self.slot_top_k = np.zeros(b, np.int64)
        self.slot_top_p = np.ones(b, np.float32)
        self.slot_key = [0] * b
        self.active = np.zeros(b, bool)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.slot_out: List[List[int]] = [[] for _ in range(b)]
        self.slot_admitted = np.zeros(b, np.int32)

        self.queue: "collections.deque[Request]" = collections.deque()
        self.finished: Dict[int, FinishedRequest] = {}
        self.step_count = 0
        self.decode_steps = 0
        self.peak_active = 0
        self.host_syncs = 0                  # token-vector device->host syncs
        self.events = {REJECTED_QUEUE_FULL: 0, "cancelled": 0,
                       "deadline_ttft": 0, "deadline_total": 0,
                       "preemptions": 0}

    # --- scheduler ----------------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Queue a request. With ``queue_limit`` set, a full queue rejects it
        at once with status ``rejected_queue_full``. Returns False iff
        rejected."""
        if (self.queue_limit is not None
                and len(self.queue) >= self.queue_limit):
            self._finish_unstarted(request, REJECTED_QUEUE_FULL)
            return False
        self.queue.append(request)
        return True

    def cancel(self, rid: int) -> bool:
        """Client cancellation: retire the request now with status
        ``cancelled``, freeing its slot and blocks (queued requests are just
        removed). Tokens generated so far are kept. Returns False if ``rid``
        is not live."""
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            if req is not None and req.rid == rid:
                self._retire_slot(slot, "cancelled")
                return True
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._finish_unstarted(req, "cancelled")
                return True
        return False

    def _finish_unstarted(self, req: Request, reason: str) -> None:
        self.finished[req.rid] = FinishedRequest(
            req.rid, np.zeros(0, np.int32), len(req.prompt), -1,
            self.step_count, reason, preemptions=req.preempt_count)
        if reason in self.events:
            self.events[reason] += 1

    def _eos_of(self, req: Request) -> int:
        """Effective EOS token id, ``-1`` = none."""
        eos = req.eos_id if req.eos_id is not None else self.eos_id
        return -1 if eos is None else int(eos)

    def _budget(self, req: Request) -> int:
        # token n's step writes its input's KV at offset start + n - 2 (the
        # final token's own KV is never written), so n tokens need
        # start + n - 1 <= max_len; clamp the request budget to the slot
        return max(1, min(req.max_new_tokens,
                          self.max_len - len(req.prompt) + 1))

    def _reserved_blocks(self, req: Request) -> int:
        """Worst-case block footprint: prompt + clamped budget, minus the
        final token whose KV is never written."""
        return self.pool.spec.blocks_for(len(req.prompt)
                                         + self._budget(req) - 1)

    def _prefix_plan(self, req: Request):
        """(chain keys, hit blocks, extra COW budget, resume offset).

        Resuming at ``min(cached, start - 1)``, never ``start``, keeps the
        first sampled token equal to a cold prefill's: the final chunk
        recomputes at least the last prompt position. When the whole prompt
        is cached, that position rewrites the final attached block, the one
        COW site admission budgets an extra fresh block for.
        """
        if not self.prefix_cache:
            return (), [], 0, 0
        start = len(req.prompt)
        bs = self.pool.spec.block_size
        keys = paged_mod.chain_keys(self._prefix_seed, req.prompt, bs,
                                    start // bs)
        hits = self.pool.match_prefix(keys)
        cached = len(hits) * bs
        resume = min(cached, start - 1)
        extra_cow = 1 if cached >= start else 0
        return keys, hits, extra_cow, resume

    def _admit_paged(self, slot: int, req: Request, plan=None) -> None:
        start = len(req.prompt)
        if start > self.max_len:
            raise ValueError(f"request {req.rid}: prompt length {start} "
                             f"exceeds max_len {self.max_len}")
        keys, hits, extra_cow, resume = (self._prefix_plan(req)
                                         if plan is None else plan)
        self.pool.reserve(slot, self._reserved_blocks(req), hits=hits,
                          extra_cow=extra_cow, written=resume)
        if hits:
            self._tables_dirty = True        # attach rewrote the table row
            self.prefix_events["prefix_hits"] += 1
            self.prefix_events["prefix_tokens_skipped"] += resume
        # start_pos > 0 resumes a cached prefix: the table already maps the
        # shared blocks, so prefill picks up at the boundary
        model_api.reset_slot(self.cache, slot)
        sp = req.params
        self.slot_temp[slot] = sp.temperature
        self.slot_top_k[slot] = sp.top_k
        self.slot_top_p[slot] = sp.top_p
        self.slot_key[slot] = sampling.request_key(sp.seed, req.rid)
        self.active[slot] = True
        self.slot_req[slot] = req
        self.slot_out[slot] = []
        self.slot_admitted[slot] = self.step_count
        self.slot_prefill_off[slot] = resume
        self.slot_pos[slot] = resume
        self.slot_chain[slot] = keys
        self.slot_cacheable[slot] = self.prefix_cache

    def _release_keys(self, slot: int) -> Sequence[bytes]:
        """Content keys for every block the retiring slot fully wrote:
        prompt *and* generated tokens (KV position p holds token p of
        ``prompt ++ out``), so a follow-up whose prompt extends this
        conversation matches the decode-produced blocks too."""
        req = self.slot_req[slot]
        bs = self.pool.spec.block_size
        full = int(self.slot_pos[slot]) // bs
        if full == 0:
            return ()
        toks = np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(self.slot_out[slot], np.int32)])
        full = min(full, len(toks) // bs)
        return paged_mod.chain_keys(self._prefix_seed, toks[:full * bs], bs)

    def _free_slot(self, slot: int) -> None:
        """Clear a slot's host state and return (or cache) its blocks."""
        keys = self._release_keys(slot) if self.slot_cacheable[slot] else ()
        self.active[slot] = False
        self.slot_req[slot] = None
        self.slot_out[slot] = []
        self.pool.release(slot, keys=keys)   # free-on-retire (or cache)
        self.slot_prefill_off[slot] = None
        self.slot_chain[slot] = ()
        self.slot_cacheable[slot] = False
        self._tables_dirty = True
        if self.validate_pool:
            self.pool.check()                # leaks surface at retire time

    def _retire_slot(self, slot: int, reason: str) -> None:
        req = self.slot_req[slot]
        self.finished[req.rid] = FinishedRequest(
            req.rid, np.asarray(self.slot_out[slot], np.int32),
            len(req.prompt), int(self.slot_admitted[slot]), self.step_count,
            reason, preemptions=req.preempt_count)
        self._free_slot(slot)
        if reason in self.events:
            self.events[reason] += 1

    def _maybe_retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        out = self.slot_out[slot]
        eos = self._eos_of(req)
        if eos >= 0 and out and out[-1] == eos:
            self._retire_slot(slot, "eos")
        elif len(out) >= self._budget(req):
            self._retire_slot(slot, "length")

    def _preempt_slot(self, slot: int) -> Request:
        """Evict a live request: free its slot and blocks, drop its partial
        stream and return it for requeueing (replay from the prompt gives the
        same stream). Ages the request's effective priority."""
        req = self.slot_req[slot]
        req.preempt_count += 1               # aging: no starvation
        self._free_slot(slot)
        self.events["preemptions"] += 1
        return req

    def _eff_priority(self, req: Request) -> int:
        return req.priority + req.preempt_count

    def _next_candidate(self) -> Optional[int]:
        """Queue index of the next request to admit: highest effective
        priority among arrived requests; equal priorities keep FIFO order."""
        best = None
        for i, req in enumerate(self.queue):
            if req.arrival > self.step_count:
                continue                     # trace replay: not yet arrived
            if (best is None or self._eff_priority(req)
                    > self._eff_priority(self.queue[best])):
                best = i
        return best

    def _plan_preemption(self, req: Request, fresh: int,
                         hits: Sequence[int]) -> Optional[List[int]]:
        """Victim slots to evict so ``req`` can reserve ``fresh`` new blocks
        (on top of attaching the ``hits`` prefix blocks), or None. Only
        strictly-lower-effective-priority slots qualify, most recently
        admitted first. Pure planning: no side effects."""
        pri = self._eff_priority(req)
        victims = sorted(
            (s for s in np.flatnonzero(self.active)
             if self._eff_priority(self.slot_req[s]) < pri),
            key=lambda s: (-int(self.slot_admitted[s]), -s))
        chosen: List[int] = []
        for s in victims:
            if self.pool.can_admit(fresh, hits, exclude=chosen):
                break
            chosen.append(s)
        if not self.pool.can_admit(fresh, hits, exclude=chosen):
            return None
        return chosen

    def _enforce_deadlines(self) -> None:
        """Retire every live or queued request past its step budget
        (measured from ``arrival`` in engine steps: deterministic)."""
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            age = self.step_count - req.arrival
            if (req.ttft_deadline is not None and not self.slot_out[slot]
                    and age >= req.ttft_deadline):
                self._retire_slot(slot, "deadline_ttft")
            elif req.total_deadline is not None and age >= req.total_deadline:
                self._retire_slot(slot, "deadline_total")
        if any(r.ttft_deadline is not None or r.total_deadline is not None
               for r in self.queue):
            keep = collections.deque()
            for req in self.queue:
                age = self.step_count - req.arrival
                reason = None
                if req.arrival <= self.step_count:
                    if (req.ttft_deadline is not None
                            and age >= req.ttft_deadline):
                        reason = "deadline_ttft"
                    elif (req.total_deadline is not None
                          and age >= req.total_deadline):
                        reason = "deadline_total"
                if reason:
                    self._finish_unstarted(req, reason)
                else:
                    keep.append(req)
            self.queue = keep

    def _admit_ready(self) -> None:
        for slot in range(self.n_slots):
            if not self.queue:
                return
            if self.active[slot]:
                continue
            idx = self._next_candidate()
            if idx is None:
                return                       # nothing has arrived yet
            req = self.queue[idx]
            need = self._reserved_blocks(req)
            if need > self.pool.spec.n_blocks:
                raise ValueError(
                    f"request {req.rid} needs {need} blocks but the pool "
                    f"holds {self.pool.spec.n_blocks}: raise n_blocks or "
                    "lower max_new_tokens")
            # the prefix plan is committed here: preempting victims may
            # surface new cached blocks, but re-matching after eviction could
            # pin more residents than the feasibility check saw
            plan = self._prefix_plan(req)
            keys, hits, extra_cow, resume = plan
            fresh = need - len(hits) + extra_cow
            if not self.pool.can_admit(fresh, hits):
                victims = self._plan_preemption(req, fresh, hits)
                if victims is None:
                    return                   # out of blocks: backpressure
                del self.queue[idx]
                # evicted requests go back to the queue front
                for s in victims:
                    self.queue.appendleft(self._preempt_slot(s))
                self._admit_paged(slot, req, plan)
                continue
            del self.queue[idx]
            self._admit_paged(slot, req, plan)

    def _paged_step(self) -> None:
        """One mixed prefill+decode chunk step over all slots."""
        live = np.flatnonzero(self.active)
        prefilling = [s for s in live if self.slot_prefill_off[s] is not None]
        # step width: the widest remaining chunk this step needs (bounded by
        # prefill_chunk); decode rows in a mixed step pay for the width
        t = max((min(self.prefill_chunk,
                     len(self.slot_req[s].prompt) - self.slot_prefill_off[s])
                 for s in prefilling), default=1)
        b = self.n_slots
        q_len = np.zeros(b, np.int64)
        emit = np.zeros(b, bool)
        tokens = np.zeros((b, t), np.int64)
        clens = {}
        for s in live:
            req = self.slot_req[s]
            off = self.slot_prefill_off[s]
            if off is not None:              # prompt chunk
                start = len(req.prompt)
                clen = min(t, start - off)
                clens[s] = clen
                q_len[s] = clen
                emit[s] = off + clen == start
                tokens[s, :clen] = req.prompt[off:off + clen]
                self._tables_dirty |= self.pool.ensure(s, off + clen)
            else:                            # decode row
                q_len[s] = 1
                emit[s] = True
                tokens[s, 0] = self.slot_out[s][-1]
                self._tables_dirty |= self.pool.ensure(
                    s, int(self.slot_pos[s]) + 1)
        self._apply_cow()
        if self._tables_dirty:
            self.cache["block_tables"].copy_(torch.from_numpy(self.pool.tables))
            self._tables_dirty = False
        # one upload per step: tokens | positions | q_len
        packed = torch.from_numpy(np.concatenate(
            [tokens, self.slot_pos[:, None], q_len[:, None]], axis=1)
        ).to(self.device)
        logits, self.cache = self._chunk(self.params, packed[:, :t],
                                         self.cache, packed[:, t],
                                         packed[:, t + 1])
        # token i of a request samples with fold_in(base key, i)
        keys = ([sampling.fold_in(self.slot_key[s], len(self.slot_out[s]))
                 for s in range(b)] if (self.slot_temp > 0).any() else [0] * b)
        tok = sampling.sample_tokens(logits[:, 0], self.slot_temp,
                                     self.slot_top_k, self.slot_top_p, keys)
        tok_np = tok.cpu().numpy()           # the one per-step device sync
        self.host_syncs += 1
        self.step_count += 1
        if len(prefilling) < len(live):
            self.decode_steps += 1
        self.occ["slot_steps"] += b
        self.occ["slot_active_steps"] += len(live)
        self.occ["block_steps"] += self.pool.spec.n_blocks
        self.occ["block_alloc_steps"] += self.pool.allocated_blocks
        for s in live:
            if s in clens:
                clen = clens[s]
                self.slot_prefill_off[s] += clen
                self.slot_pos[s] += clen
                self.occ["prefill_tokens"] += clen
                if self.slot_prefill_off[s] == len(self.slot_req[s].prompt):
                    self.slot_prefill_off[s] = None
                    if self.slot_cacheable[s]:
                        # prompt fully resident: publish its full blocks so
                        # concurrent same-prefix admissions share them now
                        self.pool.publish(s, self.slot_chain[s])
            else:
                self.slot_pos[s] += 1
                self.occ["decode_tokens"] += 1
            if emit[s]:
                self.slot_out[s].append(int(tok_np[s]))
                self._maybe_retire(s)

    def _apply_cow(self) -> None:
        """Apply pending copy-on-write block clones on the device (one call
        over every pool leaf)."""
        copies = self.pool.drain_copies()
        if not copies:
            return
        src = torch.tensor([c[0] for c in copies], device=self.device)
        dst = torch.tensor([c[1] for c in copies], device=self.device)
        self.cache = self._copy_blocks(self.cache, src, dst)

    def step(self) -> None:
        """Enforce deadlines, admit what fits, run one batched ragged step."""
        self._enforce_deadlines()
        self._admit_ready()
        self.peak_active = max(self.peak_active, int(self.active.sum()))
        if not self.active.any():
            self.step_count += 1             # idle tick (waiting on arrivals)
            return
        self._paged_step()

    def run(self, requests: Sequence[Request] = (),
            max_steps: Optional[int] = None) -> Dict[int, FinishedRequest]:
        """Drive the engine until every submitted request has finished."""
        for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(req)
        limit = max_steps if max_steps is not None else 10 ** 9
        while (self.queue or self.active.any()) and self.step_count < limit:
            self.step()
        return dict(self.finished)

    @property
    def stats(self) -> Dict[str, Any]:
        gen = sum(len(f.tokens) for f in self.finished.values())
        occ = self.occ
        out: Dict[str, Any] = {
            "steps": self.step_count, "decode_steps": self.decode_steps,
            "generated_tokens": gen, "finished": len(self.finished),
            "peak_active_slots": self.peak_active,
            "multi_step": self.multi_step,
            "host_syncs": self.host_syncs,
            "syncs_per_token": round(self.host_syncs / max(1, gen), 4)}
        out.update(self.events)              # reliability counters
        out.update({
            # occupancy: fraction of slot-steps / pool-block-steps that held
            # live work, plus the prefill-vs-decode token split
            "slot_utilization": round(occ["slot_active_steps"]
                                      / max(1, occ["slot_steps"]), 3),
            "block_utilization": round(occ["block_alloc_steps"]
                                       / max(1, occ["block_steps"]), 3),
            "peak_allocated_blocks": self.pool.peak_allocated,
            "prefill_tokens": occ["prefill_tokens"],
            "decode_tokens": occ["decode_tokens"],
            "prefix_cache": self.prefix_cache,
            "prefix_shared_blocks": self.pool.shared_attached,
            "prefix_cow_copies": self.pool.cow_copies,
            "prefix_evicted_blocks": self.pool.evicted_blocks,
            "prefix_cached_blocks": self.pool.cached_blocks,
        })
        out.update(self.prefix_events)
        return out


def make_poisson_trace(n_requests: int, *, rate: float, vocab_size: int,
                       prompt_lens: Sequence[int] = (8, 12, 16),
                       gen_lens: Sequence[int] = (4, 8, 12, 16, 24),
                       seed: int = 0,
                       params: sampling.SamplingParams = sampling.GREEDY
                       ) -> List[Request]:
    """Synthetic ragged request trace with Poisson arrivals: exponential
    inter-arrival gaps of mean ``1/rate`` engine steps, prompt and generation
    lengths drawn uniformly from the given pools. The same numpy draws as
    the reference, so the same seed gives the same trace."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.choice(prompt_lens))
        out.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.choice(gen_lens)),
            params=params,
            arrival=int(t)))
    return out
