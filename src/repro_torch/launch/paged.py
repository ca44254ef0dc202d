"""Paged KV-cache block pool (port of ``repro/launch/paged.py``): free-list
allocator + per-slot block tables with refcounted copy-on-write prefix
sharing.

Pure host-side Python with no framework in it, so it is a copy of the
reference module and behaves identically (``tests/test_torch_engine.py``
drives both on the same random trace).

Each full-attention cache leaf is a device pool
``(L, n_blocks + 1, block_size, KH, hd)`` and each slot owns a block-table
row ``(max_blocks,)`` mapping its logical positions to pool blocks
(``pos // block_size`` -> block id, ``pos % block_size`` -> offset). Attention
reads walk the table (``models.layers.chunked_attention``; on the card the
paged-attention kernel), writes scatter to ``(block, offset)`` pairs; the
table is host-authoritative and uploaded to the step when it changes.

Allocation protocol (all host-side, O(1) per event):

* **reserve-on-admit** — admission reserves the request's worst-case block
  footprint ``ceil((prompt_len + token_budget - 1) / block_size)``; a request
  is admitted only while every live slot's remaining *fresh* allocations fit
  in ``free + evictable`` blocks, so a later alloc-on-write never fails
  mid-stream.
* **alloc-on-write** — blocks leave the free list only when a chunk/decode
  write first touches them.
* **free-on-retire** — retirement returns every block the slot owned and
  clears its table row back to the dump block.

**Prefix caching** layers content identity on top: per-block refcounts, a
rolling blake2b chain key per full block (`chain_keys`), a prefix index from
keys to resident blocks (`match_prefix`, ``reserve(hits=...)``),
copy-on-write of shared blocks before a write (`ensure`, `drain_copies`), an
LRU of unreferenced cached blocks evicted deepest-first only under pressure,
and `invalidate` to drop the whole index.

Block index ``n_blocks`` (the last pool row) is the **dump block**: masked
writes (padded chunk tokens, inactive slots) are redirected there, and no
live table row maps it for a valid position.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Pool geometry: ``n_blocks`` usable blocks of ``block_size`` tokens."""
    n_blocks: int
    block_size: int

    @property
    def dump(self) -> int:
        """Pool index of the scratch block masked writes are redirected to."""
        return self.n_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.block_size)


def cache_seed(cfg, policy) -> bytes:
    """Chain seed digest: everything a block's KV bits depend on besides the
    token ids. Two pools may share a block only under the same model config
    and GEMM policy — a backend or quantization change must miss."""
    return hashlib.blake2b(repr((cfg, policy)).encode(),
                           digest_size=16).digest()


def chain_keys(seed: bytes, tokens, block_size: int,
               n_blocks: Optional[int] = None) -> Tuple[bytes, ...]:
    """Rolling content keys for the leading full blocks of ``tokens``.

    ``key_i`` digests the seed plus tokens ``[0, (i+1) * block_size)`` — a
    chain, so a block key identifies the whole prefix behind it, not just
    the block's own tokens. Keys exist only for *full* blocks; a partial
    trailing block has no identity and is never shared.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    n = len(toks) // block_size if n_blocks is None else int(n_blocks)
    out: List[bytes] = []
    h = seed
    for i in range(n):
        blk = toks[i * block_size:(i + 1) * block_size]
        h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
        out.append(h)
    return tuple(out)


class BlockPool:
    """Host-side free-list allocator over a paged KV pool (see module docs)."""

    def __init__(self, spec: PagedSpec, n_slots: int, max_len: int):
        if spec.block_size < 1 or spec.n_blocks < 1:
            raise ValueError(f"bad paged spec {spec}")
        self.spec = spec
        self.n_slots = n_slots
        self.max_blocks = spec.blocks_for(max_len)
        # LIFO free list: retired blocks are reused first (cache-friendly)
        self._free: List[int] = list(range(spec.n_blocks - 1, -1, -1))
        self.tables = np.full((n_slots, self.max_blocks), spec.dump, np.int32)
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]
        self._reserved = np.zeros(n_slots, np.int64)
        # prefix-cache state: per-block refcount (owner tables mapping it),
        # key index (content key -> block), per-block key, and the LRU of
        # unreferenced-but-cached blocks (insertion order == release recency)
        self._ref = np.zeros(spec.n_blocks, np.int64)
        self._index: Dict[bytes, int] = {}
        self._key_of: Dict[int, bytes] = {}
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # per-slot admit-time budget of *fresh* (non-shared) allocations and
        # the written-token watermark bounding the next COW sweep
        self._fresh = np.zeros(n_slots, np.int64)
        self._written = np.zeros(n_slots, np.int64)
        self._pending_copies: List[Tuple[int, int]] = []
        self.peak_allocated = 0
        self.cow_copies = 0
        self.evicted_blocks = 0
        self.shared_attached = 0
        self.invalidations = 0

    # --- accounting ---------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        """Blocks assignable to a fresh allocation: truly free + evictable
        cached blocks (an LRU resident costs nothing under pressure)."""
        return len(self._free) + len(self._lru)

    @property
    def allocated_blocks(self) -> int:
        """Distinct blocks held by live slots (a shared block counts once)."""
        return self.spec.n_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Blocks the prefix index maps (pinned or evictable)."""
        return len(self._index)

    @property
    def evictable_blocks(self) -> int:
        return len(self._lru)

    @property
    def reserved_blocks(self) -> int:
        return int(self._reserved.sum())

    def can_reserve(self, n_blocks: int) -> bool:
        """Would a request needing ``n_blocks`` fresh blocks fit?"""
        return self.can_admit(n_blocks)

    def can_admit(self, n_fresh: int, hits: Sequence[int] = (),
                  exclude: Sequence[int] = ()) -> bool:
        """Admission feasibility: after attaching ``hits`` and reserving
        ``n_fresh`` fresh blocks, does every live slot's outstanding fresh
        budget still fit in free + evictable blocks?

        ``exclude`` names slots assumed preempted first (planning only):
        their fresh budgets drop out and any block they alone hold returns
        to the assignable set. This is the invariant that makes
        alloc-on-write infallible for live requests.
        """
        excl = {int(s) for s in exclude}
        owners: collections.Counter = collections.Counter()
        for s in range(self.n_slots):
            if s in excl:
                continue
            owners.update(self._owned[s])
        # blocks only the excluded victims hold come back to the pool...
        gain = len({b for s in excl for b in self._owned[s]
                    if owners[b] == 0})
        # ...while every hit with no surviving owner newly pins one resident
        pins = sum(1 for b in set(hits) if owners[b] == 0)
        outstanding = int(sum(self._fresh[s] for s in range(self.n_slots)
                              if s not in excl))
        avail = len(self._free) + len(self._lru) + gain - pins
        return n_fresh + outstanding <= avail

    def match_prefix(self, keys: Sequence[bytes]) -> List[int]:
        """Resident blocks for the longest leading run of ``keys``."""
        out: List[int] = []
        for key in keys:
            blk = self._index.get(key)
            if blk is None:
                break
            out.append(blk)
        return out

    # --- lifecycle ----------------------------------------------------------

    def reserve(self, slot: int, n_blocks: int, *,
                hits: Sequence[int] = (), extra_cow: int = 0,
                written: int = 0) -> None:
        """Reserve-on-admit; ``hits`` (from `match_prefix`) are attached to
        the slot's table immediately (refcount + 1, un-parked from the LRU).

        ``extra_cow`` widens the fresh budget for admissions that must
        copy-on-write into an attached block (whole-prompt-cached resume);
        ``written`` seeds the watermark at the resume offset so the first
        `ensure` sweeps exactly the recomputed window.
        """
        if self._reserved[slot] or self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        if n_blocks > self.max_blocks:
            raise ValueError(f"request needs {n_blocks} blocks but a slot "
                             f"table holds only {self.max_blocks}")
        hits = list(hits)
        if len(hits) > n_blocks:
            raise ValueError(f"{len(hits)} prefix hits exceed the "
                             f"{n_blocks}-block reservation")
        fresh = n_blocks - len(hits) + int(extra_cow)
        if not self.can_admit(fresh, hits):
            raise RuntimeError(
                f"out of blocks: need {fresh} fresh + {len(hits)} shared, "
                f"{len(self._free)} free + {len(self._lru)} evictable — "
                "admission should have backpressured")
        for i, blk in enumerate(hits):
            assert blk in self._key_of, "prefix hit lost its content key"
            if self._ref[blk] == 0:
                del self._lru[blk]           # pinned: no longer evictable
            self._ref[blk] += 1
            self.tables[slot, i] = blk
            self._owned[slot].append(blk)
        self._reserved[slot] = n_blocks
        self._fresh[slot] = fresh
        self._written[slot] = int(written)
        self.shared_attached += len(hits)
        self.peak_allocated = max(self.peak_allocated, self.allocated_blocks)

    def _take_block(self, slot: int) -> int:
        """One fresh block: free list first, then evict the LRU head.
        Eviction drops the victim's key — it provably has refcount 0."""
        if self._fresh[slot] <= 0:
            raise RuntimeError(
                f"slot {slot} exceeded its admit-time fresh-block budget")
        self._fresh[slot] -= 1
        if self._free:
            return self._free.pop()
        if self._lru:
            blk, _ = self._lru.popitem(last=False)
            assert self._ref[blk] == 0, "evicting a referenced block"
            del self._index[self._key_of.pop(blk)]
            self.evicted_blocks += 1
            return blk
        raise RuntimeError("out of blocks: no free or evictable block for a "
                           "reserved allocation — accounting is broken")

    def ensure(self, slot: int, upto_tokens: int) -> bool:
        """Alloc-on-write: own every block covering positions < upto_tokens,
        copy-on-write first. Returns True when the table row changed.

        The sweep covers only the *new* write window — positions between the
        slot's written watermark and ``upto_tokens``. A window block some
        other table still maps (refcount > 1) is cloned: a fresh block
        replaces it in this slot's table and the device copy is queued for
        `drain_copies`. A window block this slot holds exclusively but the
        prefix index still maps is detached from the index (the rewrite is
        bit-identical, but index entries must never be written). Blocks
        below the watermark — the shared prefix — are never touched.
        """
        upto = int(upto_tokens)
        need = self.spec.blocks_for(upto)
        if need > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot} writing past its reservation "
                f"({need} > {self._reserved[slot]} blocks)")
        bs = self.spec.block_size
        owned = self._owned[slot]
        w = int(self._written[slot])
        changed = False
        if upto > w:
            for i in range(w // bs, min(need, len(owned))):
                blk = owned[i]
                if self._ref[blk] > 1:       # shared: clone before writing
                    dst = self._take_block(slot)
                    self._pending_copies.append((blk, dst))
                    self._ref[blk] -= 1
                    self._ref[dst] = 1
                    owned[i] = dst
                    self.tables[slot, i] = dst
                    self.cow_copies += 1
                    changed = True
                elif blk in self._key_of:    # exclusive but indexed: detach
                    del self._index[self._key_of.pop(blk)]
            self._written[slot] = upto
        while len(owned) < need:
            blk = self._take_block(slot)
            self._ref[blk] = 1
            self.tables[slot, len(owned)] = blk
            owned.append(blk)
            changed = True
        self.peak_allocated = max(self.peak_allocated, self.allocated_blocks)
        return changed

    def ensure_horizon(self, slot: int, upto_tokens: int) -> bool:
        """Horizon-aware alloc-on-write: like :meth:`ensure` (including the
        copy-on-write sweep), but clamps the target to the slot's admit-time
        reservation.

        A multi-step horizon conservatively asks for coverage of ``pos + n``
        tokens before dispatch; near the end of a request that overshoots
        the reservation (the final token's KV is never written, and the
        device-side retirement mask stops all writes at the budget), so the
        overshoot is provably never touched and clamping is safe. The
        reserve-on-admit invariant — a live request can never fail
        alloc-on-write — carries over unchanged.
        """
        cap = int(self._reserved[slot]) * self.spec.block_size
        return self.ensure(slot, min(int(upto_tokens), cap))

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Pending COW ``(src, dst)`` block copies; the engine applies them
        on device before the next dispatch. Draining transfers ownership."""
        out, self._pending_copies = self._pending_copies, []
        return out

    def publish(self, slot: int, keys: Sequence[bytes]) -> None:
        """Insert the slot's leading fully-written blocks into the prefix
        index (key ``i`` for owned block ``i``) so concurrent admissions can
        share them while the slot is still live. Blocks already keyed, or
        keys already mapped, are left alone."""
        owned = self._owned[slot]
        for i, key in enumerate(keys):
            if i >= len(owned):
                break
            blk = owned[i]
            if blk not in self._key_of and key not in self._index:
                self._index[key] = blk
                self._key_of[blk] = key

    def release(self, slot: int, keys: Sequence[bytes] = ()) -> None:
        """Free-on-retire: drop the slot's references, clear its table row.

        ``keys`` (one per leading fully-written block) index the released
        blocks for future prefix matches; an unreferenced block parks in the
        LRU if it carries a key and returns to the free list otherwise.
        """
        frees: List[int] = []
        parked: List[int] = []
        for i, blk in enumerate(self._owned[slot]):
            if (i < len(keys) and blk not in self._key_of
                    and keys[i] not in self._index):
                self._index[keys[i]] = blk
                self._key_of[blk] = keys[i]
            self._ref[blk] -= 1
            assert self._ref[blk] >= 0, f"double free of block {blk}"
            if self._ref[blk] == 0:
                if blk in self._key_of:
                    parked.append(blk)
                else:
                    frees.append(blk)
        # park chain-deepest first: a match needs an unbroken *leading* run,
        # so the LRU head (evicted first) must be the tail of a released
        # chain — eviction then shortens cached prefixes from the back
        # instead of beheading them
        for blk in reversed(parked):
            self._lru[blk] = None            # most recently released = MRU
        self._free.extend(reversed(frees))
        self._owned[slot] = []
        self._reserved[slot] = 0
        self._fresh[slot] = 0
        self._written[slot] = 0
        self.tables[slot, :] = self.spec.dump

    def invalidate(self) -> None:
        """Drop the whole prefix index (cache-fault quarantine): evictable
        cached blocks return to the free list, pinned blocks stay owned but
        can never be matched again."""
        self._free.extend(self._lru)
        self._lru.clear()
        self._index.clear()
        self._key_of.clear()
        self.invalidations += 1

    # --- invariants (exercised by the property tests) -----------------------

    def check(self) -> None:
        """No leaks or double-frees, refcounts match the tables, the LRU is
        exactly the ref-0 cached set, shared blocks are position-aligned."""
        owners: collections.Counter = collections.Counter()
        for lst in self._owned:
            assert len(set(lst)) == len(lst), "block aliased within a slot"
            owners.update(lst)
        uniq, free, lru = set(owners), set(self._free), set(self._lru)
        assert len(self._free) == len(free), "free-list double entry"
        assert not (uniq & free), "block simultaneously owned and free"
        assert not (lru & free), "cached block also on the free list"
        assert not (lru & uniq), "cached-unreferenced block still owned"
        assert len(uniq) + len(free) + len(lru) == self.spec.n_blocks, \
            "block leak: owned + free + cached != pool"
        for blk in range(self.spec.n_blocks):
            assert self._ref[blk] == owners.get(blk, 0), \
                f"refcount leak on block {blk}"
        assert lru == {b for b in self._key_of if self._ref[b] == 0}, \
            "LRU out of sync with the ref-0 cached set"
        assert len(self._index) == len(self._key_of), \
            "index/key_of size mismatch"
        for key, blk in self._index.items():
            assert self._key_of.get(blk) == key, "index/key bijection broken"
        cols: Dict[int, set] = {}
        for slot, lst in enumerate(self._owned):
            assert len(lst) <= self._reserved[slot], \
                f"slot {slot} owns more than it reserved"
            assert self._fresh[slot] >= 0, \
                f"slot {slot} fresh budget went negative"
            row = self.tables[slot]
            assert list(row[:len(lst)]) == lst, f"slot {slot} table mismatch"
            assert (row[len(lst):] == self.spec.dump).all(), \
                f"slot {slot} table maps unowned positions"
            for i, blk in enumerate(lst):
                cols.setdefault(blk, set()).add(i)
        for blk, cs in cols.items():
            if owners[blk] > 1:
                assert len(cs) == 1, \
                    f"shared block {blk} mapped at different table columns"
        assert int(self._fresh.sum()) <= len(self._free) + len(self._lru), \
            "outstanding fresh budgets exceed assignable blocks"


def default_spec(n_slots: int, max_len: int, block_size: int) -> PagedSpec:
    """Pool sized to the contiguous engine's budget: every slot can still hold
    ``max_len`` tokens, so admission never backpressures more than the
    contiguous engine would — capacity wins come from setting ``n_blocks``
    below this (or ``n_slots`` above the contiguous count at equal budget)."""
    return PagedSpec(n_blocks=n_slots * (-(-max_len // block_size)),
                     block_size=block_size)
