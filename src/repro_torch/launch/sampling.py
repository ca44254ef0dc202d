"""Per-slot token sampling for the continuous-batching engine (port of
``repro/launch/sampling.py``).

Every slot of the batched step carries its own sampling parameters and its
own random stream, so a request's sampled tokens are a function of (request
seed, request id, token index) only, never of which other requests share its
batch. The engine derives one integer key per request (`request_key`) and
folds the token index into it each step (`fold_in`); `sample_tokens` seeds a
``torch.Generator`` with each sampled slot's key to draw that slot's uniform
number. The streams cannot reproduce ``jax.random``'s bits, so stochastic
sampling is held to its own determinism contract, not against the reference;
greedy sampling (temperature 0) is an argmax and equals the reference's.

Knobs (all per slot):

* ``temperature`` — 0 selects greedy argmax (the parity reference path);
  > 0 divides logits before sampling.
* ``top_k``       — keep only the k highest logits (0 disables).
* ``top_p``       — nucleus sampling: keep the smallest set of tokens whose
  probability mass reaches p (1.0 disables). Applied after top-k.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (see module docstring)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


GREEDY = SamplingParams()


def _digest(*ints: int) -> int:
    data = b"".join(int(i).to_bytes(8, "little", signed=True) for i in ints)
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little") >> 1                     # 63 bits


def request_key(seed: int, rid: int) -> int:
    """Base random key of one request: the seed folded with the request id."""
    return _digest(seed, rid)


def fold_in(key: int, i: int) -> int:
    """The key of token ``i`` of the request whose base key is ``key``."""
    return _digest(key, i)


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p,
                  keys: Sequence[int]) -> torch.Tensor:
    """Sample one token per slot.

    logits: (B, V) float on any device; temperature (B,), top_k (B,) and
    top_p (B,) host arrays; keys: B per-slot integer keys (`fold_in`).
    Returns (B,) int64 on the logits' device. Slots with temperature == 0
    take the greedy argmax and ignore their key.

    A batch where every slot is greedy (the serving default) returns the
    argmax without the sorts the top-k/top-p filters need; the sampled path
    gives greedy slots the same argmax, so outputs do not depend on the
    batch's mix.
    """
    temperature = np.asarray(temperature, np.float32)
    greedy = torch.argmax(logits, dim=-1)
    hot = np.flatnonzero(temperature > 0.0)
    if hot.size == 0:
        return greedy
    dev = logits.device
    rows = torch.from_numpy(hot).to(dev)
    l = logits[rows].to(torch.float32) / torch.from_numpy(
        np.maximum(temperature[hot], 1e-6)).to(dev)[:, None]
    v = l.shape[-1]
    k = torch.from_numpy(np.asarray(top_k, np.int64)[hot]).to(dev)
    p = torch.from_numpy(np.asarray(top_p, np.float32)[hot]).to(dev)
    # top-k: keep the k highest logits (ties at the threshold all survive)
    desc = torch.sort(l, dim=-1, descending=True).values
    kth = desc.gather(1, (k.clamp(1, v) - 1)[:, None])
    l = torch.where((k[:, None] > 0) & (l < kth), float("-inf"), l)
    # top-p: smallest prefix of the sorted distribution with mass >= p
    probs = torch.softmax(l, dim=-1)
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    first = torch.argmax((torch.cumsum(sorted_p, dim=-1) >= p[:, None])
                         .to(torch.int8), dim=-1)
    thr = sorted_p.gather(1, first[:, None])
    l = torch.where((p[:, None] < 1.0) & (probs < thr), float("-inf"), l)
    # inverse-CDF draw with one uniform number per slot from its own key
    u = torch.tensor([torch.rand((), generator=torch.Generator()
                                 .manual_seed(int(keys[i]))).item()
                      for i in hot], dtype=torch.float32, device=dev)
    cdf = torch.cumsum(torch.softmax(l, dim=-1), dim=-1)
    pick = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None],
                              right=True).clamp_max(v - 1)
    out = greedy.clone()
    out[rows] = pick[:, 0]
    return out
