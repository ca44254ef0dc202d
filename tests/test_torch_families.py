"""The port's other dense configs held against the JAX package, on the CPU.

``reduced`` gemma2-27b (attention and final softcaps, alternating 8-token
windows), gemma3-12b (local:global windows) and qwen2.5-14b (QKV bias): 4
layers, d_model 64, head dim 16, vocab 256, built from the JAX package's
``init_params(PRNGKey(0))`` through ``convert.params_from_numpy``; prompts
from a numpy seed. Prefill logits, then teacher-forced decode logits (both
packages fed the same tokens), under ``exact`` and ``mxu_int8`` (bound, as
the server runs). The windowed configs also run with
``init_cache(..., windowed=False)`` and a 24-token prompt, past the 8-token
window: the uniform cache whose windowed layers mask their window in
attention, on both sides.

Logit tolerance: 4 bf16 ulps (``LOGIT_ATOL`` = 0.125 at |logits| < 8), as
``tests/test_torch_model.py`` states it: the two frameworks round bf16
intermediates at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core import gemm as j_gemm
from repro.models import get_model as j_get_model
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import gemm
from repro_torch.models import get_model

LOGIT_ATOL = 0.125
BATCH, N_DECODE = 2, 3


def _check_logits(want, got, what):
    d = np.abs(np.asarray(want, np.float32) - got.numpy())
    assert d.max() <= LOGIT_ATOL, f"{what}: max |diff| {d.max()}"


def _run(arch, prompt, backends, windowed=None):
    """Prefill on ``prompt`` tokens and N_DECODE teacher-forced decode steps
    in both packages, each backend; logits held within LOGIT_ATOL."""
    cfg = reduced(ARCHS[arch])
    tcfg = t_reduced(T_ARCHS[arch])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jm, tm = j_get_model(cfg), get_model(tcfg)
    jp0 = jm.init_params(jax.random.PRNGKey(0))
    tp0 = params_from_numpy(jax.tree.map(np.asarray, jp0))
    rng = np.random.default_rng(len(arch) + prompt)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (BATCH, N_DECODE)).astype(np.int32)
    kw = {} if windowed is None else {"windowed": windowed}
    for backend in backends:
        jpol = j_gemm.GemmPolicy(backend=backend)
        pol = gemm.GemmPolicy(backend=backend)
        jp, tp = jp0, tp0
        if backend != "exact":
            jp, tp = jm.bind_params(jp0, jpol), tm.bind_params(tp0, pol)
        jprefill = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c,
                                                      policy=jpol))
        jdecode = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos,
                                                              policy=jpol))
        jc = jm.init_cache(BATCH, prompt + N_DECODE, **kw)
        tc = tm.init_cache(BATCH, prompt + N_DECODE, **kw)
        jl, jc = jprefill(jp, jnp.asarray(prompts), jc)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts).long()},
                            tc, policy=pol)
        assert tl.shape == (BATCH, 1, cfg.vocab_size)
        what = f"{arch} {backend} prompt {prompt}"
        _check_logits(jl, tl, f"{what} prefill")
        for i in range(N_DECODE):
            tok = feed[:, i:i + 1]
            jl, jc = jdecode(jp, jnp.asarray(tok), jc, jnp.int32(prompt + i))
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                                    prompt + i, policy=pol)
            _check_logits(jl, tl, f"{what} decode step {i}")


@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-12b", "qwen2.5-14b"])
def test_family_logits_match_reference(arch):
    """Within the window: prompt 5 and 3 decode steps, max_len 8."""
    _run(arch, 5, ("exact", "mxu_int8"))


def test_windowed_false_past_the_window_matches_reference():
    """A 24-token prompt and 3 decode steps over the uniform cache
    (``windowed=False``), 3x the 8-token window: the first test in which the
    port's window mask bites, in prefill (the flash route) and in decode."""
    for arch in ("gemma3-12b", "gemma2-27b"):
        _run(arch, 24, ("exact", "mxu_int8"), windowed=False)


def test_ring_cache_still_raises():
    """``windowed=None`` past the window picks the two-tier ring cache, as
    the reference does; the port has no ring cache yet and says so."""
    tm = get_model(t_reduced(T_ARCHS["gemma3-12b"]))
    with pytest.raises(NotImplementedError, match="ring"):
        tm.init_cache(1, 24)
    with pytest.raises(NotImplementedError, match="ring"):
        tm.init_cache(1, 4, windowed=True)
    assert tm.init_cache(1, 8)["k"].shape[2] == 8      # within the window
    assert tm.init_cache(1, 24, windowed=False)["k"].shape[2] == 24
