"""The port's dense model and lockstep server held against the JAX package.

``reduced(smollm-360m)`` (2 layers, d_model 64, vocab 256) with the JAX
package's ``init_params(PRNGKey(0))`` crossed into the port through
``convert.params_from_numpy``; prompts from a numpy seed. The port runs on
the CPU (its kernel wrappers take their plain versions), JAX with its Pallas
kernels in interpret mode.

Logit tolerance: the logits are the bf16 output of the vocab projection
(8 significant bits). The two frameworks round bf16 intermediates (norm
outputs, RoPE, SiLU products, residual adds) at different places, which moves
a logit by a few bf16 ulps and, under the int8 backends, can move one
activation by one quantization level. With |logits| < 8 here one bf16 ulp is
at most 2^-5, so the bound is 4 ulps (0.125) per logit and 1 ulp (0.03125)
on the mean. Greedy streams must agree, except where the port's top-2 margin
at the first differing position is within that bound (a flagged tie).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.core import gemm as j_gemm
from repro.launch import serve as j_serve
from repro.models import get_model as j_get_model
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import gemm
from repro_torch.launch import serve
from repro_torch.models import get_model

LOGIT_ATOL = 0.125
LOGIT_MEAN_ATOL = 0.03125
BATCH, PROMPT, GEN = 4, 16, 6


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(ARCHS["smollm-360m"])
    jm = j_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = t_reduced(T_ARCHS["smollm-360m"])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)  # copied configs
    tm = get_model(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return cfg, jm, jp, tcfg, tm, tp, prompts


def _check_logits(want, got, what):
    d = np.abs(np.asarray(want, np.float32) - got.numpy())
    assert d.max() <= LOGIT_ATOL, f"{what}: max |diff| {d.max()}"
    assert d.mean() <= LOGIT_MEAN_ATOL, f"{what}: mean |diff| {d.mean()}"


@pytest.mark.parametrize("backend", ["exact", "mxu_int8", "approx_lut"])
def test_prefill_and_decode_logits_match_reference(setup, backend):
    """Prefill logits, then teacher-forced decode logits (both packages fed
    the same tokens), bound under the int8 backends as the server runs."""
    cfg, jm, jp, tcfg, tm, tp, prompts = setup
    jpol = j_gemm.GemmPolicy(backend=backend)
    pol = gemm.GemmPolicy(backend=backend)
    if backend != "exact":
        jp, tp = jm.bind_params(jp, jpol), tm.bind_params(tp, pol)
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, 3))
    jprefill = jax.jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c,
                                                  policy=jpol))
    jdecode = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c, pos,
                                                          policy=jpol))
    jc = jm.init_cache(BATCH, PROMPT + 3)
    tc = tm.init_cache(BATCH, PROMPT + 3)
    jl, jc = jprefill(jp, jnp.asarray(prompts), jc)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts).long()}, tc,
                        policy=pol)
    assert tl.shape == (BATCH, 1, cfg.vocab_size) and tl.dtype == torch.float32
    _check_logits(jl, tl, f"{backend} prefill")
    for i in range(3):
        tok = feed[:, i:i + 1]
        jl, jc = jdecode(jp, jnp.asarray(tok, jnp.int32), jc,
                         jnp.int32(PROMPT + i))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), tc,
                                PROMPT + i, policy=pol)
        _check_logits(jl, tl, f"{backend} decode step {i}")


def _teacher_forced_logits(tm, tp, prompts, stream, pol):
    """The port's logits along a given greedy stream: row t predicts stream[:, t]."""
    c = tm.init_cache(BATCH, PROMPT + GEN)
    logits, c = tm.prefill(tp, {"tokens": torch.from_numpy(prompts).long()}, c,
                           policy=pol)
    out = [logits[:, 0]]
    for i in range(GEN - 1):
        tok = torch.from_numpy(stream[:, i:i + 1]).long()
        logits, c = tm.decode_step(tp, tok, c, PROMPT + i, policy=pol)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1)                      # (B, GEN, V)


@pytest.mark.parametrize("backend", ["exact", "mxu_int8", "approx_lut"])
def test_lockstep_streams_match_reference(setup, backend):
    cfg, jm, jp, tcfg, tm, tp, prompts = setup
    jpol = j_gemm.GemmPolicy(backend=backend)
    pol = gemm.GemmPolicy(backend=backend)
    if backend != "exact":
        jp, tp = jm.bind_params(jp, jpol), tm.bind_params(tp, pol)
    want = j_serve.lockstep_generate(cfg, jm, jp, jnp.asarray(prompts), GEN,
                                     policy=jpol)
    got = serve.lockstep_generate(tcfg, tm, tp,
                                  torch.from_numpy(prompts).long(), GEN,
                                  policy=pol)
    assert got.shape == (BATCH, GEN) and got.dtype == np.int32
    if np.array_equal(want, got):
        return
    logits = _teacher_forced_logits(tm, tp, prompts, want, pol)
    for r in range(BATCH):
        diff = np.nonzero(want[r] != got[r])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        top2 = torch.topk(logits[r, t], 2).values
        margin = float(top2[0] - top2[1])
        assert margin <= LOGIT_ATOL, (
            f"{backend} row {r} differs at step {t} with top-2 margin {margin}")
        warnings.warn(f"{backend}: flagged tie at row {r} step {t} "
                      f"(top-2 margin {margin})")


@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_bound_equals_unbound_inside_port(setup, backend):
    _, _, _, tcfg, tm, tp, prompts = setup
    pol = gemm.GemmPolicy(backend=backend)
    t = torch.from_numpy(prompts).long()
    unbound = serve.lockstep_generate(tcfg, tm, tp, t, GEN, policy=pol)
    bound = serve.lockstep_generate(tcfg, tm, tm.bind_params(tp, pol), t, GEN,
                                    policy=pol)
    np.testing.assert_array_equal(unbound, bound)
    c1, c2 = tm.init_cache(BATCH, PROMPT), tm.init_cache(BATCH, PROMPT)
    l1, _ = tm.prefill(tp, {"tokens": t}, c1, policy=pol)
    l2, _ = tm.prefill(tm.bind_params(tp, pol), {"tokens": t}, c2, policy=pol)
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("backend", ["exact", "mxu_int8", "approx_lut"])
def test_serve_main_runs_on_cpu(backend, capsys):
    out = serve.main(["--debug", "--device", "cpu", "--backend", backend,
                      "--gen-len", "4"])
    assert out.shape == (4, 4) and out.dtype == np.int32
    assert ((out >= 0) & (out < 256)).all()
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_serve_main_bound_equals_unbound(backend):
    argv = ["--debug", "--device", "cpu", "--backend", backend, "--gen-len",
            "4"]
    np.testing.assert_array_equal(serve.main(argv),
                                  serve.main(argv + ["--no-bind"]))


def test_trace_serve_runs_on_cpu():
    """The profiler breakdown runs; without a card it measures no device
    time and says so rather than report a CPU number as a device one."""
    from repro_torch.launch import trace_serve
    out = trace_serve.main(["--debug", "--device", "cpu", "--backend",
                            "approx_lut", "--gen-len", "3"])
    assert out["decode_wall_ms"] > 0
    assert out["device_busy_ms"] == "not measured"


def test_serve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--debug"])


def test_engine_flag_is_not_silently_lockstep(capsys):
    """``--engine`` runs the continuous-batching engine, not the lockstep
    loop: it returns the engine's finished requests and prints its report."""
    from repro_torch.launch import engine
    finished = serve.main(["--debug", "--device", "cpu", "--engine",
                           "--requests", "3", "--gen-len", "4"])
    assert isinstance(finished, dict) and len(finished) == 3
    assert all(isinstance(f, engine.FinishedRequest)
               for f in finished.values())
    out = capsys.readouterr().out
    assert "engine: 3 requests, 12 tokens" in out and "occupancy:" in out
    assert "generated (" not in out                   # the lockstep report


@pytest.mark.parametrize("flags", [["--contiguous"], ["--multi-step", "4"]])
def test_unported_engine_modes_exit(flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        serve.main(["--debug", "--device", "cpu", "--engine", *flags])


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model(T_ARCHS["qwen3-moe-30b-a3b"])
