"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips without a card; whether one exists is
decided inside the ``device`` fixture, never at import, so every test process
collects the same tests. This file imports no JAX (the machine with the card
has none); run it there without the JAX package's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Kernels are held bit-exact against their plain versions: both compute
integer sums exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import approx_gemm, ops, systolic_gemm
from repro_torch.kernels.ref import approx_matmul_ref, systolic_matmul_ref

pytestmark = pytest.mark.cuda

# (M, K, N): the slice's decode/prefill shapes for smollm-360m and odd shapes
SHAPES = [(4, 960, 960), (4, 960, 320), (64, 960, 2560), (64, 2560, 960),
          (4, 960, 49152), (1, 1, 1), (3, 37, 130), (17, 131, 67),
          (65, 259, 333)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int8(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=g, device=device,
                         dtype=torch.int8)


@pytest.mark.parametrize("m,kd,n", SHAPES)
def test_systolic_gemm_matches_plain(device, m, kd, n):
    a, b = _int8((m, kd), 1, device), _int8((kd, n), 2, device)
    before = systolic_gemm.launches
    got = systolic_gemm.systolic_matmul(a, b)
    torch.cuda.synchronize()
    assert systolic_gemm.launches == before + 1
    assert torch.equal(got, systolic_matmul_ref(a, b))


@pytest.mark.parametrize("m,kd,n", SHAPES[:2] + SHAPES[5:])
def test_approx_gemm_matches_plain(device, m, kd, n):
    a, b = _int8((m, kd), 3, device), _int8((kd, n), 4, device)
    for k in (0, 2, 4, 6, 8):
        table = approx_gemm.make_table(k, device=device)
        before = approx_gemm.launches
        got = approx_gemm.approx_matmul_lut(a, b, table)
        torch.cuda.synchronize()
        assert approx_gemm.launches == before + 1
        assert torch.equal(got, approx_matmul_ref(a, b, table.flat,
                                                  span=table.span)), k


def test_approx_gemm_small_table(device):
    """n_bits = 4: 16 x 16 table; operands keep only their low 4 bits."""
    a, b = _int8((5, 70), 5, device), _int8((70, 9), 6, device)
    table = approx_gemm.make_table(2, n_bits=4, device=device)
    got = approx_gemm.approx_matmul_lut(a, b, table)
    torch.cuda.synchronize()
    assert torch.equal(got, approx_matmul_ref(a, b, table.flat, span=16))


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    a, b = _int8((4, 32), 7, device), _int8((32, 8), 8, device)
    with pytest.raises(ValueError, match="int16"):
        approx_gemm.approx_matmul_lut(
            a, b, approx_gemm.make_table(4, signed=False, device=device))
    with pytest.raises(TypeError):
        systolic_gemm.systolic_matmul(a.to(torch.int32), b)
    with pytest.raises(ValueError, match="contiguous"):
        systolic_gemm.systolic_matmul(a, _int8((8, 32), 9, device).T)
    with pytest.raises(ValueError):
        systolic_gemm.systolic_matmul(a, b.cpu())


def test_cpu_tensors_never_launch(device):
    before = (systolic_gemm.launches, approx_gemm.launches)
    a = torch.randint(-128, 128, (3, 16), dtype=torch.int8)
    b = torch.randint(-128, 128, (16, 5), dtype=torch.int8)
    ops.systolic_matmul(a, b)
    ops.approx_matmul(a, b)
    assert (systolic_gemm.launches, approx_gemm.launches) == before


@pytest.mark.parametrize("backend", ["mxu_int8", "approx_lut"])
def test_reduced_server_on_card(device, backend):
    """The lockstep server on the card: kernels launched for every GEMM,
    bound == unbound, tokens in range."""
    from repro_torch.launch import serve
    mod = systolic_gemm if backend == "mxu_int8" else approx_gemm
    before = mod.launches
    argv = ["--debug", "--backend", backend, "--gen-len", "4"]
    bound = serve.main(argv)
    # reduced smollm: 2 layers x 7 GEMMs + lm_head, 4 forwards
    assert mod.launches - before == 4 * (7 * 2 + 1)
    np.testing.assert_array_equal(bound, serve.main(argv + ["--no-bind"]))
    assert ((bound >= 0) & (bound < 256)).all()
