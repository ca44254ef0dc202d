"""The port's applications (``repro_torch.apps``: DCT, edge detection, BDCN)
held bit for bit against the JAX package's, and the paper's Table-VI floors.

Both packages run the same numpy glue on the same synthetic image; the port's
GEMMs run on the CPU (the kernels' plain versions), JAX's through its Pallas
kernels in interpret mode. At 32 px every backend's output (DCT
coefficients, the edge response map, the BDCN edge map under its hybrid
policy) is compared exactly: the left-prepared T8 of the DCT's first stage,
the right-prepared operands, and the BDCN's per-layer exact overrides. The
fast floors at 64 px are those of ``tests/test_quality_regression.py``
(paper value less 0.5 dB).
"""
import numpy as np
import pytest
import torch

from repro.apps import bdcn as j_bdcn
from repro.apps import dct as j_dct
from repro.apps import edge as j_edge
from repro.core import gemm as j_gemm
from repro_torch.apps import bdcn, dct, edge, images
from repro_torch.core import errors, gemm

BACKENDS = ("approx_lut", "approx_delta", "approx_onehot", "approx_oracle")
SMALL = 32
FAST = 64
PAPER_DCT_PSNR = {2: 45.97, 4: 38.21, 6: 35.67, 8: 28.43}
PAPER_EDGE_PSNR = {2: 30.45, 4: 20.51}
TOL_DB = 0.5


@pytest.fixture(scope="module")
def img():
    want = np.asarray(j_dct.images.test_image(SMALL, 0))
    got = images.test_image(SMALL, 0)
    np.testing.assert_array_equal(want, got)
    return got


@pytest.mark.parametrize("backend", BACKENDS)
def test_dct_blocks_bit_identical(img, backend):
    blocks = images.to_blocks(img)
    for k in (0, 2, 4, 6, 8):
        want = np.asarray(j_dct.forward_dct_blocks(blocks, k, policy=backend))
        got = dct.forward_dct_blocks(blocks, k, policy=backend, device="cpu")
        np.testing.assert_array_equal(want, got, err_msg=f"k={k}")
    np.testing.assert_array_equal(j_dct.inverse_dct_blocks(want),
                                  dct.inverse_dct_blocks(got))


@pytest.mark.parametrize("backend", BACKENDS)
def test_edge_response_bit_identical(img, backend):
    for k in (0, 2, 4, 8):
        for kernel in (j_edge.LAPLACIAN, j_edge.LAPLACIAN8):
            want = np.asarray(j_edge.conv_gemm(img, kernel, k, policy=backend))
            got = edge.conv_gemm(img, kernel, k, policy=backend, device="cpu")
            np.testing.assert_array_equal(want, got, err_msg=f"k={k}")
    np.testing.assert_array_equal(j_edge.edge_map(want), edge.edge_map(got))


@pytest.mark.parametrize("backend", BACKENDS)
def test_bdcn_hybrid_bit_identical(img, backend):
    """The hybrid policy (approximate blocks 0-1, exact 2-3) and a full
    policy used as-is, through every layer's right-prepared weights."""
    ws = j_bdcn.make_weights([8, 16, 16, 16], 0)
    for want_w, got_w in zip(ws, bdcn.make_weights([8, 16, 16, 16], 0)):
        np.testing.assert_array_equal(want_w, got_w)
    jpol = j_bdcn.hybrid_policy(2, backend)
    pol = bdcn.hybrid_policy(2, backend)
    assert (pol.overrides, pol.k, pol.backend) == (jpol.overrides, jpol.k,
                                                   jpol.backend)
    for k in (0, 2, 4):
        want = j_bdcn.bdcn_forward(img, ws, k, policy=backend)
        got = bdcn.bdcn_forward(img, ws, k, policy=backend, device="cpu")
        np.testing.assert_array_equal(want, got, err_msg=f"k={k}")
    want = j_bdcn.bdcn_forward(img, ws, 4,
                               policy=j_gemm.GemmPolicy(backend=backend))
    got = bdcn.bdcn_forward(img, ws, 4, policy=gemm.GemmPolicy(backend=backend),
                            device="cpu")
    np.testing.assert_array_equal(want, got)


def test_run_reports_match_reference():
    """``run``'s PSNR/SSIM per k (the paper's methodology) equal JAX's."""
    for jmod, mod, kw in ((j_dct, dct, dict(ks=(0, 4), policy="approx_delta")),
                          (j_edge, edge, dict(ks=(2,), policy="approx_lut")),
                          (j_bdcn, bdcn, dict(ks=(2,), policy="approx_delta",
                                              channels=(4, 8)))):
        assert jmod.run(size=SMALL, **kw) == mod.run(size=SMALL, device="cpu",
                                                      **kw), mod.__name__


def test_errors_match_reference():
    from repro.core import errors as j_errors
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (40, 40)).astype(np.float64)
    b = np.clip(a + rng.normal(0, 4, a.shape), 0, 255)
    assert errors.psnr(a, b) == j_errors.psnr(a, b)
    assert errors.ssim(a, b) == j_errors.ssim(a, b)
    assert errors.gemm_error_metrics(b, a) == j_errors.gemm_error_metrics(b, a)
    assert (errors.pe_error_metrics(4, 2) == j_errors.pe_error_metrics(4, 2))


@pytest.mark.parametrize("backend", ["approx_lut", "approx_delta"])
def test_fast_floors_paper_k(backend):
    """The paper's Table-VI operating points at 64 px: DCT at k = 4, edge
    detection at k = 2; and the repro-pinned BDCN floor."""
    res = dct.run(size=FAST, ks=(4,), policy=backend, device="cpu")
    assert res[4]["psnr"] >= PAPER_DCT_PSNR[4] - TOL_DB
    res = edge.run(size=FAST, ks=(2,), policy=backend, device="cpu")
    assert res[2]["psnr"] >= PAPER_EDGE_PSNR[2] - TOL_DB
    if backend == "approx_delta":
        res = bdcn.run(size=FAST, ks=(2,), policy=backend, device="cpu")
        assert res[2]["psnr"] >= 55.0 and res[2]["ssim"] >= 0.995


def test_apps_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dct.run(size=SMALL, ks=(2,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edge.conv_gemm(images.test_image(SMALL), edge.LAPLACIAN, 2)
