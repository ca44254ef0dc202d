"""PyTorch/CUDA port of the exact and approximate systolic-array GEMM stack.

Mirrors the layout of the JAX package ``repro`` module by module
(``repro_torch/core/gemm.py`` is the counterpart of ``repro/core/gemm.py``)
and imports nothing of it. Every Pallas kernel on a ported path is a CUDA C++
kernel for Hopper (``kernels/csrc``), built with ``nvcc`` at first use; each
kernel wrapper runs the kernel's plain PyTorch version only for tensors that
lie on the CPU, and launches the kernel (or raises) for CUDA tensors.

Entry points take an explicit ``device``. They default to ``"cuda"`` and raise
when no card is present; tests pass ``device="cpu"``.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
