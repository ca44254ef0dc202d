"""Hand-written Hopper kernels for the paper's compute hot spot (the systolic GEMM).

systolic_gemm.py — exact int8 PE array (csrc/systolic_gemm.cu, __dp4a tiles).
approx_gemm.py   — approximate PE via a shared-memory product table
                   (csrc/approx_gemm.cu).
ops.py           — public wrappers and the weight-stationary prepared operand.
ref.py           — the kernels' plain PyTorch versions.
_build.py        — nvcc build at first use, ctypes loading.
"""
