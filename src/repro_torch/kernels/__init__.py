"""Hand-written Hopper kernels: the paper's compute hot spot (the systolic
GEMM), the serving engine's paged attention and the prefill's flash
attention.

systolic_gemm.py   — exact int8 PE array (csrc/systolic_gemm.cu, __dp4a tiles).
approx_gemm.py     — approximate PE via a shared-memory product table
                     (csrc/approx_gemm.cu).
delta_gemm.py      — approximate PE as exact int8 GEMM plus a rank-r f32
                     error correction (csrc/delta_gemm.cu).
paged_attention.py — attention through per-slot block tables over a shared
                     KV pool (csrc/paged_attention.cu).
flash_attention.py — causal/window/softcap attention of a whole prompt
                     from position 0 (csrc/flash_attention.cu).
ops.py             — public wrappers and the weight-stationary prepared operand.
ref.py             — the kernels' plain PyTorch versions.
_build.py          — nvcc build at first use, ctypes loading.
"""
