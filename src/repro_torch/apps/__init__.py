"""The paper's §V applications (Table VI), routed through ``core.gemm``
(port of ``repro/apps``).

dct.py  — 8x8 integer DCT image compression (fixed T8 weights, both sides).
edge.py — kernel-based edge detection via im2col GEMM (fixed conv kernel).
bdcn.py — compact BDCN-style CNN with the paper's hybrid policy expressed as
          per-layer GemmPolicy overrides (approx early blocks, exact late).

The numpy glue is the reference's; every GEMM goes through the port's
``gemm.dot`` on the device the caller names (``device``, default ``cuda``;
the CPU runs the kernels' plain versions). Fixed weights are prepared once
(``gemm.prepare_weights_cached``).
"""
from . import bdcn, dct, edge, images  # noqa: F401
