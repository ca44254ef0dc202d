"""Core: the paper's exact/approximate systolic-array GEMM.

Ported so far: quant (int8 symmetric quantization), emulate (bit-level PE
and its product table), gemm (the backend registry, the unified `dot` entry
point and `bind` for weight-stationary bound parameters).
"""
