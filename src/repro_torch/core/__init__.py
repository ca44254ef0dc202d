"""Core: the paper's exact/approximate systolic-array GEMM.

quant (int8 symmetric quantization), emulate (bit-level PE, its product table
and the PE-chain GEMM oracle), lut (product-table gather and one-hot GEMMs),
error_delta (exact-plus-error-delta decomposition of the table), errors
(Table V/VI error and image-quality metrics), gemm (the backend registry, the
unified `dot` entry point and `bind` for weight-stationary bound parameters).
"""
