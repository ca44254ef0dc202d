// Approximate-PE systolic GEMM for Hopper (sm_90a): out[m,n] = sum_k T[a_u[m,k]*span + b_u[k,n]]
// with int32 (wrapping) accumulation, T the PE's (span x span) product table.
//
// Replaces the Pallas TPU kernel repro/kernels/approx_gemm.py::approx_matmul_lut
// (VMEM-resident int32 table, one gather per (a, b) pair).
//
// What bounds it on the H100: every product is a table lookup, so nothing runs
// on the tensor cores. Each lookup is one shared-memory access; the bound is
// M*N*K lookups at 32 shared-memory accesses per clock per SM on 132 SMs.
// Random indices cause bank conflicts, so the kernel reaches a fraction of it.
//
// Design:
//  * The int32 table (256 KiB at span 256) does not fit the 227 KB a block
//    may hold. Every table of product_table(8, k) for k = 0..8 lies in
//    [-16256, 16384], so the wrapper passes an int16 copy (128 KiB), checked
//    to fit on the host, and each block stages it in dynamic shared memory.
//  * With 128 KiB of table one block fills an SM, so the grid is persistent:
//    at most one block per SM, each staging the table once and then walking
//    work items (m tile, n tile, K split) with a grid-stride loop.
//  * Operands are int8 bit patterns; the kernel masks them to the low n_bits
//    (x & (span-1)), so signed values index by their two's-complement pattern.
//    The moving operand is `a`: the table is not symmetric.
//  * Sums are uint32 and stored as int32, matching a wrapping int32 add
//    without signed-overflow UB. K entries past the edge are skipped, so
//    T[0,0] is never added for padding. When M x N tiles cannot fill the
//    SMs, K is split and partial sums are added with unsigned atomics
//    (integer addition is associative: same bits in any order).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
approx_gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                   const int16_t* __restrict__ table, int32_t* __restrict__ c,
                   int M, int N, int K, int n_bits, int k_tiles_per_split,
                   int splits) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int table_len = 1 << (2 * n_bits);
  const int table_bytes = ((table_len * 2 + 15) / 16) * 16;
  int16_t* T = reinterpret_cast<int16_t*>(smem);
  uint8_t* As = smem + table_bytes;   // [BM][BK]
  uint8_t* Bs = As + BM * BK;         // [BK][BN]

  const int tid = threadIdx.x;
  {
    const int n_vec = table_len * 2 / 16;
    const int4* src = reinterpret_cast<const int4*>(table);
    int4* dst = reinterpret_cast<int4*>(T);
    for (int i = tid; i < n_vec; i += THREADS) dst[i] = src[i];
    for (int i = n_vec * 8 + tid; i < table_len; i += THREADS) T[i] = table[i];
  }
  __syncthreads();

  const int tx = tid % TX;
  const int ty = tid / TX;
  const uint32_t mask = (1u << n_bits) - 1u;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int n_work = m_tiles * n_tiles * splits;

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int nt = work % n_tiles;
    const int mt = (work / n_tiles) % m_tiles;
    const int sp = work / (n_tiles * m_tiles);
    const int m0 = mt * BM, n0 = nt * BN;
    const int kt0 = sp * k_tiles_per_split;
    const int kt1 = min(k_tiles, kt0 + k_tiles_per_split);

    uint32_t acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * BK;
      const int klen = min(BK, K - k0);
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        const int m = m0 + r, k = k0 + kk;
        As[i] = (m < M && k < K) ? a[(size_t)m * K + k] : 0;
      }
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, nn = i % BN;
        const int k = k0 + kk, n = n0 + nn;
        Bs[i] = (k < K && n < N) ? b[(size_t)k * N + n] : 0;
      }
      __syncthreads();
      for (int kk = 0; kk < klen; ++kk) {   // entries past K are skipped
        uint32_t ai[TM], bi[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          ai[i] = ((uint32_t)As[(ty + i * TY) * BK + kk] & mask) << n_bits;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bi[j] = (uint32_t)Bs[kk * BN + tx + j * TX] & mask;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += (uint32_t)(int32_t)T[ai[i] | bi[j]];
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + j * TX;
        if (m < M && n < N) {
          int32_t* out = c + (size_t)m * N + n;
          if (splits > 1) atomicAdd(reinterpret_cast<unsigned int*>(out), acc[i][j]);
          else *out = (int32_t)acc[i][j];
        }
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const int16_t* table,
                   int32_t* c, int M, int N, int K, int n_bits, int sm_count,
                   cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int k_tiles = (K + BK - 1) / BK;
  // split K until the work items cover every SM once
  int splits = (sm_count + m_tiles * n_tiles - 1) / (m_tiles * n_tiles);
  splits = max(1, min(splits, k_tiles));
  const int per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per_split - 1) / per_split;
  const int n_work = m_tiles * n_tiles * splits;
  const int grid = min(n_work, sm_count);
  const int table_bytes = (((1 << (2 * n_bits)) * 2 + 15) / 16) * 16;
  const int smem = table_bytes + BM * BK + BK * BN;
  auto kernel = approx_gemm_kernel<BM, BN, BK, TM, TN>;
  // The shared-memory limit is an attribute of the kernel on each device:
  // raise it once per instantiation and device, to the largest size asked
  // for so far, not on every launch.
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  if (splits > 1) {
    err = cudaMemsetAsync(c, 0, (size_t)M * N * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, (BM / TM) * (BN / TN), smem, stream>>>(
      a, b, table, c, M, N, K, n_bits, per_split, splits);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success). `a` (M,K) and `b` (K,N) are
// contiguous int8 bit patterns, `table` the contiguous int16 (2^n_bits)^2
// product table (16-byte aligned), `c` the (M,N) int32 output.
extern "C" int approx_gemm(const void* a, const void* b, const void* table,
                           void* c, int M, int N, int K, int n_bits,
                           int sm_count, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || n_bits < 1 || n_bits > 8 ||
      (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  const auto* pt = static_cast<const int16_t*>(table);
  auto* pc = static_cast<int32_t*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    return (int)launch<4, 128, 64, 1, 1>(pa, pb, pt, pc, M, N, K, n_bits, sm_count, s);
  return (int)launch<32, 128, 32, 4, 2>(pa, pb, pt, pc, M, N, K, n_bits, sm_count, s);
}

// The message of a cudaError_t value returned by approx_gemm().
extern "C" const char* approx_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
