// Exact-PE systolic GEMM for Hopper (sm_90a): (M,K) int8 x (K,N) int8 -> (M,N) int32.
//
// Replaces the Pallas TPU kernel repro/kernels/systolic_gemm.py::systolic_matmul
// (the exact PE array mapped onto the MXU, K-innermost accumulation into the
// output block). Here the K loop runs inside each block, since blocks run in
// parallel and carry nothing between them.
//
// What bounds it on the H100: at decode the batch is the M dimension (4 rows),
// so the GEMM is a matrix-vector product that reads every weight byte once for
// 2*M operations per byte, far below the ~590 int8 operations per byte the
// card needs before compute binds. The bound is the weight bytes over the
// memory rate (3.35 TB/s). At prefill (M = 64) it is still memory-bound.
//
// Design (simple and exact first; wgmma/TMA come later):
//  * Tiles are staged in shared memory as 32-bit words packing 4 consecutive K
//    values, and every thread accumulates with __dp4a (4 int8 MACs into an
//    int32), so the sum is exact int32 arithmetic, as on the MXU.
//  * Small M (<= 16, decode) uses a 4-row tile (BM = 4) so no lane computes
//    rows that do not exist; larger M uses 64x64 tiles with a 4x4 register
//    tile per thread. Both are 64 columns wide, to give many blocks over N.
//  * When the M x N tiles alone cannot fill the SMs (decode at N = 320 gives 5
//    tiles), K is split over gridDim.z and the partial sums are added with
//    integer atomics. Integer addition is associative, so the result is the
//    same bits in any order; the output is zeroed first.
//  * The kernel masks the ragged M/N/K edges itself (zero fill: exact).
//  * Weight rows are read as 32-bit words and transposed 4x4 in registers with
//    __byte_perm when N and the pointer allow it; otherwise byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
systolic_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                     int32_t* __restrict__ c, int M, int N, int K,
                     int k_tiles_per_split, int vec_a, int vec_b) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int KW = BK / 4;      // packed words along K
  constexpr int TX = BN / TN;     // threads along N
  constexpr int TY = BM / TM;     // threads along M
  __shared__ int32_t As[BM][KW];
  __shared__ int32_t Bs[KW][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int kt1 = min(k_tiles, kt0 + k_tiles_per_split);

  int32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    // A tile: word (r, kw) holds a[m0+r][k0+4kw .. +3], byte i = K offset i
    for (int w = tid; w < BM * KW; w += THREADS) {
      const int r = w / KW, kw = w % KW;
      const int m = m0 + r, k = k0 + 4 * kw;
      uint32_t word = 0;
      if (m < M) {
        const int8_t* p = a + (size_t)m * K + k;
        if (vec_a && k + 3 < K) {
          word = *reinterpret_cast<const uint32_t*>(p);
        } else {
          for (int i = 0; i < 4; ++i)
            if (k + i < K) word |= (uint32_t)(uint8_t)p[i] << (8 * i);
        }
      }
      As[r][kw] = (int32_t)word;
    }
    // B tile: word (kw, n) holds b[k0+4kw .. +3][n0+n], byte i = K offset i
    if (vec_b) {
      for (int w = tid; w < KW * (BN / 4); w += THREADS) {
        const int kw = w / (BN / 4), nq = 4 * (w % (BN / 4));
        const int n = n0 + nq, k = k0 + 4 * kw;
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)   // N % 4 == 0, so n < N means n + 3 < N
          r[i] = (n < N && k + i < K)
              ? *reinterpret_cast<const uint32_t*>(b + (size_t)(k + i) * N + n)
              : 0u;
        // 4x4 byte transpose: word j gathers byte j of r[0..3]
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        Bs[kw][nq + 0] = (int32_t)__byte_perm(t0, t1, 0x5410);
        Bs[kw][nq + 1] = (int32_t)__byte_perm(t0, t1, 0x7632);
        Bs[kw][nq + 2] = (int32_t)__byte_perm(t2, t3, 0x5410);
        Bs[kw][nq + 3] = (int32_t)__byte_perm(t2, t3, 0x7632);
      }
    } else {
      for (int w = tid; w < KW * BN; w += THREADS) {
        const int kw = w / BN, nn = w % BN;
        const int n = n0 + nn, k = k0 + 4 * kw;
        uint32_t word = 0;
        if (n < N)
          for (int i = 0; i < 4; ++i)
            if (k + i < K)
              word |= (uint32_t)(uint8_t)b[(size_t)(k + i) * N + n] << (8 * i);
        Bs[kw][nn] = (int32_t)word;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < KW; ++kw) {
      int32_t av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[ty + i * TY][kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kw][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (m < M && n < N) {
        int32_t* out = c + (size_t)m * N + n;
        if (split) atomicAdd(out, acc[i][j]);
        else *out = acc[i][j];
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const int8_t* a, const int8_t* b, int32_t* c, int M, int N,
                   int K, int sm_count, cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int k_tiles = (K + BK - 1) / BK;
  // split K until the grid holds about two blocks per SM
  int splits = (2 * sm_count + m_tiles * n_tiles - 1) / (m_tiles * n_tiles);
  splits = max(1, min(splits, k_tiles));
  const int per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per_split - 1) / per_split;
  if (splits > 1) {
    cudaError_t err =
        cudaMemsetAsync(c, 0, (size_t)M * N * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  const int vec_a = (K % 4 == 0) && ((uintptr_t)a % 4 == 0);
  const int vec_b = (N % 4 == 0) && ((uintptr_t)b % 4 == 0);
  dim3 grid(n_tiles, m_tiles, splits);
  systolic_gemm_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a, b, c, M, N, K, per_split,
                                                  vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success). Pointers are device pointers of
// contiguous row-major tensors; `stream` is a cudaStream_t.
extern "C" int systolic_gemm(const void* a, const void* b, void* c, int M, int N,
                             int K, int sm_count, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  auto* pc = static_cast<int32_t*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return (int)launch<4, 64, 64, 1, 1>(pa, pb, pc, M, N, K, sm_count, s);
  return (int)launch<64, 64, 64, 4, 4>(pa, pb, pc, M, N, K, sm_count, s);
}

// The message of a cudaError_t value returned by systolic_gemm().
extern "C" const char* systolic_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
