// Fused exact-plus-error-delta GEMM for Hopper (sm_90a):
//   (M,K) int8 x (K,N) int8 -> (M,N) int32,
//   out = sum over K-blocks of [ dot_i8(a_blk, b_blk)
//                                + rint( sum_{kk in blk} sum_j f[a_u*r + j] * g[j*span + b_u] ) ]
// with a_u = a & (span-1), b_u = b & (span-1), f/g the rank-r factors of the
// approximate PE's error table (core/error_delta.py).
//
// Replaces the Pallas TPU kernel repro/kernels/delta_gemm.py::delta_matmul_fused
// (the exact int8 base on the MXU plus r f32 correction dots per K-block,
// rounded per block). At the exact rank each block's correction is an
// integer plus f32 noise far below 0.5, so the result is bit-identical to the
// product-table GEMM (approx_gemm) whatever the block size or summation
// order. The K-block here is the kernel's K tile, 64 (the reference's
// exactness argument holds for blocks up to 512).
//
// What bounds it on the H100: the correction, M*N*K*r f32 FMAs on the CUDA
// cores. At decode, (4, 960) x (960, 2560) at r = 7 (k = 4) is 69 M FMAs,
// about 2 us at the 67 TFLOP/s of non-tensor f32 (NVIDIA data sheet), against
// 0.7 us for the 2.5 MB of int8 weight at 3.35 TB/s. So the f32 operations,
// not the bytes, bound it; each FMA also needs shared-memory reads of f and g.
//
// Design (simple and exact first; the tensor cores come later):
//  * The base is __dp4a on 32-bit words of 4 K-values staged in shared memory,
//    as in systolic_gemm.cu: exact int32 arithmetic.
//  * The correction is sequential f32 FMAs per output, over the tile's K rows
//    and the r factors, rounded once per K tile with __float2int_rn (half to
//    even, as jnp.round). Never TF32: the per-block exactness needs full f32.
//    The bit patterns are read back from the staged int8 words, so the
//    correction moves no extra bytes from device memory.
//  * f (span, r) and g transposed to (span, r) are staged in dynamic shared
//    memory when 2*span*r*4 bytes fit beside the tiles (r <= ~100 at span
//    256: 127 KB at r = 62, k = 8); above that they are read from global
//    memory through the L2. Any rank 0..span runs. Rank 0 runs the base alone
//    (the truncated-rank exact_cancel route).
//  * A row of a warp shares its a pattern, so f reads are broadcasts; g reads
//    are gathers by b pattern (bank conflicts).
//  * Decode (M <= 16) takes a 4-row tile with each thread holding all 4 rows
//    of one column; prefill 32x64 tiles. The grid is persistent (as many
//    blocks as fit on the SMs, each staging f and g once) and walks
//    (m tile, n tile, K split) items. K splits hold whole K tiles, so every
//    per-tile rounding is the same in any split; partial sums are added with
//    integer atomics (associative: same bits in any order).
//  * Ragged M/N/K edges are masked: zero fill for the base, and the
//    correction loop stops at the last live K row, so padding adds nothing
//    (the reference pads K and subtracts k_pad * round(f[0] . g[:,0])).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN, bool SMEM_TABLES>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
delta_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  const float* __restrict__ f, const float* __restrict__ g,
                  int32_t* __restrict__ c, int M, int N, int K, int rank,
                  int span_bits, int m_tiles, int n_tiles, int k_tiles_per_split,
                  int n_work, int vec_a, int vec_b) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int KW = BK / 4;      // packed words along K
  constexpr int TX = BN / TN;     // threads along N
  constexpr int TY = BM / TM;     // threads along M
  __shared__ int32_t As[BM][KW];
  __shared__ int32_t Bs[KW][BN];
  extern __shared__ __align__(16) float tabs[];

  const int span = 1 << span_bits;
  const uint32_t pmask = (uint32_t)span - 1u;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int k_tiles = (K + BK - 1) / BK;

  // f element (v, j) at fp[v * rank + j]; g element (j, v) at gp[v * gsv + j * gsj]
  const float* fp = f;
  const float* gp = g;
  int gsv = 1, gsj = span;
  if constexpr (SMEM_TABLES) {
    float* f_s = tabs;
    float* g_s = tabs + span * rank;
    const int len = span * rank;
    for (int i = tid; i < len; i += THREADS) {
      f_s[i] = f[i];
      const int j = i / span, v = i - j * span;
      g_s[v * rank + j] = g[i];
    }
    __syncthreads();
    fp = f_s;
    gp = g_s;
    gsv = rank;
    gsj = 1;
  }

  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int mt = w % m_tiles;
    const int rest = w / m_tiles;
    const int nt = rest % n_tiles;
    const int split = rest / n_tiles;
    const int m0 = mt * BM;
    const int n0 = nt * BN;
    const int kt0 = split * k_tiles_per_split;
    const int kt1 = min(k_tiles, kt0 + k_tiles_per_split);

    int32_t acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * BK;
      // A tile: word (r, kw) holds a[m0+r][k0+4kw .. +3], byte i = K offset i
      for (int wd = tid; wd < BM * KW; wd += THREADS) {
        const int r = wd / KW, kw = wd % KW;
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
        for (int wd = tid; wd < KW * (BN / 4); wd += THREADS) {
          const int kw = wd / (BN / 4), nq = 4 * (wd % (BN / 4));
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
        for (int wd = tid; wd < KW * BN; wd += THREADS) {
          const int kw = wd / BN, nn = wd % BN;
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

      // exact base: int8 x int8 -> int32
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

      // rank-r correction over the tile's live K rows, rounded once per tile
      if (rank > 0) {
        float cf[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) cf[i][j] = 0.0f;
        const int kmax = min(BK, K - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const int kw = kk >> 2, sh = (kk & 3) * 8;
          int fo[TM], go[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            fo[i] = (int)(((uint32_t)As[ty + i * TY][kw] >> sh) & pmask) * rank;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            go[j] = (int)(((uint32_t)Bs[kw][tx + j * TX] >> sh) & pmask) * gsv;
#pragma unroll 2
          for (int rr = 0; rr < rank; ++rr) {
            float fv[TM], gv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) fv[i] = fp[fo[i] + rr];
#pragma unroll
            for (int j = 0; j < TN; ++j) gv[j] = gp[go[j] + rr * gsj];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) cf[i][j] = fmaf(fv[i], gv[j], cf[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += __float2int_rn(cf[i][j]);
      }
      __syncthreads();
    }

    const bool atomic = k_tiles_per_split < k_tiles;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + j * TX;
        if (m < M && n < N) {
          int32_t* out = c + (size_t)m * N + n;
          if (atomic) atomicAdd(out, acc[i][j]);
          else *out = acc[i][j];
        }
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, bool SMEM_TABLES>
cudaError_t launch_tiles(const int8_t* a, const int8_t* b, const float* f,
                         const float* g, int32_t* c, int M, int N, int K,
                         int rank, int span_bits, int dyn_smem, int sm_count,
                         cudaStream_t stream) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  auto kernel = delta_gemm_kernel<BM, BN, BK, TM, TN, SMEM_TABLES>;
  // The shared-memory limit is an attribute of the kernel on each device:
  // raise it once per instantiation and device, to the largest size asked
  // for so far, not on every launch.
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (dyn_smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = dyn_smem;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      dyn_smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int slots = per_sm * sm_count;
  // split K (in whole tiles) until the work items fill the resident blocks
  int splits = (slots + m_tiles * n_tiles - 1) / (m_tiles * n_tiles);
  splits = max(1, min(splits, k_tiles));
  const int per_split = (k_tiles + splits - 1) / splits;
  splits = (k_tiles + per_split - 1) / per_split;
  const long long n_work_ll = (long long)m_tiles * n_tiles * splits;
  if (n_work_ll > 0x7fffffff) return cudaErrorInvalidValue;
  const int n_work = (int)n_work_ll;
  const int grid = min(n_work, slots);
  if (splits > 1) {
    err = cudaMemsetAsync(c, 0, (size_t)M * N * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  const int vec_a = (K % 4 == 0) && ((uintptr_t)a % 4 == 0);
  const int vec_b = (N % 4 == 0) && ((uintptr_t)b % 4 == 0);
  kernel<<<grid, THREADS, dyn_smem, stream>>>(
      a, b, f, g, c, M, N, K, rank, span_bits, m_tiles, n_tiles, per_split,
      n_work, vec_a, vec_b);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* f,
                   const float* g, int32_t* c, int M, int N, int K, int rank,
                   int span_bits, int sm_count, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const long long static_bytes = (long long)BM * (BK / 4) * 4 + (long long)(BK / 4) * BN * 4;
  const long long tab_bytes = 2LL * (1 << span_bits) * rank * (long long)sizeof(float);
  if (static_bytes + tab_bytes <= optin)
    return launch_tiles<BM, BN, BK, TM, TN, true>(
        a, b, f, g, c, M, N, K, rank, span_bits, (int)tab_bytes, sm_count, stream);
  return launch_tiles<BM, BN, BK, TM, TN, false>(
      a, b, f, g, c, M, N, K, rank, span_bits, 0, sm_count, stream);
}

}  // namespace

// Returns a cudaError_t value (0 on success). `a` (M,K) and `b` (K,N) are
// contiguous int8 signed operand values; `f` is the contiguous (span * rank)
// f32 row factor f[v * rank + j], `g` the (rank * span) column factor
// g[j * span + v] (unused at rank 0); `c` the (M,N) int32 output.
extern "C" int delta_gemm(const void* a, const void* b, const void* f,
                          const void* g, void* c, int M, int N, int K,
                          int rank, int span_bits, int sm_count, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || span_bits < 1 || span_bits > 8 ||
      rank < 0 || rank > (1 << span_bits))
    return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  const auto* pf = static_cast<const float*>(f);
  const auto* pg = static_cast<const float*>(g);
  auto* pc = static_cast<int32_t*>(c);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    return (int)launch<4, 128, 64, 4, 1>(pa, pb, pf, pg, pc, M, N, K, rank,
                                         span_bits, sm_count, s);
  return (int)launch<32, 64, 64, 4, 2>(pa, pb, pf, pg, pc, M, N, K, rank,
                                       span_bits, sm_count, s);
}

// The message of a cudaError_t value returned by delta_gemm().
extern "C" const char* delta_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
