// Paged attention for Hopper (sm_90a): flash attention and flash decoding over
// a shared KV block pool, walking each row's block table inside the kernel.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::paged_attention.
// Computes what it computes, for q (B,Sq,H,D) bf16/f32, pools
// (n_blocks+1, bs, KH, D) bf16/f32/int8 (int8 dequantized by int8_scale),
// block tables (B,W) int32 (dump row n_blocks), kv_valid_len (B,) and
// q_positions (B,Sq) int32:
//  * q is scaled by D**-0.5 in the query dtype before the f32 products;
//  * KV positions >= kv_valid_len[b], past the causal frontier or outside the
//    window are masked to BIG_NEG (not -inf) after the softcap;
//  * each KV chunk of `chunk` positions (the caller's min(attn_chunk, W*bs))
//    updates the online softmax in f32: m_new = max(m, chunk max),
//    p = exp(s - m_new), l = l*corr + sum p, acc = acc*corr + p.V;
//  * a row's scan stops at ceil(kv_valid_len/chunk) and at the causal
//    frontier; rows with kv_valid_len == 0 return zeros;
//  * n_splits > 1 splits the chunk range over blocks, each writing its
//    partial (acc, m, l) in f32 for the log-sum-exp combine in the wrapper.
// A row masked in every chunk it has seen so far holds m = BIG_NEG and
// p = exp(0) = 1 for its masked columns; the next chunk with a live column
// multiplies that state by corr = exp(BIG_NEG - m) = 0, so it cancels without
// a NaN, as in the reference.
//
// What bounds it on the H100: the KV bytes. At decode a query row does 4*D
// flops per KV position against 2*D*bytes(pool) bytes read, about one flop
// per byte for bf16, far below the ~295 the card needs before compute binds;
// so the bound is the live KV bytes over the memory rate (3.35 TB/s).
//
// Design (simple and right first; wgmma/TMA come later):
//  * One block of 128 threads per (query tile, KV head, batch row x split).
//    GQA: the block holds the G = H/KH query heads of its KV head for up to
//    `qt` query positions (R = G*qt rows, at most 64; 32 at D = 256), so
//    each KV byte read serves G*qt rows. Head dims 16, 32, 64, 128, 256.
//  * KV is staged 64 positions at a time: every thread issues 16-byte
//    cp.async copies of pool rows straight from the block the table names
//    into shared memory (rows padded so 16-byte row reads are free of bank
//    conflicts). Tiles past the live length or the causal frontier are not
//    loaded at all.
//  * The chunk's scores stay in shared memory (R x chunk floats), so the
//    softmax update sees the whole chunk as the reference does. Scores:
//    one thread per KV position, its K row in registers (128 values at a
//    time), FMAs over D. P.V: one thread per (row group, d), two columns d
//    at D = 256, the V column read from shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KT = 64;            // KV positions per shared-memory tile
constexpr int RMAX = 64;          // query rows (G x query positions) per block
constexpr int SMEM_LIMIT = 232448;
constexpr float BIG_NEG = -2.3819763e38f;

// Row padding in elements: 16-byte row reads by 8 neighbouring threads then
// fall in distinct bank groups.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };
template <> struct Pad<int8_t> { static constexpr int v = 16; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* kv_len;
  const int32_t* q_pos;
  void* out;
  float* acc;
  float* m;
  float* l;
  int B, Sq, H, KH, n_pool, bs, W, chunk, nk, n_splits, qt, causal, window;
  float softcap, scale, int8_scale;
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Bytes of shared memory of one block: Q, acc, the chunk's scores, m/l/corr
// and the query positions in f32/int32, then one K and one V tile.
template <typename KVT, int D>
__host__ __device__ __forceinline__ size_t smem_bytes(int G, int qt, int chunk) {
  const size_t rmax = (size_t)G * qt;
  const size_t head = (2 * rmax * D + rmax * chunk + 3 * rmax + qt) * 4;
  return align16(head) + 2 * (size_t)KT * (D + Pad<KVT>::v) * sizeof(KVT);
}

// Stage pool rows [pos0, pos0 + n) of KV head kh for one batch row's table.
template <typename KVT, int D>
__device__ __forceinline__ void load_tile(KVT* dst, const KVT* pool,
                                          const int32_t* table, const Args& a,
                                          int kh, int pos0, int n) {
  constexpr int VEC = 16 / sizeof(KVT);
  constexpr int PER_ROW = D / VEC;
  constexpr int STRIDE = D + Pad<KVT>::v;
  const int dump = a.n_pool - 1;
  for (int i = threadIdx.x; i < n * PER_ROW; i += THREADS) {
    const int row = i / PER_ROW, vec = i % PER_ROW;
    const int p = pos0 + row;
    const int lb = p / a.bs;
    int blk = lb < a.W ? table[lb] : dump;      // the chunk grid's padding
    blk = min(max(blk, 0), dump);               // never read outside the pool
    const KVT* src = pool + ((size_t)(blk * a.bs + p % a.bs) * a.KH + kh) * D + vec * VEC;
    cp_async16(dst + row * STRIDE + vec * VEC, src);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Work split of the score and P.V passes by head dim. Scores: one thread per
// KV position holds DP of its K row in registers at a time (two pieces at
// D = 256). P.V: thread (row group, column) with DT columns per row group;
// at D = 256 each thread owns two columns and a block at most 32 rows, so
// its partial sums stay at 64 registers.
template <int D> struct Split {
  static constexpr int DP = D < 128 ? D : 128;
  static constexpr int DT = D < THREADS ? D : THREADS;
  static constexpr int NG2 = THREADS / DT;    // row groups of the P.V pass
  static constexpr int DPT = D / DT;          // columns per thread
  static constexpr int RM = D > THREADS ? RMAX / 2 : RMAX;   // rows per block
  static constexpr int RPT = RM / NG2;        // rows per thread of the P.V pass
};

template <typename KVT>
__device__ __forceinline__ float load_kv(KVT x, float int8_scale) {
  if constexpr (std::is_same<KVT, int8_t>::value) return to_f32(x) / int8_scale;
  else return to_f32(x);
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(const Args a) {
  constexpr int STRIDE = D + Pad<KVT>::v;
  constexpr int VEC = 16 / sizeof(KVT);
  constexpr int NG1 = THREADS / KT;   // row groups of the score pass
  constexpr int DP = Split<D>::DP, DT = Split<D>::DT, NG2 = Split<D>::NG2;
  constexpr int DPT = Split<D>::DPT, RPT = Split<D>::RPT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int G = a.H / a.KH;
  const int rmax = G * a.qt;
  const int q0 = blockIdx.x * a.qt;
  const int nq = min(a.qt, a.Sq - q0);
  const int R = G * nq;                          // rows r = qi * G + g
  const int kh = blockIdx.y;
  const int b = blockIdx.z / a.n_splits;
  const int split = blockIdx.z % a.n_splits;
  const int tid = threadIdx.x;
  const int C = a.chunk;

  float* Qs = reinterpret_cast<float*>(smem);   // [rmax][D]
  float* Acc = Qs + rmax * D;                   // [rmax][D]
  float* S = Acc + rmax * D;                    // [rmax][C]
  float* Mr = S + (size_t)rmax * C;             // [rmax]
  float* Lr = Mr + rmax;                        // [rmax]
  float* Cr = Lr + rmax;                        // [rmax]
  int* Qp = reinterpret_cast<int*>(Cr + rmax);  // [qt]
  KVT* Ks = reinterpret_cast<KVT*>(
      smem + align16((2 * (size_t)rmax * D + (size_t)rmax * C + 3 * rmax + a.qt) * 4));
  KVT* Vs = Ks + KT * STRIDE;

  const QT* q = static_cast<const QT*>(a.q);
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = r / G, g = r % G;
    const float x = to_f32(q[(((size_t)b * a.Sq + q0 + qi) * a.H + kh * G + g) * D + d]);
    Qs[i] = to_f32(from_f32<QT>(x * a.scale));   // scaled in the query dtype
    Acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    Mr[r] = BIG_NEG;
    Lr[r] = 0.f;
  }
  for (int i = tid; i < nq; i += THREADS) Qp[i] = a.q_pos[(size_t)b * a.Sq + q0 + i];
  __syncthreads();

  const int kvl = a.kv_len[b];
  int maxq = INT_MIN;
  for (int i = 0; i < nq; ++i) maxq = max(maxq, Qp[i]);
  const int cps = (a.nk + a.n_splits - 1) / a.n_splits;
  const int lo = split * cps;
  int hi = min(lo + cps, a.nk);
  hi = min(hi, kvl > 0 ? (kvl + C - 1) / C : 0);
  if (a.causal) hi = min(hi, floor_div(maxq + C, C));
  const int win = a.window > 0 ? a.window : INT_MAX;
  const int32_t* table = a.tables + (size_t)b * a.W;
  const KVT* kpool = static_cast<const KVT*>(a.k);
  const KVT* vpool = static_cast<const KVT*>(a.v);
  const int warp = tid / 32, lane = tid % 32;

  for (int ci = lo; ci < hi; ++ci) {
    const int base = ci * C;
    // 1. the chunk's masked scores
    for (int c0 = 0; c0 < C; c0 += KT) {
      const int n = min(KT, C - c0);
      const int pos0 = base + c0;
      const bool live = pos0 < kvl && (!a.causal || pos0 <= maxq);
      if (!live) {
        for (int i = tid; i < R * n; i += THREADS) S[(i / n) * C + c0 + i % n] = BIG_NEG;
        continue;
      }
      load_tile<KVT, D>(Ks, kpool, table, a, kh, pos0, n);
      const int c = tid % KT;
      if (c < n) {
        const int kpos = pos0 + c;
#pragma unroll
        for (int p0 = 0; p0 < D; p0 += DP) {   // one FMA chain over D, DP at a time
          float kr[DP];
#pragma unroll
          for (int v = 0; v < DP / VEC; ++v) {
            const uint4 w = reinterpret_cast<const uint4*>(Ks + c * STRIDE + p0)[v];
            const KVT* e = reinterpret_cast<const KVT*>(&w);
#pragma unroll
            for (int i = 0; i < VEC; ++i) kr[v * VEC + i] = load_kv(e[i], a.int8_scale);
          }
          for (int r = tid / KT; r < R; r += NG1) {
            const float* qr = Qs + r * D + p0;
            float s = p0 == 0 ? 0.f : S[r * C + c0 + c];
#pragma unroll
            for (int d = 0; d < DP; ++d) s = fmaf(qr[d], kr[d], s);
            if (p0 + DP < D) {          // a partial sum: this thread's own entry
              S[r * C + c0 + c] = s;
              continue;
            }
            if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
            bool ok = kpos < kvl;
            if (a.causal) {
              const int delta = Qp[r / G] - kpos;
              ok = ok && delta >= 0 && delta < win;
            }
            S[r * C + c0 + c] = ok ? s : BIG_NEG;
          }
        }
      }
      __syncthreads();   // the next tile overwrites Ks
    }
    __syncthreads();
    // 2. online-softmax update over the whole chunk, one warp per row
    for (int r = warp; r < R; r += WARPS) {
      float* sr = S + (size_t)r * C;
      float mx = BIG_NEG;
      for (int c = lane; c < C; c += 32) mx = fmaxf(mx, sr[c]);
      const float m_new = fmaxf(Mr[r], warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float p = expf(sr[c] - m_new);
        sr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(Mr[r] - m_new);
        Lr[r] = Lr[r] * corr + sum;
        Mr[r] = m_new;
        Cr[r] = corr;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + P.V (masked tiles hold p = 0 for every live row)
    const int dt = tid % DT, rg = tid / DT;
    float pv[DPT][RPT];
#pragma unroll
    for (int e = 0; e < DPT; ++e)
#pragma unroll
      for (int j = 0; j < RPT; ++j) pv[e][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += KT) {
      const int n = min(KT, C - c0);
      const int pos0 = base + c0;
      if (!(pos0 < kvl && (!a.causal || pos0 <= maxq))) continue;   // block-uniform
      load_tile<KVT, D>(Vs, vpool, table, a, kh, pos0, n);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = rg + j * NG2;
        if (r < R) {
          const float* pr = S + (size_t)r * C + c0;
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            float s = pv[e][j];
            for (int c = 0; c < n; ++c)
              s = fmaf(pr[c], load_kv(Vs[c * STRIDE + dt + e * DT], a.int8_scale), s);
            pv[e][j] = s;
          }
        }
      }
      __syncthreads();   // the next tile overwrites Vs
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rg + j * NG2;
      if (r < R) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const int d = dt + e * DT;
          Acc[r * D + d] = Acc[r * D + d] * Cr[r] + pv[e][j];
        }
      }
    }
    __syncthreads();     // the next chunk rewrites S and Cr
  }

  if (a.n_splits == 1) {
    QT* out = static_cast<QT*>(a.out);
    for (int i = tid; i < R * D; i += THREADS) {
      const int r = i / D, d = i % D, qi = r / G, g = r % G;
      out[(((size_t)b * a.Sq + q0 + qi) * a.H + kh * G + g) * D + d] =
          from_f32<QT>(Acc[i] / fmaxf(Lr[r], 1e-30f));
    }
  } else {
    const size_t row0 = ((size_t)split * a.B + b) * a.Sq + q0;   // (n_splits, B, Sq, H, ...)
    for (int i = tid; i < R * D; i += THREADS) {
      const int r = i / D, d = i % D, qi = r / G, g = r % G;
      a.acc[((row0 + qi) * a.H + kh * G + g) * D + d] = Acc[i];
    }
    for (int r = tid; r < R; r += THREADS) {
      const size_t at = (row0 + r / G) * a.H + kh * G + r % G;
      a.m[at] = Mr[r];
      a.l[at] = Lr[r];
    }
  }
}

template <typename QT, typename KVT, int D>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int G = a.H / a.KH;
  // query positions per block: as many as the row cap and shared memory allow
  int qt = min(a.Sq, Split<D>::RM / G);
  while (qt > 1 && smem_bytes<KVT, D>(G, qt, a.chunk) > (size_t)SMEM_LIMIT) --qt;
  if (qt < 1 || smem_bytes<KVT, D>(G, qt, a.chunk) > (size_t)SMEM_LIMIT)
    return cudaErrorInvalidValue;
  a.qt = qt;
  const int smem = (int)smem_bytes<KVT, D>(G, qt, a.chunk);
  auto kernel = paged_attention_kernel<QT, KVT, D>;
  // The shared-memory limit is an attribute of the kernel on each device:
  // raise it once per instantiation and device, to the largest size asked
  // for so far, not on every launch.
  static int smem_set[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  const dim3 grid((a.Sq + qt - 1) / qt, a.KH, a.B * a.n_splits);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<QT, KVT, 16>(a, s);
    case 32: return launch<QT, KVT, 32>(a, s);
    case 64: return launch<QT, KVT, 64>(a, s);
    case 128: return launch<QT, KVT, 128>(a, s);
    case 256: return launch<QT, KVT, 256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t dispatch_kv(const Args& a, int D, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return dispatch_d<QT, float>(a, D, s);
    case 1: return dispatch_d<QT, __nv_bfloat16>(a, D, s);
    case 2: return dispatch_d<QT, int8_t>(a, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t value (0 on success). q (B,Sq,H,D), the pools
// (n_pool,bs,KH,D), tables (B,W), kv_len (B,) and q_pos (B,Sq) are
// contiguous; the pools 16-byte aligned. n_splits == 1 writes `out`
// (B,Sq,H,D) in q's dtype; n_splits > 1 writes `acc` (n_splits,B,Sq,H,D),
// `m` and `l` (n_splits,B,Sq,H) in f32. Dtype codes: 0 f32, 1 bf16, 2 int8
// (pools only). `chunk` must be a multiple of bs; n_splits <= the chunk count.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* kv_len,
                               const void* q_pos, void* out, void* acc, void* m,
                               void* l, int B, int Sq, int H, int KH, int D,
                               int n_pool, int bs, int W, int chunk,
                               int n_splits, int causal, int window,
                               int q_dtype, int kv_dtype, float softcap,
                               float scale, float int8_scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || n_pool <= 0 ||
      bs <= 0 || W <= 0 || chunk <= 0 || chunk % bs != 0 || n_splits < 1 ||
      (uintptr_t)k % 16 != 0 || (uintptr_t)v % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.tables = static_cast<const int32_t*>(tables);
  a.kv_len = static_cast<const int32_t*>(kv_len);
  a.q_pos = static_cast<const int32_t*>(q_pos);
  a.out = out;
  a.acc = static_cast<float*>(acc);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.KH = KH;
  a.n_pool = n_pool;
  a.bs = bs;
  a.W = W;
  a.chunk = chunk;
  a.nk = (W * bs + chunk - 1) / chunk;
  a.n_splits = n_splits;
  a.qt = 0;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  a.int8_scale = int8_scale;
  if (n_splits > a.nk) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<float>(a, D, kv_dtype, s);
    case 1: return (int)dispatch_kv<__nv_bfloat16>(a, D, kv_dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The message of a cudaError_t value returned by paged_attention().
extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
