// Flash attention (forward) for Hopper (sm_90a): causal / sliding-window /
// softcap attention of a whole sequence from position 0, with an online
// softmax over K/V tiles staged through shared memory.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention.
// Computes what it computes, for q (B,H,Sq,D) and k/v (B,KH,Skv,D), each
// f32 or bf16, given by element strides (the last dim contiguous), query
// head h reading KV head h / (H/KH) (GQA without a broadcast copy):
//  * scores are f32 FMAs of q scaled by D**-0.5 (in q's dtype, as the port's
//    plain version and chunked attention do) and k, with no TF32;
//  * the optional softcap cap*tanh(s/cap), then keys at or past
//    kv_valid_len[b] (or past Skv), and, when causal, keys with
//    qpos - kpos < 0 or >= window (window > 0) are masked to BIG_NEG, with
//    positions the row indices from 0;
//  * each K tile updates the running max m, sum l and output acc in f32:
//    m_new = max(m, tile max), p = exp(s - m_new), l = l*corr + sum p,
//    acc = acc*corr + p.V with corr = exp(m - m_new);
//  * the output is acc / max(l, 1e-30) in q's dtype.
// A row masked in every tile it has seen holds m = BIG_NEG and p = exp(0) =
// 1 for its masked columns; the first tile with a live column multiplies
// that state by corr = exp(BIG_NEG - m_new) = 0. So the K loop may start at
// the first tile any row of the q-tile can see (q0 - window + 1) and stop at
// min(ceil(kv_valid_len / BK), the causal frontier), as the reference's
// block loop stops, without changing the result.
//
// What bounds it on the H100: operations. A q-tile of BQ rows reads each K
// and V byte once for BQ rows, 4*D flops per (query, key) pair, so the
// arithmetic intensity is about BQ/2 flops per byte read from the L2 and
// far more per byte of device memory; the f32 FMAs run outside the tensor
// cores (67 TFLOP/s), which is the bound at long prompts.
//
// Design (simple and right first; wgmma, TMA and warp specialisation come
// later):
//  * One block of 128 threads per (q-tile, head, batch row), q-tiles of
//    BQ = 64 rows (32 at D = 256), launched latest tile first since causal
//    tiles late in the sequence see the most keys.
//  * The scaled q-tile, one K or V tile of 64 keys and the tile's
//    probabilities sit in shared memory as f32, rows padded by 4 floats so
//    16-byte reads by 8 neighbouring threads hit distinct banks. K and V
//    share one buffer: the loads are not overlapped with compute.
//  * Threads form a 16 x 8 grid: thread (ty, tx) owns TM consecutive query
//    rows; for the scores it owns 8 keys (tx + 8j), for the output the D/8
//    columns tx + 8e. Row max and sum reduce over the 8 tx lanes by
//    shuffles. m, l and acc stay in registers (TM*D/8 floats: at most 64).
//  * Shared memory: (BQ + 64) * (D + 4) * 4 + BQ * 68 * 4 bytes, 109 KB at
//    D = 256 and 85 KB at D = 128, so two blocks fit an SM; above 48 KB the
//    launcher raises the kernel's dynamic shared-memory limit once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 128;
constexpr int TX = 8;               // threads along a row
constexpr int TY = THREADS / TX;    // 16 thread rows
constexpr int BK = 64;              // keys per tile
constexpr int TN = BK / TX;         // keys per thread in the score pass
constexpr int PAD = 4;              // floats of row padding
constexpr int PS = BK + PAD;        // row stride of the probability tile
constexpr float BIG_NEG = -2.3819763e38f;

template <int D> struct Geom {
  static constexpr int TM = D > 128 ? 2 : 4;   // query rows per thread
  static constexpr int BQ = TY * TM;          // query rows per block
  static constexpr int RS = D + PAD;          // row stride of the q and K/V tiles
  static constexpr int TD = D / TX;           // output columns per thread
  static constexpr size_t SMEM = ((size_t)(BQ + BK) * RS + (size_t)BQ * PS) * 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_len;    // (B,) or null: kv_len_all for every row
  void* out;
  int B, H, KH, Sq, Skv, kv_len_all, causal, window;
  long long sq_b, sq_h, sq_s, sk_b, sk_h, sk_s, sv_b, sv_h, sv_s, so_b, so_h, so_s;
  float softcap, scale;
};

// rows [row0, row0 + n_rows) of a (rows, D) slice with row stride `rs`
// (elements) into f32 shared memory of row stride Geom<D>::RS, times `mul`
// rounded to T first when `scaled`; rows past `valid` are zeros.
template <typename T, int D, bool scaled>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int row0, int n_rows, int valid, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int RS = Geom<D>::RS;
  for (int i = threadIdx.x; i < n_rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    float x[VEC];
    if (row0 + r < valid) {
      const uint4 w = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        x[j] = scaled ? to_f32(from_f32<T>(to_f32(e[j]) * mul)) : to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * RS + c);
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j)
      d4[j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(const Args a) {
  using G = Geom<D>;
  constexpr int TM = G::TM, BQ = G::BQ, RS = G::RS, TD = G::TD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [BQ][RS]
  float* KVs = Qs + BQ * RS;                     // [BK][RS], K then V
  float* Ps = KVs + BK * RS;                     // [BQ][PS]

  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = qtile * BQ;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;

  const QT* q = static_cast<const QT*>(a.q) + b * a.sq_b + h * a.sq_h;
  const KVT* k = static_cast<const KVT*>(a.k) + b * a.sk_b + kh * a.sk_h;
  const KVT* v = static_cast<const KVT*>(a.v) + b * a.sv_b + kh * a.sv_h;
  int kvl = a.kv_len ? a.kv_len[b] : a.kv_len_all;
  kvl = min(kvl, a.Skv);

  // K tiles [kt0, kt1): past kv_valid_len and the causal frontier nothing
  // is live; before the first key any row's window reaches, nothing is.
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  int kt1 = (max(kvl, 0) + BK - 1) / BK;
  int kt0 = 0;
  if (a.causal) {
    kt1 = min(kt1, q_last / BK + 1);
    if (a.window > 0) kt0 = max(0, q0 - a.window + 1) / BK;
  }
  const int win = a.window > 0 ? a.window : 0x7fffffff;

  stage<QT, D, true>(Qs, q, a.sq_s, q0, BQ, a.Sq, a.scale);

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = BIG_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < TD; ++e) acc[i][e] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's V reads are done (and Qs staged)
    stage<KVT, D, false>(KVs, k, a.sk_s, k0, BK, a.Skv, 1.f);
    __syncthreads();
    // 1. scores of rows ty*TM + i against keys tx + 8j
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * TM + i) * RS + d);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + TX * j) * RS + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }
    // 2. softcap, mask and the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty * TM + i;
      float mx = BIG_NEG;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = s[i][j];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = kpos < kvl;
        if (a.causal) {
          const int delta = qpos - kpos;
          ok = ok && delta >= 0 && delta < win;
        }
        x = ok ? x : BIG_NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * TM + i) * PS + tx + TX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < TD; ++e) acc[i][e] *= corr;
    }
    __syncthreads();   // the scores' K reads are done; Ps is complete
    stage<KVT, D, false>(KVs, v, a.sv_s, k0, BK, a.Skv, 1.f);
    __syncthreads();
    // 3. acc += P.V over the tile's keys
#pragma unroll 1
    for (int c = 0; c < BK; c += 4) {
      float4 p4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * TM + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = KVs + (c + cc) * RS + tx;
#pragma unroll
        for (int e = 0; e < TD; ++e) {
          const float x = vr[TX * e];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y : cc == 2 ? p4[i].z : p4[i].w;
            acc[i][e] = fmaf(p, x, acc[i][e]);
          }
        }
      }
    }
  }

  QT* out = static_cast<QT*>(a.out) + b * a.so_b + h * a.so_h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty * TM + i;
    if (r >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < TD; ++e)
      out[r * a.so_s + tx + TX * e] = from_f32<QT>(acc[i][e] * inv);
  }
}

template <typename QT, typename KVT, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Geom<D>;
  auto kernel = flash_attention_kernel<QT, KVT, D>;
  constexpr int smem = (int)G::SMEM;
  // The shared-memory limit is an attribute of the kernel on each device:
  // raise it once per instantiation and device.
  static bool smem_set[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && !smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((a.Sq + G::BQ - 1) / G::BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<QT, KVT, 16>(a, s);
    case 64: return launch<QT, KVT, 64>(a, s);
    case 80: return launch<QT, KVT, 80>(a, s);
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t value (0 on success). q (B,H,Sq,D), k and v
// (B,KH,Skv,D) and out (B,H,Sq,D) are given by element strides over
// (batch, head, row); the last dim is contiguous, every base pointer and
// row 16-byte aligned. kv_len is a (B,) int32 vector or null (then
// kv_len_all holds for every row). Dtype codes: 0 f32, 1 bf16; k and v
// share one, out has q's. D in {16, 64, 80, 128, 256}.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, int B, int H,
                               int KH, int Sq, int Skv, int D, int kv_len_all,
                               long long sq_b, long long sq_h, long long sq_s,
                               long long sk_b, long long sk_h, long long sk_s,
                               long long sv_b, long long sv_h, long long sv_s,
                               long long so_b, long long so_h, long long so_s,
                               int causal, int window, int q_dtype, int kv_dtype,
                               float softcap, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Skv < 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)out})
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_len = static_cast<const int32_t*>(kv_len);
  a.out = out;
  a.B = B;
  a.H = H;
  a.KH = KH;
  a.Sq = Sq;
  a.Skv = Skv;
  a.kv_len_all = kv_len_all;
  a.causal = causal;
  a.window = window;
  a.sq_b = sq_b;
  a.sq_h = sq_h;
  a.sq_s = sq_s;
  a.sk_b = sk_b;
  a.sk_h = sk_h;
  a.sk_s = sk_s;
  a.sv_b = sv_b;
  a.sv_h = sv_h;
  a.sv_s = sv_s;
  a.so_b = so_b;
  a.so_h = so_h;
  a.so_s = so_s;
  a.softcap = softcap;
  a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<float>(a, D, kv_dtype, s);
    case 1: return (int)dispatch_kv<__nv_bfloat16>(a, D, kv_dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The message of a cudaError_t value returned by flash_attention().
extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
