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
//    window are masked after the softcap: they carry no weight, as the
//    reference's BIG_NEG scores carry none once a row has seen a live one;
//  * the softmax is online in f32 (m, l, acc) and the result acc / l;
//  * rows that see no live position (kv_valid_len == 0) return zeros, and
//    the dump row is the only pool row read past a table's live blocks.
// The reference scans KV chunks of `chunk` positions in order; here the
// positions are split over lane groups, warps and blocks and their states
// merged by log-sum-exp, so the sums run in another order (within one bf16
// ulp of the reference; tests/test_torch_paged_kernel.py emulates this
// arithmetic in torch on the CPU).
//
// What bounds it on the H100. At decode a query row does 4*D flops per KV
// position against 2*D*bytes(pool) bytes read, about one flop per byte in
// bf16, far below the ~295 the card needs before compute binds: the bound is
// the live KV bytes over the memory rate (3.35 TB/s). At the engine's shapes
// (at most 64 live positions a row, 20-32 (row, KV head) pairs) those bytes
// take well under a microsecond, so what the kernel pays is the chain of
// dependent memory round trips from launch to store (kv_len and the table,
// then K/V) and each warp's chain of dependent latencies per stage (score
// shuffles, exps). Over long contexts the bytes bind only where enough
// warps keep enough stages in flight: the split over blocks and the rings
// are there for that.
//
// Design:
//  * The geometry (rows and warps of a block, elements a lane, positions a
//    stage, table pages a split, splits at most, blocks an SM, ring bytes)
//    comes from the PA_* macros, which kernels/_build.py sets from the
//    constants of kernels/paged_attention.py: the wrapper sizes its grids
//    and the CPU emulation test reads the same values.
//  * A block takes RT rows (query position x query head of one KV head, so
//    each KV byte serves every head of its group; 2 today) in WARPS warps
//    (8), one batch row, and one split of the row's table pages. Small
//    tiles give the card more blocks, and each warp fewer stages in a row.
//  * Every load in flight before the first wait. The block reads kv_len, the
//    rows' query positions, its split's table entries (into shared memory)
//    and q (16-byte vector loads, scaled in q's dtype, into registers) all at
//    once; one barrier; then each warp issues the cp.async copies of the K
//    and V rows of its first NS stages together. Tiles past the live length,
//    the causal frontier or before the window are never loaded.
//  * The live range split over warps: a KV row is spread over L = D/8 lanes
//    (8 elements a lane, never a whole 128-float piece), so a warp takes
//    32/L positions at a time, NP = 2 per lane group per stage; stages are
//    dealt to the warps in turn. Each lane copies exactly the bytes it later
//    reads (its 8 elements of each of its positions' K and V rows) into its
//    warp's ring of NS stages, so no barrier guards the ring: a lane waits
//    on its own copy groups (cp.async.wait_group), computes the stage, and
//    issues the stage NS ahead into the slot it just read.
//  * Each lane group keeps its own online softmax (m, l, acc[8] per row) in
//    registers: scores are partial dot products reduced over the group's
//    lanes by shuffles, p stays in registers. At the end the groups of a
//    warp merge by shuffles and the warps once through shared memory.
//  * The live range split over blocks when the grid is short: the wrapper
//    picks the split from the table's width and the SM count (the caller's
//    n_splits is a floor). Each block writes its state (acc, m, l) in f32;
//    the last block of a (row tile, KV head, batch row) to finish, found by
//    an atomic counter that it resets to 0, merges them inside the launch
//    (every split's state requested at once) and writes the output. Splits
//    past a row's live range write l = 0 and acc = 0.
//  * Registers follow the rows: q and acc take EL*RT each (16 a thread at
//    8 elements and 2 rows). A stage computes all RT rows without a branch
//    per row (rows past the live ones hold q = 0 and are never stored), so
//    the compiler interleaves the rows' and positions' shuffle chains.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#if !defined(PA_ROWS) || !defined(PA_WARPS) || !defined(PA_LANE_ELEMENTS) ||  \
    !defined(PA_STAGE_POSITIONS) || !defined(PA_TABLE_MAX) || !defined(PA_SPLIT_MAX) || \
    !defined(PA_BLOCKS_PER_SM) || !defined(PA_RING_BYTES)
#error "build with kernels/_build.py: it passes the geometry of kernels/paged_attention.py"
#endif

namespace {

constexpr int RT = PA_ROWS;                  // rows per block
constexpr int WARPS = PA_WARPS;              // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int SPLIT_MAX = PA_SPLIT_MAX;      // blocks a row tile is split over
constexpr int EL = PA_LANE_ELEMENTS;         // elements of a KV row per lane
constexpr int NP = PA_STAGE_POSITIONS;       // positions per lane group per stage
constexpr int RING_BYTES = PA_RING_BYTES;    // the warps' K/V rings together, at least
constexpr int TABLE_MAX = PA_TABLE_MAX;      // table entries of one split
constexpr int BLOCKS_PER_SM = PA_BLOCKS_PER_SM;
static_assert(TABLE_MAX % THREADS == 0, "each thread reads as many table entries");
constexpr float BIG_NEG = -2.3819763e38f;
constexpr unsigned FULL = 0xffffffffu;

// Dtype codes of the C interface: 0 f32, 1 bf16, 2 int8 (pools only).
template <int C> struct DType;
template <> struct DType<0> { using T = float; };
template <> struct DType<1> { using T = __nv_bfloat16; };
template <> struct DType<2> { using T = int8_t; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N contiguous elements of T at p (aligned to their size: 8 bytes or a
// multiple of 16), read as vectors and widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES == 8 || BYTES % 16 == 0, "8 bytes or a multiple of 16");
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int k = 0; k < PER; ++k) out[i * PER + k] = to_f32(e[k]);
    }
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = to_f32(e[k]);
  }
}

// Asynchronous copy of BYTES (8 or 16) global -> shared; zero-fills the
// destination and reads nothing when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* kv_len;
  const int32_t* q_pos;
  void* out;
  float* acc;      // (n_split, B, Sq, H, D) partial states, n_split > 1
  float* m;        // (n_split, B, Sq, H)
  float* l;
  int* counters;   // one per (batch row, KV head, row tile), 0 between launches
  int B, Sq, H, KH, n_pool, bs, bs_shift, W, n_pages, n_split, span, n_rt, causal,
      window;
  float softcap, scale, inv_int8_scale;
};

// Shared memory of a block: NS stages of every warp's ring (RING_BYTES, or
// two stages where those take more), then the split's table entries.
template <typename KVT> struct Ring {
  static constexpr int STAGE = 2 * NP * 32 * EL;   // K and V of a warp stage, elements
  static constexpr int WARP_STAGE = STAGE * (int)sizeof(KVT);
  static constexpr int NS = RING_BYTES / (WARPS * WARP_STAGE) > 2
                                ? RING_BYTES / (WARPS * WARP_STAGE) : 2;
  static constexpr int BYTES = NS * WARPS * WARP_STAGE;
  static constexpr int SMEM = BYTES + TABLE_MAX * 4;   // dynamic, at most
  // BLOCKS_PER_SM blocks fit the SM's 227 KB (1 KB of static per block)
  static_assert(BLOCKS_PER_SM * (SMEM + 1024) <= 227 * 1024, "blocks fit an SM");
};

template <int QC, int KC, int D>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    paged_attention_kernel(const Args a) {
  using QT = typename DType<QC>::T;
  using KVT = typename DType<KC>::T;
  constexpr int L = D / EL;                  // lanes per KV row
  constexpr int PW = 32 / L;                 // lane groups per warp
  constexpr int PS = PW * NP;                // positions per warp stage
  constexpr int VEC = 16 / (int)sizeof(KVT) < EL ? 16 / (int)sizeof(KVT) : EL;
  constexpr int CH = EL / VEC;               // contiguous chunks of a lane's EL
  constexpr int CB = VEC * (int)sizeof(KVT); // bytes of a chunk: 16, or 8 (int8)
  static_assert(D % EL == 0 && 32 % L == 0, "a KV row spreads over lanes of one warp");
  static_assert(CB == 16 || CB == 8, "cp.async copies of 16 or 8 bytes");
  constexpr int STAGE = Ring<KVT>::STAGE;   // K then V of a stage
  constexpr int NS = Ring<KVT>::NS;
  static_assert(STAGE == 2 * PS * D, "a stage holds PS rows of K and of V");
  static_assert(NS >= 2 && (NS & (NS - 1)) == 0, "ring of >= 2 stages");
  static_assert(WARPS * RT * D * 4 + 2 * WARPS * RT * 4 <= RING_BYTES, "merge fits");
  static_assert(2 * RT * SPLIT_MAX * 4 <= RING_BYTES, "split weights fit");
  constexpr int RING = Ring<KVT>::BYTES;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem + RING);   // the split's pages
  __shared__ int last_block;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int li = lane % L, gi = lane / L;
  const int split = blockIdx.x % a.n_split, rt = blockIdx.x / a.n_split;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KH;
  const int r0 = rt * RT;                    // rows r = qi * G + g
  const int R = min(RT, a.Sq * G - r0);

  // 1. Everything the block reads first, all in flight at once.
  const int kvl = a.kv_len[b];
  int qp[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
    qp[r] = r < R ? a.q_pos[(size_t)b * a.Sq + (r0 + r) / G] : 0;
  const int page0 = split * a.span;
  const int npg = max(min(a.span, a.n_pages - page0), 0);
  const int dump = a.n_pool - 1;
  const int32_t* table = a.tables + (size_t)b * a.W;
  int tv[TABLE_MAX / THREADS];               // the entries, stored after q is requested
#pragma unroll
  for (int i = 0; i < TABLE_MAX / THREADS; ++i) {
    const int e = page0 + tid + i * THREADS;
    tv[i] = tid + i * THREADS < npg && e < a.W ? table[e] : dump;   // the chunk grid's padding
  }
  float q[RT][EL];
  const QT* qg = static_cast<const QT*>(a.q);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < R) {
      const int row = r0 + r;
      const QT* src = qg + (((size_t)b * a.Sq + row / G) * a.H + kh * G + row % G) * D;
#pragma unroll
      for (int c = 0; c < CH; ++c) load_vec<QT, VEC>(src + (c * L + li) * VEC, q[r] + c * VEC);
#pragma unroll
      for (int e = 0; e < EL; ++e) q[r][e] = to_f32(from_f32<QT>(q[r][e] * a.scale));
    } else {
#pragma unroll
      for (int e = 0; e < EL; ++e) q[r][e] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < TABLE_MAX / THREADS; ++i)
    if (tid + i * THREADS < npg) tab[tid + i * THREADS] = min(max(tv[i], 0), dump);   // never outside the pool
  __syncthreads();

  // 2. The block's live range: its split's pages, the live length, the
  // causal frontier of its last row and the window of its first.
  int maxq = INT_MIN, minq = INT_MAX;
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (r < R) {
      maxq = max(maxq, qp[r]);
      minq = min(minq, qp[r]);
    }
  int lo = page0 * a.bs;
  int hi = min((page0 + npg) * a.bs, kvl);
  if (a.causal) {
    hi = min(hi, maxq < INT_MAX ? maxq + 1 : maxq);
    if (a.window > 0) lo = max(lo, minq - a.window + 1);
  }
  const int n = max(hi - lo, 0);
  const int win = a.window > 0 ? a.window : INT_MAX;
  const int nst = n > warp * PS ? (n - warp * PS + WARPS * PS - 1) / (WARPS * PS) : 0;

  const KVT* kpool = static_cast<const KVT*>(a.k);
  const KVT* vpool = static_cast<const KVT*>(a.v);
  KVT* ring = reinterpret_cast<KVT*>(smem) + (size_t)warp * NS * STAGE;
  // Stage t of this warp: positions lo + (t * WARPS + warp) * PS + j * PW + gi.
  auto issue = [&](int t) {
    KVT* st = ring + (t % NS) * STAGE;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int p = lo + (t * WARPS + warp) * PS + j * PW + gi;
      const bool ok = p < hi;
      const int pc = ok ? p : lo;
      const int pg = a.bs_shift >= 0 ? pc >> a.bs_shift : pc / a.bs;
      const int blk = tab[pg - page0];
      const size_t off = ((size_t)blk * a.bs + (pc - pg * a.bs)) * a.KH * D + (size_t)kh * D;
      KVT* dk = st + (j * PW + gi) * D;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int d0 = (c * L + li) * VEC;
        cp_async<CB>(dk + d0, kpool + off + d0, ok);
        cp_async<CB>(dk + PS * D + d0, vpool + off + d0, ok);
      }
    }
  };

  float m[RT], l[RT], acc[RT][EL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = BIG_NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[r][e] = 0.f;
  }
#pragma unroll 1
  for (int t = 0; t < NS; ++t) {
    if (t < nst) issue(t);
    cp_commit();
  }

  // 3. The warp's stages: scores, online softmax per lane group, P.V.
#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    cp_wait<NS - 1>();                      // this lane's copies of stage t
    const KVT* st = ring + (t % NS) * STAGE;
    const int pbase = lo + (t * WARPS + warp) * PS + gi;
    float s[NP][RT];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float kf[EL];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        load_vec<KVT, VEC>(st + (j * PW + gi) * D + (c * L + li) * VEC, kf + c * VEC);
      if constexpr (std::is_same<KVT, int8_t>::value) {
#pragma unroll
        for (int e = 0; e < EL; ++e) kf[e] *= a.inv_int8_scale;   // exact: a power of two
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) x = fmaf(q[r][e], kf[e], x);
        s[j][r] = x;
      }
    }
    // Every row, live or not (rows past R hold q = 0 and are never stored),
    // and the shuffle rounds outermost: the (position, row) chains interleave.
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int r = 0; r < RT; ++r) s[j][r] += __shfl_xor_sync(FULL, s[j][r], o);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = m[r];
      bool ok[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float x = s[j][r];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const int p = pbase + j * PW, delta = qp[r] - p;
        ok[j] = p < hi && (!a.causal || (delta >= 0 && delta < win));
        s[j][r] = x;
        if (ok[j]) mx = fmaxf(mx, x);
      }
      const float corr = __expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        s[j][r] = ok[j] ? __expf(s[j][r] - mx) : 0.f;
        sum += s[j][r];
      }
      m[r] = mx;
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float vf[EL];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        load_vec<KVT, VEC>(st + PS * D + (j * PW + gi) * D + (c * L + li) * VEC, vf + c * VEC);
      if constexpr (std::is_same<KVT, int8_t>::value) {
#pragma unroll
        for (int e = 0; e < EL; ++e) vf[e] *= a.inv_int8_scale;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[r][e] = fmaf(s[j][r], vf[e], acc[r][e]);
      }
    }
    if (t + NS < nst) issue(t + NS);        // into the slot just read
    cp_commit();
  }
  cp_wait<0>();

  // 4. Merge the warp's lane groups (log-sum-exp, by shuffles).
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float mo = __shfl_xor_sync(FULL, m[r], o);
      const float lo2 = __shfl_xor_sync(FULL, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float c1 = __expf(m[r] - mn), c2 = __expf(mo - mn);
      l[r] = l[r] * c1 + lo2 * c2;
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        const float ao = __shfl_xor_sync(FULL, acc[r][e], o);
        acc[r][e] = acc[r][e] * c1 + ao * c2;
      }
      m[r] = mn;
    }
  }

  // 5. Merge the warps once, through shared memory (the rings are done).
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem);   // [WARPS][RT][D]
  float* wm = wacc + WARPS * RT * D;              // [WARPS][RT]
  float* wl = wm + WARPS * RT;
  if (gi == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < R) {
        float* dst = wacc + (warp * RT + r) * D;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) dst[(c * L + li) * VEC + e] = acc[r][c * VEC + e];
        }
        if (li == 0) {
          wm[warp * RT + r] = m[r];
          wl[warp * RT + r] = l[r];
        }
      }
    }
  }
  __syncthreads();

  QT* out = static_cast<QT*>(a.out);
  const size_t prow = ((size_t)split * a.B + b) * a.Sq;   // (n_split, B, Sq, H, ...)
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D, row = r0 + r;
    float mx = BIG_NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * RT + r]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = __expf(wm[w * RT + r] - mx);
      ls += wl[w * RT + r] * c;
      as += wacc[(w * RT + r) * D + d] * c;
    }
    const size_t h = (size_t)kh * G + row % G;
    if (a.n_split == 1) {
      out[(((size_t)b * a.Sq + row / G) * a.H + h) * D + d] = from_f32<QT>(as / fmaxf(ls, 1e-30f));
    } else {
      const size_t at = (prow + row / G) * a.H + h;
      a.acc[at * D + d] = as;                      // 0 where no position was live
      if (d == 0) {
        a.m[at] = mx;
        a.l[at] = ls;
      }
    }
  }
  if (a.n_split == 1) return;

  // 6. The last split of this tile to finish merges every split's state:
  // every (m, l) at once into shared memory, then each output element's
  // acc of every split, all loads in flight together.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = a.counters + ((size_t)b * a.KH + kh) * a.n_rt + rt;
    const int done = atomicAdd(cnt, 1);
    last_block = done == a.n_split - 1;
    if (last_block) *cnt = 0;               // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int ns = a.n_split;
  float* sw = reinterpret_cast<float*>(smem);    // [RT][ns] weights
  float* sl = sw + RT * ns;                      // [RT][ns] l, then [RT] sums
  const size_t stride = (size_t)a.B * a.Sq * a.H;   // one split's rows
  for (int i = tid; i < R * ns; i += THREADS) {
    const int r = i / ns, sp = i % ns, row = r0 + r;
    const size_t at = sp * stride + ((size_t)b * a.Sq + row / G) * a.H + kh * G + row % G;
    sw[i] = __ldcg(a.m + at);
    sl[i] = __ldcg(a.l + at);
  }
  __syncthreads();
  if (tid < R) {
    float mx = BIG_NEG, ls = 0.f;
    for (int sp = 0; sp < ns; ++sp) mx = fmaxf(mx, sw[tid * ns + sp]);
    for (int sp = 0; sp < ns; ++sp) {
      const float lp = sl[tid * ns + sp];
      const float c = lp > 0.f ? __expf(sw[tid * ns + sp] - mx) : 0.f;
      sw[tid * ns + sp] = c;
      ls += lp * c;
    }
    sl[tid * ns] = ls;                           // l of every split merged
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D, row = r0 + r;
    const size_t at = ((size_t)b * a.Sq + row / G) * a.H + kh * G + row % G;
    float as = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < ns; ++sp)
      as = fmaf(sw[r * ns + sp], __ldcg(a.acc + (sp * stride + at) * D + d), as);
    out[at * D + d] = from_f32<QT>(as / fmaxf(sl[r * ns], 1e-30f));
  }
}

template <int QC, int KC, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using R = Ring<typename DType<KC>::T>;
  constexpr int RING = R::BYTES;
  constexpr int SMEM = R::SMEM;
  auto kernel = paged_attention_kernel<QC, KC, D>;
  // The shared-memory limit is an attribute of the kernel on each device:
  // raise it once per instantiation and device, not on every launch.
  static bool smem_set[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int smem = RING + ((a.span * 4 + 15) & ~15);
  const dim3 grid(a.n_rt * a.n_split, a.KH, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int QC, int KC>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<QC, KC, 16>(a, s);
    case 32: return launch<QC, KC, 32>(a, s);
    case 64: return launch<QC, KC, 64>(a, s);
    case 128: return launch<QC, KC, 128>(a, s);
    case 256: return launch<QC, KC, 256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int QC>
cudaError_t dispatch_kv(const Args& a, int D, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case 0: return dispatch_d<QC, 0>(a, D, s);
    case 1: return dispatch_d<QC, 1>(a, D, s);
    case 2: return dispatch_d<QC, 2>(a, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t value (0 on success). q (B,Sq,H,D), the pools
// (n_pool,bs,KH,D), tables (B,W), kv_len (B,) and q_pos (B,Sq) are
// contiguous; q and the pools 16-byte aligned. Positions [0, n_pages * bs)
// are scanned (the reference's chunk grid; table entries past W read the dump
// row), split into n_split runs of ceil(n_pages / n_split) pages, at most
// TABLE_MAX. n_split == 1 writes `out` (B,Sq,H,D) in q's dtype directly;
// n_split > 1 also takes f32 scratch `acc` (n_split,B,Sq,H,D), `m` and `l`
// (n_split,B,Sq,H) and `counters`, B*KH*ceil(Sq*H/KH / RT) int32 that are
// 0 and are left 0. n_split is at most SPLIT_MAX.
// Dtype codes: 0 f32, 1 bf16, 2 int8 (pools only); int8_scale is a power
// of two.
extern "C" int paged_attention(const void* q, const void* k, const void* v,
                               const void* tables, const void* kv_len,
                               const void* q_pos, void* out, void* acc, void* m,
                               void* l, void* counters, int B, int Sq, int H,
                               int KH, int D, int n_pool, int bs, int W,
                               int n_pages, int n_split, int causal,
                               int window, int q_dtype, int kv_dtype,
                               float softcap, float scale, float int8_scale,
                               void* stream) {
  int exp2 = 0;
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || n_pool <= 0 ||
      bs <= 0 || W <= 0 || n_pages <= 0 || n_split < 1 || n_split > n_pages ||
      (uintptr_t)q % 16 != 0 || (uintptr_t)k % 16 != 0 || (uintptr_t)v % 16 != 0 ||
      frexpf(int8_scale, &exp2) != 0.5f || B > 65535 || KH > 65535 ||
      n_split > SPLIT_MAX)
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
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.KH = KH;
  a.n_pool = n_pool;
  a.bs = bs;
  a.bs_shift = (bs & (bs - 1)) == 0 ? __builtin_ctz(bs) : -1;
  a.W = W;
  a.n_pages = n_pages;
  a.n_split = n_split;
  a.span = (n_pages + n_split - 1) / n_split;
  a.n_rt = (Sq * (H / KH) + RT - 1) / RT;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  a.inv_int8_scale = 1.f / int8_scale;
  if (a.span > TABLE_MAX || (long long)a.n_rt * n_split > INT_MAX ||
      (n_split > 1 && (!acc || !m || !l || !counters)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return (int)dispatch_kv<0>(a, D, kv_dtype, s);
    case 1: return (int)dispatch_kv<1>(a, D, kv_dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The message of a cudaError_t value returned by paged_attention().
extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
