// Flash attention (forward) for Hopper (sm_90a): causal / sliding-window /
// softcap attention of a whole sequence from position 0, with an online
// softmax over K/V tiles staged through shared memory.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (its pallas_call at :148). Computes what it computes, for q (B,H,Sq,D) and
// k/v (B,KH,Skv,D), each f32 or bf16, given by element strides (the last dim
// contiguous), query head h reading KV head h / (H/KH) (GQA without a
// broadcast copy):
//  * scores are f32 sums of products of q scaled by D**-0.5 (in q's dtype, as
//    the port's plain version and chunked attention do) and k, with no TF32;
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
// Two variants, chosen by dtype alone (flash_attention_variant below):
//
// 1. q, k and v all bf16 (every served model): the tensor-core kernel
//    (namespace tc). What bounds it on the H100: operations. A live
//    (query, key, head) costs 4*D flops of q k^T and p v, and a block of
//    128 query rows reads each K/V byte once for all 128, so at long
//    prompts the bf16 tensor cores (989 TFLOP/s) are the limit; at
//    smollm's 16-token prefill, one tile's latency is. Design:
//    * One block of two warpgroups (256 threads) per (head, 128-row q-tile,
//      batch row), every head's latest q-tile first (causal tiles late in
//      the sequence see the most keys). Each warpgroup owns 64 query rows and runs on
//      its own: the two meet only where one would overtake the other by a
//      whole ring of K/V tiles.
//    * Both products are warpgroup MMAs (wgmma, f32 accumulators in
//      registers). S = Q K^T: m64n64k16, A = the warpgroup's q rows and
//      B = a 64-key K tile, both bf16 in shared memory; q is scaled in bf16
//      once and stays there for the whole K loop. Softcap (cap * tanh from
//      the SFU's exp2), masks and the softmax update run on the accumulator
//      registers, each branch taken by the whole warpgroup outside the
//      element loops; row max and sum reduce over the 4 lanes that share a
//      row. Then O = O*corr + hi.V + lo.V with A = p from registers and
//      B = the V tile read N-major (transposed) from shared memory, 16 keys
//      a step: the next step's halves are computed while a step's products
//      run.
//    * p is split, not rounded: hi = bf16(p), lo = bf16(p - hi) (p - hi is
//      exact in f32), so hi + lo carries 16 of p's 24 bits and the two bf16
//      products, summed in f32, keep the f32 function within one bf16 ulp
//      of the output; a single bf16 p (what SDPA does) leaves some outputs
//      more than one bf16 ulp off (tests/test_torch_flash.py emulates both
//      against the plain version). The split costs 6*D flops a live pair
//      instead of 4*D: its ceiling is 1.5x the bound.
//    * K/V tiles (bf16) go through a ring of STAGES slots (2 at D = 256, 3
//      below) by TMA: one thread issues a tile's boxes, which complete on
//      the slot's mbarrier, and the warpgroups wait on that. The last of
//      the block's 8 warps to be done with a slot refills it with the tile
//      STAGES ahead, so no warp is set aside to load and none waits to.
//      Rows past Skv read as zeros.
//    * Shared memory holds the tiles as wgmma reads them. Where D is a
//      multiple of 64: 128-byte swizzled atoms of 64 columns (a row of an
//      atom is 128 bytes, its 16-byte chunk j at j ^ (row % 8)), which TMA
//      writes for K/V and threads copy q into, so that neither the copies
//      nor the products meet bank conflicts. D = 16 and 80: wgmma's core
//      matrices without swizzle (8 rows of 16 bytes, 128 contiguous bytes).
//    * The output goes through shared memory (the warpgroup's q rows, no
//      longer read) and leaves 16 bytes a thread.
//    * Registers at D = 256: the 64 x 256 f32 output is 128 a thread, the
//      scores 32, two steps of p's halves 16; __launch_bounds__(256, 1)
//      leaves 255 and ptxas spills nothing (the build log shows each
//      instantiation's count). A producer warpgroup would cap the others
//      at 240 by setmaxnreg, and at D = 256 ptxas then spilled the output
//      accumulator; with none, there is nothing to rebalance.
//    * Shared memory: 128 rows of q plus 2 * STAGES tiles of 64 keys:
//      193 KB at D = 256, 129 KB at D = 128, one block an SM.
//
// 2. q or k/v in f32 (tests, f32 models): the SIMT kernel (namespace simt),
//    f32 FMAs outside the tensor cores on operands widened to f32 in shared
//    memory; its bound is the f32 peak (67 TFLOP/s).
//    * One block of 128 threads per (q-tile, head, batch row), q-tiles of
//      BQ = 64 rows (32 at D = 256), latest tile first.
//    * The scaled q-tile, one K or V tile of 64 keys and the tile's
//      probabilities sit in shared memory as f32, rows padded by 4 floats.
//      K and V share one buffer: the loads are not overlapped with compute.
//    * Threads form a 16 x 8 grid: thread (ty, tx) owns TM consecutive query
//      rows; for the scores it owns 8 keys (tx + 8j), for the output the D/8
//      columns tx + 8e. m, l and acc stay in registers.
//    * Shared memory: (BQ + 64) * (D + 4) * 4 + BQ * 68 * 4 bytes, 109 KB at
//      D = 256.
// Above 48 KB of shared memory the launcher raises the kernel's dynamic
// shared-memory limit once per device.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float BIG_NEG = -2.3819763e38f;
constexpr int NO_WINDOW = 0x7fffffff;

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

// K tiles [kt0, kt1) that rows [r0, r_last] need: past kv_valid_len and the
// causal frontier nothing is live; before the first key row r0's window
// reaches, nothing is.
__device__ __forceinline__ void tile_range(const Args& a, int kvl, int r0, int r_last,
                                           int bk, int& kt0, int& kt1) {
  kt1 = (max(kvl, 0) + bk - 1) / bk;
  kt0 = 0;
  if (a.causal) {
    kt1 = min(kt1, r_last / bk + 1);
    if (a.window > 0) kt0 = max(0, r0 - a.window + 1) / bk;
  }
}

// Raise a kernel's dynamic shared-memory limit above 48 KB, once per device
// (`done` is the instantiation's own flag array).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && !done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (q, k, v in bf16).
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WG_THREADS = 128;       // a warpgroup
constexpr int NWG = 2;                // warpgroups a block
constexpr int THREADS = NWG * WG_THREADS;
constexpr int WG_ROWS = 64;           // query rows a warpgroup
constexpr int BQ = NWG * WG_ROWS;     // query rows a block
constexpr int BK = 64;                // keys a tile
constexpr int CORE = 128;             // bytes of a core matrix
constexpr float LOG2E = 1.4426950408889634f;

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (each in 16-byte units) and the swizzle mode.
constexpr uint64_t SWIZZLE_128B = 1ull << 62;
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// A bf16 tile of ROWS rows and D columns in shared memory, as wgmma reads
// it; see the note at the top. Where D is a multiple of 64: 128-byte
// swizzled atoms of 64 columns (a row of an atom is 128 bytes; its 16-byte
// chunk j sits at j ^ (row % 8)); else core matrices without swizzle, one
// 8-column group after the other. Either way a TMA box of BOX_W columns
// lands at every BOX_BYTES.
template <int ROWS, int D> struct Tile {
  static constexpr bool SW = D % 64 == 0;
  static constexpr int ATOM = ROWS * 128;              // bytes of a 64-column atom
  static constexpr int COL = ROWS / 8 * CORE;          // no swizzle: bytes a column group
  static constexpr int BYTES = SW ? D / 64 * ATOM : D / 8 * COL;
  static constexpr int BOX_W = SW ? 64 : 8;            // columns of a TMA box
  static constexpr int BOX_BYTES = SW ? ATOM : COL;    // shared-memory stride of the boxes
  // byte offset of the 16-byte chunk of columns 8*c8..8*c8+7 in row r
  __device__ static __forceinline__ uint32_t offset(int r, int c8) {
    if constexpr (SW) return (c8 >> 3) * ATOM + r * 128 + (((c8 & 7) ^ (r & 7)) << 4);
    else return c8 * COL + (r >> 3) * CORE + (r & 7) * 16;
  }
  // K-major operand (q as A, K as B): all ROWS rows, columns 16kk..16kk+15.
  // Swizzled: LBO unused, SBO the 1024 bytes between 8-row groups; the 32
  // bytes of a 16-column step are added to the start address. (Each step
  // adds its offset to the first one's descriptor: the address field
  // cannot carry out, and one base descriptor is all that stays live.)
  __device__ static __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    if constexpr (SW)
      return (desc(base, 16, 1024) | SWIZZLE_128B) + (((kk >> 2) * ATOM + (kk & 3) * 32) >> 4);
    else return desc(base, COL, CORE) + ((2 * kk * COL) >> 4);
  }
  // N-major operand (V as B of p v): rows (keys) 16kk..16kk+15, columns
  // nc*c..nc*c+nc-1. Swizzled (nc = 64, one atom): SBO the 1024 bytes
  // between 8-key groups, LBO (between atoms along N) unused.
  template <int nc>
  __device__ static __forceinline__ uint64_t n_major(uint32_t base, int c, int kk) {
    if constexpr (SW) return (desc(base, 1024, 1024) | SWIZZLE_128B) + ((c * ATOM + kk * 16 * 128) >> 4);
    else return desc(base, CORE, COL) + ((c * (nc / 8) * COL + 2 * kk * CORE) >> 4);
  }
};

template <int D> struct Geom {
  using QTile = Tile<WG_ROWS, D>;
  using KVTile = Tile<BK, D>;
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int NC = D % 64 == 0 ? 64 : 16;   // output columns a p v wgmma
  static constexpr int NCH = D / NC;
  static constexpr int Q_BYTES = QTile::BYTES;       // a warpgroup's q rows
  static constexpr int KV_BYTES = KVTile::BYTES;     // one K or V tile (a multiple of 1024)
  // 1024 bytes to align the base to a swizzle atom's 8 rows (and every TMA
  // box); the ring's barriers and release counts last
  static constexpr size_t SMEM =
      1024 + (size_t)NWG * Q_BYTES + 2 * STAGES * (size_t)KV_BYTES + 2 * STAGES * 8;
};

#define F8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 f32) = [d +] a (64 x 16 bf16, shared, K-major) . b (16 x 64 bf16,
// shared, K-major); d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += a (64 x 16 bf16, registers) . b (16 x 64 bf16, shared, N-major)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16 f32) += a (64 x 16 bf16, registers) . b (16 x 16 bf16, shared, N-major)
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef F8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N = 0> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers a wgmma wrote or read stay put until its wait: the compiler must
// not read them earlier or reuse them before.
template <int N> __device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 16 bytes global -> shared, asynchronous; zeros when !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// This thread's shared-memory writes, visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory, and TMA loads that complete on them.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete. A wait that lasts
// about 10 s traps (a launch failure) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}
// The box at (x, y, z, w) of a 4-d tensor map into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         int z, int w, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(w), "r"(bar)
      : "memory");
}

// 2^x on the SFU; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cap * tanh(x / cap) as cap * (1 - 2 / (2^(x * k) + 1)) with k = 2 log2(e) /
// cap: the SFU's exp2 and reciprocal, within a few 1e-7 * cap of tanhf's.
__device__ __forceinline__ float softcap_tanh(float x, float cap, float k) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(exp2_ftz(x * k) + 1.f));
  return cap * (1.f - 2.f * r);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ Args a, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v) {
  using G = Geom<D>;
  using QT = typename G::QTile;
  using KT = typename G::KVTile;
  constexpr int STAGES = G::STAGES, NC = G::NC, NCH = G::NCH;
  constexpr int C8 = D / 8;                        // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - raw % 1024) % 1024);
  const uint32_t q_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t kv_s = q_s + NWG * G::Q_BYTES;   // STAGES x (K tile, V tile)
  const uint32_t full = kv_s + 2 * STAGES * G::KV_BYTES;   // STAGES mbarriers
  // per slot, the warps done with its tile
  unsigned* released = reinterpret_cast<unsigned*>(smem + (full - q_s) + 8 * STAGES);

  // Blocks start in order of blockIdx.x (the head) fastest: every head's
  // latest q-tile first, the longest causal ones, so that the short tiles
  // fill the last wave.
  const int h = blockIdx.x, qtile = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KH);
  const int q0 = qtile * BQ;
  const int tid = threadIdx.x, wg = tid / WG_THREADS;
  const int wt = tid % WG_THREADS;                 // thread within the warpgroup
  const int warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  int kvl = a.kv_len ? a.kv_len[b] : a.kv_len_all;
  kvl = min(kvl, a.Skv);

  // The block loads K/V tiles [kt0, kt1) into the ring; each warpgroup
  // multiplies the ones its rows see, [wk0, wk1).
  int kt0, kt1;
  tile_range(a, kvl, q0, min(q0 + BQ, a.Sq) - 1, BK, kt0, kt1);
  const int n = kt1 - kt0;
  // Tile it of the loop into slot it % STAGES, by TMA, completing on that
  // slot's mbarrier.
  auto load = [&](int it) {
    const int s = it % STAGES;
    const uint32_t ks = kv_s + s * 2 * G::KV_BYTES, vs = ks + G::KV_BYTES;
    const int k0 = (kt0 + it) * BK;
    mbar_expect_tx(full + 8 * s, 2 * G::KV_BYTES);
#pragma unroll
    for (int x = 0; x < D / KT::BOX_W; ++x) {
      tma_load(ks + x * KT::BOX_BYTES, &map_k, x * KT::BOX_W, k0, kh, b, full + 8 * s);
      tma_load(vs + x * KT::BOX_BYTES, &map_v, x * KT::BOX_W, k0, kh, b, full + 8 * s);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                 // the loader's expect_tx
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < min(n, STAGES); ++it) load(it);
  }
  __syncthreads();

  const int w0 = q0 + wg * WG_ROWS, w_last = min(w0 + WG_ROWS, a.Sq) - 1;
  int wk0, wk1;
  tile_range(a, kvl, w0, w_last, BK, wk0, wk1);
  if (w0 >= a.Sq) wk1 = wk0;                      // no rows of the sequence
  const int win = a.window > 0 ? a.window : NO_WINDOW;

  // This warpgroup's q rows, scaled by D**-0.5 in bf16: copied (rows past
  // Sq zero-filled), then each thread scales the chunks it copied, in place.
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq_b + h * a.sq_h;
  const uint32_t qa = q_s + wg * G::Q_BYTES;
  for (int i = wt; i < WG_ROWS * C8; i += WG_THREADS) {
    const int r = i / C8, c8 = i % C8;
    const bool ok = w0 + r < a.Sq;
    cp_async16(qa + QT::offset(r, c8), q + (ok ? w0 + r : 0) * a.sq_s + c8 * 8, ok);
  }
  cp_async_wait_all();
  for (int i = wt; i < WG_ROWS * C8; i += WG_THREADS) {
    uint4* chunk = reinterpret_cast<uint4*>(smem + wg * G::Q_BYTES + QT::offset(i / C8, i % C8));
    uint4 w = *chunk;
    bf16* e = reinterpret_cast<bf16*>(&w);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * a.scale);
    *chunk = w;
  }
  fence_async_shared();
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS) : "memory");

  // Thread (warp, g, t) holds rows row0 and row0 + 8 of the warpgroup's
  // accumulators, at columns 8i + 2t and 8i + 2t + 1 of each 8-column group
  // i: d[4i], d[4i + 1] in row row0, d[4i + 2], d[4i + 3] in row row0 + 8.
  const int row0 = w0 + warp * 16 + g;
  float o[NCH][NC / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) o[c][j] = 0.f;
  float m[2] = {BIG_NEG, BIG_NEG};
  float l[2] = {0.f, 0.f};          // this thread's columns only; summed at the end
  float s[BK / 2];
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    const int kt = kt0 + it;
    mbar_wait(full + 8 * st, (it / STAGES) & 1);
    if (kt >= wk0 && kt < wk1) {                  // else every row of the warpgroup is masked
      const int k0 = kt * BK;
      // Shared-memory bases, opaque to the compiler within the iteration so
      // that it rebuilds the descriptors from them here instead of keeping
      // every step's descriptor live across the loop.
      uint32_t qb = qa, ks = kv_s + st * 2 * G::KV_BYTES;
      asm volatile("" : "+r"(qb), "+r"(ks));
      const uint32_t vs = ks + G::KV_BYTES;

      // 1. s = q k^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma_ss(s, QT::k_major(qb, kk), KT::k_major(ks, kk), kk);
      wgmma_commit();
      wgmma_wait();
      keep(s);

      // 2. softcap, masks and the running max of each row
      if (a.softcap > 0.f) {
        const float k = 2.f * LOG2E / a.softcap;
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) s[j] = softcap_tanh(s[j], a.softcap, k);
      }
      // masks only where some key of the tile is masked for some row of the
      // warpgroup (each branch is the warpgroup's, outside the element loops)
      if (k0 + BK > kvl || (a.causal && (k0 + BK - 1 > w0 || w_last - k0 >= win))) {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int kpos = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
          const int delta = row0 + 8 * ((j >> 1) & 1) - kpos;
          const bool ok = kpos < kvl && (!a.causal || (delta >= 0 && delta < win));
          s[j] = ok ? s[j] : BIG_NEG;
        }
      }
      float mx[2] = {BIG_NEG, BIG_NEG};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2_ftz((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        l[r] *= corr[r];
      }

      // 3. o = o * corr (corr is 1 in every row of most tiles)
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < NC / 2; ++j) o[c][j] *= corr[(j >> 1) & 1];
      }

      // 4. o += hi v + lo v, 16 keys at a time: p = exp(s - m) in f32, split
      // into bf16 halves laid out as wgmma's A fragments (for keys
      // 16kk..16kk+15, register e holds s[8kk + 2e] and s[8kk + 2e + 1], of
      // row row0 for even e and row0 + 8 for odd). Each step's products run
      // while the next step's halves are computed; its registers (two steps
      // of halves) are reused once its group has completed.
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t(&h)[4] = hi[kk & 1];
        uint32_t(&w)[4] = lo[kk & 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * kk + 2 * e, r = e & 1;
          const float p0 = exp2_ftz((s[j] - m[r]) * LOG2E);
          const float p1 = exp2_ftz((s[j + 1] - m[r]) * LOG2E);
          l[r] += p0 + p1;
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
          h[e] = pack(h2);
          w[e] = pack(__floats2bfloat162_rn(p0 - __low2float(h2), p1 - __high2float(h2)));
        }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const uint64_t bv = KT::template n_major<NC>(vs, c, kk);
          mma_rs(o[c], h, bv);
          mma_rs(o[c], w, bv);
        }
        wgmma_commit();
        if (kk > 0) {
          wgmma_wait<1>();             // step kk - 1's products are done
          keep(hi[(kk - 1) & 1]);
          keep(lo[(kk - 1) & 1]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NCH; ++c) keep(o[c]);
      keep(hi[(BK / 16 - 1) & 1]);
      keep(lo[(BK / 16 - 1) & 1]);
    }
    // This warp is done with the slot; the last of the block's warps to be
    // done refills it with tile it + STAGES. Neither warpgroup waits for
    // the other, except where it would overtake it by STAGES tiles.
    __syncwarp();
    if (lane == 0 && atomicAdd(&released[st], 1) == NWG * 4 - 1) {
      released[st] = 0;
      if (it + STAGES < n) {
        fence_async_shared();
        load(it + STAGES);
      }
    }
  }

  // The output goes through shared memory (this warpgroup's q rows, which
  // no product reads any more), then 16 bytes a thread to device memory,
  // neighbouring threads on a row's neighbouring chunks.
  unsigned char* stage = smem + wg * G::Q_BYTES;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int rl = warp * 16 + g + 8 * r;          // row within the warpgroup
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int i = 0; i < NC / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(stage + QT::offset(rl, (c * NC + 8 * i) / 8) + 4 * t) =
            __floats2bfloat162_rn(o[c][4 * i + 2 * r] * inv, o[c][4 * i + 2 * r + 1] * inv);
  }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS) : "memory");
  bf16* out = static_cast<bf16*>(a.out) + b * a.so_b + h * a.so_h;
  for (int i = wt; i < WG_ROWS * C8; i += WG_THREADS) {
    const int r = i / C8, c8 = i % C8;
    if (w0 + r < a.Sq)
      *reinterpret_cast<uint4*>(out + (w0 + r) * a.so_s + c8 * 8) =
          *reinterpret_cast<const uint4*>(stage + QT::offset(r, c8));
  }
}

// cuTensorMapEncodeTiled, from the driver by its entry point (no link to
// libcuda); null if the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d TMA map of a (B, KH, rows, D) bf16 tensor with element strides
// (s_b, s_h, s_row, 1): boxes of `box_w` columns by BK rows, 128-byte
// swizzled or not, rows past `rows` read as zeros.
template <int D>
cudaError_t kv_map(CUtensorMap* map, const void* base, int rows, int heads, int batch,
                   long long s_row, long long s_head, long long s_batch) {
  using KT = typename Geom<D>::KVTile;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(rows > 0 ? rows : 1), (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)KT::BOX_W, (cuuint32_t)BK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            KT::SW ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = flash_tc_kernel<D>;
  constexpr int smem = (int)Geom<D>::SMEM;
  static bool smem_set[64] = {false};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap map_k, map_v;
  err = kv_map<D>(&map_k, a.k, a.Skv, a.KH, a.B, a.sk_s, a.sk_h, a.sk_b);
  if (err != cudaSuccess) return err;
  err = kv_map<D>(&map_v, a.v, a.Skv, a.KH, a.B, a.sv_s, a.sv_h, a.sv_b);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.Sq + BQ - 1) / BQ, a.B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(a, map_k, map_v);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The SIMT kernel (q or k/v in f32).
namespace simt {

constexpr int THREADS = 128;
constexpr int TX = 8;               // threads along a row
constexpr int TY = THREADS / TX;    // 16 thread rows
constexpr int BK = 64;              // keys per tile
constexpr int TN = BK / TX;         // keys per thread in the score pass
constexpr int PAD = 4;              // floats of row padding
constexpr int PS = BK + PAD;        // row stride of the probability tile

template <int D> struct Geom {
  static constexpr int TM = D > 128 ? 2 : 4;   // query rows per thread
  static constexpr int BQ = TY * TM;          // query rows per block
  static constexpr int RS = D + PAD;          // row stride of the q and K/V tiles
  static constexpr int TD = D / TX;           // output columns per thread
  static constexpr size_t SMEM = ((size_t)(BQ + BK) * RS + (size_t)BQ * PS) * 4;
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
  extern __shared__ __align__(128) unsigned char smem[];
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

  int kt0, kt1;
  tile_range(a, kvl, q0, min(q0 + BQ, a.Sq) - 1, BK, kt0, kt1);
  const int win = a.window > 0 ? a.window : NO_WINDOW;

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
  static bool smem_set[64] = {false};
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + G::BQ - 1) / G::BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt

// Dtype codes: 0 f32, 1 bf16. The tensor-core kernel takes q, k and v in
// bf16; any f32 operand takes the SIMT kernel.
bool tensor_core(int q_dtype, int kv_dtype) { return q_dtype == 1 && kv_dtype == 1; }

template <int D>
cudaError_t dispatch_dtype(const Args& a, int q_dtype, int kv_dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (tensor_core(q_dtype, kv_dtype)) return tc::launch<D>(a, s);
  if (q_dtype == 0 && kv_dtype == 0) return simt::launch<float, float, D>(a, s);
  if (q_dtype == 0 && kv_dtype == 1) return simt::launch<float, bf16, D>(a, s);
  if (q_dtype == 1 && kv_dtype == 0) return simt::launch<bf16, float, D>(a, s);
  return cudaErrorInvalidValue;
}

template <int D>
int smem_bytes(int q_dtype, int kv_dtype) {
  return (int)(tensor_core(q_dtype, kv_dtype) ? tc::Geom<D>::SMEM : simt::Geom<D>::SMEM);
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
  switch (D) {
    case 16: return (int)dispatch_dtype<16>(a, q_dtype, kv_dtype, s);
    case 64: return (int)dispatch_dtype<64>(a, q_dtype, kv_dtype, s);
    case 80: return (int)dispatch_dtype<80>(a, q_dtype, kv_dtype, s);
    case 128: return (int)dispatch_dtype<128>(a, q_dtype, kv_dtype, s);
    case 256: return (int)dispatch_dtype<256>(a, q_dtype, kv_dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1 if flash_attention() runs the tensor-core kernel for these dtype codes,
// 0 if the SIMT kernel.
extern "C" int flash_attention_variant(int q_dtype, int kv_dtype) {
  return tensor_core(q_dtype, kv_dtype) ? 1 : 0;
}

// The dynamic shared memory a block of the kernel flash_attention() runs
// for these dtype codes and head dim takes, in bytes; -1 for a head dim it
// does not take.
extern "C" int flash_attention_smem(int q_dtype, int kv_dtype, int D) {
  switch (D) {
    case 16: return smem_bytes<16>(q_dtype, kv_dtype);
    case 64: return smem_bytes<64>(q_dtype, kv_dtype);
    case 80: return smem_bytes<80>(q_dtype, kv_dtype);
    case 128: return smem_bytes<128>(q_dtype, kv_dtype);
    case 256: return smem_bytes<256>(q_dtype, kv_dtype);
    default: return -1;
  }
}

// The message of a cudaError_t value returned by flash_attention().
extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
