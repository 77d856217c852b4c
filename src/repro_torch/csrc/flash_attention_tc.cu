// Flash attention for Hopper (sm_90a) on the tensor cores: the bf16 route of
// K2, forward and backward, for the training path (cache-less attention
// over whole sequences). fp32 keeps the CUDA-core kernels of
// flash_attention.cu: on the tensor cores fp32 would mean TF32.
//
// Replaces:
//   flash_fwd_tc_kernel      <- repro/kernels/flash_attention/kernel.py
//                               _flash_kernel (flash_attention_pallas)
//   flash_bwd_dq_tc_kernel,  the backward, which the Pallas kernel never had
//   flash_bwd_dkdv_tc_kernel,   (the JAX training step differentiates the
//   flash_bwd_dkdv_sum_kernel   jnp flash_attention)
//
// Bound on the H100: operations. At the training shape (S = 2048, D = 64)
// every key and value is reused by a whole tile of query rows, far above
// the ~295 operations per byte at which memory would be the limit. So every
// product runs on the tensor cores: wgmma.mma_async m64n64k16 with bf16
// operands and fp32 sums. Q.K^T-like products read both operands from
// shared memory; products by a probability or a dS tile take it from
// registers (it is rounded to bf16 there, in the accumulator layout, which
// is the A-fragment layout of the next product) and the other operand from
// shared memory with the transpose bit.
//
// Shared memory. Every tile is bf16, rows of the head dim zero-padded to
// DP = a multiple of 64 (one 128-byte swizzle atom: zero columns change no
// dot product), stored as DP/64 column blocks of R rows x 128 bytes with
// the 128-byte swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)),
// 1024-byte aligned: the layout wgmma's descriptors name as B128, read
// K-major (a k16 step is 32 bytes along a row) or MN-major (a k16 step is
// 16 rows). Tiles arrive by cp.async 16-byte copies (zero-filled past the
// sequence), issued by all threads one tile ahead of the compute in a ring
// of two stages (one at DP = 256, where two do not fit). Head dims that are
// not a multiple of 8 (D = 100) cannot use 16-byte copies from a (B, S, H,
// D) row; they are staged element by element, as synchronous loads.
// A single producer warp with TMA would overlap more; this first
// tensor-core version keeps every warp on the same program, so the ring is
// guarded by __syncthreads and cp.async groups, not by mbarriers.
//
// Per-score code (scale, soft-cap, mask, exp) runs on every score of every
// tile and is the largest part of the forward's time on the H100
// (tools/flash_tc_variants.py times the forward without it), so the
// uniform branches sit outside the loops, the mask is a bit set built
// without branches (only for tiles not proven fully visible), and exp runs
// as the special-function unit's ex2.approx.
//
// Masking is that of flash_attention.cu exactly: scores are q.k / sqrt(D),
// soft-capped, masked to NEG_INF = -1e30 where the key is at or past
// kv_len, in the query's future (causal) or at or before qpos - window;
// m_safe = 0 while the row max is NEG_INF; alpha = 0 while the previous max
// is; out = acc / max(l, 1e-30); LSE = m + log(l), LSE_MASKED = 1e30 for a
// fully masked row. Before its loop a block flags, one bit a tile in
// shared memory (sequences up to MAX_TILES x 64 = 131072 rows), the
// iterated tiles whose position ranges may hold a pair visible to its rows,
// and loads only those; a warpgroup also skips computing a tile its own 64
// rows cannot see. Both are exact, since such a tile changes no sum. A tile
// whose ranges prove every pair visible skips the per-score mask.
//
// Grids. Forward and dq: one block of two consumer warpgroups (64 query
// rows each) per 128-row q tile of one (batch, q head), over 64-key tiles,
// q tiles launched longest-first (reversed blockIdx.x) so the causal tail
// does not end the kernel on a few SMs; at DP = 64 the forward is held to
// 128 registers, so two blocks share an SM. dk/dv: one block per (128-key
// tile, q head, batch), two warpgroups of 64 keys, over 64-row q tiles,
// heaviest kv tiles first; each writes fp32 partial dK, dV of shape
// (B, Sk, Hq, D), and flash_bwd_dkdv_sum_kernel sums the G partials of each
// kv head in a fixed order into dk, dv. The grid is then Hq, not Hkv, wide,
// which balances the causal triangle over the SMs, and no atomics are used:
// two calls give bitwise-equal gradients. The dq kernel writes Delta =
// rowsum(dO * O) in its prologue; the dk/dv kernel runs after it on the
// same stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LSE_MASKED = 1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 256;   // two warpgroups
constexpr int TR = 128;   // rows a block owns (64 per warpgroup)
constexpr int TI = 64;    // rows of an iterated tile
constexpr int MAX_TILES = 2048;  // iterated tiles a block can flag: 131072 rows

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* q;       // (B, Sq, Hq, D)
  const bf16* k;       // (B, Sk, Hkv, D)
  const bf16* v;       // (B, Sk, Hkv, D)
  const int* qpos;     // (B, Sq)
  const int* kpos;     // (B, Sk)
  const int* kvlen;    // (B,) or nullptr
  const bf16* o;       // backward: the forward's output
  const bf16* dout;    // backward: dO
  const float* lse;    // backward: (B, Hq, Sq)
  float* delta;        // backward: (B, Hq, Sq), written by the dq kernel
  bf16* out;           // forward: O; backward: dQ
  float* lse_out;      // forward: (B, Hq, Sq)
  float* dk_part;      // backward: (B, Sk, Hq, D) fp32
  float* dv_part;
  bf16* dk;            // backward: (B, Sk, Hkv, D)
  bf16* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  int causal, window;
  float softcap, scale;
  int vec;             // 16-byte copies: D % 8 == 0 and 16-byte aligned tensors
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a B128-swizzled tile: start, leading and stride byte
// offsets (the stride is 1024: eight 128-byte rows)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_D32(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
  "+f"(d[31])

#define WG_REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64) (+)= A (64 x 16, K-major in shared memory) . B (16 x 64, stored
// as 64 rows of 16: K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16 bf16 in registers, accumulator layout) . B
// (16 x 64, stored as 16 rows of 64: MN-major, transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (no range fix-up: results below the
// smallest normal float flush to 0, which a probability can take)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// k16 step kk of a 64 x 64 accumulator as the A fragment of the next product
__device__ __forceinline__ void to_afrag(const float (&s)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// byte offset of 16-byte chunk j of row r in a swizzled tile of R rows
__device__ __forceinline__ uint32_t chunk_off(int R, int r, int j) {
  return static_cast<uint32_t>((j >> 3) * R * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4));
}

// Stage rows [row0, row0 + R) of one head (src points at row 0 of it, rows
// `stride` elements apart) into a swizzled tile of DP columns; rows at or
// past n_rows and columns at or past D are zero.
template <int R, int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int row0, int n_rows,
                                          long stride, int D, bool vec) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  if (vec) {
    for (int idx = threadIdx.x; idx < R * CH; idx += NT) {
      const int r = idx / CH, j = idx - r * CH;
      const int g = row0 + r;
      const bool ok = g < n_rows && 8 * j < D;
      const bf16* p = ok ? src + static_cast<long>(g) * stride + 8 * j : src;
      cp_async16(dst + chunk_off(R, r, j), p, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * DP; idx += NT) {
      const int r = idx / DP, c = idx - r * DP;
      const int g = row0 + r;
      const bf16 x = g < n_rows && c < D ? src[static_cast<long>(g) * stride + c]
                                         : __float2bfloat16(0.f);
      const uint32_t a = dst + chunk_off(R, r, c >> 3) + ((c & 7) << 1);
      asm volatile("st.shared.b16 [%0], %1;\n"
                   :: "r"(a), "h"(*reinterpret_cast<const unsigned short*>(&x)) : "memory");
    }
  }
}

// K-major descriptor of the 64 rows at `row` of a tile of R rows, k16 step ks
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row, int ks) {
  return gmma_desc(tile + (ks >> 2) * R * 128 + row * 128 + (ks & 3) * 32, 0);
}

// MN-major descriptor: k16 step kk (rows 16 kk ..) and 64-column block cb of
// a tile of R rows
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int cb) {
  return gmma_desc(tile + cb * R * 128 + kk * 16 * 128, R * 128);
}

// ---------------------------------------------------------------------------
// position ranges and tile votes
// ---------------------------------------------------------------------------

struct Range {
  int lo, hi;  // lo > hi: no valid row
};

// min / max of pos[0 .. min(count, valid)), over one warp
__device__ __forceinline__ Range warp_range(const int* pos, int count, int valid) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x & 31; i < count; i += 32) {
    if (i < valid) {
      const int p = pos[i];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  return {__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi)};
}

__device__ __forceinline__ bool none_visible(const Args& a, Range q, Range k, int kvlen) {
  if (q.lo > q.hi || k.lo > k.hi || k.lo >= kvlen) return true;
  if (a.causal && k.lo > q.hi) return true;
  if (a.window > 0 && static_cast<long>(k.hi) <= static_cast<long>(q.lo) - a.window) return true;
  return false;
}

// every (valid row, key) pair visible; `full`: the iterated tile lies
// wholly inside its sequence
__device__ __forceinline__ bool all_visible(const Args& a, Range q, Range k, int kvlen,
                                            bool full) {
  if (!full || q.lo > q.hi || k.lo > k.hi || k.hi >= kvlen) return false;
  if (a.causal && k.hi > q.lo) return false;
  if (a.window > 0 && static_cast<long>(k.lo) <= static_cast<long>(q.hi) - a.window)
    return false;
  return true;
}

// Flag, in `flags` (shared memory, MAX_TILES bits), each tile of TI rows of
// the iterated sequence (n rows at positions pos) that may hold a visible
// pair with the block's own rows (range `own`): each warp takes every
// eighth tile. `keys`: the iterated rows are keys (forward, dq), else
// queries (dk/dv). Ends in a barrier.
__device__ __forceinline__ void flag_tiles(uint32_t* flags, const Args& a, Range own,
                                           const int* pos, int n, int ntiles, int kvlen,
                                           bool keys) {
  for (int w = threadIdx.x; w < MAX_TILES / 32; w += NT) flags[w] = 0u;
  __syncthreads();
  for (int t = threadIdx.x >> 5; t < ntiles; t += NT / 32) {
    const Range r = warp_range(pos + t * TI, TI, n - t * TI);
    const bool none = keys ? none_visible(a, own, r, kvlen) : none_visible(a, r, own, kvlen);
    if ((threadIdx.x & 31) == 0 && !none) atomicOr(&flags[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
}

// the first flagged tile at or after t (ntiles when none is)
__device__ __forceinline__ int next_tile(const uint32_t* flags, int t, int ntiles) {
  for (; t < ntiles; ++t)
    if ((flags[t >> 5] >> (t & 31)) & 1u) break;
  return t;
}

// without branches: the per-element code runs on every score of a tile
__device__ __forceinline__ bool visible(const Args& a, int qp, int kp, int kvlen) {
  return (kp < kvlen) & (!a.causal | (kp <= qp)) &
         ((a.window <= 0) | (static_cast<long>(kp) > static_cast<long>(qp) - a.window));
}

// accumulator element i of thread lane: its column (its row within the
// warp's 16 is lane / 4, plus 8 for i % 4 >= 2)
__device__ __forceinline__ int acc_col(int lane, int i) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// Bit e set: accumulator element e of this thread is a visible pair. The
// thread's two rows have positions rpos and validity rin; column j has
// position cpos[j] and is valid below n_cols. ROWS_Q: the rows are queries
// (forward, dq), else keys (dk/dv).
template <bool ROWS_Q>
__device__ __forceinline__ uint32_t vis_mask(const Args& a, const int (&rpos)[2],
                                             const bool (&rin)[2], const int* cpos,
                                             int n_cols, int lane, int kvlen) {
  uint32_t m = 0;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int hf = (e >> 1) & 1, j = acc_col(lane, e), cp = cpos[j];
    const bool ok = rin[hf] & (j < n_cols) &
                    (ROWS_Q ? visible(a, rpos[hf], cp, kvlen) : visible(a, cp, rpos[hf], kvlen));
    m |= static_cast<uint32_t>(ok) << e;
  }
  return m;
}

// aligned base of the dynamic shared memory
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  const uintptr_t p = reinterpret_cast<uintptr_t>(smem_raw);
  return reinterpret_cast<uint8_t*>((p + 1023) & ~static_cast<uintptr_t>(1023));
}

template <int DP>
__host__ __device__ constexpr int stages() { return DP == 256 ? 1 : 2; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT, DP == 64 ? 2 : 1) flash_fwd_tc_kernel(Args a) {
  constexpr int NS = stages<DP>(), QB = TR * DP * 2, KB = TI * DP * 2, NC = DP / 64;
  uint8_t* sm = smem_base();
  const uint32_t q_s = smem_u32(sm), k_s = q_s + QB, v_s = k_s + NS * KB;
  int* kp_s = reinterpret_cast<int*>(sm + QB + 2 * NS * KB);  // NS x TI
  uint32_t* flags = reinterpret_cast<uint32_t*>(kp_s + NS * TI);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv), D = a.D;
  const long q_stride = static_cast<long>(a.Hq) * D, k_stride = static_cast<long>(a.Hkv) * D;
  const bf16* qg = a.q + (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
  const bf16* kg = a.k + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const bf16* vg = a.v + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const int* qpos = a.qpos + static_cast<long>(b) * a.Sq;
  const int* kpos = a.kpos + static_cast<long>(b) * a.Sk;
  const int kvlen = a.kvlen ? a.kvlen[b] : INT_MAX;
  const bool vec = a.vec;

  const Range qr_blk = warp_range(qpos + q0, TR, a.Sq - q0);
  const Range qr_wg = warp_range(qpos + q0 + 64 * wg, 64, a.Sq - q0 - 64 * wg);
  int qp[2];
  bool rin[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hf;
    rin[hf] = r < a.Sq;
    qp[hf] = rin[hf] ? qpos[r] : 0;
  }
  const int nk = (a.Sk + TI - 1) / TI;
  flag_tiles(flags, a, qr_blk, kpos, a.Sk, nk, kvlen, true);
  auto next = [&](int kt) { return next_tile(flags, kt, nk); };
  auto load = [&](int kt, int st) {
    load_tile<TI, DP>(k_s + st * KB, kg, kt * TI, a.Sk, k_stride, D, vec);
    load_tile<TI, DP>(v_s + st * KB, vg, kt * TI, a.Sk, k_stride, D, vec);
    if (tid < TI) {
      const int c = kt * TI + tid;
      cp_async4(kp_s + st * TI + tid, kpos + (c < a.Sk ? c : 0), c < a.Sk);
    }
  };

  float o[NC][32];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int cb = 0; cb < NC; ++cb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[cb][e] = 0.f;

  load_tile<TR, DP>(q_s, qg, q0, a.Sq, q_stride, D, vec);
  int kt = next(0), st = 0;
  if (NS == 2 && kt < nk) load(kt, 0);
  cp_commit();
  while (kt < nk) {
    const int kn = next(kt + 1);
    if (NS == 2) {
      if (kn < nk) {
        load(kn, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    } else {
      load(kt, 0);
      cp_commit();
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    const Range kr = warp_range(kp_s + st * TI, TI, a.Sk - kt * TI);
    if (!none_visible(a, qr_wg, kr, kvlen)) {
      const bool all = all_visible(a, qr_wg, kr, kvlen, kt * TI + TI <= a.Sk);
      const uint32_t kt_s = k_s + st * KB, vt_s = v_s + st * KB;
      float s[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wgmma_ss(s, desc_k<TR>(q_s, 64 * wg, ks), desc_k<TI>(kt_s, 0, ks), ks > 0);
      wg_commit();
      wg_wait0();

      const uint32_t vis = all ? 0xffffffffu
                               : vis_mask<true>(a, qp, rin, kp_s + st * TI,
                                                a.Sk - kt * TI, lane, kvlen);
      // scale, soft-cap, mask; the uniform branches stay outside the loops
      if (a.softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = tanhf(s[e] * a.scale / a.softcap) * a.softcap;
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] *= a.scale;
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = (vis >> e) & 1u ? s[e] : NEG_INF;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        const float m_new = fmaxf(m[hf], mx[hf]);
        m_safe[hf] = m_new <= NEG_INF / 2 ? 0.f : m_new;
        alpha[hf] = m[hf] <= NEG_INF / 2 ? 0.f : exp2_fast((m[hf] - m_safe[hf]) * LOG2E);
        m[hf] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hf = (e >> 1) & 1;
        const float p = (vis >> e) & 1u ? exp2_fast((s[e] - m_safe[hf]) * LOG2E) : 0.f;
        s[e] = p;
        ps[hf] += p;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        ps[hf] += __shfl_xor_sync(0xffffffffu, ps[hf], 1);
        ps[hf] += __shfl_xor_sync(0xffffffffu, ps[hf], 2);
        l[hf] = l[hf] * alpha[hf] + ps[hf];
      }
#pragma unroll
      for (int cb = 0; cb < NC; ++cb)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[cb][e] *= alpha[(e >> 1) & 1];

      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_afrag(s, kk, af[kk]);
      wg_fence();
#pragma unroll
      for (int cb = 0; cb < NC; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(o[cb], af[kk], desc_mn<TI>(vt_s, kk, cb));
      wg_commit();
      wg_wait0();
    }
    __syncthreads();  // the stage is free for the load after next
    kt = kn;
    if (NS == 2) st ^= 1;
  }
  cp_wait<0>();

  bf16* og = a.out + (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hf;
    if (!rin[hf]) continue;
    const float inv = 1.f / fmaxf(l[hf], 1e-30f);
    bf16* row = og + static_cast<long>(r) * q_stride;
#pragma unroll
    for (int cb = 0; cb < NC; ++cb)
#pragma unroll
      for (int e = 2 * hf; e < 32; e += 4) {  // e, e + 1: columns c, c + 1
        const int c = cb * 64 + acc_col(lane, e);
        if (c + 1 < D && !(D & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) =
              __floats2bfloat162_rn(o[cb][e] * inv, o[cb][e + 1] * inv);
        } else {
          if (c < D) row[c] = __float2bfloat16(o[cb][e] * inv);
          if (c + 1 < D) row[c + 1] = __float2bfloat16(o[cb][e + 1] * inv);
        }
      }
    if ((lane & 3) == 0) {
      const float ms = m[hf] <= NEG_INF / 2 ? 0.f : m[hf];
      a.lse_out[(static_cast<long>(b) * a.Hq + h) * a.Sq + r] =
          l[hf] > 0.f ? ms + logf(l[hf]) : LSE_MASKED;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dQ (with the Delta prologue)
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_tc_kernel(Args a) {
  constexpr int NS = stages<DP>(), QB = TR * DP * 2, KB = TI * DP * 2, NC = DP / 64;
  uint8_t* sm = smem_base();
  const uint32_t q_s = smem_u32(sm), do_s = q_s + QB, k_s = do_s + QB, v_s = k_s + NS * KB;
  int* kp_s = reinterpret_cast<int*>(sm + 2 * QB + 2 * NS * KB);  // NS x TI
  float* dl_s = reinterpret_cast<float*>(kp_s + NS * TI);         // TR
  uint32_t* flags = reinterpret_cast<uint32_t*>(dl_s + TR);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv), D = a.D;
  const long q_stride = static_cast<long>(a.Hq) * D, k_stride = static_cast<long>(a.Hkv) * D;
  const long q_base = (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
  const bf16* kg = a.k + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const bf16* vg = a.v + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const int* qpos = a.qpos + static_cast<long>(b) * a.Sq;
  const int* kpos = a.kpos + static_cast<long>(b) * a.Sk;
  const long row_base = (static_cast<long>(b) * a.Hq + h) * a.Sq;
  const int kvlen = a.kvlen ? a.kvlen[b] : INT_MAX;
  const bool vec = a.vec;

  load_tile<TR, DP>(q_s, a.q + q_base, q0, a.Sq, q_stride, D, vec);
  load_tile<TR, DP>(do_s, a.dout + q_base, q0, a.Sq, q_stride, D, vec);
  {  // Delta = rowsum(dO * O), O as the forward stored it; two threads a row
    const int r = tid >> 1, g = q0 + r;
    float part = 0.f;
    if (g < a.Sq) {
      const bf16* orow = a.o + q_base + static_cast<long>(g) * q_stride;
      const bf16* drow = a.dout + q_base + static_cast<long>(g) * q_stride;
      for (int d = tid & 1; d < D; d += 2)
        part = fmaf(__bfloat162float(drow[d]), __bfloat162float(orow[d]), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tid & 1) == 0) {
      dl_s[r] = part;
      if (g < a.Sq) a.delta[row_base + g] = part;
    }
  }

  const Range qr_blk = warp_range(qpos + q0, TR, a.Sq - q0);
  const Range qr_wg = warp_range(qpos + q0 + 64 * wg, 64, a.Sq - q0 - 64 * wg);
  int qp[2];
  bool rin[2];
  float lse[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hf;
    rin[hf] = r < a.Sq;
    qp[hf] = rin[hf] ? qpos[r] : 0;
    lse[hf] = rin[hf] ? a.lse[row_base + r] : 0.f;
  }
  const int nk = (a.Sk + TI - 1) / TI;
  flag_tiles(flags, a, qr_blk, kpos, a.Sk, nk, kvlen, true);
  auto next = [&](int kt) { return next_tile(flags, kt, nk); };
  auto load = [&](int kt, int st) {
    load_tile<TI, DP>(k_s + st * KB, kg, kt * TI, a.Sk, k_stride, D, vec);
    load_tile<TI, DP>(v_s + st * KB, vg, kt * TI, a.Sk, k_stride, D, vec);
    if (tid < TI) {
      const int c = kt * TI + tid;
      cp_async4(kp_s + st * TI + tid, kpos + (c < a.Sk ? c : 0), c < a.Sk);
    }
  };

  float dq[NC][32];
#pragma unroll
  for (int cb = 0; cb < NC; ++cb)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[cb][e] = 0.f;

  int kt = next(0), st = 0;
  if (NS == 2 && kt < nk) load(kt, 0);
  cp_commit();
  __syncthreads();  // Delta in shared memory
  float delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) delta[hf] = dl_s[64 * wg + 16 * warp + (lane >> 2) + 8 * hf];

  while (kt < nk) {
    const int kn = next(kt + 1);
    if (NS == 2) {
      if (kn < nk) {
        load(kn, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    } else {
      load(kt, 0);
      cp_commit();
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    const Range kr = warp_range(kp_s + st * TI, TI, a.Sk - kt * TI);
    if (!none_visible(a, qr_wg, kr, kvlen)) {
      const bool all = all_visible(a, qr_wg, kr, kvlen, kt * TI + TI <= a.Sk);
      const uint32_t kt_s = k_s + st * KB, vt_s = v_s + st * KB;
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wgmma_ss(s, desc_k<TR>(q_s, 64 * wg, ks), desc_k<TI>(kt_s, 0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wgmma_ss(dp, desc_k<TR>(do_s, 64 * wg, ks), desc_k<TI>(vt_s, 0, ks), ks > 0);
      wg_commit();
      wg_wait0();
      const uint32_t vis = all ? 0xffffffffu
                               : vis_mask<true>(a, qp, rin, kp_s + st * TI,
                                                a.Sk - kt * TI, lane, kvlen);
      // dS = P * (dP - Delta), times 1 - tanh^2 under a softcap
      auto grad = [&](auto cap) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hf = (e >> 1) & 1;
          float sc = s[e] * a.scale, dcap = 1.f;
          if (decltype(cap)::value) {
            const float t = tanhf(sc / a.softcap);
            sc = t * a.softcap;
            dcap = 1.f - t * t;
          }
          const float p = (vis >> e) & 1u ? exp2_fast((sc - lse[hf]) * LOG2E) : 0.f;
          s[e] = p * (dp[e] - delta[hf]) * dcap;
        }
      };
      if (a.softcap > 0.f) grad(std::true_type{}); else grad(std::false_type{});
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_afrag(s, kk, af[kk]);
      wg_fence();
#pragma unroll
      for (int cb = 0; cb < NC; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(dq[cb], af[kk], desc_mn<TI>(kt_s, kk, cb));
      wg_commit();
      wg_wait0();
    }
    __syncthreads();
    kt = kn;
    if (NS == 2) st ^= 1;
  }
  cp_wait<0>();

  bf16* dqg = a.out + q_base;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hf;
    if (!rin[hf]) continue;
    bf16* row = dqg + static_cast<long>(r) * q_stride;
#pragma unroll
    for (int cb = 0; cb < NC; ++cb)
#pragma unroll
      for (int e = 2 * hf; e < 32; e += 4) {
        const int c = cb * 64 + acc_col(lane, e);
        const float x0 = dq[cb][e] * a.scale, x1 = dq[cb][e + 1] * a.scale;
        if (c + 1 < D && !(D & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < D) row[c] = __float2bfloat16(x0);
          if (c + 1 < D) row[c + 1] = __float2bfloat16(x1);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// backward: partial dK and dV per q head (reads the dq kernel's Delta)
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_tc_kernel(Args a) {
  constexpr int NS = stages<DP>(), KB = TR * DP * 2, QB = TI * DP * 2, NC = DP / 64;
  uint8_t* sm = smem_base();
  const uint32_t k_s = smem_u32(sm), v_s = k_s + KB, q_s = v_s + KB, do_s = q_s + NS * QB;
  int* qp_s = reinterpret_cast<int*>(sm + 2 * KB + 2 * NS * QB);  // NS x TI each
  float* lse_s = reinterpret_cast<float*>(qp_s + NS * TI);
  float* dl_s = lse_s + NS * TI;
  uint32_t* flags = reinterpret_cast<uint32_t*>(dl_s + NS * TI);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int k0 = blockIdx.x * TR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv), D = a.D;
  const long q_stride = static_cast<long>(a.Hq) * D, k_stride = static_cast<long>(a.Hkv) * D;
  const long q_base = (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
  const long k_base = (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const int* qpos = a.qpos + static_cast<long>(b) * a.Sq;
  const int* kpos = a.kpos + static_cast<long>(b) * a.Sk;
  const long row_base = (static_cast<long>(b) * a.Hq + h) * a.Sq;
  const int kvlen = a.kvlen ? a.kvlen[b] : INT_MAX;
  const bool vec = a.vec;

  load_tile<TR, DP>(k_s, a.k + k_base, k0, a.Sk, k_stride, D, vec);
  load_tile<TR, DP>(v_s, a.v + k_base, k0, a.Sk, k_stride, D, vec);

  const Range kr_blk = warp_range(kpos + k0, TR, a.Sk - k0);
  const Range kr_wg = warp_range(kpos + k0 + 64 * wg, 64, a.Sk - k0 - 64 * wg);
  int kp[2];
  bool kin[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int c = k0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hf;
    kin[hf] = c < a.Sk;
    kp[hf] = kin[hf] ? kpos[c] : 0;
  }
  const int nq = (a.Sq + TI - 1) / TI;
  flag_tiles(flags, a, kr_blk, qpos, a.Sq, nq, kvlen, false);
  auto next = [&](int qt) { return next_tile(flags, qt, nq); };
  auto load = [&](int qt, int st) {
    load_tile<TI, DP>(q_s + st * QB, a.q + q_base, qt * TI, a.Sq, q_stride, D, vec);
    load_tile<TI, DP>(do_s + st * QB, a.dout + q_base, qt * TI, a.Sq, q_stride, D, vec);
    if (tid < TI) {
      const int r = qt * TI + tid, rr = r < a.Sq ? r : 0;
      cp_async4(qp_s + st * TI + tid, qpos + rr, r < a.Sq);
      cp_async4(lse_s + st * TI + tid, a.lse + row_base + rr, r < a.Sq);
      cp_async4(dl_s + st * TI + tid, a.delta + row_base + rr, r < a.Sq);
    }
  };

  float dk[NC][32], dv[NC][32];
#pragma unroll
  for (int cb = 0; cb < NC; ++cb)
#pragma unroll
    for (int e = 0; e < 32; ++e) { dk[cb][e] = 0.f; dv[cb][e] = 0.f; }

  int qt = next(0), st = 0;
  if (NS == 2 && qt < nq) load(qt, 0);
  cp_commit();
  while (qt < nq) {
    const int qn = next(qt + 1);
    if (NS == 2) {
      if (qn < nq) {
        load(qn, st ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    } else {
      load(qt, 0);
      cp_commit();
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    const Range qr = warp_range(qp_s + st * TI, TI, a.Sq - qt * TI);
    if (!none_visible(a, qr, kr_wg, kvlen)) {
      const bool all = all_visible(a, qr, kr_wg, kvlen, qt * TI + TI <= a.Sq);
      const uint32_t qt_s = q_s + st * QB, dot_s = do_s + st * QB;
      float s[32], dp[32];  // S^T and dP^T: rows are keys, columns q rows
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wgmma_ss(s, desc_k<TR>(k_s, 64 * wg, ks), desc_k<TI>(qt_s, 0, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wgmma_ss(dp, desc_k<TR>(v_s, 64 * wg, ks), desc_k<TI>(dot_s, 0, ks), ks > 0);
      wg_commit();
      wg_wait0();
      const uint32_t vis = all ? 0xffffffffu
                               : vis_mask<false>(a, kp, kin, qp_s + st * TI,
                                                 a.Sq - qt * TI, lane, kvlen);
      // P^T, and dS^T = P^T * (dP^T - Delta), times 1 - tanh^2 under a softcap
      auto grad = [&](auto cap) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int jj = st * TI + acc_col(lane, e);
          float sc = s[e] * a.scale, dcap = 1.f;
          if (decltype(cap)::value) {
            const float t = tanhf(sc / a.softcap);
            sc = t * a.softcap;
            dcap = 1.f - t * t;
          }
          const float p = (vis >> e) & 1u ? exp2_fast((sc - lse_s[jj]) * LOG2E) : 0.f;
          s[e] = p;
          dp[e] = p * (dp[e] - dl_s[jj]) * dcap;
        }
      };
      if (a.softcap > 0.f) grad(std::true_type{}); else grad(std::false_type{});
      uint32_t pf[4][4], sf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        to_afrag(s, kk, pf[kk]);
        to_afrag(dp, kk, sf[kk]);
      }
      wg_fence();
#pragma unroll
      for (int cb = 0; cb < NC; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs(dv[cb], pf[kk], desc_mn<TI>(dot_s, kk, cb));
          wgmma_rs(dk[cb], sf[kk], desc_mn<TI>(qt_s, kk, cb));
        }
      wg_commit();
      wg_wait0();
    }
    __syncthreads();
    qt = qn;
    if (NS == 2) st ^= 1;
  }
  cp_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int c = k0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hf;
    if (!kin[hf]) continue;
    const long off = ((static_cast<long>(b) * a.Sk + c) * a.Hq + h) * D;
    float* dkr = a.dk_part + off;
    float* dvr = a.dv_part + off;
#pragma unroll
    for (int cb = 0; cb < NC; ++cb)
#pragma unroll
      for (int e = 2 * hf; e < 32; e += 4) {
        const int d = cb * 64 + acc_col(lane, e);
        if (d + 1 < D && !(D & 1)) {
          *reinterpret_cast<float2*>(dkr + d) =
              make_float2(dk[cb][e] * a.scale, dk[cb][e + 1] * a.scale);
          *reinterpret_cast<float2*>(dvr + d) = make_float2(dv[cb][e], dv[cb][e + 1]);
        } else {
          if (d < D) { dkr[d] = dk[cb][e] * a.scale; dvr[d] = dv[cb][e]; }
          if (d + 1 < D) { dkr[d + 1] = dk[cb][e + 1] * a.scale; dvr[d + 1] = dv[cb][e + 1]; }
        }
      }
  }
}

// dk[b, s, hk, d] = sum over g = 0 .. G-1, in order, of dk_part[b, s, hk*G + g, d]
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum_kernel(Args a) {
  const int G = a.Hq / a.Hkv, D = a.D;
  const long n = static_cast<long>(a.B) * a.Sk * a.Hkv * D;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(i % D);
    const long rest = i / D;  // (b * Sk + s) * Hkv + hk
    const long src = (rest * G) * D + d;  // (b*Sk + s)*Hq + hk*G, since Hq = G*Hkv
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < G; ++g) {
      sk += a.dk_part[src + static_cast<long>(g) * D];
      sv += a.dv_part[src + static_cast<long>(g) * D];
    }
    a.dk[i] = __float2bfloat16(sk);
    a.dv[i] = __float2bfloat16(sv);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Which { FWD = 0, BWD_DQ = 1, BWD_DKDV = 2 };

template <int DP>
constexpr size_t smem_bytes(Which w) {
  constexpr size_t NS = stages<DP>(), R = TR * DP * 2, I = TI * DP * 2;
  return 1024 + MAX_TILES / 8 +
         (w == FWD ? R + 2 * NS * I + NS * TI * 4
          : w == BWD_DQ ? 2 * R + 2 * NS * I + NS * TI * 4 + TR * 4
                        : 2 * R + 2 * NS * I + 3 * NS * TI * 4);
}

template <int DP>
int launch_one(Which which, const Args& a, cudaStream_t stream) {
  void (*kernel)(Args);
  dim3 grid;
  if (which == FWD) {
    kernel = flash_fwd_tc_kernel<DP>;
    grid = dim3((a.Sq + TR - 1) / TR, a.Hq, a.B);
  } else if (which == BWD_DQ) {
    kernel = flash_bwd_dq_tc_kernel<DP>;
    grid = dim3((a.Sq + TR - 1) / TR, a.Hq, a.B);
  } else {
    kernel = flash_bwd_dkdv_tc_kernel<DP>;
    grid = dim3((a.Sk + TR - 1) / TR, a.Hq, a.B);
  }
  const size_t smem = smem_bytes<DP>(which);
  // The limit on dynamic shared memory is an attribute of the kernel on one
  // device: set once per (kernel, device), one bit a device, so a graph
  // capture after the first launch on a device makes no such call. Devices
  // past 63 set it on every launch.
  static std::atomic<uint64_t> allowed[3];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(allowed[which].load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[which].fetch_or(bit, std::memory_order_relaxed);
  }
  kernel<<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// DP: the head dim padded to a multiple of 64
int launch(Which which, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_one<64>(which, a, stream);
  if (a.D <= 128) return launch_one<128>(which, a, stream);
  if (a.D <= 192) return launch_one<192>(which, a, stream);
  return launch_one<256>(which, a, stream);
}

size_t smem_for(Which which, int D) {
  if (D <= 64) return smem_bytes<64>(which);
  if (D <= 128) return smem_bytes<128>(which);
  if (D <= 192) return smem_bytes<192>(which);
  return smem_bytes<256>(which);
}

int aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool bad_shape(const Args& a) {
  return a.D <= 0 || a.D > 256 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
         a.Sq > MAX_TILES * TI || a.Sk > MAX_TILES * TI;
}

}  // namespace

// The dynamic shared memory one launch of a kernel asks for at head dim D
// (which: 0 forward, 1 dq, 2 dk/dv), 0 for a D the kernels do not take.
extern "C" long flash_tc_smem_bytes(int which, int D) {
  if (which < FWD || which > BWD_DKDV || D <= 0 || D > 256) return 0;
  return static_cast<long>(smem_for(static_cast<Which>(which), D));
}

// bf16 only. kvlen may be null. Returns the cudaError_t of the launch.
extern "C" int flash_tc_fwd_launch(const void* q, const void* k, const void* v,
                                   const int* qpos, const int* kpos, const int* kvlen,
                                   void* out, float* lse, int B, int Sq, int Sk, int Hq,
                                   int Hkv, int D, int causal, int window, float softcap,
                                   float scale, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.qpos = qpos; a.kpos = kpos; a.kvlen = kvlen;
  a.out = static_cast<bf16*>(out); a.lse_out = lse;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  a.vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(FWD, a, static_cast<cudaStream_t>(stream));
}

// The backward: the dq kernel (which also writes delta), the dk/dv kernel
// (fp32 partials per q head, (B, Sk, Hq, D)), then their sum over the G q
// heads of each kv head, on one stream.
extern "C" int flash_tc_bwd_launch(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   const int* qpos, const int* kpos, const int* kvlen,
                                   float* delta, void* dq, float* dk_part, float* dv_part,
                                   void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int causal, int window, float softcap, float scale,
                                   void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v); a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout); a.lse = lse;
  a.qpos = qpos; a.kpos = kpos; a.kvlen = kvlen; a.delta = delta;
  a.out = static_cast<bf16*>(dq); a.dk_part = dk_part; a.dv_part = dv_part;
  a.dk = static_cast<bf16*>(dk); a.dv = static_cast<bf16*>(dv);
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  a.vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = launch(BWD_DQ, a, s);
  if (rc != 0) return rc;
  rc = launch(BWD_DKDV, a, s);
  if (rc != 0) return rc;
  const long n = static_cast<long>(B) * Sk * Hkv * D;
  const int blocks = static_cast<int>((n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536);
  flash_bwd_dkdv_sum_kernel<<<blocks, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
