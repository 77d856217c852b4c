// Paged attention for Hopper (sm_90a) on the tensor cores: the bf16 route of
// paged decode (one query per sequence) and chunked paged prefill (a chunk
// of C queries per sequence), both read straight through the block table
// from the shared page pool. fp32 keeps the CUDA-core kernels of
// paged_attention.cu: on the tensor cores fp32 would mean TF32.
//
// Replaces:
//   paged_decode_tc_kernel  <- repro/kernels/paged_attention/kernel.py
//                              _paged_kernel (paged_attention_pallas)
//   paged_prefill_tc_kernel <- repro/kernels/paged_attention/kernel.py
//                              _paged_prefill_kernel (paged_prefill_attention_pallas)
// Both are one template (paged_tc); the names differ so that a profile
// tells decode from prefill.
//
// Bound on the H100: bytes, and at the serving shapes latency. Per visible
// key a (sequence, kv head) reads 2*D bf16 values and does 4*D operations
// for each of its G*C query rows: at decode (G = 8) 16 operations a byte,
// at a 64-token chunk ~1,000 operations per key byte but over only a few
// hundred keys. A decode step moves under 1 MB, a few tenths of a
// microsecond at 3.35 TB/s, so what the card pays is the chain of
// dependent latencies: table entry -> page copy -> products -> combine.
// The design shortens that chain and spreads it over the SMs:
//
// - Split-K over pages. The grid is (row tiles, splits, B * Hkv); the host
//   picks the split count from the shapes alone (ops.tc_plan; it never
//   reads cache_len, which would cost a sync a layer). Groups of at most 16
//   rows (decode) split to about one block an SM, so a decode step's 16
//   (sequence, kv head) pairs become ~128 blocks that each stream a few
//   pages instead of 16 blocks walking up to 18 pages in turn; a prefill
//   chunk's 64-row blocks already cover the SMs, and there the combine
//   would cost more than it saves (tools/paged_tc_variants.py times other
//   split counts). A split whose pages all lie at or past cache_len (or
//   before the window) writes an empty partial (m = NEG_INF, l = 0) and
//   stops.
// - One launch a call, bitwise repeatable. Each block of a multi-split
//   launch writes its partial (fp32 acc, m, l) to scratch the wrapper
//   allocates; the last block of each (row tile, sequence, kv head) to
//   arrive (an int32 counter: __threadfence, then atomicAdd) combines the
//   splits in split order, reading the partials with __ldcg (no stale L1
//   line), and resets the counter to 0, so a counter buffer allocated
//   zeroed once (per device and stream, by the wrapper) stays zero between
//   launches, and a CUDA graph replay keeps that. One split writes the
//   output directly.
// - Products on the tensor cores. One warp owns 16 query rows (row =
//   c * G + g: chunk position c, q head h * G + g, the row order of
//   paged_attention.cu, so a 16-row tile spans two chunk positions and its
//   causal extent is nearly uniform). S = Q K^T and O += P V run as
//   mma.sync m16n8k16 (bf16 in, fp32 sums); Q and K fragments come from
//   shared memory by ldmatrix, V by ldmatrix.trans; P stays in registers:
//   S's fp32 accumulator, rounded to bf16, is the A fragment of P V (the
//   FlashAttention-2 layout). At decode G = 8 fills half of a 16-row tile
//   and three of a block's four warps have no rows; the padding costs
//   tensor-core work the kernel is not bound by, and those warps still
//   issue their share of the copies.
// - Staging by cp.async. A tile of KT keys (64 = four 16-token pages for
//   D <= 128, else 32) is copied in 16-byte cp.async copies into bf16 rows
//   padded by 16 bytes (ldmatrix's eight row addresses then fall in
//   distinct banks), in a ring of four stages: a block that walks several
//   tiles has three in flight while it computes one. A page contributes
//   its rows of one kv head at row stride Hkv * D. Each block loads its
//   split's block-table entries into shared memory once, beside cache_len.
//   The head dim is zero-padded in shared memory to DP, the next of 32, 64,
//   128, 256 (multiples of the k16 step), so D = 32, 64, 100 and up to 256
//   all run; a head dim that is not a multiple of 8 (or a tensor not
//   16-byte aligned) is staged element by element, with plain loads.
//
// Masking is that of paged_attention.cu and kernel.py:73-91 exactly:
// scores are q.k / sqrt(D), soft-capped, then masked to NEG_INF = -1e30
// (keys at or past cache_len or past the table's nL * page, in the query's
// future for prefill, at or before qpos - window); m_safe = 0 while the
// running max is NEG_INF; masked probabilities are 0; alpha = 0 while the
// previous max is NEG_INF; the output is acc / max(l, 1e-30), so a fully
// masked row (an idle decode slot, cache_len 0) writes 0. The combine
// weighs a split whose m is NEG_INF by 0. Table entries inside cache_len
// are clipped to [0, P) as the reference gather clips them; keys outside a
// block's visible range are never read (zero-filled in shared memory).
//
// Not yet done (later work): TMA copies of whole pages with mbarriers, a
// producer warp, and wgmma (64-row tiles, which a decode step cannot fill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NW = 4;                 // warps a block
constexpr int NT = NW * 32;
constexpr int BR = NW * 16;           // query rows a block owns
constexpr int MAX_SPLITS = 64;
constexpr int MAX_SPLIT_PAGES = 1024; // table entries a block stages
constexpr int STAGES = 4;             // key tiles in flight in a block

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* q;       // (B, C, Hq, D)
  const bf16* k;       // (P, page, Hkv, D)
  const bf16* v;
  const int* tbl;      // (B, nL), -1 = unallocated
  const int* lens;     // (B,) written tokens (cache_len)
  const int* qstart;   // (B,) position of query 0 (decode: q_position)
  bf16* out;           // (B, C, Hq, D)
  float* part_acc;     // (B * Hkv, row tiles, splits, BR, D) fp32
  float* part_ml;      // (B * Hkv, row tiles, splits, BR, 2): m, l
  int* counters;       // (B * Hkv * row tiles), 0 between launches
  int C, Hq, Hkv, D, page, nL, P;
  int causal;          // prefill: mask kpos <= qpos; decode: 0
  int window;          // <= 0: none
  float softcap;       // <= 0: none
  float scale;         // 1/sqrt(D)
  int splits;          // grid.y
  int split_pages;     // logical pages a split covers
  int vec;             // 16-byte copies: D % 8 == 0 and 16-byte aligned tensors
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (results below the smallest normal
// float flush to 0, which a probability can take)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int DP, int KT>
struct Tile {
  static constexpr int LD = DP + 8;         // bf16 row stride in shared memory
  static constexpr int CPR = DP / 8;        // 16-byte chunks a row
  static constexpr size_t q_elems = static_cast<size_t>(BR) * LD;
  static constexpr size_t kv_elems = static_cast<size_t>(KT) * LD;  // one of K, V
  // Q, STAGES stages of K and V, the split's table entries
  static constexpr size_t smem(int split_pages) {
    return (q_elems + 2 * STAGES * kv_elems) * sizeof(bf16) + sizeof(int) * split_pages;
  }
  static_assert(2 * STAGES * kv_elems * sizeof(bf16) >= sizeof(float) * (MAX_SPLITS + 1) * BR,
                "the combine's weights and sums reuse the K and V stages");
};

template <int DP, int KT>
__device__ __forceinline__ void paged_tc(const Args& a) {
  using T = Tile<DP, KT>;
  constexpr int LD = T::LD, CPR = T::CPR;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + T::q_elems;            // stage s: K at 2s, V at 2s + 1
  int* tbl_s = reinterpret_cast<int*>(kv_s + 2 * STAGES * T::kv_elems);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rt = blockIdx.x, sp = blockIdx.y, grp = blockIdx.z;
  const int b = grp / a.Hkv, h = grp - b * a.Hkv;
  const int G = a.Hq / a.Hkv, rows = G * a.C, r0 = rt * BR;
  const int nrows = min(BR, rows - r0);
  const int D = a.D, page = a.page;
  const int start = a.qstart[b];
  const int len = min(a.lens[b], a.nL * page);  // keys past the table do not exist

  // keys some row of this block can see, inside this split: [kb, ke)
  int hi = len;
  if (a.causal) hi = min(hi, start + (r0 + nrows - 1) / G + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, start + r0 / G - a.window + 1);
  const int pg0 = sp * a.split_pages;
  const int npg = min(a.split_pages, a.nL - pg0);
  const int ks = pg0 * page;
  const int kb = max(ks, lo), ke = min(ks + npg * page, hi);

  // the row each thread's accumulator rows hold, and the keys each sees
  const int gq = lane >> 2, tq = lane & 3;
  int klo[2], khi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i;
    const int qp = start + (r0 + r) / G;
    klo[i] = kb;
    khi[i] = ke;
    if (a.window > 0) klo[i] = max(klo[i], qp - a.window + 1);
    if (a.causal) khi[i] = min(khi[i], qp + 1);
    if (r >= nrows) khi[i] = klo[i];
  }
  const bool active = warp * 16 < nrows;

  const bf16* qp_ = a.q;
  const long tok = static_cast<long>(a.Hkv) * D;  // one token of a page
  auto row_off = [&](int r) -> long {             // (b, c, h*G + g) of row r
    const int c = r / G, g = r - c * G;
    return ((static_cast<long>(b) * a.C + c) * a.Hq + h * G + g) * D;
  };

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // the split's table entries, read beside cache_len rather than after it
  for (int i = tid; i < npg; i += NT)
    tbl_s[i] = min(max(a.tbl[static_cast<long>(b) * a.nL + pg0 + i], 0), a.P - 1);
  if (kb < ke) {
    // Q rows, zero past the block's rows and the head dim
    if (a.vec) {
      for (int i = tid; i < BR * CPR; i += NT) {
        const int r = i / CPR, cc = i - r * CPR;
        const bool ok = r < nrows && cc * 8 < D;
        cp_async16(q_s + r * LD + cc * 8, ok ? qp_ + row_off(r0 + r) + cc * 8 : qp_, ok);
      }
    } else {
      for (int i = tid; i < BR * DP; i += NT) {
        const int r = i / DP, d = i - r * DP;
        q_s[r * LD + d] = r < nrows && d < D ? qp_[row_off(r0 + r) + d] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();  // tbl_s

    auto load_kv = [&](int stage, int k0) {
      bf16* kd = kv_s + (2 * stage) * T::kv_elems;
      bf16* vd = kd + T::kv_elems;
      if (a.vec) {
        for (int i = tid; i < KT * CPR; i += NT) {
          const int j = i / CPR, cc = i - j * CPR;
          const int kpos = k0 + j;
          const bool ok = kpos >= kb && kpos < ke && cc * 8 < D;
          long off = 0;
          if (ok) {
            const int lp = kpos / page;
            off = (static_cast<long>(tbl_s[lp - pg0]) * page + (kpos - lp * page)) * tok +
                  static_cast<long>(h) * D + cc * 8;
          }
          cp_async16(kd + j * LD + cc * 8, a.k + off, ok);
          cp_async16(vd + j * LD + cc * 8, a.v + off, ok);
        }
      } else {
        for (int i = tid; i < KT * DP; i += NT) {
          const int j = i / DP, d = i - j * DP;
          const int kpos = k0 + j;
          bf16 kx = __float2bfloat16(0.f), vx = kx;
          if (kpos >= kb && kpos < ke && d < D) {
            const int lp = kpos / page;
            const long off = (static_cast<long>(tbl_s[lp - pg0]) * page + (kpos - lp * page)) *
                             tok + static_cast<long>(h) * D + d;
            kx = a.k[off];
            vx = a.v[off];
          }
          kd[j * LD + d] = kx;
          vd[j * LD + d] = vx;
        }
      }
    };

    // tiles of KT keys from the split's first key: the first holding kb,
    // up to the one holding ke - 1; tile t in stage t % STAGES. The first
    // STAGES - 1 tiles are issued (one copy group each, empty past ke)
    // before any is computed, and each step issues the tile STAGES - 1
    // ahead into the stage computed in the step before.
    const int k_first = ks + ((kb - ks) / KT) * KT;
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (k_first + t * KT < ke) load_kv(t, k_first + t * KT);
      cp_commit();
    }
    for (int t = 0, k0 = k_first; k0 < ke; ++t, k0 += KT) {
      const int kn = k0 + (STAGES - 1) * KT;
      if (kn < ke) load_kv((t + STAGES - 1) % STAGES, kn);
      cp_commit();
      cp_wait<STAGES - 1>();  // tile t (and Q) landed; later ones may be in flight
      __syncthreads();
      const bf16* k_s = kv_s + (2 * (t % STAGES)) * T::kv_elems;
      const bf16* v_s = k_s + T::kv_elems;
      if (active) {
        // S = Q K^T over the padded head dim
        float s[KT / 8][4];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < DP / 16; ++kc) {
          uint32_t af[4];
          ldsm_x4(af, q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kc * 16 +
                          (lane >> 4) * 8);
#pragma unroll
          for (int jp = 0; jp < KT / 16; ++jp) {
            uint32_t bf[4];
            ldsm_x4(bf, k_s + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kc * 16 +
                            ((lane >> 3) & 1) * 8);
            mma16816(s[2 * jp], af, bf[0], bf[1]);
            mma16816(s[2 * jp + 1], af, bf[2], bf[3]);
          }
        }
        // scale, soft-cap, mask; the online softmax of the tile
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            float x = s[j][e] * a.scale;
            if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
            x = kpos >= klo[i] && kpos < khi[i] ? x : NEG_INF;
            s[j][e] = x;
            mx[i] = fmaxf(mx[i], x);
          }
        }
        float alpha[2], msafe[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          msafe[i] = mx[i] <= NEG_INF / 2 ? 0.f : mx[i];
          alpha[i] = m[i] <= NEG_INF / 2 ? 0.f : exp2_fast((m[i] - msafe[i]) * LOG2E);
          m[i] = mx[i];
          l[i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float x = s[j][e];
            const float p = x <= NEG_INF / 2 ? 0.f : exp2_fast((x - msafe[i]) * LOG2E);
            s[j][e] = p;
            l[i] += p;
          }
        }
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
        // O += P V: P in registers (bf16), V by ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int dp = 0; dp < DP / 16; ++dp) {
            uint32_t bf[4];
            ldsm_x4_trans(bf, v_s + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  dp * 16 + (lane >> 4) * 8);
            mma16816(o[2 * dp], pa, bf[0], bf[1]);
            mma16816(o[2 * dp + 1], pa, bf[2], bf[3]);
          }
        }
      }
      __syncthreads();  // this stage's readers are done before it is refilled
    }
  }

  // the row sums over the four lanes of a row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  if (a.splits == 1) {
    // one split: the output directly
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gq + 8 * i;
      if (r >= nrows) continue;
      const float lsafe = fmaxf(l[i], 1e-30f);
      bf16* dst = a.out + row_off(r0 + r);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * tq + e;
          if (d < D) dst[d] = __float2bfloat16(o[n][2 * i + e] / lsafe);
        }
      }
    }
    return;
  }

  // this split's partial: acc (only where the row saw a key), m, l
  const int cidx = grp * gridDim.x + rt;
  const long pbase = (static_cast<long>(cidx) * a.splits + sp) * BR;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i;
    if (r >= nrows) continue;
    if (tq == 0) {
      a.part_ml[(pbase + r) * 2] = m[i];
      a.part_ml[(pbase + r) * 2 + 1] = l[i];
    }
    if (m[i] <= NEG_INF / 2) continue;
    float* dst = a.part_acc + (pbase + r) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * tq + e;
        if (d < D) dst[d] = o[n][2 * i + e];
      }
    }
  }

  // arrival: the last block of this (row tile, sequence, kv head) combines
  __shared__ int last_s;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(a.counters + cidx, 1) == a.splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) a.counters[cidx] = 0;  // zero again for the next launch

  // combine the splits in split order: weights w_i = exp(m_i - m), 0 for an
  // empty split. Every load is issued whatever the weight (an empty split's
  // acc was never written and may hold anything; the select drops it), so a
  // thread's loads over the splits are independent and overlap: at decode
  // (8 rows) each thread sums one float4 of the output over all splits.
  float* w_s = reinterpret_cast<float*>(kv_s);  // splits x BR, then BR sums
  float* lsum_s = w_s + a.splits * BR;
  const long gbase = static_cast<long>(cidx) * a.splits * BR;
  for (int r = tid; r < nrows; r += NT) {
    const float* ml = a.part_ml + (gbase + r) * 2;
    float mt = NEG_INF;
#pragma unroll 8
    for (int i = 0; i < a.splits; ++i) mt = fmaxf(mt, __ldcg(ml + i * BR * 2));
    float lt = 0.f;
#pragma unroll 8
    for (int i = 0; i < a.splits; ++i) {
      const float2 mli = __ldcg(reinterpret_cast<const float2*>(ml + i * BR * 2));
      const float w = mli.x <= NEG_INF / 2 ? 0.f : expf(mli.x - mt);
      lt = w != 0.f ? fmaf(w, mli.y, lt) : lt;
      w_s[i * BR + r] = w;
    }
    lsum_s[r] = fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  const long split_stride = static_cast<long>(BR) * D;
  if ((D & 3) == 0) {
    const int D4 = D >> 2;
    for (int idx = tid; idx < nrows * D4; idx += NT) {
      const int r = idx / D4, d = (idx - r * D4) * 4;
      const float* src = a.part_acc + (gbase + r) * D + d;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int i = 0; i < a.splits; ++i) {
        const float w = w_s[i * BR + r];
        const float4 x = __ldcg(reinterpret_cast<const float4*>(src + i * split_stride));
        acc.x = w != 0.f ? fmaf(w, x.x, acc.x) : acc.x;
        acc.y = w != 0.f ? fmaf(w, x.y, acc.y) : acc.y;
        acc.z = w != 0.f ? fmaf(w, x.z, acc.z) : acc.z;
        acc.w = w != 0.f ? fmaf(w, x.w, acc.w) : acc.w;
      }
      const float ls = lsum_s[r];
      bf16* dst = a.out + row_off(r0 + r) + d;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc.x / ls, acc.y / ls);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(acc.z / ls, acc.w / ls);
    }
  } else {
    for (int idx = tid; idx < nrows * D; idx += NT) {
      const int r = idx / D, d = idx - r * D;
      const float* src = a.part_acc + (gbase + r) * D + d;
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < a.splits; ++i) {
        const float w = w_s[i * BR + r];
        const float x = __ldcg(src + i * split_stride);
        acc = w != 0.f ? fmaf(w, x, acc) : acc;
      }
      a.out[row_off(r0 + r) + d] = __float2bfloat16(acc / lsum_s[r]);
    }
  }
}

template <int DP, int KT>
__global__ void __launch_bounds__(NT) paged_decode_tc_kernel(Args a) {
  paged_tc<DP, KT>(a);
}

template <int DP, int KT>
__global__ void __launch_bounds__(NT) paged_prefill_tc_kernel(Args a) {
  paged_tc<DP, KT>(a);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// KT: keys a tile holds; 32 past DP = 128, where O's registers grow
template <int DP>
constexpr int kt_of() { return DP <= 128 ? 64 : 32; }

template <int DP>
int launch_dp(int prefill, const Args& a, int B, cudaStream_t stream) {
  constexpr int KT = kt_of<DP>();
  using T = Tile<DP, KT>;
  void (*kernel)(Args) = prefill ? paged_prefill_tc_kernel<DP, KT> : paged_decode_tc_kernel<DP, KT>;
  // The limit on dynamic shared memory is an attribute of the kernel on one
  // device: set once per (kernel, device) to what the largest split asks,
  // one bit a device, so a graph capture after the first launch on a device
  // makes no such call. Devices past 63 set it on every launch.
  static std::atomic<uint64_t> allowed[2];  // decode, prefill
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(allowed[prefill].load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::smem(MAX_SPLIT_PAGES)));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[prefill].fetch_or(bit, std::memory_order_relaxed);
  }
  const int rows = (a.Hq / a.Hkv) * a.C;
  const dim3 grid((rows + BR - 1) / BR, a.splits, B * a.Hkv);
  kernel<<<grid, NT, T::smem(a.split_pages), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Rows of queries a block owns (the wrapper sizes the partials by it).
extern "C" int paged_tc_block_rows() { return BR; }

// bf16 only. prefill: 0 = decode (C must be 1; qstart = q_position),
// 1 = chunked prefill. splits / split_pages: the host's plan (ops.tc_plan);
// with splits > 1, part_acc / part_ml hold at least acc_floats / ml_floats
// floats and counters B * Hkv * row-tile ints, zero on entry (and on exit).
// Returns the cudaError_t of the launch.
extern "C" int paged_tc_launch(int prefill, const void* q, const void* k, const void* v,
                               const int* tbl, const int* lens, const int* qstart, void* out,
                               float* part_acc, float* part_ml, int* counters, long acc_floats,
                               long ml_floats, int B, int C, int Hq, int Hkv, int D, int page,
                               int nL, int P, int causal, int window, float softcap,
                               float scale, int splits, int split_pages, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (D <= 0 || D > 256 || Hkv <= 0 || Hq % Hkv != 0 || page <= 0 || nL <= 0 || P <= 0 ||
      (!prefill && C != 1) || splits < 1 || splits > MAX_SPLITS || split_pages < 1 ||
      split_pages > MAX_SPLIT_PAGES || static_cast<long>(splits) * split_pages < nL ||
      static_cast<long>(splits - 1) * split_pages >= nL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles = static_cast<long>(B) * Hkv * (((Hq / Hkv) * C + BR - 1) / BR);
  if (splits > 1 && (!part_acc || !part_ml || !counters || acc_floats < tiles * splits * BR * D ||
                     ml_floats < tiles * splits * BR * 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.tbl = tbl; a.lens = lens; a.qstart = qstart; a.out = static_cast<bf16*>(out);
  a.part_acc = part_acc; a.part_ml = part_ml; a.counters = counters;
  a.C = C; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.page = page; a.nL = nL; a.P = P;
  a.causal = prefill ? causal : 0; a.window = window; a.softcap = softcap; a.scale = scale;
  a.splits = splits; a.split_pages = split_pages;
  a.vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_dp<32>(prefill, a, B, s);
  if (D <= 64) return launch_dp<64>(prefill, a, B, s);
  if (D <= 128) return launch_dp<128>(prefill, a, B, s);
  return launch_dp<256>(prefill, a, B, s);
}
