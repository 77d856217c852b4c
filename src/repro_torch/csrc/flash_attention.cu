// Flash attention for Hopper (sm_90a): the forward and its backward, for the
// training path (cache-less attention over a whole sequence), in fp32. This
// is K2's fp32 route, on the CUDA cores: fp32 on the tensor cores would mean
// TF32. bf16 takes the tensor-core kernels of flash_attention_tc.cu.
//
// Replaces:
//   flash_fwd_kernel  <- repro/kernels/flash_attention/kernel.py _flash_kernel
//                        (flash_attention_pallas)
//   flash_bwd_dq_kernel, flash_bwd_dkdv_kernel: the backward, which the Pallas
//                        kernel never had (the JAX training step
//                        differentiates the jnp flash_attention)
//
// Bound on the H100: operations. At the training shape (S = 2048, D = 64)
// each key and value is reused by every query row of a tile, so the work
// is ~4*D operations per visible (query, key) pair against a few bytes per
// row: far above the ~295 operations per byte at which the memory would be
// the limit. These first kernels do the work on the CUDA cores in fp32
// (FMAs from shared memory), so they are bound by the fp32 rate and the
// shared-memory bandwidth, not by the tensor cores; mma/wgmma, TMA and
// pipelined staging are later work.
//
// Design. The Pallas grid (B*Hq, q_blocks) ran its kv loop as a fori_loop
// inside one program; here one block of 16 x 16 threads owns one tile of
// BQ = 16*RM query rows of one (batch, q head) and loops over kv tiles of
// BK = 16*RM keys, staged in shared memory as fp32 (rows padded to D+1
// floats). Thread (ty, tx) owns rows ty + 16*i and keys tx + 16*j of the
// score tile (RM x RM scores in registers); the 16 threads of a row reduce
// its max and sum with shuffles. Probabilities go through shared memory
// into the P.V product, where the thread owns rows ty + 16*i and head-dim
// columns tx + 16*jd. GQA: q head h reads kv head h / G.
//
// Masking follows kernel.py:65-81 and layers/attention.py flash_attention
// exactly: scores are q.k * 1/sqrt(D), soft-capped, then masked to NEG_INF
// = -1e30 where the key's position is at or past kv_len, in the future of
// the query's (causal), or at or before qpos - window; m_safe = 0 while
// the running max is NEG_INF; masked probabilities are 0; alpha = 0 while
// the previous max is NEG_INF; the output is acc / max(l, 1e-30), so a
// fully masked row writes 0. Before staging a kv tile the block takes one
// vote (__syncthreads_or) on whether any of its (row, key) pairs is
// visible and skips the tile when none is: such a step changes neither
// acc, m nor l, so the skip is exact for any positions, and for the index
// positions of training it is the causal bound hi of kernel.py:51-55.
//
// The forward also writes the fp32 row log-sum-exp LSE = m + log(l)
// (B, Hq, Sq); a fully masked row gets LSE_MASKED = 1e30, so exp(s - LSE)
// is 0 and its backward is zero.
//
// Backward (FlashAttention-2), two kernels, no atomics, so the gradients
// are deterministic:
//   flash_bwd_dq_kernel   one block per (batch, q head, q tile). Prologue:
//                         Delta = rowsum(dO * O) for its rows (to global,
//                         for the second kernel). Then over kv tiles:
//                         recompute P = exp(S - LSE), dP = dO.V^T,
//                         dS = P * (dP - Delta) (times 1 - tanh^2 under a
//                         softcap), dQ += dS.K * scale.
//   flash_bwd_dkdv_kernel one block per (batch, kv head, kv tile), launched
//                         after the first on the same stream. It loops over
//                         the G q heads of its kv head and every q tile,
//                         recomputes P and dS, and accumulates
//                         dV += P^T.dO and dK += dS^T.Q * scale in
//                         registers: GQA's sum over G happens in the block.
//
// Head dims up to 256: three variants by the largest D they take, (DMAX,
// RM) = (64, 4), (128, 4), (256, 2), so registers and shared memory fit;
// inside a variant every loop over the head dim runs to the true D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LSE_MASKED = 1e30f;
constexpr int TX = 16;        // threads per row of the 16 x 16 block
constexpr int NT = TX * TX;   // threads per block

struct Args {
  const void* q;      // (B, Sq, Hq, D)
  const void* k;      // (B, Sk, Hkv, D)
  const void* v;      // (B, Sk, Hkv, D)
  const int* qpos;    // (B, Sq) query positions
  const int* kpos;    // (B, Sk) key positions
  const int* kvlen;   // (B,) keys at positions >= kvlen are masked; nullptr: none
  const void* o;      // backward: the forward's output, layout of q
  const void* dout;   // backward: dO, layout of q
  const float* lse;   // backward: (B, Hq, Sq)
  float* delta;       // backward: (B, Hq, Sq), written by the dq kernel
  void* out;          // forward: O; backward: dQ (layout of q)
  float* lse_out;     // forward: (B, Hq, Sq)
  void* dk;           // backward: (B, Sk, Hkv, D)
  void* dv;
  int B, Sq, Sk, Hq, Hkv, D;
  int causal;
  int window;         // <= 0: none
  float softcap;      // <= 0: none
  float scale;        // 1/sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// max / sum over the 16 threads of one score row (lanes differing in bits 0-3)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp, int kvlen) {
  bool ok = kp < kvlen;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && kp > qp - a.window;
  return ok;
}

// dst[r * Dp + d] = src[(row0 + r) * stride + d] as fp32, zero past n_rows
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int n_rows,
                                          int rows, long stride, int D, int Dp) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, d = idx - r * D;
    const int g = row0 + r;
    dst[r * Dp + d] = g < n_rows ? to_f(src[static_cast<long>(g) * stride + d]) : 0.f;
  }
}

// scores s (and, with DO, dP = dO.V^T) of the thread's RM x RM pairs from
// shared tiles: rows ty + 16 i of a (Q, dO), keys tx + 16 j of (K, V)
template <int RM, bool DO>
__device__ __forceinline__ void score_tile(const float* q_s, const float* do_s,
                                           const float* k_s, const float* v_s,
                                           int D, int Dp, int tx, int ty,
                                           float (&s)[RM][RM], float (&dp)[RM][RM]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RM; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
  for (int d = 0; d < D; ++d) {
    float qv[RM], kv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty + TX * i) * Dp + d];
#pragma unroll
    for (int j = 0; j < RM; ++j) kv[j] = k_s[(tx + TX * j) * Dp + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    if (DO) {
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = do_s[(ty + TX * i) * Dp + d];
#pragma unroll
      for (int j = 0; j < RM; ++j) kv[j] = v_s[(tx + TX * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) dp[i][j] = fmaf(qv[i], kv[j], dp[i][j]);
    }
  }
}

// scale and soft-cap one raw score; t = tanh(s / cap) for the backward
__device__ __forceinline__ float cap_score(const Args& a, float raw, float& t) {
  float sc = raw * a.scale;
  t = 0.f;
  if (a.softcap > 0.f) {
    t = tanhf(sc / a.softcap);
    sc = t * a.softcap;
  }
  return sc;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int DMAX, int RM>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int BQ = TX * RM, BK = TX * RM, DC = DMAX / TX;
  extern __shared__ float smem[];
  const int D = a.D, Dp = D + 1;
  float* q_s = smem;             // BQ x Dp
  float* k_s = q_s + BQ * Dp;    // BK x Dp
  float* v_s = k_s + BK * Dp;    // BK x Dp
  float* p_s = v_s + BK * Dp;    // BQ x (BK + 1)

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const long q_stride = static_cast<long>(a.Hq) * D, k_stride = static_cast<long>(a.Hkv) * D;
  const T* qg = static_cast<const T*>(a.q) + (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
  const T* kg = static_cast<const T*>(a.k) + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const T* vg = static_cast<const T*>(a.v) + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const int kvlen = a.kvlen ? a.kvlen[b] : INT_MAX;

  load_tile(q_s, qg, q0, a.Sq, BQ, q_stride, D, Dp);

  int qp[RM];
  bool rin[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + TX * i;
    rin[i] = r < a.Sq;
    qp[i] = rin[i] ? a.qpos[static_cast<long>(b) * a.Sq + r] : 0;
  }
  bool dok[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dok[c] = tx + TX * c < D;

  float acc[RM][DC];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nk = (a.Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    int kp[RM];
    bool kin[RM];
    int any = 0;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int c = k0 + tx + TX * j;
      kin[j] = c < a.Sk;
      kp[j] = kin[j] ? a.kpos[static_cast<long>(b) * a.Sk + c] : 0;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) any |= rin[i] && kin[j] && visible(a, qp[i], kp[j], kvlen);
    // the vote is also the barrier before the tiles of the last step are overwritten
    if (!__syncthreads_or(any)) continue;
    load_tile(k_s, kg, k0, a.Sk, BK, k_stride, D, Dp);
    load_tile(v_s, vg, k0, a.Sk, BK, k_stride, D, Dp);
    __syncthreads();

    float s[RM][RM], unused[RM][RM];
    score_tile<RM, false>(q_s, nullptr, k_s, nullptr, D, Dp, tx, ty, s, unused);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = NEG_INF;
      bool vis[RM];
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        float t;
        const float sc = cap_score(a, s[i][j], t);
        vis[j] = rin[i] && kin[j] && visible(a, qp[i], kp[j], kvlen);
        s[i][j] = vis[j] ? sc : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_safe) : 0.f;
        p_s[(ty + TX * i) * (BK + 1) + tx + TX * j] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RM], vv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + TX * i) * (BK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) vv[jd] = dok[jd] ? v_s[c * Dp + tx + TX * jd] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

  T* og = static_cast<T*>(a.out) + (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + TX * i;
    if (!rin[i]) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      if (dok[jd]) og[static_cast<long>(r) * q_stride + tx + TX * jd] = from_f<T>(acc[i][jd] / lsafe);
    if (tx == 0) {
      const float m_safe = m[i] <= NEG_INF / 2 ? 0.f : m[i];
      a.lse_out[(static_cast<long>(b) * a.Hq + h) * a.Sq + r] =
          l[i] > 0.f ? m_safe + logf(l[i]) : LSE_MASKED;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dQ (with the Delta prologue)
// ---------------------------------------------------------------------------

template <typename T, int DMAX, int RM>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
  constexpr int BQ = TX * RM, BK = TX * RM, DC = DMAX / TX;
  extern __shared__ float smem[];
  const int D = a.D, Dp = D + 1;
  float* q_s = smem;             // BQ x Dp
  float* do_s = q_s + BQ * Dp;   // BQ x Dp
  float* k_s = do_s + BQ * Dp;   // BK x Dp
  float* v_s = k_s + BK * Dp;    // BK x Dp
  float* ds_s = v_s + BK * Dp;   // BQ x (BK + 1)

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const long q_stride = static_cast<long>(a.Hq) * D, k_stride = static_cast<long>(a.Hkv) * D;
  const long q_base = (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
  const T* qg = static_cast<const T*>(a.q) + q_base;
  const T* og = static_cast<const T*>(a.o) + q_base;
  const T* dog = static_cast<const T*>(a.dout) + q_base;
  const T* kg = static_cast<const T*>(a.k) + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const T* vg = static_cast<const T*>(a.v) + (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const long row_base = (static_cast<long>(b) * a.Hq + h) * a.Sq;
  const int kvlen = a.kvlen ? a.kvlen[b] : INT_MAX;

  load_tile(q_s, qg, q0, a.Sq, BQ, q_stride, D, Dp);
  load_tile(do_s, dog, q0, a.Sq, BQ, q_stride, D, Dp);
  __syncthreads();

  int qp[RM];
  bool rin[RM];
  float lse[RM], delta[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + TX * i;
    rin[i] = r < a.Sq;
    qp[i] = rin[i] ? a.qpos[static_cast<long>(b) * a.Sq + r] : 0;
    lse[i] = rin[i] ? a.lse[row_base + r] : 0.f;
    // Delta = rowsum(dO * O), O as the forward stored it
    float part = 0.f;
    if (rin[i])
      for (int d = tx; d < D; d += TX)
        part = fmaf(do_s[(ty + TX * i) * Dp + d], to_f(og[static_cast<long>(r) * q_stride + d]), part);
    delta[i] = row_sum(part);
    if (rin[i] && tx == 0) a.delta[row_base + r] = delta[i];
  }
  bool dok[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dok[c] = tx + TX * c < D;

  float acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int nk = (a.Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    int kp[RM];
    bool kin[RM];
    int any = 0;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int c = k0 + tx + TX * j;
      kin[j] = c < a.Sk;
      kp[j] = kin[j] ? a.kpos[static_cast<long>(b) * a.Sk + c] : 0;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) any |= rin[i] && kin[j] && visible(a, qp[i], kp[j], kvlen);
    if (!__syncthreads_or(any)) continue;
    load_tile(k_s, kg, k0, a.Sk, BK, k_stride, D, Dp);
    load_tile(v_s, vg, k0, a.Sk, BK, k_stride, D, Dp);
    __syncthreads();

    float s[RM][RM], dp[RM][RM];
    score_tile<RM, true>(q_s, do_s, k_s, v_s, D, Dp, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        float t;
        const float sc = cap_score(a, s[i][j], t);
        const bool vis = rin[i] && kin[j] && visible(a, qp[i], kp[j], kvlen);
        const float p = vis ? expf(sc - lse[i]) : 0.f;
        float ds = p * (dp[i][j] - delta[i]);
        if (a.softcap > 0.f) ds *= 1.f - t * t;
        ds_s[(ty + TX * i) * (BK + 1) + tx + TX * j] = ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RM], kv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsv[i] = ds_s[(ty + TX * i) * (BK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) kv[jd] = dok[jd] ? k_s[c * Dp + tx + TX * jd] : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) acc[i][jd] = fmaf(dsv[i], kv[jd], acc[i][jd]);
    }
  }

  T* dqg = static_cast<T*>(a.out) + q_base;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + TX * i;
    if (!rin[i]) continue;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      if (dok[jd]) dqg[static_cast<long>(r) * q_stride + tx + TX * jd] = from_f<T>(acc[i][jd] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV (reads the dq kernel's Delta)
// ---------------------------------------------------------------------------

template <typename T, int DMAX, int RM>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(Args a) {
  constexpr int BQ = TX * RM, BK = TX * RM, DC = DMAX / TX;
  extern __shared__ float smem[];
  const int D = a.D, Dp = D + 1;
  float* k_s = smem;             // BK x Dp
  float* v_s = k_s + BK * Dp;    // BK x Dp
  float* q_s = v_s + BK * Dp;    // BQ x Dp
  float* do_s = q_s + BQ * Dp;   // BQ x Dp
  float* p_s = do_s + BQ * Dp;   // BQ x (BK + 1)
  float* ds_s = p_s + BQ * (BK + 1);

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const long q_stride = static_cast<long>(a.Hq) * D, k_stride = static_cast<long>(a.Hkv) * D;
  const long k_base = (static_cast<long>(b) * a.Sk * a.Hkv + hk) * D;
  const int kvlen = a.kvlen ? a.kvlen[b] : INT_MAX;

  load_tile(k_s, static_cast<const T*>(a.k) + k_base, k0, a.Sk, BK, k_stride, D, Dp);
  load_tile(v_s, static_cast<const T*>(a.v) + k_base, k0, a.Sk, BK, k_stride, D, Dp);

  // score-phase keys: k0 + tx + 16 j
  int kp[RM];
  bool kin[RM];
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    const int c = k0 + tx + TX * j;
    kin[j] = c < a.Sk;
    kp[j] = kin[j] ? a.kpos[static_cast<long>(b) * a.Sk + c] : 0;
  }
  bool dok[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) dok[c] = tx + TX * c < D;

  // accumulate-phase rows of the kv tile: k0 + ty + 16 i
  float dk[RM][DC], dv[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) { dk[i][c] = 0.f; dv[i][c] = 0.f; }

  const int nq = (a.Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long q_base = (static_cast<long>(b) * a.Sq * a.Hq + h) * D;
    const long row_base = (static_cast<long>(b) * a.Hq + h) * a.Sq;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      int qp[RM];
      bool rin[RM];
      int any = 0;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = q0 + ty + TX * i;
        rin[i] = r < a.Sq;
        qp[i] = rin[i] ? a.qpos[static_cast<long>(b) * a.Sq + r] : 0;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) any |= rin[i] && kin[j] && visible(a, qp[i], kp[j], kvlen);
      if (!__syncthreads_or(any)) continue;
      load_tile(q_s, static_cast<const T*>(a.q) + q_base, q0, a.Sq, BQ, q_stride, D, Dp);
      load_tile(do_s, static_cast<const T*>(a.dout) + q_base, q0, a.Sq, BQ, q_stride, D, Dp);
      float lse[RM], delta[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = q0 + ty + TX * i;
        lse[i] = rin[i] ? a.lse[row_base + r] : 0.f;
        delta[i] = rin[i] ? a.delta[row_base + r] : 0.f;
      }
      __syncthreads();

      float s[RM][RM], dp[RM][RM];
      score_tile<RM, true>(q_s, do_s, k_s, v_s, D, Dp, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          float t;
          const float sc = cap_score(a, s[i][j], t);
          const bool vis = rin[i] && kin[j] && visible(a, qp[i], kp[j], kvlen);
          const float p = vis ? expf(sc - lse[i]) : 0.f;
          float ds = p * (dp[i][j] - delta[i]);
          if (a.softcap > 0.f) ds *= 1.f - t * t;
          p_s[(ty + TX * i) * (BK + 1) + tx + TX * j] = p;
          ds_s[(ty + TX * i) * (BK + 1) + tx + TX * j] = ds;
        }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RM], dsv[RM], dov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pv[i] = p_s[r * (BK + 1) + ty + TX * i];
          dsv[i] = ds_s[r * (BK + 1) + ty + TX * i];
        }
#pragma unroll
        for (int jd = 0; jd < DC; ++jd) {
          dov[jd] = dok[jd] ? do_s[r * Dp + tx + TX * jd] : 0.f;
          qv[jd] = dok[jd] ? q_s[r * Dp + tx + TX * jd] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int jd = 0; jd < DC; ++jd) {
            dv[i][jd] = fmaf(pv[i], dov[jd], dv[i][jd]);
            dk[i][jd] = fmaf(dsv[i], qv[jd], dk[i][jd]);
          }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + k_base;
  T* dvg = static_cast<T*>(a.dv) + k_base;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int c = k0 + ty + TX * i;
    if (c >= a.Sk) continue;
#pragma unroll
    for (int jd = 0; jd < DC; ++jd)
      if (dok[jd]) {
        const long off = static_cast<long>(c) * k_stride + tx + TX * jd;
        dkg[off] = from_f<T>(dk[i][jd] * a.scale);
        dvg[off] = from_f<T>(dv[i][jd]);
      }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Which { FWD = 0, BWD_DQ = 1, BWD_DKDV = 2 };

template <typename T, int DMAX, int RM>
int launch_one(Which which, const Args& a, cudaStream_t stream) {
  constexpr int BQ = TX * RM, BK = TX * RM;
  const int Dp = a.D + 1;
  void (*kernel)(Args);
  dim3 grid;
  size_t floats;
  if (which == FWD) {
    kernel = flash_fwd_kernel<T, DMAX, RM>;
    grid = dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
    floats = static_cast<size_t>(BQ) * Dp + 2 * BK * Dp + BQ * (BK + 1);
  } else if (which == BWD_DQ) {
    kernel = flash_bwd_dq_kernel<T, DMAX, RM>;
    grid = dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
    floats = static_cast<size_t>(2) * BQ * Dp + 2 * BK * Dp + BQ * (BK + 1);
  } else {
    kernel = flash_bwd_dkdv_kernel<T, DMAX, RM>;
    grid = dim3((a.Sk + BK - 1) / BK, a.Hkv, a.B);
    floats = static_cast<size_t>(2) * BK * Dp + 2 * BQ * Dp + 2 * BQ * (BK + 1);
  }
  const size_t smem = floats * sizeof(float);
  // Allow each kernel the shared memory its variant needs at D = DMAX, once
  // (so never inside a CUDA-graph capture after the first launch).
  static int smem_allowed[3] = {0, 0, 0};
  if (smem > 48 * 1024 && smem_allowed[which] < static_cast<int>(smem)) {
    const int dp = DMAX + 1;
    const int most = static_cast<int>(sizeof(float)) * (
        which == FWD ? BQ * dp + 2 * BK * dp + BQ * (BK + 1)
        : which == BWD_DQ ? 2 * BQ * dp + 2 * BK * dp + BQ * (BK + 1)
                          : 2 * BK * dp + 2 * BQ * dp + 2 * BQ * (BK + 1));
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed[which] = most;
  }
  kernel<<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(Which which, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch_one<T, 64, 4>(which, a, stream);
  if (a.D <= 128) return launch_one<T, 128, 4>(which, a, stream);
  return launch_one<T, 256, 2>(which, a, stream);
}

int launch(Which which, const Args& a, void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (a.D <= 0 || a.D > 256 || a.Hkv <= 0 || a.Hq % a.Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_dtype<float>(which, a, s);
}

}  // namespace

// float32 tensors. kvlen may be null. Returns the
// cudaError_t of the launch.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const int* qpos, const int* kpos, const int* kvlen,
                                void* out, float* lse, int B, int Sq, int Sk, int Hq,
                                int Hkv, int D, int causal, int window, float softcap,
                                float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.qpos = qpos; a.kpos = kpos; a.kvlen = kvlen;
  a.out = out; a.lse_out = lse;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  return launch(FWD, a, stream);
}

// The backward: the dq kernel (which also writes delta), then the dk/dv
// kernel on the same stream.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const float* lse,
                                const int* qpos, const int* kpos, const int* kvlen,
                                float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                int Sk, int Hq, int Hkv, int D, int causal, int window,
                                float softcap, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.qpos = qpos; a.kpos = kpos; a.kvlen = kvlen; a.delta = delta;
  a.out = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.causal = causal; a.window = window; a.softcap = softcap; a.scale = scale;
  const int rc = launch(BWD_DQ, a, stream);
  if (rc != 0) return rc;
  return launch(BWD_DKDV, a, stream);
}
