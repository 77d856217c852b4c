// Paged attention for Hopper (sm_90a) on the CUDA cores: the fp32 route of
// decode (one query per sequence) and chunked prefill (a chunk of queries
// per sequence), both read straight through the block table from the
// shared page pool. bf16 goes to the tensor-core kernels of
// paged_attention_tc.cu (split-K over pages, mma.sync, cp.async staging).
//
// Replaces:
//   paged_decode_kernel  <- repro/kernels/paged_attention/kernel.py
//                           _paged_kernel (paged_attention_pallas)
//   paged_prefill_kernel <- repro/kernels/paged_attention/kernel.py
//                           _paged_prefill_kernel (paged_prefill_attention_pallas)
//
// Bound on the H100: bytes. Each visible key and value is read from the
// pool once per block, and per key a block does 4*D operations for each
// of its query rows: at most a few operations per byte, far below the
// ~295 at which the tensor cores would be the limit.
//
// Design. The Pallas grid (batch, kv_head, logical_page) carried the
// online-softmax state acc/m/l in VMEM from one page to the next; blocks on
// Hopper run in no order, so the page walk becomes a loop inside one block
// per (sequence, kv head, tile of NWARPS query rows). One warp owns one
// query row (row = c*G + g: chunk position c, query head h*G + g). The
// block reads its own block-table row and walks only the pages holding
// keys some row of the tile can see: [lo, hi) with hi = cache_len (and the
// tile's last causal position + 1), lo = the tile's first window start.
// A page past cache_len is never read, so neither is the page a -1 entry
// would be clipped to. Entries inside cache_len are clipped to [0, P) as
// the reference gather clips them. Each step stages KCH keys and values of
// one page in shared memory (fp32, rows padded to D+1 floats so the lanes
// of a warp hit distinct banks) and every warp of the block reads them:
// the pool traffic is shared by the NWARPS rows. Lane j scores key j, the
// warp reduces the chunk max and sum with shuffles, and each lane keeps
// D/32 accumulator columns in registers.
//
// Masking follows kernel.py:73-91 exactly: scores are scaled by 1/sqrt(D),
// soft-capped, then masked to NEG_INF = -1e30; m_safe = 0 while the
// running max is still NEG_INF; masked probabilities are 0; alpha = 0 while
// the previous max is NEG_INF; the output is acc / max(l, 1e-30), so a
// fully masked row writes 0. Skipped key ranges are masked for every row
// of the tile, where a step changes neither acc, m nor l, so skipping them
// is exact.
//
// Not yet done (later work): split-K over pages for long caches with few
// (sequence, head) pairs (the bf16 route has it).

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARP = 32;
constexpr int NWARPS = 8;            // query rows per block, one warp each
constexpr int KCH = 32;              // keys staged per step (one per lane)
constexpr int MAX_D = 256;
constexpr int DPL = MAX_D / WARP;    // accumulator columns per lane

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* tbl;     // (B, nL) block table, -1 = unallocated
  const int* lens;    // (B,) written tokens (cache_len)
  const int* qstart;  // (B,) position of query 0 (decode: q_position)
  void* out;          // (B, C, Hq, D), the layout of q
  int C, Hq, Hkv, D, page, nL, P;
  int causal;         // prefill: mask kpos <= qpos; decode: 0
  int window;         // <= 0: none
  float softcap;      // <= 0: none
  float scale;        // 1/sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void paged_attend(const Args& a) {
  extern __shared__ float smem[];
  const int D = a.D, Dp = D + 1;
  float* q_s = smem;                  // NWARPS x D
  float* k_s = q_s + NWARPS * D;      // KCH x Dp
  float* v_s = k_s + KCH * Dp;        // KCH x Dp

  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* op = static_cast<T*>(a.out);

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int rows = G * a.C;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int r0 = blockIdx.z * NWARPS;
  const int row = r0 + warp;
  const bool row_ok = row < rows;     // uniform across the warp
  const int c = row_ok ? row / G : 0;
  const int g = row_ok ? row % G : 0;
  const int start = a.qstart[b];
  const int qpos = start + c;
  const int len = a.lens[b];
  const long q_off = ((static_cast<long>(b) * a.C + c) * a.Hq + h * G + g) * D;

  for (int d = lane; d < D; d += WARP)
    q_s[warp * D + d] = row_ok ? to_f(qp[q_off + d]) : 0.f;

  // keys any row of this tile can see: [lo, hi)
  const int r_last = min(r0 + NWARPS, rows) - 1;
  int hi = len;
  if (a.causal) hi = min(hi, start + r_last / G + 1);
  int lo = 0;
  if (a.window > 0) lo = max(0, start + r0 / G - a.window + 1);

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const long tok_stride = static_cast<long>(a.Hkv) * D;  // one token of a page
  // the gathered view of the reference holds nL pages: keys past it do not exist
  const int n_pages = hi > 0 ? min((hi + a.page - 1) / a.page, a.nL) : 0;
  for (int lp = lo / a.page; lp < n_pages; ++lp) {
    const int phys = min(max(a.tbl[b * a.nL + lp], 0), a.P - 1);
    for (int t0 = 0; t0 < a.page; t0 += KCH) {
      const int kbase = lp * a.page + t0;
      const int n = min(KCH, a.page - t0);
      if (kbase >= hi) break;
      if (kbase + n <= lo) continue;
      __syncthreads();  // the previous chunk's readers are done (and q_s is written)
      const long base = (static_cast<long>(phys) * a.page + t0) * tok_stride
                        + static_cast<long>(h) * D;
      for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
        const int t = idx / D, d = idx - t * D;
        const long off = base + t * tok_stride + d;
        k_s[t * Dp + d] = to_f(kp[off]);
        v_s[t * Dp + d] = to_f(vp[off]);
      }
      __syncthreads();

      float s = NEG_INF;
      bool valid = false;
      if (lane < n) {
        const int kpos = kbase + lane;
        valid = row_ok && kpos < len;
        if (a.causal) valid = valid && kpos <= qpos;
        if (a.window > 0) valid = valid && kpos > qpos - a.window;
        const float* qr = q_s + warp * D;
        const float* kr = k_s + lane * Dp;
        // four independent partial sums: the shared-memory loads of one
        // chain overlap the FMAs of the others
        float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
        int d = 0;
#pragma unroll 4
        for (; d + 4 <= D; d += 4) {
          p0 = fmaf(qr[d], kr[d], p0);
          p1 = fmaf(qr[d + 1], kr[d + 1], p1);
          p2 = fmaf(qr[d + 2], kr[d + 2], p2);
          p3 = fmaf(qr[d + 3], kr[d + 3], p3);
        }
        for (; d < D; ++d) p0 = fmaf(qr[d], kr[d], p0);
        float sc = ((p0 + p1) + (p2 + p3)) * a.scale;
        if (a.softcap > 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
        s = valid ? sc : NEG_INF;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float p = valid ? expf(s - m_safe) : 0.f;
      const float alpha = m <= NEG_INF / 2 ? 0.f : expf(m - m_safe);
      l = l * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = v_s + j * Dp;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + i * WARP;
          if (d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float lsafe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + i * WARP;
      if (d < D) op[q_off + d] = from_f<T>(acc[i] / lsafe);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NWARPS * WARP) paged_decode_kernel(Args a) {
  paged_attend<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(NWARPS * WARP) paged_prefill_kernel(Args a) {
  paged_attend<T>(a);
}

int launch(void (*kernel)(Args), const Args& a, int B, void* stream) {
  if (B <= 0 || a.C <= 0) return 0;
  if (a.D <= 0 || a.D > MAX_D || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.page <= 0 ||
      a.nL <= 0 || a.P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (a.Hq / a.Hkv) * a.C;
  const dim3 grid(B, a.Hkv, (rows + NWARPS - 1) / NWARPS);
  const size_t smem = sizeof(float) * (NWARPS * a.D + 2 * KCH * (a.D + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, NWARPS * WARP, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 only. Returns the cudaError_t of the launch.
extern "C" int paged_decode_launch(const void* q, const void* k, const void* v,
                                   const int* tbl, const int* lens, const int* qpos,
                                   void* out, int B, int Hq, int Hkv, int D, int page,
                                   int nL, int P, int window, float softcap, float scale,
                                   void* stream) {
  const Args a{q, k, v, tbl, lens, qpos, out, 1, Hq, Hkv, D, page, nL, P,
               0, window, softcap, scale};
  return launch(paged_decode_kernel<float>, a, B, stream);
}

extern "C" int paged_prefill_launch(const void* q, const void* k, const void* v,
                                    const int* tbl, const int* lens, const int* qstart,
                                    void* out, int B, int C, int Hq, int Hkv, int D,
                                    int page, int nL, int P, int causal, int window,
                                    float softcap, float scale, void* stream) {
  const Args a{q, k, v, tbl, lens, qstart, out, C, Hq, Hkv, D, page, nL, P,
               causal, window, softcap, scale};
  return launch(paged_prefill_kernel<float>, a, B, stream);
}
