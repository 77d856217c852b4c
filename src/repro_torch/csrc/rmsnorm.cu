// RMSNorm for Hopper (sm_90a): the forward and its backward, bf16 and fp32.
//
// Replaces:
//   rmsnorm_fwd_kernel    <- repro/kernels/rmsnorm/kernel.py:22 _rmsnorm_kernel
//                            (rmsnorm_pallas)
//   rmsnorm_bwd_kernel,   the backward (dx, dscale), which the Pallas kernel
//   rmsnorm_dscale_kernel never had: the JAX training step differentiates the
//                            jnp repro.layers.norms.rmsnorm
//
// The function: y = x * rsqrt(mean(x^2) + eps) * s over the last axis of a
// (rows, d) array, with the sum in fp32 and s = scale (or 1 + scale,
// zero-centred); the backward's dx = rstd * (g - xhat * mean(g * xhat))
// with g = dy * s and xhat = x * rstd, and dscale = sum over rows of
// dy * xhat.
//
// Bound on the H100: bytes. The forward reads a row once and writes it once
// (the backward reads x and dy and writes dx) and does ~4-8 operations per
// element, far below the ~295 operations per byte at which the tensor cores
// would be the limit. What the design does about it:
//
// - Every element is read once and written once, in 16-byte accesses (8
//   bf16 or 4 fp32 a thread), neighbouring threads on neighbouring
//   addresses. A block is a team of W warps that owns one row at a time,
//   each thread VPT vectors of it (at most 16 elements of each tensor); the
//   row's sums and outputs come from registers. The scale is read once a
//   block, its load in flight with the first row's, and widened to fp32
//   (1 + scale when zero-centred) where it is used.
// - Bytes in flight. A block walks a contiguous run of rows (the host's
//   plan: kernels/rmsnorm/ops.py plan) and keeps the loads of the next rows
//   in flight by cp.async into a ring in shared memory, which holds no
//   register while the copy is on its way: while one row is summed and
//   written, up to `ring` rows behind it are arriving. Registers then no
//   longer bound the bytes in flight an SM has. The backward recomputes
//   rstd from x, so the forward saves only its inputs.
// - A row's sums (the forward's sum of x^2; the backward's sum of x^2 and
//   of g * x, together) are one warp-shuffle butterfly and, for a team of
//   more than one warp, one shared-memory step; every thread adds the
//   warps' sums in warp order, so all of them hold the same bits.
// - dscale: each thread owns the same columns in every row of its block's
//   run and sums dy * xhat for them in fp32 registers; the block writes
//   them as one fp32 partial row. A second launch, rmsnorm_dscale_kernel,
//   spreads the combine over the card: a block per 32 columns (d/32
//   blocks), 32 warps each; warp w sums a contiguous run of the partial
//   rows in block order, and warp 0 adds the 32 runs in order. The plan
//   reads only the shapes, the dtype and the SM count, so every sum has a
//   fixed order and both gradients are bitwise repeatable. The combine is
//   not folded into the row pass by a last-arrival counter: the last block
//   would read every partial (4 MB at 8192 x 2048) through one SM.
//
// A width that is not a multiple of the vector, or a pointer that is not
// 16-byte aligned, takes the scalar path: one element an access, columns in
// a loop, each read for the sums and again for the outputs. Widths up to
// MAX_D = 8192 on either path; x and the scale may each be fp32 or bf16.
// Each launch function returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_WARPS = 16;        // warps of a team (a row)
constexpr int MAX_THREADS = 512;     // threads of a block
constexpr int MAX_EPT = 16;          // elements of a tensor a thread holds
constexpr int SCALAR_VPT = 16;       // columns a thread takes on the scalar path (plan)
constexpr int MAX_D = 8192;
constexpr int MAX_RING = 8;          // rows a block keeps in flight
constexpr int RING_BYTES = 40 * 1024;  // a block's ring: under the 48 KB of a plain launch
constexpr int COMBINE_COLS = 32;     // columns of a combine block (one a lane)
constexpr int COMBINE_WARPS = 32;    // runs of partial rows a combine block sums

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// N elements of T as one access: 16 bytes on the vector path (two for an
// fp32 scale beside a bf16 row), one element on the scalar path.
template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> ld(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cp.async: a 16-byte copy from device to shared memory that holds no
// register while in flight; a commit group per row; waiting until at most
// k groups are pending (k < MAX_RING; a uniform switch, since the count
// must be an immediate).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}
__device__ __forceinline__ void cp_wait_dyn(int k) {
  switch (k) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

// The block's (one team's) sums of K values: warp shuffles, then for more
// than one warp one shared-memory step, added in warp order by every
// thread. red holds two buffers, so a row needs one barrier.
template <int K>
__device__ __forceinline__ void team_sum(float* v, float (*red)[MAX_WARPS][2], int it) {
#ifdef RMSNORM_NO_SUM  // a leave-out for timing: each thread keeps its own sums
  return;
#endif
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return;
  float(*buf)[2] = red[it & 1];
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) buf[threadIdx.x >> 5][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = 0.f;
    for (int w = 0; w < warps; ++w) v[k] += buf[w][k];
  }
}

struct Args {
  const void* x;
  const void* scale;
  const void* dy;  // backward
  void* out;       // y (forward), dx (backward)
  float* part;     // backward: one fp32 partial row of dscale a block
  int rows, d, per, ring, zc;
  float eps;
};

extern __shared__ uint4 ring_smem[];

// Rows [blockIdx.x * per, +per) of a block: its first row and count.
struct Run {
  long base;
  int n;
  __device__ __forceinline__ Run(const Args& a) {
    base = static_cast<long>(blockIdx.x) * a.per;
    n = base < a.rows ? static_cast<int>(a.rows - base < a.per ? a.rows - base : a.per) : 0;
  }
};

// The 16-byte path. A block is one team (blockDim.x = 32 * warps threads)
// and walks its rows in order; thread t holds the vectors v * blockDim.x +
// t of every row, v < VPT. The rows' loads go by cp.async into a ring of
// `ring` slots in shared memory, each thread copying (and later reading)
// only its own vectors, so no barrier guards the ring: row i + ring is
// requested as soon as row i has been read out of its slot. With ring 0
// (rows too wide for a slot in RING_BYTES) a row is loaded into registers
// when it is reached.
template <typename TX, typename TS, int N, int VPT, int TENSORS>
struct Walk : Run {
  using P = Pack<TX, N>;
  int t, tpr, d, ring;
  bool zc;
  const TX* src[TENSORS];
  Pack<TS, N> sc[VPT];  // the scale as loaded (0 past d), widened at use, so
                        // that its load overlaps the first row's

  __device__ __forceinline__ Walk(const Args& a, const TX* const* srcs) : Run(a) {
    t = threadIdx.x;
    tpr = blockDim.x;
    d = a.d;
    ring = a.ring;
    zc = a.zc;
#pragma unroll
    for (int j = 0; j < TENSORS; ++j) src[j] = srcs[j];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      if (col(v) < d) {
        sc[v] = ld<TS, N>(static_cast<const TS*>(a.scale) + col(v));
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) sc[v].v[i] = from_f<TS>(0.f);
      }
    }
  }
  // s = scale, or 1 + scale (zero-centred), in fp32
  __device__ __forceinline__ float s(int v, int i) const {
    return zc ? 1.f + to_f(sc[v].v[i]) : to_f(sc[v].v[i]);
  }
  __device__ __forceinline__ int col(int v) const { return (v * tpr + t) * N; }
  __device__ __forceinline__ long row(int i) const { return base + i; }
  __device__ __forceinline__ P* slot(int i, int j, int v) const {
    return reinterpret_cast<P*>(ring_smem) + ((i % ring * TENSORS + j) * VPT + v) * tpr + t;
  }
  // Request row i: one commit group a row, an empty one past n, so that
  // waiting for all but the last ring - 1 groups waits for row i.
  __device__ __forceinline__ void issue(int i) {
    if (ring == 0) return;
    if (i < n) {
#pragma unroll
      for (int v = 0; v < VPT; ++v)
        if (col(v) < d) {
#pragma unroll
          for (int j = 0; j < TENSORS; ++j)
            cp_async16(slot(i, j, v), src[j] + row(i) * d + col(v));
        }
    }
    cp_commit();
  }
  __device__ __forceinline__ void start() {
    for (int i = 0; i < ring; ++i) issue(i);
  }
  // Row i's vectors into registers (0 past d).
  __device__ __forceinline__ void acquire(int i, P (&q)[TENSORS][VPT]) {
    if (ring > 0) cp_wait_dyn(ring - 1);
#pragma unroll
    for (int v = 0; v < VPT; ++v)
#pragma unroll
      for (int j = 0; j < TENSORS; ++j) {
        if (col(v) < d) {
          q[j][v] = ring > 0 ? *slot(i, j, v) : ld<TX, N>(src[j] + row(i) * d + col(v));
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) q[j][v].v[e] = from_f<TX>(0.f);
        }
      }
  }
};

// The scalar path (a width off the 16-byte vector, or a pointer off a
// 16-byte boundary): one element an access, the columns t, t + blockDim.x,
// ... in a loop, read once for the sums and again for the outputs, so that
// no register array is held over a row (nothing spills at 8192 wide). The
// sums run over the same columns in the same order as the 16-byte path's.
template <typename TS>
__device__ __forceinline__ float scale_at(const Args& a, int c) {
  const float s = to_f(static_cast<const TS*>(a.scale)[c]);
  return a.zc ? 1.f + s : s;
}

template <typename TX, typename TS>
__device__ void fwd_scalar(const Args& a, float (*red)[MAX_WARPS][2]) {
  const Run run(a);
  const TX* X = static_cast<const TX*>(a.x);
  TX* Y = static_cast<TX*>(a.out);
  const int d = a.d;
  for (int i = 0; i < run.n; ++i) {
    const long r = (run.base + i) * d;
    float ss[1] = {0.f};
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float x = to_f(X[r + c]);
      ss[0] = fmaf(x, x, ss[0]);
    }
    team_sum<1>(ss, red, i);
    const float rstd = rsqrtf(ss[0] / d + a.eps);
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      Y[r + c] = from_f<TX>(to_f(X[r + c]) * rstd * scale_at<TS>(a, c));
  }
}

// The block's dscale partial lives in its row of a.part, which each thread
// updates for its own columns, row after row in order.
template <typename TX, typename TS>
__device__ void bwd_scalar(const Args& a, float (*red)[MAX_WARPS][2]) {
  const Run run(a);
  const TX* X = static_cast<const TX*>(a.x);
  const TX* DY = static_cast<const TX*>(a.dy);
  TX* DX = static_cast<TX*>(a.out);
  const int d = a.d;
  float* prow = a.part + static_cast<long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) prow[c] = 0.f;
  for (int i = 0; i < run.n; ++i) {
    const long r = (run.base + i) * d;
    float acc[2] = {0.f, 0.f};  // sum x^2, sum g * x
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float x = to_f(X[r + c]);
      acc[0] = fmaf(x, x, acc[0]);
      acc[1] = fmaf(to_f(DY[r + c]) * scale_at<TS>(a, c), x, acc[1]);
    }
    team_sum<2>(acc, red, i);
    const float rstd = rsqrtf(acc[0] / d + a.eps);
    const float c2 = rstd * (acc[1] / d);  // mean(g * xhat)
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float xh = to_f(X[r + c]) * rstd, dy = to_f(DY[r + c]);
      DX[r + c] = from_f<TX>(rstd * (dy * scale_at<TS>(a, c) - xh * c2));
      prow[c] = fmaf(dy, xh, prow[c]);
    }
  }
}

template <typename TX, typename TS, int N, int VPT>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_fwd_kernel(Args a) {
  __shared__ float red[2][MAX_WARPS][2];
  if constexpr (N == 1) {
    fwd_scalar<TX, TS>(a, red);
  } else {
    const TX* srcs[1] = {static_cast<const TX*>(a.x)};
    Walk<TX, TS, N, VPT, 1> w(a, srcs);
    TX* Y = static_cast<TX*>(a.out);
    w.start();
    for (int i = 0; i < w.n; ++i) {
      Pack<TX, N> q[1][VPT];
      w.acquire(i, q);
      float ss[1] = {0.f};
#pragma unroll
      for (int v = 0; v < VPT; ++v)
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float x = to_f(q[0][v].v[e]);
          ss[0] = fmaf(x, x, ss[0]);
        }
      team_sum<1>(ss, red, i);
      w.issue(i + w.ring);
      const float rstd = rsqrtf(ss[0] / w.d + a.eps);
      const long r = w.row(i);
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        if (w.col(v) >= w.d) continue;
        Pack<TX, N> o;
#pragma unroll
        for (int e = 0; e < N; ++e) o.v[e] = from_f<TX>(to_f(q[0][v].v[e]) * rstd * w.s(v, e));
        *reinterpret_cast<Pack<TX, N>*>(Y + r * w.d + w.col(v)) = o;
      }
    }
  }
}

template <typename TX, typename TS, int N, int VPT>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_bwd_kernel(Args a) {
  __shared__ float red[2][MAX_WARPS][2];
  if constexpr (N == 1) {
    bwd_scalar<TX, TS>(a, red);
  } else {
    const TX* srcs[2] = {static_cast<const TX*>(a.x), static_cast<const TX*>(a.dy)};
    Walk<TX, TS, N, VPT, 2> w(a, srcs);
    TX* DX = static_cast<TX*>(a.out);
    float ds[VPT][N];
#pragma unroll
    for (int v = 0; v < VPT; ++v)
#pragma unroll
      for (int e = 0; e < N; ++e) ds[v][e] = 0.f;
    w.start();
    for (int i = 0; i < w.n; ++i) {
      Pack<TX, N> q[2][VPT];  // x, dy
      w.acquire(i, q);
      float acc[2] = {0.f, 0.f};  // sum x^2, sum g * x
#pragma unroll
      for (int v = 0; v < VPT; ++v)
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float x = to_f(q[0][v].v[e]);
          acc[0] = fmaf(x, x, acc[0]);
          acc[1] = fmaf(to_f(q[1][v].v[e]) * w.s(v, e), x, acc[1]);
        }
      team_sum<2>(acc, red, i);
      w.issue(i + w.ring);
      const float rstd = rsqrtf(acc[0] / w.d + a.eps);
      const float c2 = rstd * (acc[1] / w.d);  // mean(g * xhat)
      const long r = w.row(i);
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        if (w.col(v) >= w.d) continue;
        Pack<TX, N> o;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xh = to_f(q[0][v].v[e]) * rstd, dy = to_f(q[1][v].v[e]);
          o.v[e] = from_f<TX>(rstd * (dy * w.s(v, e) - xh * c2));
          ds[v][e] = fmaf(dy, xh, ds[v][e]);
        }
        *reinterpret_cast<Pack<TX, N>*>(DX + r * w.d + w.col(v)) = o;
      }
    }
    float* prow = a.part + static_cast<long>(blockIdx.x) * w.d;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      if (w.col(v) >= w.d) continue;
      Pack<float, N> o;
#pragma unroll
      for (int e = 0; e < N; ++e) o.v[e] = ds[v][e];
      *reinterpret_cast<Pack<float, N>*>(prow + w.col(v)) = o;
    }
  }
}

// dscale[c] = the partial rows' sum: warp w adds the rows of its run
// [w * blocks / 32, (w + 1) * blocks / 32) in block order (unrolled 16
// deep, so a run of 16, the training shape's, issues its loads at once),
// warp 0 the runs in order.
template <typename TS>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
    rmsnorm_dscale_kernel(const float* part, TS* dscale, int blocks, int d) {
  __shared__ float runs[COMBINE_WARPS][COMBINE_COLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * COMBINE_COLS + lane;
  const int b0 = static_cast<int>(static_cast<long>(warp) * blocks / COMBINE_WARPS);
  const int b1 = static_cast<int>(static_cast<long>(warp + 1) * blocks / COMBINE_WARPS);
  float acc = 0.f;
  if (c < d) {
#pragma unroll 16
    for (int b = b0; b < b1; ++b) acc += part[static_cast<long>(b) * d + c];
  }
  runs[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || c >= d) return;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < COMBINE_WARPS; ++w) sum += runs[w][lane];
  dscale[c] = from_f<TS>(sum);
}

template <int N, int VPT>
constexpr bool fits() { return N * VPT <= MAX_EPT; }

using Kernel = void (*)(Args);

// The kernels of one (x, scale) type pair for the plan's (n, vpt); left null
// for a pair the plan never asks for.
template <typename TX, typename TS, int N, int VPT>
void pick(int vpt, int n, Kernel* fwd, Kernel* bwd) {
  if constexpr (fits<N, VPT>()) {
    if (n == N && vpt == VPT) {
      *fwd = rmsnorm_fwd_kernel<TX, TS, N, VPT>;
      *bwd = rmsnorm_bwd_kernel<TX, TS, N, VPT>;
    }
  }
}

template <typename TX, typename TS>
void kernels_of(int vec, int vpt, Kernel* fwd, Kernel* bwd) {
  constexpr int NV = 16 / sizeof(TX);
  const int n = vec ? NV : 1;
  pick<TX, TS, 1, SCALAR_VPT>(vpt, n, fwd, bwd);
  pick<TX, TS, NV, 1>(vpt, n, fwd, bwd);
  pick<TX, TS, NV, 2>(vpt, n, fwd, bwd);
  pick<TX, TS, NV, 4>(vpt, n, fwd, bwd);
}

void kernels(int x_bf16, int s_bf16, int vec, int vpt, Kernel* fwd, Kernel* bwd) {
  *fwd = *bwd = nullptr;
  if (x_bf16 && s_bf16) kernels_of<bf16, bf16>(vec, vpt, fwd, bwd);
  else if (x_bf16) kernels_of<bf16, float>(vec, vpt, fwd, bwd);
  else if (s_bf16) kernels_of<float, bf16>(vec, vpt, fwd, bwd);
  else kernels_of<float, float>(vec, vpt, fwd, bwd);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The plan's layout of a row (vec: 16-byte accesses or one element; vpt
// accesses a thread; warps a team) must cover it, and its blocks of per
// consecutive rows must cover the rows, none empty.
bool plan_ok(int rows, int d, int x_bf16, int vec, int vpt, int warps, int blocks, int per) {
  const int n = vec ? (x_bf16 ? 8 : 4) : 1;
  return d >= 1 && d <= MAX_D && warps >= 1 && warps <= MAX_WARPS && vpt >= 1 &&
         (!vec || d % n == 0) && static_cast<long>(32) * warps * vpt * n >= d && blocks >= 1 &&
         per >= 1 && static_cast<long>(blocks) * per >= rows &&
         static_cast<long>(blocks - 1) * per < rows;
}

// Shared memory of the ring, or -1 where it is out of range (the scalar
// path keeps none: ring 0).
long ring_bytes(int vec, int ring, int tensors, int vpt, int warps) {
  if (ring < 0 || ring > MAX_RING || (!vec && ring != 0)) return -1;
  const long bytes = 16L * ring * tensors * vpt * 32 * warps;
  return bytes <= RING_BYTES ? bytes : -1;
}

}  // namespace

// Limits the host's plan must respect.
extern "C" int rmsnorm_max_d() { return MAX_D; }
extern "C" int rmsnorm_max_ept() { return MAX_EPT; }
extern "C" int rmsnorm_scalar_vpt() { return SCALAR_VPT; }
extern "C" int rmsnorm_combine_warps() { return COMBINE_WARPS; }
extern "C" int rmsnorm_max_ring() { return MAX_RING; }
extern "C" int rmsnorm_ring_bytes() { return RING_BYTES; }

// x, out: (rows, d) contiguous, bf16 if x_bf16 else fp32; scale (d,), bf16
// if s_bf16. The plan: vec, vpt, warps a block, blocks of per consecutive
// rows, ring rows in flight a block. Returns the cudaError_t of the launch.
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* out, int rows, int d,
                                  int x_bf16, int s_bf16, int zero_centered, float eps, int vec,
                                  int vpt, int warps, int blocks, int per, int ring,
                                  void* stream) {
  if (rows <= 0) return 0;
  Kernel fwd, bwd;
  kernels(x_bf16, s_bf16, vec, vpt, &fwd, &bwd);
  const long smem = ring_bytes(vec, ring, 1, vpt, warps);
  if (!fwd || smem < 0 || !plan_ok(rows, d, x_bf16, vec, vpt, warps, blocks, per) ||
      (vec && !(aligned16(x) && aligned16(scale) && aligned16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, scale, nullptr, out, nullptr, rows, d, per, ring, zero_centered != 0, eps};
  fwd<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: (rows, d) contiguous in x's type; scale, dscale (d,) in the
// scale's; part: at least blocks * d floats of scratch. The plan as for the
// forward. Launches the row pass, then the dscale combine, on the stream;
// returns the first cudaError_t.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale, const void* dy, void* dx,
                                  float* part, void* dscale, int rows, int d, int x_bf16,
                                  int s_bf16, int zero_centered, float eps, int vec, int vpt,
                                  int warps, int blocks, int per, int ring, void* stream) {
  if (rows <= 0) return 0;
  Kernel fwd, bwd;
  kernels(x_bf16, s_bf16, vec, vpt, &fwd, &bwd);
  const long smem = ring_bytes(vec, ring, 2, vpt, warps);
  if (!bwd || !part || smem < 0 || !plan_ok(rows, d, x_bf16, vec, vpt, warps, blocks, per) ||
      (vec && !(aligned16(x) && aligned16(scale) && aligned16(dy) && aligned16(dx))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{x, scale, dy, dx, part, rows, d, per, ring, zero_centered != 0, eps};
  bwd<<<blocks, 32 * warps, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = (d + COMBINE_COLS - 1) / COMBINE_COLS;
  if (s_bf16)
    rmsnorm_dscale_kernel<bf16><<<grid, COMBINE_WARPS * 32, 0, st>>>(
        part, static_cast<bf16*>(dscale), blocks, d);
  else
    rmsnorm_dscale_kernel<float><<<grid, COMBINE_WARPS * 32, 0, st>>>(
        part, static_cast<float*>(dscale), blocks, d);
  return static_cast<int>(cudaGetLastError());
}
