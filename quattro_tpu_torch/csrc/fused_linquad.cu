// Linearize + quadratize a trajectory batch in one launch (kernel K5).
//
// Replaces the TPU kernel quattro_tpu/ops/fused_linquad.py::
// linquad_batched_fused. At every point (b, t) of a (B, H) trajectory batch
// it evaluates the stage derivatives
//   A = df/dx, B = df/du of the plant's discrete step (Euler or RK4),
//   l_x, l_u, l_xx, l_uu, l_ux of the running cost,
// and writes them straight into the packed stage layout that the batched
// backward pass (K4) reads: per tensor (nb * h_pad, entries, tile_s * 128),
// axis 0 batch block then (padded) time, axis 1 the row-major matrix entry,
// the last the in-block trajectory (b = blk * chunk + lane, chunk =
// tile_s * 128). The h_pad - H pad steps come first in each block and hold
// the identity stage (A = I, B = 0, l_uu = I, the rest 0), which leaves the
// backward recursion's carry unchanged. So K5 -> K4 crosses device memory once
// with no repack, and the layout is element for element the TPU kernel's.
//
// The TPU kernel traces jax.jacfwd of the user's dynamics and grad /
// forward-over-reverse Hessians of the user's cost into its body; here the
// plant (plants.cuh) and the cost family (costs.cuh: quadratic +
// softplus^2 barrier, analytic expansion) are device functions, and the
// wrapper refuses plants and costs without device code.
//
// What bounds it: every point is independent. At B=2048, H=50 (quadrotor,
// float32) the outputs are 170 MB (0.05 ms at the memory rate; a kernel that
// only stores the identity stage everywhere takes 0.06 ms) and the
// arithmetic, once the step's value is computed once per point, well under
// that at the float32 rate. Design:
//   - One thread per point. A CTA covers 32 neighbouring trajectories of one
//     packed block (a warp's lanes) and kSteps consecutive steps (one warp
//     each); every warp writes 32 neighbouring elements of each entry it
//     stores, and every warp stores the same 416 entries per lane (A, B and
//     the 224 of the cost expansion), so the stores are coalesced and
//     balanced across warps.
//   - The CTA's x and u rows, and the cost tables, are staged once into
//     shared memory by cp.async (each trajectory's rows are contiguous over t:
//     16-byte pieces where aligned), then read from there.
//   - The step's value is computed once per point (discrete_step_points:
//     each field evaluation's trig, tan, 1/cos(pitch) and quotients kept in
//     registers); each of the N + M Jacobian columns is then tangent-only
//     arithmetic on those values (discrete_step_tangent_column), where the
//     dual-number step had evaluated the value again for every column.
//   - l_xx and the quadratic parts of l_uu are the symmetrized tables,
//     formed once per CTA in shared memory; l_ux is zero.
// No fast-math: tan and 1/cos(pitch) keep full accuracy.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays, n and m the plant's: x_seq (B,H+1,n) (the first H states read),
// u_seq (B,H,m), q (n,n), r (m,m), x_ref (n); out = host array of 7 device
// pointers a, b, l_xx, l_uu, l_ux, l_x, l_u, each (B / chunk * h_pad,
// entries, chunk). Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "costs.cuh"
#include "plants.cuh"
#include "tile_copy.cuh"

namespace {

constexpr int kSteps = 4;  // steps per CTA, one warp each
constexpr int kThreads = 32 * kSteps;
constexpr int kStages = 7;

template <typename T>
struct LinquadArgs {
  int B, H, h_pad, chunk, rk4;
  int x_piece, u_piece;  // bytes per cp.async of the x and u rows (16, 8 or the element)
  qt::StepSizes<T> h;
  T barrier_alpha, barrier_beta;
  const T *x_seq, *u_seq, *q, *r, *x_ref;
  T* out[kStages];  // a, b, l_xx, l_uu, l_ux, l_x, l_u
};

// cp.async of `rows` consecutive rows of `width` values from src into dst,
// for each of the CTA's 32 trajectories (src advancing by src_stride values,
// dst by dst_stride), in pieces of `piece` bytes spread over the CTA.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_stride, const T* src, long long src_stride, int rows,
                                           int width, int piece) {
  const int per_traj = rows * width * static_cast<int>(sizeof(T)) / piece;
  for (int i = threadIdx.x; i < 32 * per_traj; i += kThreads) {
    const int traj = i / per_traj, part = i - traj * per_traj;
    qt::copy_async_bytes(piece, reinterpret_cast<unsigned char*>(dst + traj * dst_stride) + part * piece,
               reinterpret_cast<const unsigned char*>(src + traj * src_stride) + part * piece);
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) linquad_kernel(LinquadArgs<T> g, P plant) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  // Row strides of the staged tiles: kSteps rows per trajectory in whole
  // 16-byte pieces, plus one piece so that the lanes' rows spread over banks.
  constexpr int XS = ((kSteps * N * sizeof(T) + 15) / 16 * 16 + 16) / sizeof(T);
  constexpr int US = ((kSteps * M * sizeof(T) + 15) / 16 * 16 + 16) / sizeof(T);
  __shared__ __align__(16) T xs[32 * XS];
  __shared__ __align__(16) T us[32 * US];
  __shared__ T lxx_tab[N * N], luu_tab[M * M], xref_tab[N];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step_tiles = (g.h_pad + kSteps - 1) / kSteps, groups = g.chunk / 32;
  const int tile_t = blockIdx.x % step_tiles;
  const long long rest = blockIdx.x / step_tiles;
  const int group = static_cast<int>(rest % groups);
  const long long blk = rest / groups;
  const int t_pad0 = tile_t * kSteps, t_pad = t_pad0 + warp;
  const int pad = g.h_pad - g.H;  // pad steps lead each block
  const int in_block = group * 32 + lane;
  const long long b0 = blk * g.chunk + group * 32;

  // Stage the real steps' rows t_lo .. t_hi - 1 of the CTA's trajectories, at
  // row t + pad - t_pad0 of each trajectory's tile, and the cost tables.
  const int t_lo = max(t_pad0 - pad, 0), t_hi = min(t_pad0 + kSteps - pad, g.H);
  if (t_hi > t_lo) {
    const int w_lo = t_lo + pad - t_pad0;
    stage_rows(xs + w_lo * N, XS, g.x_seq + (b0 * (g.H + 1) + t_lo) * N, (long long)(g.H + 1) * N, t_hi - t_lo, N,
               g.x_piece);
    stage_rows(us + w_lo * M, US, g.u_seq + (b0 * g.H + t_lo) * M, (long long)g.H * M, t_hi - t_lo, M, g.u_piece);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < N * N; i += kThreads) lxx_tab[i] = g.q[i] + g.q[(i % N) * N + i / N];
  for (int i = threadIdx.x; i < M * M; i += kThreads) luu_tab[i] = g.r[i] + g.r[(i % M) * M + i / M];
  for (int i = threadIdx.x; i < N; i += kThreads) xref_tab[i] = g.x_ref[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (t_pad >= g.h_pad) return;

  const int t = t_pad - pad;  // < 0: a pad step
  const long long row = blk * g.h_pad + t_pad;
  // Element e of packed tensor q at this point.
  auto at = [&](int q, int entries, int e) -> T& { return g.out[q][(row * entries + e) * g.chunk + in_block]; };

  if (t < 0) {
#pragma unroll 4
    for (int e = 0; e < N * N; ++e) at(0, N * N, e) = e / N == e % N ? T(1) : T(0);
#pragma unroll 4
    for (int e = 0; e < N * M; ++e) at(1, N * M, e) = T(0);
#pragma unroll 4
    for (int e = 0; e < N * N; ++e) at(2, N * N, e) = T(0);
#pragma unroll
    for (int e = 0; e < M * M; ++e) at(3, M * M, e) = e / M == e % M ? T(1) : T(0);
#pragma unroll 4
    for (int e = 0; e < M * N; ++e) at(4, M * N, e) = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) at(5, N, i) = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j) at(6, M, j) = T(0);
    return;
  }

  T x[N], u[M];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xs[lane * XS + warp * N + i];
#pragma unroll
  for (int j = 0; j < M; ++j) u[j] = us[lane * US + warp * M + j];

  // The running cost's expansion (costs.cuh's law: l_x = (Q + Q') dx,
  // l_u = (R + R') u plus the barrier's gradient, l_uu plus its diagonal).
  {
    T dx[N];
#pragma unroll
    for (int i = 0; i < N; ++i) dx[i] = x[i] - xref_tab[i];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) acc += lxx_tab[i * N + j] * dx[j];
      at(5, N, i) = acc;
    }
#pragma unroll 4
    for (int e = 0; e < N * N; ++e) at(2, N * N, e) = lxx_tab[e];
#pragma unroll 4
    for (int e = 0; e < M * N; ++e) at(4, M * N, e) = T(0);
    T lu[M], barrier_uu[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc += luu_tab[i * M + j] * u[j];
      lu[i] = acc;
      barrier_uu[i] = T(0);
    }
    if (g.barrier_alpha > T(0)) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        T grad;
        qt::barrier_derivatives(u[j], g.barrier_alpha, g.barrier_beta, &grad, &barrier_uu[j]);
        lu[j] += grad;
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) at(6, M, j) = lu[j];
#pragma unroll
    for (int e = 0; e < M * M; ++e) {
      const T v = luu_tab[e];
      at(3, M * M, e) = e / M == e % M ? v + barrier_uu[e / M] : v;
    }
  }

  // [A | B]: the step's value once, then each column tangent-only.
  typename qt::PointOf<P>::type pts[4];
  qt::discrete_step_points(plant, g.rk4, g.h, x, u, pts);
#pragma unroll 1
  for (int d = 0; d < N + M; ++d) {
    T col[N];
    qt::discrete_step_tangent_column(plant, g.rk4, g.h, pts, d, col);
    if (d < N) {
#pragma unroll
      for (int i = 0; i < N; ++i) at(0, N * N, i * N + d) = col[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) at(1, N * M, i * M + (d - N)) = col[i];
    }
  }
}

// The widest cp.async piece (16, 8 bytes, else the element) on which every
// staged row run starts and ends: rows of `row_bytes` from `base`.
int piece_for(const void* base, long long row_bytes, int element) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(base);
  for (int g = 16; g > element; g /= 2)
    if (at % g == 0 && row_bytes % g == 0) return g;
  return element;
}

template <typename T, template <typename> class Plant>
int launch(int B, int H, int h_pad, int chunk, int rk4, const double* params, double dt,
           double barrier_alpha, double barrier_beta, const void* x_seq, const void* u_seq,
           const void* q, const void* r, const void* x_ref, void* const* out, cudaStream_t stream) {
  constexpr int N = Plant<T>::N;
  constexpr int M = Plant<T>::M;
  LinquadArgs<T> g;
  g.B = B;
  g.H = H;
  g.h_pad = h_pad;
  g.chunk = chunk;
  g.rk4 = rk4;
  g.x_piece = piece_for(x_seq, N * (long long)sizeof(T), sizeof(T));
  g.u_piece = piece_for(u_seq, M * (long long)sizeof(T), sizeof(T));
  g.h = qt::StepSizes<T>::from(dt);
  g.barrier_alpha = static_cast<T>(barrier_alpha);
  g.barrier_beta = static_cast<T>(barrier_beta);
  g.x_seq = static_cast<const T*>(x_seq);
  g.u_seq = static_cast<const T*>(u_seq);
  g.q = static_cast<const T*>(q);
  g.r = static_cast<const T*>(r);
  g.x_ref = static_cast<const T*>(x_ref);
  for (int i = 0; i < kStages; ++i) g.out[i] = static_cast<T*>(out[i]);
  const long long blocks = (long long)B / 32 * ((h_pad + kSteps - 1) / kSteps);
  if (blocks == 0) return 0;
  linquad_kernel<T, Plant<T>><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g, Plant<T>::from(params));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. plant and params as in qt_fused_rollout
// (0 = quadrotor, 1 = cart-pole). rk4: 1 = RK4, 0 = forward Euler. B must be a
// multiple of chunk (tile_s * 128) and h_pad >= H.
extern "C" int qt_fused_linquad(int dtype, int plant, int B, int H, int h_pad, int chunk, int rk4,
                                const double* params, double dt, double barrier_alpha,
                                double barrier_beta, const void* x_seq, const void* u_seq,
                                const void* q, const void* r, const void* x_ref, void* const* out,
                                void* stream) {
  if (B < 1 || H < 0 || chunk < 1 || chunk % 32 || B % chunk || h_pad < H || dtype < 0 || dtype > 1 ||
      plant < 0 || plant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_LAUNCH(T, Plant)                                                                       \
  launch<T, Plant>(B, H, h_pad, chunk, rk4, params, dt, barrier_alpha, barrier_beta, x_seq, u_seq, \
                   q, r, x_ref, out, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
