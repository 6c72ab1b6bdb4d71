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
// plant (plants.cuh: a Jacobian column is the step on Dual<T>, value and one
// tangent, as forward-mode autodiff computes it) and the cost family
// (costs.cuh: quadratic + softplus^2 barrier, analytic expansion) are device
// functions, and the wrapper refuses plants and costs without device code.
//
// What bounds it: every point is independent. At B=2048, H=50 (quadrotor,
// float32) the outputs are 170 MB (0.05 ms at the memory rate) and the work
// about 1.4 GFLOP, mostly dual-number RK4 (0.02 ms at the float32 rate), so
// the bytes bound it if the warps' writes coalesce.
// Design: one thread per (point, task), task d < n a column of A, n <= d <
// n + m a column of B, d = n + m the cost expansion; consecutive threads are
// consecutive trajectories of one (time step, task), so each warp writes 32
// neighbouring elements of every entry it produces. No fast-math.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays, n and m the plant's: x_seq (B,H+1,n) (the first H states read),
// u_seq (B,H,m), q (n,n), r (m,m), x_ref (n); out = host array of 7 device
// pointers a, b, l_xx, l_uu, l_ux, l_x, l_u, each (B / chunk * h_pad,
// entries, chunk). Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "costs.cuh"
#include "plants.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 7;

template <typename T>
struct LinquadArgs {
  int B, H, h_pad, chunk, rk4;
  qt::StepSizes<T> h;
  T barrier_alpha, barrier_beta;
  const T *x_seq, *u_seq, *q, *r, *x_ref;
  T* out[kStages];  // a, b, l_xx, l_uu, l_ux, l_x, l_u
};

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) linquad_kernel(LinquadArgs<T> g, P plant) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  constexpr int kTasks = N + M + 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)g.B / g.chunk * g.h_pad * kTasks * g.chunk;
  if (idx >= total) return;
  const int lane = static_cast<int>(idx % g.chunk);
  long long rest = idx / g.chunk;
  const int d = static_cast<int>(rest % kTasks);
  rest /= kTasks;
  const int t_pad = static_cast<int>(rest % g.h_pad);
  const long long blk = rest / g.h_pad;
  const long long b = blk * g.chunk + lane;
  const int t = t_pad - (g.h_pad - g.H);  // < 0: a pad step
  const long long row = blk * g.h_pad + t_pad;
  // Element e of packed tensor q at this point.
  auto at = [&](int q, int entries, int e) -> T& { return g.out[q][(row * entries + e) * g.chunk + lane]; };

  T x[N], u[M];
  if (t >= 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = g.x_seq[(b * (g.H + 1) + t) * N + i];
#pragma unroll
    for (int j = 0; j < M; ++j) u[j] = g.u_seq[(b * g.H + t) * M + j];
  }

  if (d < N + M) {  // column d of [A | B]
    T col[N];
    if (t >= 0) {
      qt::discrete_step_jacobian_column(plant, g.rk4, g.h, x, u, d, col);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) col[i] = (i == d) ? T(1) : T(0);
    }
    if (d < N) {
#pragma unroll
      for (int i = 0; i < N; ++i) at(0, N * N, i * N + d) = col[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) at(1, N * M, i * M + (d - N)) = col[i];
    }
    return;
  }

  // The running cost's expansion.
  T lx[N], lu[M], lxx[N * N], luu[M * M], lux[M * N];
  if (t >= 0) {
    qt::running_cost_expansion<N, M>(g.q, g.r, g.x_ref, g.barrier_alpha, g.barrier_beta, x, u, lx, lu,
                                     lxx, luu, lux);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) lx[i] = T(0);
#pragma unroll
    for (int i = 0; i < N * N; ++i) lxx[i] = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j) lu[j] = T(0);
#pragma unroll
    for (int i = 0; i < M * M; ++i) luu[i] = (i / M == i % M) ? T(1) : T(0);
#pragma unroll
    for (int i = 0; i < M * N; ++i) lux[i] = T(0);
  }
#pragma unroll
  for (int i = 0; i < N * N; ++i) at(2, N * N, i) = lxx[i];
#pragma unroll
  for (int i = 0; i < M * M; ++i) at(3, M * M, i) = luu[i];
#pragma unroll
  for (int i = 0; i < M * N; ++i) at(4, M * N, i) = lux[i];
#pragma unroll
  for (int i = 0; i < N; ++i) at(5, N, i) = lx[i];
#pragma unroll
  for (int j = 0; j < M; ++j) at(6, M, j) = lu[j];
}

template <typename T, template <typename> class Plant>
int launch(int B, int H, int h_pad, int chunk, int rk4, const double* params, double dt,
           double barrier_alpha, double barrier_beta, const void* x_seq, const void* u_seq,
           const void* q, const void* r, const void* x_ref, void* const* out, cudaStream_t stream) {
  LinquadArgs<T> g;
  g.B = B;
  g.H = H;
  g.h_pad = h_pad;
  g.chunk = chunk;
  g.rk4 = rk4;
  g.h = qt::StepSizes<T>::from(dt);
  g.barrier_alpha = static_cast<T>(barrier_alpha);
  g.barrier_beta = static_cast<T>(barrier_beta);
  g.x_seq = static_cast<const T*>(x_seq);
  g.u_seq = static_cast<const T*>(u_seq);
  g.q = static_cast<const T*>(q);
  g.r = static_cast<const T*>(r);
  g.x_ref = static_cast<const T*>(x_ref);
  for (int i = 0; i < kStages; ++i) g.out[i] = static_cast<T*>(out[i]);
  constexpr int kTasks = Plant<T>::N + Plant<T>::M + 1;
  const long long total = (long long)B * h_pad * kTasks;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  linquad_kernel<T, Plant<T>><<<blocks, kThreads, 0, stream>>>(g, Plant<T>::from(params));
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
  if (B < 1 || H < 0 || chunk < 1 || B % chunk || h_pad < H || dtype < 0 || dtype > 1 || plant < 0 ||
      plant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_LAUNCH(T, Plant)                                                                       \
  launch<T, Plant>(B, H, h_pad, chunk, rk4, params, dt, barrier_alpha, barrier_beta, x_seq, u_seq, \
                   q, r, x_ref, out, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
