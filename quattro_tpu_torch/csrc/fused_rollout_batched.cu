// All-alpha closed-loop rollouts of a trajectory batch in one launch
// (kernels K6 and K7).
//
// Replaces the TPU kernels quattro_tpu/ops/fused_rollout.py::
// fused_feedback_rollouts_batched2d (K6: the (alpha, batch) pairs packed on
// sublanes and lanes) and fused_feedback_rollouts_batched (K7: batch on lanes,
// alphas on sublanes). The two compute one function, so they are one kernel
// here: for every step size alpha_a and trajectory b,
//   u_t = u_ref_bt + alpha_a (k_bt + K_bt (x_t - x_ref_bt)),  x_{t+1} = f(x_t, u_t)
// from x0_b, with f the quadrotor or the cart-pole under Euler or RK4
// (plants.cuh). The TPU kernels trace the user's plant; a CUDA kernel cannot,
// so the wrapper refuses plants it does not know.
//
// What bounds it: each rollout is a chain of H steps of a feedback product and
// four vector-field evaluations (sin, cos, tan, a divide), a few hundred
// dependent instructions per step. At A=6, B=2048, H=50 the inputs are about
// 28 MB and the candidates 40 MB (float32): 0.02 ms at the memory rate; the
// time is the chain's latency, hidden by running A*B chains at once.
// Design: one thread per (alpha, trajectory) pair, pairs alpha-major
// (p = a * B + b, the order of the TPU kernels' broadcast), the state in
// registers, the whole horizon inside one launch. The thread's body is
// rollout_lane.cuh, which K2 also runs, so each lane computes bit for bit what
// K2 computes for that trajectory. Each thread reads its own trajectory's
// references and gains, so a warp's loads are not coalesced (neighbouring
// threads are H * m * n elements apart); L1 and L2 serve the A threads that
// share a trajectory. The TPU tiling knobs (tile_s, tile_b, max_resident,
// block_t) sized VMEM tiles and change no result; they have no counterpart.
// No fast-math.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays, n and m the plant's: x0 (B,n), x_ref (B,R,n) with R >= H rows of
// which the first H are read, u_ref (B,H,m), k (B,H,m), big_k (B,H,m,n),
// alphas (A) -> cand_x (A,B,H+1,n), cand_u (A,B,H,m).
// Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "rollout_lane.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) rollout_batched_kernel(
    int B, int H, int n_alpha, int ref_rows, int rk4, P plant, qt::StepSizes<T> h,
    const T* __restrict__ x0, const T* __restrict__ x_ref, const T* __restrict__ u_ref,
    const T* __restrict__ k, const T* __restrict__ big_k, const T* __restrict__ alphas,
    T* __restrict__ cand_x, T* __restrict__ cand_u) {
  constexpr int kN = P::N;
  constexpr int kM = P::M;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)n_alpha * B) return;
  const int a = static_cast<int>(p / B);
  const long long b = p % B;
  qt::rollout_lane(plant, rk4, h, H, alphas[a], x0 + b * kN, x_ref + b * ref_rows * kN,
                   u_ref + b * H * kM, k + b * H * kM, big_k + b * H * kM * kN,
                   cand_x + p * (H + 1) * kN, cand_u + p * H * kM);
}

template <typename T, template <typename> class Plant>
int launch(int B, int H, int n_alpha, int ref_rows, int rk4, const double* params, double dt,
           const void* x0, const void* x_ref, const void* u_ref, const void* k, const void* big_k,
           const void* alphas, void* cand_x, void* cand_u, cudaStream_t stream) {
  const long long pairs = (long long)n_alpha * B;
  const unsigned blocks = static_cast<unsigned>((pairs + kThreads - 1) / kThreads);
  rollout_batched_kernel<T, Plant<T>><<<blocks, kThreads, 0, stream>>>(
      B, H, n_alpha, ref_rows, rk4, Plant<T>::from(params), qt::StepSizes<T>::from(dt),
      static_cast<const T*>(x0), static_cast<const T*>(x_ref), static_cast<const T*>(u_ref),
      static_cast<const T*>(k), static_cast<const T*>(big_k), static_cast<const T*>(alphas),
      static_cast<T*>(cand_x), static_cast<T*>(cand_u));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. plant and params as in qt_fused_rollout
// (0 = quadrotor, 1 = cart-pole). rk4: 1 = RK4, 0 = forward Euler.
extern "C" int qt_fused_rollout_batched(int dtype, int plant, int B, int H, int n_alpha, int ref_rows,
                                        int rk4, const double* params, double dt, const void* x0,
                                        const void* x_ref, const void* u_ref, const void* k,
                                        const void* big_k, const void* alphas, void* cand_x,
                                        void* cand_u, void* stream) {
  if (B < 1 || H < 0 || n_alpha < 1 || ref_rows < H || dtype < 0 || dtype > 1 || plant < 0 || plant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_LAUNCH(T, Plant)                                                                       \
  launch<T, Plant>(B, H, n_alpha, ref_rows, rk4, params, dt, x0, x_ref, u_ref, k, big_k, alphas, \
                   cand_x, cand_u, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
