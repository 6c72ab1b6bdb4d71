// All-alpha closed-loop rollouts of an in-repo plant in one launch (kernel K2).
//
// Replaces the TPU kernel quattro_tpu/ops/fused_rollout.py::
// fused_feedback_rollouts. For every step size alpha_a at once:
//   u_t = u_ref_t + alpha_a (k_t + K_t (x_t - x_ref_t)),  x_{t+1} = f(x_t, u_t)
// with f the quadrotor or the cart-pole vector field under Euler or RK4
// (plants.cuh). The TPU kernel traces the user's plant into its body; a CUDA
// kernel cannot, so the plants are device functions and the wrapper refuses
// plants it does not know.
//
// What bounds it: H sequential steps per candidate, each a feedback product
// (4 x 12 for the quadrotor) and four evaluations of the vector field (sin,
// cos, tan, a divide) -- a latency chain of a few hundred dependent
// instructions per step. The bytes (about 30 KB of inputs at H=100 in f32)
// and the flops are negligible.
// Design: one thread per candidate, the state in registers, the whole horizon
// inside one launch; the thread's body is rollout_lane.cuh, which the batched
// rollout kernel (K6/K7) shares. All candidates run the same instruction
// stream, so the warp never diverges. No fast-math: tan and 1/cos(pitch) keep
// full accuracy.
// Outputs are written candidate-major, the layout the caller returns.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays, n and m the plant's: x0 (n), x_ref (H+1,n) (first H rows read),
// u_ref (H,m), k (H,m), big_k (H,m,n), alphas (A) -> cand_x (A,H+1,n),
// cand_u (A,H,m). Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "rollout_lane.cuh"

namespace {

template <typename T, typename P>
__global__ void rollout_kernel(int H, int n_alpha, int rk4, P plant, qt::StepSizes<T> h,
                               const T* __restrict__ x0,
                               const T* __restrict__ x_ref,
                               const T* __restrict__ u_ref,
                               const T* __restrict__ k,
                               const T* __restrict__ big_k,
                               const T* __restrict__ alphas,
                               T* __restrict__ cand_x,
                               T* __restrict__ cand_u) {
  const int c = threadIdx.x;
  if (c >= n_alpha) return;
  qt::rollout_lane(plant, rk4, h, H, alphas[c], x0, x_ref, u_ref, k, big_k,
                   cand_x + (size_t)c * (H + 1) * P::N, cand_u + (size_t)c * H * P::M);
}

template <typename T, template <typename> class Plant>
int launch(int H, int n_alpha, int rk4, const double* params, double dt,
           const void* x0, const void* x_ref, const void* u_ref, const void* k,
           const void* big_k, const void* alphas, void* cand_x, void* cand_u,
           cudaStream_t stream) {
  const int threads = ((n_alpha + 31) / 32) * 32;
  rollout_kernel<T, Plant<T>><<<1, threads, 0, stream>>>(
      H, n_alpha, rk4, Plant<T>::from(params), qt::StepSizes<T>::from(dt),
      static_cast<const T*>(x0), static_cast<const T*>(x_ref), static_cast<const T*>(u_ref),
      static_cast<const T*>(k), static_cast<const T*>(big_k),
      static_cast<const T*>(alphas), static_cast<T*>(cand_x),
      static_cast<T*>(cand_u));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. plant: 0 = quadrotor (n=12, m=4; params
// mass, inertia_x, inertia_y, inertia_z, arm, gravity, k_yaw), 1 = cart-pole
// (n=4, m=1; params m_cart, m_pole, length, gravity). rk4: 1 = RK4,
// 0 = forward Euler.
extern "C" int qt_fused_rollout(
    int dtype, int plant, int H, int n_alpha, int rk4, const double* params, double dt,
    const void* x0, const void* x_ref, const void* u_ref, const void* k,
    const void* big_k, const void* alphas, void* cand_x, void* cand_u,
    void* stream) {
  if (H < 0 || n_alpha < 1 || n_alpha > 1024 || dtype < 0 || dtype > 1 || plant < 0 || plant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_LAUNCH(T, Plant) \
  launch<T, Plant>(H, n_alpha, rk4, params, dt, x0, x_ref, u_ref, k, big_k, alphas, cand_x, cand_u, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
