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
// (4 x 12 for the quadrotor) and four evaluations of the vector field (three
// sincos, a tan and a division each) -- a latency chain, not the data (about
// 30 KB of inputs at H=100 in float32).
// Design: the body of rollout_group.cuh, which the batched rollout kernel
// (K6/K7) runs too: one group of G lanes per candidate (G = 4 for the
// quadrotor, the field's transcendental work spread over the lanes; 1 for the
// cart-pole), 32/G candidates per warp, the trajectory's steps staged in
// shared memory by cp.async a chunk ahead of use. A above 32/G spreads over
// several warps, each staging its own copy (up to four warps per CTA). This
// is the batched kernel's launch at B = 1, so a batched candidate equals the
// K2 candidate of its trajectory bit for bit. No fast-math.
// Outputs are written candidate-major, the layout the caller returns.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays, n and m the plant's: x0 (n), x_ref (H,n), u_ref (H,m), k (H,m),
// big_k (H,m,n), alphas (A) -> cand_x (A,H+1,n), cand_u (A,H,m).
// Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "rollout_group.cuh"

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
#define QT_LAUNCH(T, Plant)                                                                                  \
  qt::launch_group_rollouts<T, Plant>(1, H, n_alpha, H, rk4, params, dt, x0, x_ref, u_ref, k, big_k, alphas, \
                                      cand_x, cand_u, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
