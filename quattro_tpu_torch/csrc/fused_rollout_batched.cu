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
// four vector-field evaluations (sincos, tan, a division), a latency chain.
// At A=6, B=2048, H=50 the inputs are about 28 MB and the candidates 40 MB
// (float32): 0.02 ms at the memory rate; the time is the chains, hidden by
// running many at once.
// Design: the body of rollout_group.cuh, which K2 runs too, so each candidate
// computes bit for bit what K2 computes for that trajectory. One warp per
// trajectory (per 32/G candidates of it: 8 quadrotor candidates, one group of
// G = 4 lanes each), so B=2048 fills about 15 warps per SM; the warp reads its
// trajectory's x_ref, u_ref, k and K once, as coalesced cp.async copies into
// its own two chunk slots in shared memory, which all its candidates read.
// Outputs keep the (A, B, H+1, n) and (A, B, H, m) layouts. The TPU tiling
// knobs (tile_s, tile_b, max_resident, block_t) sized VMEM tiles and change no
// result; they have no counterpart. No fast-math.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays, n and m the plant's: x0 (B,n), x_ref (B,R,n) with R >= H rows of
// which the first H are read, u_ref (B,H,m), k (B,H,m), big_k (B,H,m,n),
// alphas (A) -> cand_x (A,B,H+1,n), cand_u (A,B,H,m).
// Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "rollout_group.cuh"

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
#define QT_LAUNCH(T, Plant)                                                                                   \
  qt::launch_group_rollouts<T, Plant>(B, H, n_alpha, ref_rows, rk4, params, dt, x0, x_ref, u_ref, k, big_k, \
                                      alphas, cand_x, cand_u, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
