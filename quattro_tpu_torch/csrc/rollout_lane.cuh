// One closed-loop rollout of an in-repo plant, the per-thread body shared by
// the all-alpha rollout kernels (fused_rollout_single.cu, K2, and
// fused_rollout_batched.cu, K6/K7), so that each lane of the batched kernel
// computes exactly what K2 computes for that trajectory:
//   u_t = u_ref_t + alpha (k_t + K_t (x_t - x_ref_t)),  x_{t+1} = f(x_t, u_t)
// with f the plant's Euler or RK4 step (plants.cuh). The state stays in
// registers; x_out (H+1, n) and u_out (H, m) receive the candidate.

#pragma once

#include "plants.cuh"

namespace qt {

template <typename T, typename P>
__device__ __forceinline__ void rollout_lane(const P& plant, int rk4, const StepSizes<T>& h, int H, T alpha,
                                             const T* x0, const T* x_ref, const T* u_ref, const T* k,
                                             const T* big_k, T* x_out, T* u_out) {
  constexpr int kN = P::N;
  constexpr int kM = P::M;
  T x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    x[i] = x0[i];
    x_out[i] = x[i];
  }

  for (int t = 0; t < H; ++t) {
    T dxr[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) dxr[i] = x[i] - x_ref[(size_t)t * kN + i];
    T u[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      const T* kr = big_k + ((size_t)t * kM + j) * kN;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < kN; ++i) acc += dxr[i] * kr[i];
      u[j] = u_ref[(size_t)t * kM + j] + alpha * (k[(size_t)t * kM + j] + acc);
      u_out[(size_t)t * kM + j] = u[j];
    }
    discrete_step(plant, rk4, h, x, u, x);
#pragma unroll
    for (int i = 0; i < kN; ++i) x_out[(size_t)(t + 1) * kN + i] = x[i];
  }
}

}  // namespace qt
