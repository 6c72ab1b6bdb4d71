// All-alpha closed-loop rollouts of the quadrotor in one launch (kernel K2).
//
// Replaces the TPU kernel quattro_tpu/ops/fused_rollout.py::
// fused_feedback_rollouts. For every step size alpha_a at once:
//   u_t = u_ref_t + alpha_a (k_t + K_t (x_t - x_ref_t)),  x_{t+1} = f(x_t, u_t)
// with f the quadrotor vector field (quattro_tpu/systems/quadrotor.py) under
// Euler or RK4 (quattro_tpu/systems/integrators.py). The TPU kernel traces the
// user's plant into its body; a CUDA kernel cannot, so the plant is written
// here as a device function and the wrapper refuses plants it does not know.
//
// What bounds it: H sequential steps per candidate, each a 4 x 12 feedback
// product and four evaluations of the vector field (sin, cos, tan, a divide)
// -- a latency chain of a few hundred dependent instructions per step. The
// bytes (about 30 KB of inputs at H=100 in f32) and the flops are negligible.
// Design: one thread per candidate, the state in registers, the whole horizon
// inside one launch. All candidates run the same instruction stream, so the
// warp never diverges. No fast-math: tan and 1/cos(pitch) keep full accuracy.
// Outputs are written candidate-major, the layout the caller returns.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays: x0 (12), x_ref (H+1,12) (first H rows read), u_ref (H,4), k (H,4),
// big_k (H,4,12), alphas (A) -> cand_x (A,H+1,12), cand_u (A,H,4).
// Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 12;
constexpr int kM = 4;

template <typename T>
struct QuadParams {
  T mass, ix, iy, iz, arm, gravity, k_yaw;
};

__device__ __forceinline__ float sin_t(float v) { return sinf(v); }
__device__ __forceinline__ double sin_t(double v) { return sin(v); }
__device__ __forceinline__ float cos_t(float v) { return cosf(v); }
__device__ __forceinline__ double cos_t(double v) { return cos(v); }
__device__ __forceinline__ float tan_t(float v) { return tanf(v); }
__device__ __forceinline__ double tan_t(double v) { return tan(v); }

// Continuous-time quadrotor state derivative; same expressions and order as
// quadrotor_dynamics in the Python packages.
template <typename T>
__device__ __forceinline__ void quad_field(const T* x, const T* u,
                                           const QuadParams<T>& p, T* dx) {
  const T roll = x[6], pitch = x[7], yaw = x[8];
  const T pr = x[9], qr = x[10], rr = x[11];
  const T thrust = ((u[0] + u[1]) + u[2]) + u[3];
  const T c_roll = cos_t(roll), s_roll = sin_t(roll);
  const T c_pitch = cos_t(pitch), s_pitch = sin_t(pitch);
  const T c_yaw = cos_t(yaw), s_yaw = sin_t(yaw);
  const T tm = thrust / p.mass;

  dx[0] = x[3];
  dx[1] = x[4];
  dx[2] = x[5];
  dx[3] = tm * (s_yaw * s_roll + c_yaw * s_pitch * c_roll);
  dx[4] = tm * (c_yaw * s_roll - s_yaw * s_pitch * c_roll);
  dx[5] = -p.gravity + tm * (c_pitch * c_roll);

  const T tan_pitch = tan_t(pitch);
  dx[6] = pr + qr * s_roll * tan_pitch + rr * c_roll * tan_pitch;
  dx[7] = qr * c_roll - rr * s_roll;
  dx[8] = (qr * s_roll + rr * c_roll) / c_pitch;

  const T tau_roll = p.arm * ((u[1] + u[2]) - (u[0] + u[3]));
  const T tau_pitch = p.arm * ((u[0] + u[1]) - (u[2] + u[3]));
  const T tau_yaw = p.k_yaw * (u[0] - u[1] + u[2] - u[3]);
  dx[9] = ((p.iy - p.iz) / p.ix) * qr * rr + tau_roll / p.ix;
  dx[10] = ((p.iz - p.ix) / p.iy) * pr * rr + tau_pitch / p.iy;
  dx[11] = ((p.ix - p.iy) / p.iz) * pr * qr + tau_yaw / p.iz;
}

template <typename T>
__global__ void rollout_kernel(int H, int n_alpha, int rk4, QuadParams<T> p,
                               T dt, T half_dt, T sixth_dt,
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
  const T alpha = alphas[c];
  T* xo = cand_x + (size_t)c * (H + 1) * kN;
  T* uo = cand_u + (size_t)c * H * kM;

  T x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    x[i] = x0[i];
    xo[i] = x[i];
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
      uo[(size_t)t * kM + j] = u[j];
    }

    T k1[kN];
    quad_field(x, u, p, k1);
    if (rk4) {
      T xt[kN], k2[kN], k3[kN], k4[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) xt[i] = x[i] + half_dt * k1[i];
      quad_field(xt, u, p, k2);
#pragma unroll
      for (int i = 0; i < kN; ++i) xt[i] = x[i] + half_dt * k2[i];
      quad_field(xt, u, p, k3);
#pragma unroll
      for (int i = 0; i < kN; ++i) xt[i] = x[i] + dt * k3[i];
      quad_field(xt, u, p, k4);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        x[i] = x[i] + sixth_dt * (((k1[i] + T(2) * k2[i]) + T(2) * k3[i]) + k4[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) x[i] = x[i] + dt * k1[i];
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) xo[(size_t)(t + 1) * kN + i] = x[i];
  }
}

template <typename T>
int launch(int H, int n_alpha, int rk4, const double* params, double dt,
           const void* x0, const void* x_ref, const void* u_ref, const void* k,
           const void* big_k, const void* alphas, void* cand_x, void* cand_u,
           cudaStream_t stream) {
  QuadParams<T> p{static_cast<T>(params[0]), static_cast<T>(params[1]),
                  static_cast<T>(params[2]), static_cast<T>(params[3]),
                  static_cast<T>(params[4]), static_cast<T>(params[5]),
                  static_cast<T>(params[6])};
  const int threads = ((n_alpha + 31) / 32) * 32;
  rollout_kernel<T><<<1, threads, 0, stream>>>(
      H, n_alpha, rk4, p, static_cast<T>(dt), static_cast<T>(0.5 * dt),
      static_cast<T>(dt / 6.0), static_cast<const T*>(x0),
      static_cast<const T*>(x_ref), static_cast<const T*>(u_ref),
      static_cast<const T*>(k), static_cast<const T*>(big_k),
      static_cast<const T*>(alphas), static_cast<T*>(cand_x),
      static_cast<T*>(cand_u));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. rk4: 1 = RK4, 0 = forward Euler.
// params: mass, inertia_x, inertia_y, inertia_z, arm, gravity, k_yaw.
extern "C" int qt_fused_rollout_quadrotor(
    int dtype, int H, int n_alpha, int rk4, const double* params, double dt,
    const void* x0, const void* x_ref, const void* u_ref, const void* k,
    const void* big_k, const void* alphas, void* cand_x, void* cand_u,
    void* stream) {
  if (H < 0 || n_alpha < 1 || n_alpha > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(H, n_alpha, rk4, params, dt, x0, x_ref, u_ref, k,
                         big_k, alphas, cand_x, cand_u, s);
  if (dtype == 1)
    return launch<double>(H, n_alpha, rk4, params, dt, x0, x_ref, u_ref, k,
                          big_k, alphas, cand_x, cand_u, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
