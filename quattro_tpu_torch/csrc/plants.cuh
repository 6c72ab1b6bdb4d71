// The in-repo plants, their integrators and their Jacobians, for device and host.
//
// The TPU kernels trace the user's dynamics into their bodies and take the
// Jacobians from jax.jacfwd of the traced step (quattro_tpu/ops/
// fused_solve.py, fused_rollout.py, fused_linquad.py). A CUDA kernel cannot
// trace Python, so the plants the repo ships are written here once, on a
// scalar type S: with S = T they give the vector field and the Euler / RK4
// step, with S = Dual<T> (value and one tangent) the same code gives one
// column of the step's Jacobian [A | B], which is what forward-mode autodiff
// of the step gives. Expressions and their order follow quadrotor_dynamics,
// cartpole_dynamics, euler_step and rk4_step of the Python packages.
//
// Everything is QT_HD: __host__ __device__ under nvcc, plain inline under a
// host compiler, so a CPU test can hold these derivatives against autodiff.
// No fast-math anywhere: tan and 1/cos(pitch) keep full accuracy.

#pragma once

#include <cmath>

#if defined(__CUDACC__)
#define QT_HD __host__ __device__ __forceinline__
#else
#define QT_HD inline
#endif

namespace qt {

QT_HD float sin_t(float v) { return sinf(v); }
QT_HD double sin_t(double v) { return sin(v); }
QT_HD float cos_t(float v) { return cosf(v); }
QT_HD double cos_t(double v) { return cos(v); }
QT_HD float tan_t(float v) { return tanf(v); }
QT_HD double tan_t(double v) { return tan(v); }

// Forward-mode dual number: a value and its derivative along one direction.
template <typename T>
struct Dual {
  T v, d;
};

template <typename T> QT_HD Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T> QT_HD Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T> QT_HD Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T> QT_HD Dual<T> operator*(Dual<T> a, Dual<T> b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
template <typename T> QT_HD Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <typename T> QT_HD Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <typename T> QT_HD Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T> QT_HD Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <typename T> QT_HD Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T> QT_HD Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T> QT_HD Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T> QT_HD Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }
template <typename T> QT_HD Dual<T> sin_t(Dual<T> a) { return {sin_t(a.v), cos_t(a.v) * a.d}; }
template <typename T> QT_HD Dual<T> cos_t(Dual<T> a) { return {cos_t(a.v), -sin_t(a.v) * a.d}; }
template <typename T> QT_HD Dual<T> tan_t(Dual<T> a) {
  const T t = tan_t(a.v);
  return {t, (T(1) + t * t) * a.d};
}

// 12-state quadrotor: x = [p(3), v(3), (roll, pitch, yaw), (p, q, r)],
// u = four rotor thrusts.
template <typename T>
struct Quadrotor {
  static constexpr int N = 12;
  static constexpr int M = 4;
  static constexpr int NP = 7;  // mass, inertia_x, inertia_y, inertia_z, arm, gravity, k_yaw
  T mass, ix, iy, iz, arm, gravity, k_yaw;

  static Quadrotor from(const double* p) {
    return {static_cast<T>(p[0]), static_cast<T>(p[1]), static_cast<T>(p[2]), static_cast<T>(p[3]),
            static_cast<T>(p[4]), static_cast<T>(p[5]), static_cast<T>(p[6])};
  }

  template <typename S>
  QT_HD void field(const S* x, const S* u, S* dx) const {
    const S roll = x[6], pitch = x[7], yaw = x[8];
    const S pr = x[9], qr = x[10], rr = x[11];
    const S thrust = ((u[0] + u[1]) + u[2]) + u[3];
    const S c_roll = cos_t(roll), s_roll = sin_t(roll);
    const S c_pitch = cos_t(pitch), s_pitch = sin_t(pitch);
    const S c_yaw = cos_t(yaw), s_yaw = sin_t(yaw);
    const S tm = thrust / mass;

    dx[0] = x[3];
    dx[1] = x[4];
    dx[2] = x[5];
    dx[3] = tm * (s_yaw * s_roll + c_yaw * s_pitch * c_roll);
    dx[4] = tm * (c_yaw * s_roll - s_yaw * s_pitch * c_roll);
    dx[5] = -gravity + tm * (c_pitch * c_roll);

    const S tan_pitch = tan_t(pitch);
    dx[6] = pr + qr * s_roll * tan_pitch + rr * c_roll * tan_pitch;
    dx[7] = qr * c_roll - rr * s_roll;
    dx[8] = (qr * s_roll + rr * c_roll) / c_pitch;

    const S tau_roll = arm * ((u[1] + u[2]) - (u[0] + u[3]));
    const S tau_pitch = arm * ((u[0] + u[1]) - (u[2] + u[3]));
    const S tau_yaw = k_yaw * (u[0] - u[1] + u[2] - u[3]);
    dx[9] = ((iy - iz) / ix) * qr * rr + tau_roll / ix;
    dx[10] = ((iz - ix) / iy) * pr * rr + tau_pitch / iy;
    dx[11] = ((ix - iy) / iz) * pr * qr + tau_yaw / iz;
  }
};

// Cart-pole: x = [pos, vel, theta, theta_dot] with theta = 0 upright, u = [force].
template <typename T>
struct CartPole {
  static constexpr int N = 4;
  static constexpr int M = 1;
  static constexpr int NP = 4;  // m_cart, m_pole, length, gravity
  T m_cart, m_pole, length, gravity;

  static CartPole from(const double* p) {
    return {static_cast<T>(p[0]), static_cast<T>(p[1]), static_cast<T>(p[2]), static_cast<T>(p[3])};
  }

  template <typename S>
  QT_HD void field(const S* x, const S* u, S* dx) const {
    const S x_dot = x[1], theta = x[2], theta_dot = x[3];
    const S force = u[0];
    const T m_total = m_cart + m_pole;
    const T ml = m_pole * length;
    const S sin_th = sin_t(theta);
    const S cos_th = cos_t(theta);

    const S temp = (force + ml * (theta_dot * theta_dot) * sin_th) / m_total;
    const S theta_ddot = (-gravity * sin_th + cos_th * temp) /
                         (length * (T(4) / T(3) - m_pole * (cos_th * cos_th) / m_total));
    const S x_ddot = temp - ml * theta_ddot * cos_th / m_total;

    dx[0] = x_dot;
    dx[1] = x_ddot;
    dx[2] = theta_dot;
    dx[3] = theta_ddot;
  }
};

// Step sizes of one integration step, rounded once from the double dt.
template <typename T>
struct StepSizes {
  T dt, half_dt, sixth_dt;
  static StepSizes from(double dt) {
    return {static_cast<T>(dt), static_cast<T>(0.5 * dt), static_cast<T>(dt / 6.0)};
  }
};

// x_next = F(x, u): forward Euler, or RK4 with zero-order-hold control, summed
// as x + (dt/6) (((k1 + 2 k2) + 2 k3) + k4). x_next may alias x.
template <typename P, typename T, typename S>
QT_HD void discrete_step(const P& plant, int rk4, const StepSizes<T>& h, const S* x, const S* u, S* x_next) {
  constexpr int N = P::N;
  S k[N];
  plant.field(x, u, k);
  if (!rk4) {
#pragma unroll
    for (int i = 0; i < N; ++i) x_next[i] = x[i] + h.dt * k[i];
    return;
  }
  S acc[N], xt[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = k[i];
    xt[i] = x[i] + h.half_dt * k[i];
  }
  plant.field(xt, u, k);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = acc[i] + T(2) * k[i];
    xt[i] = x[i] + h.half_dt * k[i];
  }
  plant.field(xt, u, k);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = acc[i] + T(2) * k[i];
    xt[i] = x[i] + h.dt * k[i];
  }
  plant.field(xt, u, k);
#pragma unroll
  for (int i = 0; i < N; ++i) x_next[i] = x[i] + h.sixth_dt * (acc[i] + k[i]);
}

// Column d of the step's Jacobian [A | B] at (x, u): d < N differentiates
// along x_d, d >= N along u_{d-N}. col has N entries.
template <typename P, typename T>
QT_HD void discrete_step_jacobian_column(const P& plant, int rk4, const StepSizes<T>& h, const T* x,
                                         const T* u, int d, T* col) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  Dual<T> xd[N], ud[M], xn[N];
  // Seeds are set by comparison, not by indexing with d, so the arrays stay in registers.
#pragma unroll
  for (int i = 0; i < N; ++i) xd[i] = {x[i], i == d ? T(1) : T(0)};
#pragma unroll
  for (int j = 0; j < M; ++j) ud[j] = {u[j], N + j == d ? T(1) : T(0)};
  discrete_step(plant, rk4, h, xd, ud, xn);
#pragma unroll
  for (int i = 0; i < N; ++i) col[i] = xn[i].d;
}

}  // namespace qt
