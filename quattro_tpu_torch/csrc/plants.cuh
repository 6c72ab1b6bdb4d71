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

// ---------------------------------------------------------------------------
// The Jacobian of the step as one value pass plus tangent-only columns (K5).
//
// discrete_step_jacobian_column runs the whole step on Dual<T> for every
// column, so the value part (the trig, tan and the quotients of four field
// evaluations) is computed N + M times per point. Here discrete_step_points
// runs the step once on T and keeps, for each field evaluation, the values
// its derivative needs (a *Point); discrete_step_tangent_column then carries
// one tangent through the same integrator with field_tangent, which is the
// derivative part of the dual-number field written on those saved values:
// no trig, and 1/cos(pitch) (the quadrotor) and 1/den (the cart-pole) taken
// once per evaluation. Constant quotients of the plant's parameters are
// loop-invariant, so a caller's loop over columns takes them once. The
// rounding may differ from the dual form's by the order of a few operations;
// csrc/host_derivatives.cpp lets a CPU test hold it against jax.jacfwd.

template <typename T>
struct QuadrotorPoint {
  T tm, sr, cr, sp, cp, sy, cy, tp, inv_cp, f8, pr, qr, rr;
};

template <typename T>
struct CartPolePoint {
  T s, c, thd, temp, den, thdd;
};

template <typename P>
struct PointOf;
template <typename T>
struct PointOf<Quadrotor<T>> {
  using type = QuadrotorPoint<T>;
};
template <typename T>
struct PointOf<CartPole<T>> {
  using type = CartPolePoint<T>;
};

// The quadrotor's field at (x, u) (Quadrotor::field's expressions), keeping pt.
template <typename T>
QT_HD void field_point(const Quadrotor<T>& q, const T* x, const T* u, T* dx, QuadrotorPoint<T>& pt) {
  const T roll = x[6], pitch = x[7], yaw = x[8];
  pt.pr = x[9], pt.qr = x[10], pt.rr = x[11];
  const T thrust = ((u[0] + u[1]) + u[2]) + u[3];
  pt.cr = cos_t(roll), pt.sr = sin_t(roll);
  pt.cp = cos_t(pitch), pt.sp = sin_t(pitch);
  pt.cy = cos_t(yaw), pt.sy = sin_t(yaw);
  pt.tm = thrust / q.mass;
  dx[0] = x[3];
  dx[1] = x[4];
  dx[2] = x[5];
  dx[3] = pt.tm * (pt.sy * pt.sr + pt.cy * pt.sp * pt.cr);
  dx[4] = pt.tm * (pt.cy * pt.sr - pt.sy * pt.sp * pt.cr);
  dx[5] = -q.gravity + pt.tm * (pt.cp * pt.cr);
  pt.tp = tan_t(pitch);
  dx[6] = pt.pr + pt.qr * pt.sr * pt.tp + pt.rr * pt.cr * pt.tp;
  dx[7] = pt.qr * pt.cr - pt.rr * pt.sr;
  pt.f8 = (pt.qr * pt.sr + pt.rr * pt.cr) / pt.cp;
  pt.inv_cp = T(1) / pt.cp;
  dx[8] = pt.f8;
  const T tau_roll = q.arm * ((u[1] + u[2]) - (u[0] + u[3]));
  const T tau_pitch = q.arm * ((u[0] + u[1]) - (u[2] + u[3]));
  const T tau_yaw = q.k_yaw * (u[0] - u[1] + u[2] - u[3]);
  dx[9] = ((q.iy - q.iz) / q.ix) * pt.qr * pt.rr + tau_roll / q.ix;
  dx[10] = ((q.iz - q.ix) / q.iy) * pt.pr * pt.rr + tau_pitch / q.iy;
  dx[11] = ((q.ix - q.iy) / q.iz) * pt.pr * pt.qr + tau_yaw / q.iz;
}

// d field at the point pt along (tx, tu).
template <typename T>
QT_HD void field_tangent(const Quadrotor<T>& q, const QuadrotorPoint<T>& p, const T* tx, const T* tu, T* out) {
  const T dro = tx[6], dpi = tx[7], dya = tx[8], dpr = tx[9], dqr = tx[10], drr = tx[11];
  const T dtm = (((tu[0] + tu[1]) + tu[2]) + tu[3]) * (T(1) / q.mass);
  const T dcr = -p.sr * dro, dsr = p.cr * dro;
  const T dcp = -p.sp * dpi, dsp = p.cp * dpi;
  const T dcy = -p.sy * dya, dsy = p.cy * dya;
  out[0] = tx[3];
  out[1] = tx[4];
  out[2] = tx[5];
  const T cysp = p.cy * p.sp, sysp = p.sy * p.sp;
  const T dcysp = dcy * p.sp + p.cy * dsp, dsysp = dsy * p.sp + p.sy * dsp;
  const T e3 = p.sy * p.sr + cysp * p.cr, e4 = p.cy * p.sr - sysp * p.cr, e5 = p.cp * p.cr;
  out[3] = dtm * e3 + p.tm * ((dsy * p.sr + p.sy * dsr) + (dcysp * p.cr + cysp * dcr));
  out[4] = dtm * e4 + p.tm * ((dcy * p.sr + p.cy * dsr) - (dsysp * p.cr + sysp * dcr));
  out[5] = dtm * e5 + p.tm * (dcp * p.cr + p.cp * dcr);
  const T dtp = (T(1) + p.tp * p.tp) * dpi;
  const T qs = p.qr * p.sr, rc = p.rr * p.cr;
  const T dqs = dqr * p.sr + p.qr * dsr, drc = drr * p.cr + p.rr * dcr;
  out[6] = dpr + (dqs * p.tp + qs * dtp) + (drc * p.tp + rc * dtp);
  out[7] = (dqr * p.cr + p.qr * dcr) - (drr * p.sr + p.rr * dsr);
  out[8] = ((dqs + drc) - p.f8 * dcp) * p.inv_cp;
  out[9] = ((q.iy - q.iz) / q.ix) * (dqr * p.rr + p.qr * drr) + (q.arm / q.ix) * ((tu[1] + tu[2]) - (tu[0] + tu[3]));
  out[10] = ((q.iz - q.ix) / q.iy) * (dpr * p.rr + p.pr * drr) + (q.arm / q.iy) * ((tu[0] + tu[1]) - (tu[2] + tu[3]));
  out[11] = ((q.ix - q.iy) / q.iz) * (dpr * p.qr + p.pr * dqr) + (q.k_yaw / q.iz) * (tu[0] - tu[1] + tu[2] - tu[3]);
}

// The cart-pole's field at (x, u) (CartPole::field's expressions), keeping pt.
template <typename T>
QT_HD void field_point(const CartPole<T>& c, const T* x, const T* u, T* dx, CartPolePoint<T>& pt) {
  const T m_total = c.m_cart + c.m_pole;
  const T ml = c.m_pole * c.length;
  pt.thd = x[3];
  pt.s = sin_t(x[2]);
  pt.c = cos_t(x[2]);
  pt.temp = (u[0] + ml * (pt.thd * pt.thd) * pt.s) / m_total;
  pt.den = c.length * (T(4) / T(3) - c.m_pole * (pt.c * pt.c) / m_total);
  pt.thdd = (-c.gravity * pt.s + pt.c * pt.temp) / pt.den;
  dx[0] = x[1];
  dx[1] = pt.temp - ml * pt.thdd * pt.c / m_total;
  dx[2] = pt.thd;
  dx[3] = pt.thdd;
}

template <typename T>
QT_HD void field_tangent(const CartPole<T>& c, const CartPolePoint<T>& p, const T* tx, const T* tu, T* out) {
  const T m_total = c.m_cart + c.m_pole;
  const T ml = c.m_pole * c.length;
  const T dth = tx[2], dthd = tx[3];
  const T ds = p.c * dth, dc = -p.s * dth;
  const T dtemp = (tu[0] + ml * ((dthd * p.thd + p.thd * dthd) * p.s + (p.thd * p.thd) * ds)) / m_total;
  const T dden = c.length * (-(c.m_pole * (dc * p.c + p.c * dc)) / m_total);
  const T dnum = -c.gravity * ds + (dc * p.temp + p.c * dtemp);
  const T dthdd = (dnum - p.thdd * dden) / p.den;
  out[0] = tx[1];
  out[1] = dtemp - ml * (dthdd * p.c + p.thdd * dc) / m_total;
  out[2] = tx[3];
  out[3] = dthdd;
}

// The step at (x, u) once, Euler or RK4 as discrete_step, keeping each field
// evaluation's point (pts[0] only for Euler).
template <typename P, typename T>
QT_HD void discrete_step_points(const P& plant, int rk4, const StepSizes<T>& h, const T* x, const T* u,
                                typename PointOf<P>::type (&pts)[4]) {
  constexpr int N = P::N;
  T k[N], xt[N];
  field_point(plant, x, u, k, pts[0]);
  if (!rk4) return;
#pragma unroll
  for (int i = 0; i < N; ++i) xt[i] = x[i] + h.half_dt * k[i];
  field_point(plant, xt, u, k, pts[1]);
#pragma unroll
  for (int i = 0; i < N; ++i) xt[i] = x[i] + h.half_dt * k[i];
  field_point(plant, xt, u, k, pts[2]);
#pragma unroll
  for (int i = 0; i < N; ++i) xt[i] = x[i] + h.dt * k[i];
  field_point(plant, xt, u, k, pts[3]);
}

// Column d of [A | B] from the points of discrete_step_points: the tangent
// e_d carried through the integrator as discrete_step carries the state.
template <typename P, typename T>
QT_HD void discrete_step_tangent_column(const P& plant, int rk4, const StepSizes<T>& h,
                                        const typename PointOf<P>::type (&pts)[4], int d, T* col) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  T tx[N], tu[M], k[N];
#pragma unroll
  for (int i = 0; i < N; ++i) tx[i] = i == d ? T(1) : T(0);
#pragma unroll
  for (int j = 0; j < M; ++j) tu[j] = N + j == d ? T(1) : T(0);
  field_tangent(plant, pts[0], tx, tu, k);
  if (!rk4) {
#pragma unroll
    for (int i = 0; i < N; ++i) col[i] = tx[i] + h.dt * k[i];
    return;
  }
  T acc[N], xt[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = k[i];
    xt[i] = tx[i] + h.half_dt * k[i];
  }
  field_tangent(plant, pts[1], xt, tu, k);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = acc[i] + T(2) * k[i];
    xt[i] = tx[i] + h.half_dt * k[i];
  }
  field_tangent(plant, pts[2], xt, tu, k);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = acc[i] + T(2) * k[i];
    xt[i] = tx[i] + h.dt * k[i];
  }
  field_tangent(plant, pts[3], xt, tu, k);
#pragma unroll
  for (int i = 0; i < N; ++i) col[i] = tx[i] + h.sixth_dt * (acc[i] + k[i]);
}

}  // namespace qt
