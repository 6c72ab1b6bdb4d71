// The in-repo cost family, its gradient and its Hessians, for device and host.
//
//   running:  L(x, u) = dx'Q dx + u'R u + alpha * sum_j softplus(-u_j, beta)^2,  dx = x - x_ref
//   final:    Lf(x)   = dx'Qf dx
//
// (quattro_tpu/solver/costs.py: no 1/2 factor; Q, R, Qf enter as full
// matrices, a diagonal weight as its diagonal matrix). The TPU kernels get
// the expansion from jax.grad / jax.jacfwd of the traced callables; here it is
// written out. The quadratic part gives (Q + Q') dx and Q + Q'. The barrier's
// derivatives are the analytic sigmoid chain that the Python packages declare
// for it: softplus'(z) = sigmoid(beta z), softplus''(z) = beta s (1 - s),
// exact at u = 0 and free of overflow at both ends, with s and 1 - s each
// computed from the small exponential of its own half-line.

#pragma once

#include "plants.cuh"

namespace qt {

QT_HD float exp_t(float v) { return expf(v); }
QT_HD double exp_t(double v) { return exp(v); }
QT_HD float log1p_t(float v) { return log1pf(v); }
QT_HD double log1p_t(double v) { return log1p(v); }

// softplus(z, beta) = log1p(exp(beta z)) / beta with s = sigmoid(beta z) and sc = 1 - s.
template <typename T>
QT_HD void softplus_terms(T z, T beta, T* value, T* s, T* sc) {
  if (z <= T(0)) {
    const T e = exp_t(beta * z);
    *value = log1p_t(e) / beta;
    *s = e / (T(1) + e);
    *sc = T(1) / (T(1) + e);
  } else {
    const T e = exp_t(-beta * z);
    *value = z + log1p_t(e) / beta;
    *s = T(1) / (T(1) + e);
    *sc = e / (T(1) + e);
  }
}

// The barrier alpha * softplus(-u, beta)^2 differentiated in u:
// grad = alpha * (-2 sp s), hess = alpha * 2 (s^2 + sp beta s (1 - s)).
template <typename T>
QT_HD void barrier_derivatives(T u, T alpha, T beta, T* grad, T* hess) {
  T sp, s, sc;
  softplus_terms(-u, beta, &sp, &s, &sc);
  *grad = alpha * (T(-2) * sp * s);
  *hess = alpha * (T(2) * (s * s + sp * (beta * s * sc)));
}

// sum_i v_i (sum_j w[i][j] v_j) for a row-major n x n weight.
template <int N, typename T>
QT_HD T quadratic_form(const T* w, const T* v) {
  T total = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T row = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) row += w[i * N + j] * v[j];
    total += v[i] * row;
  }
  return total;
}

template <int N, int M, typename T>
QT_HD T running_cost(const T* q, const T* r, const T* x_ref, T alpha, T beta, const T* x, const T* u) {
  T dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = x[i] - x_ref[i];
  T value = quadratic_form<N>(q, dx) + quadratic_form<M>(r, u);
  if (alpha > T(0)) {
    T barrier = T(0);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T sp, s, sc;
      softplus_terms(-u[j], beta, &sp, &s, &sc);
      barrier += sp * sp;
    }
    value = value + alpha * barrier;
  }
  return value;
}

template <int N, typename T>
QT_HD T final_cost(const T* qf, const T* x_ref, const T* x) {
  T dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = x[i] - x_ref[i];
  return quadratic_form<N>(qf, dx);
}

// Gradient (W + W') v and Hessian W + W' of v'W v; hess may be null.
template <int N, typename T>
QT_HD void quadratic_expansion(const T* w, const T* v, T* grad, T* hess) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T g = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T sym = w[i * N + j] + w[j * N + i];
      g += sym * v[j];
      if (hess) hess[i * N + j] = sym;
    }
    grad[i] = g;
  }
}

// l_x (N), l_u (M), l_xx (N, N), l_uu (M, M), l_ux (M, N) of the running cost at (x, u).
template <int N, int M, typename T>
QT_HD void running_cost_expansion(const T* q, const T* r, const T* x_ref, T alpha, T beta, const T* x,
                                  const T* u, T* l_x, T* l_u, T* l_xx, T* l_uu, T* l_ux) {
  T dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = x[i] - x_ref[i];
  quadratic_expansion<N>(q, dx, l_x, l_xx);
  quadratic_expansion<M>(r, u, l_u, l_uu);
  if (alpha > T(0)) {
    // b(u) = sum_j sp(-u_j)^2:  db/du_j = -2 sp s,  d2b/du_j^2 = 2 (s^2 + sp beta s (1 - s)).
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T grad, hess;
      barrier_derivatives(u[j], alpha, beta, &grad, &hess);
      l_u[j] += grad;
      l_uu[j * M + j] += hess;
    }
  }
#pragma unroll
  for (int i = 0; i < M * N; ++i) l_ux[i] = T(0);
}

// V_x (N) and V_xx (N, N) of the final cost at x.
template <int N, typename T>
QT_HD void final_cost_expansion(const T* qf, const T* x_ref, const T* x, T* v_x, T* v_xx) {
  T dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = x[i] - x_ref[i];
  quadratic_expansion<N>(qf, dx, v_x, v_xx);
}

}  // namespace qt
