// Host build of plants.cuh and costs.cuh behind a plain C interface.
//
// The kernels' plant and cost derivatives are written by hand (dual-number
// Jacobians, K5's value pass plus tangent-only columns, analytic cost
// expansion). They are host-and-device code, so a
// host compiler can build them into this small library and a CPU test can
// hold them against autodiff without a GPU. float64 only; plant: 0 =
// quadrotor, 1 = cart-pole; params as in the kernels' entry points.

#include "costs.cuh"
#include "plants.cuh"

namespace {

template <typename P>
void step_and_jacobian(const double* params, int rk4, double dt, const double* x, const double* u,
                       double* x_next, double* a, double* b) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  const P plant = P::from(params);
  const auto h = qt::StepSizes<double>::from(dt);
  qt::discrete_step(plant, rk4, h, x, u, x_next);
  double col[N];
  for (int d = 0; d < N + M; ++d) {
    qt::discrete_step_jacobian_column(plant, rk4, h, x, u, d, col);
    for (int i = 0; i < N; ++i) {
      if (d < N)
        a[i * N + d] = col[i];
      else
        b[i * M + (d - N)] = col[i];
    }
  }
}

template <typename P>
void tangent_jacobian(const double* params, int rk4, double dt, const double* x, const double* u, double* a,
                      double* b) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  const P plant = P::from(params);
  const auto h = qt::StepSizes<double>::from(dt);
  typename qt::PointOf<P>::type pts[4];
  qt::discrete_step_points(plant, rk4, h, x, u, pts);
  double col[N];
  for (int d = 0; d < N + M; ++d) {
    qt::discrete_step_tangent_column(plant, rk4, h, pts, d, col);
    for (int i = 0; i < N; ++i) {
      if (d < N)
        a[i * N + d] = col[i];
      else
        b[i * M + (d - N)] = col[i];
    }
  }
}

template <int N, int M>
void cost_and_expansion(const double* q, const double* r, const double* x_ref, double alpha,
                        double beta, const double* qf, const double* xf_ref, const double* x,
                        const double* u, double* values, double* l_x, double* l_u, double* l_xx,
                        double* l_uu, double* l_ux, double* v_x, double* v_xx) {
  values[0] = qt::running_cost<N, M>(q, r, x_ref, alpha, beta, x, u);
  values[1] = qt::final_cost<N>(qf, xf_ref, x);
  qt::running_cost_expansion<N, M>(q, r, x_ref, alpha, beta, x, u, l_x, l_u, l_xx, l_uu, l_ux);
  qt::final_cost_expansion<N>(qf, xf_ref, x, v_x, v_xx);
}

}  // namespace

// x_next (n), a (n,n), b (n,m) of the discrete step at (x, u). Returns 0, or 1 for an unknown plant.
extern "C" int qt_host_step_and_jacobian(int plant, const double* params, int rk4, double dt,
                                         const double* x, const double* u, double* x_next,
                                         double* a, double* b) {
  if (plant == 0) {
    step_and_jacobian<qt::Quadrotor<double>>(params, rk4, dt, x, u, x_next, a, b);
    return 0;
  }
  if (plant == 1) {
    step_and_jacobian<qt::CartPole<double>>(params, rk4, dt, x, u, x_next, a, b);
    return 0;
  }
  return 1;
}

// a (n,n), b (n,m) of the discrete step at (x, u) as K5 computes them: one
// value pass, then tangent-only columns. Returns 0, or 1 for an unknown plant.
extern "C" int qt_host_step_tangent_jacobian(int plant, const double* params, int rk4, double dt,
                                             const double* x, const double* u, double* a, double* b) {
  if (plant == 0) {
    tangent_jacobian<qt::Quadrotor<double>>(params, rk4, dt, x, u, a, b);
    return 0;
  }
  if (plant == 1) {
    tangent_jacobian<qt::CartPole<double>>(params, rk4, dt, x, u, a, b);
    return 0;
  }
  return 1;
}

// values = [running cost at (x, u), final cost at x], then both expansions,
// at the plant's (n, m). Returns 0, or 1 for an unknown plant.
extern "C" int qt_host_cost_and_expansion(int plant, const double* q, const double* r,
                                          const double* x_ref, double alpha, double beta,
                                          const double* qf, const double* xf_ref, const double* x,
                                          const double* u, double* values, double* l_x, double* l_u,
                                          double* l_xx, double* l_uu, double* l_ux, double* v_x,
                                          double* v_xx) {
  if (plant == 0) {
    cost_and_expansion<12, 4>(q, r, x_ref, alpha, beta, qf, xf_ref, x, u, values, l_x, l_u, l_xx,
                              l_uu, l_ux, v_x, v_xx);
    return 0;
  }
  if (plant == 1) {
    cost_and_expansion<4, 1>(q, r, x_ref, alpha, beta, qf, xf_ref, x, u, values, l_x, l_u, l_xx,
                             l_uu, l_ux, v_x, v_xx);
    return 0;
  }
  return 1;
}
