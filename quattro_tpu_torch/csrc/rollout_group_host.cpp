// Host build of the lane-group rollout (rollout_group.cuh) behind a plain C
// interface.
//
// The kernels K2 and K6/K7 run each candidate on a group of G lanes that
// exchange values by shuffles. Here the group's QT_HD per-lane parts run on
// the host, lane after lane, with arrays standing in for the shuffles: each
// exchange reads the same lanes the device reads (r ^ mask for the feedback
// sums, r - 1 for the copied velocity, lanes 1..3 for the rates, the
// computing lane for each quotient and attitude value). A CPU test holds a
// whole rollout against the TPU kernel's law without a GPU. float64 only.

#include "rollout_group.cuh"

namespace {

using qt::Attitude;
using qt::Rates;
using qt::CartPoleGroup;
using qt::QuadrotorGroup;
using qt::StepQuotients;
using qt::StepSizes;

using Quad = QuadrotorGroup<double>;

// The quadrotor's field over the group's four lanes: in[r] is lane r's stage input, out[r] its entries of f.
void group_field(const Quad& grp, const StepQuotients<double>& q, const double in[Quad::G][Quad::E],
                 double out[Quad::G][Quad::E]) {
  const Rates<double> w{in[1][2], in[2][2], in[3][2]};
  double s[Quad::G], c[Quad::G], t[Quad::G];
  for (int r = 0; r < Quad::G; ++r) Quad::trig(Quad::angle(r, in[r]), &s[r], &c[r], &t[r]);
  const Attitude<double> a{s[Quad::kRollLane],  c[Quad::kRollLane],  s[Quad::kPitchLane], c[Quad::kPitchLane],
                           t[Quad::kPitchLane], s[Quad::kYawLane], c[Quad::kYawLane]};
  for (int r = 0; r < Quad::G; ++r) {
    const int from = (r + Quad::G - 1) % Quad::G;  // the lane r reads its velocity from
    grp.entries(r, Quad::velocity_offer(from, in[from]), w, a, q, out[r]);
  }
}

void group_step(const Quad& grp, int rk4, const StepSizes<double>& h, double x[Quad::G][Quad::E],
                const double u[Quad::G][Quad::M]) {
  double mine[Quad::G];
  for (int r = 0; r < Quad::G; ++r) mine[r] = grp.quotient(r, u[r]);
  const StepQuotients<double> q{mine[0], mine[1], mine[2], mine[3]};
  double k[Quad::G][Quad::E], acc[Quad::G][Quad::E], xt[Quad::G][Quad::E];
  group_field(grp, q, x, k);
  if (!rk4) {
    for (int r = 0; r < Quad::G; ++r) qt::euler_update<double, Quad::E>(h, x[r], k[r]);
    return;
  }
  for (int s = 0; s < 4; ++s) {
    for (int r = 0; r < Quad::G; ++r) qt::rk4_after_stage<double, Quad::E>(s, h, x[r], acc[r], k[r], xt[r]);
    if (s < 3) group_field(grp, q, xt, k);
  }
}

void group_step(const CartPoleGroup<double>& grp, int rk4, const StepSizes<double>& h, double x[1][4],
                const double u[1][1]) {
  qt::discrete_step(grp.p, rk4, h, x[0], u[0], x[0]);
}

// One candidate's rollout, as one group of the kernels runs it.
template <typename Grp>
void group_rollout(const Grp& grp, int rk4, const StepSizes<double>& h, int H, double alpha, const double* x0,
                   const double* x_ref, const double* u_ref, const double* k, const double* big_k, double* xo,
                   double* uo) {
  constexpr int G = Grp::G, E = Grp::E, N = Grp::N, M = Grp::M;
  double x[G][E];
  for (int r = 0; r < G; ++r)
    for (int e = 0; e < E; ++e) xo[Grp::entry(r, e)] = x[r][e] = x0[Grp::entry(r, e)];
  for (int t = 0; t < H; ++t) {
    double p[G][M];
    for (int r = 0; r < G; ++r)
      qt::feedback_partials<double, Grp>(r, x[r], x_ref + (size_t)t * N, big_k + (size_t)t * M * N, p[r]);
    for (int mask = 1; mask < G; mask <<= 1) {  // __shfl_xor_sync(p, mask)
      double prev[G][M];
      for (int r = 0; r < G; ++r)
        for (int j = 0; j < M; ++j) prev[r][j] = p[r][j];
      for (int r = 0; r < G; ++r)
        for (int j = 0; j < M; ++j) p[r][j] = prev[r][j] + prev[r ^ mask][j];
    }
    double u[G][M];
    for (int r = 0; r < G; ++r)
      for (int j = 0; j < M; ++j) {
        u[r][j] = qt::feedback_control(u_ref[(size_t)t * M + j], k[(size_t)t * M + j], alpha, p[r][j]);
        if (j % G == r) uo[(size_t)t * M + j] = u[r][j];
      }
    group_step(grp, rk4, h, x, u);
    for (int r = 0; r < G; ++r)
      for (int e = 0; e < E; ++e) xo[(size_t)(t + 1) * N + Grp::entry(r, e)] = x[r][e];
  }
}

template <typename Grp, typename P>
void rollouts(const double* params, int rk4, double dt, int H, int n_alpha, const double* x0, const double* x_ref,
              const double* u_ref, const double* k, const double* big_k, const double* alphas, double* cand_x,
              double* cand_u) {
  const Grp grp = Grp::from(P::from(params));
  const auto h = StepSizes<double>::from(dt);
  for (int c = 0; c < n_alpha; ++c)
    group_rollout(grp, rk4, h, H, alphas[c], x0, x_ref, u_ref, k, big_k, cand_x + (size_t)c * (H + 1) * Grp::N,
                  cand_u + (size_t)c * H * Grp::M);
}

}  // namespace

// K2's function through the group body: plant 0 = quadrotor, 1 = cart-pole
// (params as in qt_fused_rollout); x0 (n), x_ref (H,n), u_ref (H,m), k (H,m),
// big_k (H,m,n), alphas (A) -> cand_x (A,H+1,n), cand_u (A,H,m).
// Returns 0, or 1 for an unknown plant or a bad size.
extern "C" int qt_host_group_rollout(int plant, const double* params, int rk4, double dt, int H, int n_alpha,
                                     const double* x0, const double* x_ref, const double* u_ref, const double* k,
                                     const double* big_k, const double* alphas, double* cand_x, double* cand_u) {
  if (H < 0 || n_alpha < 1) return 1;
  if (plant == 0)
    rollouts<Quad, qt::Quadrotor<double>>(params, rk4, dt, H, n_alpha, x0, x_ref, u_ref, k, big_k, alphas,
                                          cand_x, cand_u);
  else if (plant == 1)
    rollouts<CartPoleGroup<double>, qt::CartPole<double>>(params, rk4, dt, H, n_alpha, x0, x_ref, u_ref, k, big_k,
                                                          alphas, cand_x, cand_u);
  else
    return 1;
  return 0;
}

// The group width G the kernels use for a plant (0 = quadrotor, 1 = cart-pole), or 0 for an unknown plant.
extern "C" int qt_host_group_width(int plant) {
  return plant == 0 ? Quad::G : (plant == 1 ? CartPoleGroup<double>::G : 0);
}
