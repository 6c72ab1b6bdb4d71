// Host build of the Riccati step's arithmetic (riccati_step.cuh) behind a
// plain C interface.
//
// The kernels K1, K3 and K4 compute each step from the QT_HD functions of
// riccati_step.cuh: the per-output products, the register factor of
// Q_uu + reg I, the substitutions and the value update. Here one step is
// composed from the same functions, entry by entry, with plain arrays where
// the device uses its stage ring and shuffles, so a CPU test can hold the
// arithmetic against the TPU step law without a GPU. float64 only.

#include "riccati_step.cuh"

namespace {

template <int NC, int MC, bool kMasked>
void host_step(int n_rt, int m_rt, double reg, const double* a, const double* b, const double* lx,
               const double* lu, const double* lxx, const double* luu, const double* lux,
               const double* vx, const double* vxx, double* k, double* bigk, double* vx_new,
               double* vxx_new) {
  const int n = kMasked ? n_rt : NC;
  const int m = kMasked ? m_rt : MC;
  qt::StepTiles<double, NC, MC> s{};
  for (int i = 0; i < n; ++i) {
    s.vx[i] = vx[i];
    for (int j = 0; j < n; ++j) s.vxx[i * NC + j] = vxx[i * n + j];
  }
  using View = qt::SlotView<double>;
  for (int idx = 0; idx < qt::kFirstEntries<NC, MC>; ++idx)
    qt::first_product<NC, MC>(idx, n, m, s, View{a}, View{b}, View{lx}, View{lu});
  for (int idx = 0; idx < qt::kQEntries<NC, MC>; ++idx)
    qt::q_expansion<NC, MC>(idx, n, m, s, View{a}, View{b}, View{lxx}, View{luu}, View{lux});

  double l[MC][MC], inv[MC], sol[NC + 1][MC];  // sol[c]: column c of [g_u | G]
  qt::chol_factor<NC, MC>(m, s, reg, l, inv);
  for (int c = 0; c <= n; ++c) qt::chol_solve_column<NC, MC>(c, m, s, l, inv, sol[c]);
  for (int i = 0; i < m; ++i) {
    k[i] = -sol[0][i];
    for (int j = 0; j < n; ++j) bigk[i * n + j] = -sol[1 + j][i];
  }
  double inner[MC];
  qt::inner_terms<NC, MC>(m, s, sol[0], inner);
  for (int idx = 0; idx < qt::kValueEntries<NC>; ++idx) {
    int ci, cj;
    qt::value_columns<NC>(idx, n, &ci, &cj);
    qt::value_update<NC, MC>(idx, n, m, reg, s, sol[ci], sol[cj], sol[0], inner, vx_new, vxx_new);
  }
}

}  // namespace

// One backward step at (n, m), through the instance the kernels dispatch to
// (qt::step_shape): k (m), big_k (m,n), v_x' (n), v_xx' (n,n) from a (n,n),
// b (n,m), l_x (n), l_u (m), l_xx (n,n), l_uu (m,m), l_ux (m,n), v_x (n),
// v_xx (n,n), all row-major. Returns 0, or 1 for a shape out of range.
extern "C" int qt_host_riccati_step(int n, int m, double reg, const double* a, const double* b,
                                    const double* lx, const double* lu, const double* lxx,
                                    const double* luu, const double* lux, const double* vx,
                                    const double* vxx, double* k, double* bigk, double* vx_new,
                                    double* vxx_new) {
  if (n < 1 || n > qt::kNMax || m < 1 || m > qt::kMMax) return 1;
  return qt::step_shape(n, m, [&](auto shape) {
    using Shape = decltype(shape);
    host_step<Shape::NC, Shape::MC, Shape::kMasked>(n, m, reg, a, b, lx, lu, lxx, luu, lux, vx, vxx, k,
                                                    bigk, vx_new, vxx_new);
    return 0;
  });
}

// Which instance (n, m) runs: 0 the quadrotor's (12, 4), 1 the cart-pole's
// (4, 1), 2 the masked one at (16, 8).
extern "C" int qt_host_step_instance(int n, int m) {
  return qt::step_shape(n, m, [](auto shape) {
    using Shape = decltype(shape);
    return Shape::kMasked ? 2 : (Shape::NC == 12 ? 0 : 1);
  });
}
