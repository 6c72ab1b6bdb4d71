// Host build of K4's warp step (riccati_warp.cuh) behind a plain C interface.
//
// K4 runs one warp per trajectory, each lane a tile of every phase of the
// step; the tiles are QT_HD functions. Here one step is composed from the same
// functions, tile after tile, with the solved columns of [g_u | G] in an array
// where the device passes them between lanes by shuffles, so a CPU test can
// hold the arithmetic bit for bit against the step of riccati_step.cuh
// (csrc/riccati_step_host.cpp, K1's step) and against the TPU step law
// without a GPU. float64 only, the stage values read in place (stride 1).

#include "riccati_warp.cuh"

namespace {

template <int NC, int MC, bool kMasked>
void host_warp_step(int n_rt, int m_rt, double reg, const double* a, const double* b, const double* lx,
                    const double* lu, const double* lxx, const double* luu, const double* lux,
                    const double* vx, const double* vxx, double* k, double* bigk, double* vx_new,
                    double* vxx_new) {
  using W = qt::WarpTiles<double, NC, MC>;
  const int n = kMasked ? n_rt : NC;
  const int m = kMasked ? m_rt : MC;
  W w{};
  for (int r = 0; r < n; ++r) {
    w.vt[r * W::RS + NC] = vx[r];
    for (int c = 0; c < n; ++c) w.vt[c * W::RS + r] = vxx[r * n + c];
  }
  using V = qt::StageRef<double, double, 1>;
  for (int tile = 0; tile < W::kFirstTiles; ++tile)
    qt::first_products_tile<NC, MC, !kMasked>(tile, n, m, w, V{a}, V{b}, V{lx}, V{lu});
  for (int tile = 0; tile < W::kQTiles; ++tile)
    qt::q_expansion_tile<NC, MC, !kMasked>(tile, n, m, w, V{a}, V{b}, V{lxx}, V{luu}, V{lux});

  double l[MC][MC], inv[MC], sol[NC + 1][MC];  // sol[c]: column c of [g_u | G], lane c's on the device
  qt::chol_factor_q<NC, MC>(m, w, reg, l, inv);
  for (int c = 0; c <= n; ++c) qt::chol_solve_column_q<NC, MC>(c, m, w, l, inv, sol[c]);
  for (int i = 0; i < m; ++i) {
    k[i] = -sol[0][i];
    for (int j = 0; j < n; ++j) bigk[i * n + j] = -sol[1 + j][i];
  }
  double inner[MC];
  qt::inner_terms_q<NC, MC>(m, w, sol[0], inner);
  for (int task = 0; task < W::kValueTasks; ++task) {
    int cols[6];
    qt::value_task_columns<NC>(task, n, cols);
    double gc[6][MC];
    for (int s = 0; s < 6; ++s)
      for (int q = 0; q < MC; ++q) gc[s][q] = sol[cols[s]][q];
    qt::value_task<NC, MC>(task, n, m, reg, w, gc, sol[0], inner);
  }
  for (int j = 0; j < n; ++j) {
    vx_new[j] = w.vt[j * W::RS + NC];
    for (int i = 0; i < n; ++i) vxx_new[i * n + j] = w.vt[j * W::RS + i];
  }
}

}  // namespace

// One backward step at (n, m) through K4's warp step, the instance chosen as
// the kernels choose it (qt::step_shape); arguments as qt_host_riccati_step of
// riccati_step_host.cpp. Returns 0, or 1 for a shape out of range.
extern "C" int qt_host_warp_riccati_step(int n, int m, double reg, const double* a, const double* b,
                                         const double* lx, const double* lu, const double* lxx,
                                         const double* luu, const double* lux, const double* vx,
                                         const double* vxx, double* k, double* bigk, double* vx_new,
                                         double* vxx_new) {
  if (n < 1 || n > qt::kNMax || m < 1 || m > qt::kMMax) return 1;
  return qt::step_shape(n, m, [&](auto shape) {
    using Shape = decltype(shape);
    host_warp_step<Shape::NC, Shape::MC, Shape::kMasked>(n, m, reg, a, b, lx, lu, lxx, luu, lux, vx, vxx, k,
                                                         bigk, vx_new, vxx_new);
    return 0;
  });
}
