// The backward Riccati step of K4 (fused_riccati_batched.cu) for one warp per
// trajectory: the same law and the same rounding as riccati_step.cuh (K1, K3),
// with each lane computing a 4 x 2 tile of outputs.
//
// Why: K4 runs only about 16 trajectories per SM at B=2048, so one warp's
// step must be short and cheap to issue. riccati_step.cuh's per-output
// products (K1's 128 threads on one trajectory) read both operands of every
// FMA from shared memory, about 24 loads per output, with CTA barriers between
// phases. Here a lane holds a 4 x 2 block of outputs in registers and, per
// term k of the inner products, loads four values of one operand (one vector
// load where they are contiguous) and two of the other: 6 loads for 8 FMAs,
// not 16, all issued before the FMA chains.
//
// The step, on the combined index space of [x | u] with the u part from
// column NC (the capacity), so that a block of 4 rows or 2 columns never
// straddles x and u; entries beyond the runtime (n, m) are computed on
// whatever the padding holds and never stored:
//   first products  [t1 | t3] = V_xx [A | B] and [q_x | q_u] = [l_x | l_u] + v_x'[A | B]:
//                   rows 0..NC-1 of V_xx, then v_x as row NC; (NC/4 + 1) x ceil((NC+MC)/2) tiles
//   Q-expansion     [[Q_xx, Q_ux'], [Q_ux, Q_uu]] = L + [A | B]'[t1 | t3]; ceil((NC+MC)/4) x ceil((NC+MC)/2) tiles
//   factor, solve   Q_uu + reg I factored in registers in every lane; lane c <= n solves column c
//                   of [Q_u | Q_ux] (as riccati_step.cuh's solve_and_update)
//   value update    V_xx' in (NC/4) x (NC/2) tiles, then the NC entries of V_x', each reading the
//                   columns of [g_u | G] it needs from their lanes
// The carry V_xx is kept transposed (vt[k][r] = V_xx[r][k]) with v_x as row NC,
// so the first products read four rows of one column as one vector.
//
// Rounding: every output is still one FMA chain from zero in the order
// q = 0, 1, ... (dot_n), the cost term added after it, the factor and the
// substitutions in the Crout order, the value update's terms in
// value_update's order; the stage values are widened exactly. So a K4 lane
// equals K1 on the same trajectory bit for bit. The functions here are QT_HD:
// csrc/riccati_warp_host.cpp composes a step from them on the host, and a CPU
// test holds it bit for bit against riccati_step_host.cpp (the step of
// riccati_step.cuh) and against the TPU step law. FP32 or FP64 FMAs only.

#pragma once

#include <cstdint>
#include <cstring>

#include "riccati_step.cuh"

namespace qt {

// Stage values as stored: the carry type, or the 16 bits of a bfloat16
// (widened exactly: the bits become the high half of a float).
template <typename T, typename S>
struct Widen {
  QT_HD static T get(S v) { return static_cast<T>(v); }
};

template <typename T>
struct Widen<T, uint16_t> {
  QT_HD static T get(uint16_t v) {
    const uint32_t bits = uint32_t(v) << 16;
#if defined(__CUDA_ARCH__)
    return static_cast<T>(__uint_as_float(bits));
#else
    float f;
    std::memcpy(&f, &bits, sizeof f);
    return static_cast<T>(f);
#endif
  }
};

// One stage tensor of one trajectory: entry e at p[e * ES] (ES = 1 for a
// trajectory's own contiguous copy, the CTA's trajectory count where
// neighbouring trajectories interleave). kVec4: ES = 1 and every run of four
// entries that get4 reads starts on a boundary of four values, so the device
// reads it as one vector.
template <typename T, typename S, int ES, bool kVec4_ = false>
struct StageRef {
  static constexpr bool kVec4 = kVec4_;
  const S* p;
  QT_HD T operator[](int e) const { return Widen<T, S>::get(p[e * ES]); }
  QT_HD void get4(int e, T (&x)[4]) const {
#if defined(__CUDA_ARCH__)
    if constexpr (kVec4 && sizeof(S) == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      x[0] = Widen<T, S>::get(v.x), x[1] = Widen<T, S>::get(v.y), x[2] = Widen<T, S>::get(v.z),
      x[3] = Widen<T, S>::get(v.w);
      return;
    } else if constexpr (kVec4 && sizeof(S) == 8) {
      const double2 v0 = *reinterpret_cast<const double2*>(p + e);
      const double2 v1 = *reinterpret_cast<const double2*>(p + e + 2);
      x[0] = Widen<T, S>::get(v0.x), x[1] = Widen<T, S>::get(v0.y), x[2] = Widen<T, S>::get(v1.x),
      x[3] = Widen<T, S>::get(v1.y);
      return;
    } else if constexpr (kVec4 && sizeof(S) == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + e);
      x[0] = Widen<T, S>::get(static_cast<uint16_t>(v.x & 0xffffu)),
      x[1] = Widen<T, S>::get(static_cast<uint16_t>(v.x >> 16)),
      x[2] = Widen<T, S>::get(static_cast<uint16_t>(v.y & 0xffffu)),
      x[3] = Widen<T, S>::get(static_cast<uint16_t>(v.y >> 16));
      return;
    }
#endif
    for (int i = 0; i < 4; ++i) x[i] = (*this)[e + i];
  }
};

// The warp's intermediates. Row strides keep each 4-row column of vt and
// each 2-column row of p and q one aligned vector.
template <typename T, int NC, int MC>
struct WarpTiles {
  static_assert(NC % 4 == 0, "row blocks of 4 must not straddle x and u");
  static constexpr int R1 = NC / 4 + 1;         // row blocks of the first products (V_xx, then v_x)
  static constexpr int C1 = (NC + MC + 1) / 2;  // column pairs of [A | B]
  static constexpr int R2 = (NC + MC + 3) / 4;  // row blocks of the Q-expansion
  static constexpr int RS = 4 * R1;             // row stride of vt
  static constexpr int PS = 2 * C1;             // row stride of p and q
  static constexpr int kFirstTiles = R1 * C1;
  static constexpr int kQTiles = R2 * C1;
  static constexpr int kValueTiles = (NC / 4) * (NC / 2);
  static constexpr int kValueTasks = kValueTiles + NC;  // then one task per entry of V_x'
  alignas(16) T vt[NC * RS];   // vt[k * RS + r] = V_xx[r][k] (r < n), v_x[k] (r = NC)
  alignas(16) T p[NC * PS];    // p[k * PS + c] = [t1 | t3][k][c], t3 from column NC
  alignas(16) T q[4 * R2 * PS];  // q[i * PS + j] = [[Q_xx, Q_ux'], [Q_ux, Q_uu]][i][j]
  alignas(16) T qrow[PS];      // [q_x | q_u]
};

// Entry c of the combined [x | u] index space exists at the runtime (n, m)
// (always, for an exact shape: kExact, n = NC and m = MC, and c < NC + MC).
template <int NC, bool kExact = false>
QT_HD bool xu_valid(int c, int n, int m) {
  return kExact || (c < NC ? c < n : c - NC < m);
}

template <typename T>
QT_HD void load4(const T* p, T (&x)[4]) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const double2 v0 = *reinterpret_cast<const double2*>(p);
    const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
    x[0] = v0.x, x[1] = v0.y, x[2] = v1.x, x[3] = v1.y;
  }
#else
  for (int i = 0; i < 4; ++i) x[i] = p[i];
#endif
}

template <typename T>
QT_HD void store2(T* p, T a, T b) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<double2*>(p) = make_double2(a, b);
#else
  p[0] = a, p[1] = b;
#endif
}

template <typename T>
QT_HD void load2(const T* p, T (&x)[2]) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
#else
  x[0] = p[0], x[1] = p[1];
#endif
}

// First products, tile `tile`: rows 4g .. 4g+3 of [V_xx; v_x'] against columns
// c0, c0 + 1 of [A | B]. V_xx rows go to p; the v_x row (4g = NC) adds
// [l_x | l_u] and goes to qrow. kExact: (n, m) = (NC, MC), no entry masked.
template <int NC, int MC, bool kExact = false, typename T, typename V>
QT_HD void first_products_tile(int tile, int n, int m, WarpTiles<T, NC, MC>& w, const V& a, const V& b,
                               const V& lx, const V& lu) {
  using W = WarpTiles<T, NC, MC>;
  const int g = tile / W::C1, c0 = 2 * (tile % W::C1);
  const bool in_a = c0 < NC;
  const V ab = in_a ? a : b;
  const int col = in_a ? c0 : c0 - NC, stride = in_a ? n : m;
  const bool ok0 = xu_valid<NC, kExact && MC % 2 == 0>(c0, n, m);
  const bool ok1 = xu_valid<NC, kExact && MC % 2 == 0>(c0 + 1, n, m);
  // All operands first, so that the loads overlap; then the chains, term k = 0, 1, ...
  T x[NC][4], y[NC][2];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k < n) {
      load4(&w.vt[k * W::RS + 4 * g], x[k]);
      y[k][0] = ok0 ? ab[k * stride + col] : T(0);
      y[k][1] = ok1 ? ab[k * stride + col + 1] : T(0);
    }
  }
  T acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = T(0);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k < n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] += x[k][r] * y[k][0];
        acc[r][1] += x[k][r] * y[k][1];
      }
    }
  }
  if (4 * g < NC) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      store2(&w.p[(4 * g + r) * W::PS + c0], acc[r][0], acc[r][1]);
    }
  } else {
    const V l = in_a ? lx : lu;
    if (ok0) w.qrow[c0] = l[col] + acc[0][0];
    if (ok1) w.qrow[c0 + 1] = l[col + 1] + acc[0][1];
  }
}

// Q-expansion, tile `tile`: rows i = 4g .. 4g+3 (columns of [A | B]) against
// columns c0, c0 + 1 of [t1 | t3], plus the cost term of each entry:
// l_xx[i][j], l_ux[j][i] (Q_ux'), l_ux[i][j] (Q_ux), l_uu[i][j].
template <int NC, int MC, bool kExact = false, typename T, typename V>
QT_HD void q_expansion_tile(int tile, int n, int m, WarpTiles<T, NC, MC>& w, const V& a, const V& b,
                            const V& lxx, const V& luu, const V& lux) {
  using W = WarpTiles<T, NC, MC>;
  const int g = tile / W::C1, c0 = 2 * (tile % W::C1), r0 = 4 * g;
  const bool rows_a = r0 < NC;
  const V ab = rows_a ? a : b;
  const int col = rows_a ? r0 : r0 - NC, stride = rows_a ? n : m;
  bool ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) ok[r] = xu_valid<NC, kExact && MC % 4 == 0>(r0 + r, n, m);
  T x[NC][4], y[NC][2];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k < n) {
      if constexpr (V::kVec4) {  // exact shapes: every row block of 4 exists
        ab.get4(k * stride + col, x[k]);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) x[k][r] = ok[r] ? ab[k * stride + col + r] : T(0);
      }
      load2(&w.p[k * W::PS + c0], y[k]);
    }
  }
  T acc[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = T(0);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k < n) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] += x[k][r] * y[k][0];
        acc[r][1] += x[k][r] * y[k][1];
      }
    }
  }
  // The tile's cost terms come from one tensor, entry (r, c) at l0 + r * dr + c * dc:
  // l_xx[i][j], l_ux[j][i] (Q_ux'), l_ux[i][j] (Q_ux) or l_uu[i][j].
  const bool cols_a = c0 < NC;
  const V lt = rows_a ? (cols_a ? lxx : lux) : (cols_a ? lux : luu);
  const int i0 = rows_a ? r0 : r0 - NC, j0 = cols_a ? c0 : c0 - NC;
  const int l0 = rows_a && !cols_a ? j0 * n + i0 : i0 * (rows_a || cols_a ? n : m) + j0;
  const int dr = rows_a && !cols_a ? 1 : rows_a || cols_a ? n : m;
  const int dc = rows_a && !cols_a ? n : 1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T v[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const T l = ok[r] && xu_valid<NC, kExact && MC % 2 == 0>(c0 + c, n, m) ? lt[l0 + r * dr + c * dc] : T(0);
      v[c] = l + acc[r][c];
    }
    store2(&w.q[(r0 + r) * W::PS + c0], v[0], v[1]);
  }
}

// chol_factor of riccati_step.cuh on the Q_uu block of w.q: the same
// operations in the same order.
template <int NC, int MC, typename T>
QT_HD void chol_factor_q(int m, const WarpTiles<T, NC, MC>& w, T reg, T (&l)[MC][MC], T (&inv)[MC]) {
  using W = WarpTiles<T, NC, MC>;
  T up[MC][MC];
#pragma unroll
  for (int i = 0; i < MC; ++i)
#pragma unroll
    for (int j = i; j < MC; ++j)
      if (j < m) up[i][j] = w.q[(NC + i) * W::PS + NC + j];
#pragma unroll
  for (int j = 0; j < MC; ++j) {
    if (j < m) {
      T diag = up[j][j] + reg;
#pragma unroll
      for (int q = 0; q < j; ++q) diag -= l[j][q] * l[j][q];
      const T r = rsqrt_t(diag);
      l[j][j] = diag * r;
      inv[j] = r;
#pragma unroll
      for (int i = j + 1; i < MC; ++i) {
        if (i < m) {
          T off = up[j][i];
#pragma unroll
          for (int q = 0; q < j; ++q) off -= l[i][q] * l[j][q];
          l[i][j] = off * r;
        }
      }
    }
  }
}

// chol_solve_column of riccati_step.cuh: column c (0 <= c <= n) of
// [Q_u | Q_ux] through the factor, into y.
template <int NC, int MC, typename T>
QT_HD void chol_solve_column_q(int c, int m, const WarpTiles<T, NC, MC>& w, const T (&l)[MC][MC],
                               const T (&inv)[MC], T (&y)[MC]) {
  using W = WarpTiles<T, NC, MC>;
#pragma unroll
  for (int i = 0; i < MC; ++i) y[i] = T(0);
#pragma unroll
  for (int i = 0; i < MC; ++i)
    if (i < m) y[i] = c == 0 ? w.qrow[NC + i] : w.q[(NC + i) * W::PS + (c - 1)];
#pragma unroll
  for (int i = 0; i < MC; ++i) {
    if (i < m) {
      T acc = y[i];
#pragma unroll
      for (int q = 0; q < i; ++q) acc -= l[i][q] * y[q];
      y[i] = acc * inv[i];
    }
  }
#pragma unroll
  for (int i = MC - 1; i >= 0; --i) {
    if (i < m) {
      T acc = y[i];
#pragma unroll
      for (int q = i + 1; q < MC; ++q)
        if (q < m) acc -= l[q][i] * y[q];
      y[i] = acc * inv[i];
    }
  }
}

// inner_terms of riccati_step.cuh: inner[q] = Q_u[q] - sum_r Q_uu[q][r] g_u[r].
template <int NC, int MC, typename T>
QT_HD void inner_terms_q(int m, const WarpTiles<T, NC, MC>& w, const T (&gu)[MC], T (&inner)[MC]) {
  using W = WarpTiles<T, NC, MC>;
#pragma unroll
  for (int q = 0; q < MC; ++q) {
    inner[q] = T(0);
    if (q < m) {
      T row[MC];
#pragma unroll
      for (int r = 0; r < MC; ++r)
        if (r < m) row[r] = w.q[(NC + q) * W::PS + NC + r];
      inner[q] = w.qrow[NC + q] - dot_n<MC>(m, row, gu);
    }
  }
}

// The columns of [g_u | G] that value task `task` reads: 1 + i for its four
// rows, then 1 + j for its two columns (a V_x' task j: 1 + j in slot 4),
// clamped to a column that exists.
template <int NC>
QT_HD void value_task_columns(int task, int n, int (&cols)[6]) {
  constexpr int kTiles = (NC / 4) * (NC / 2);
  int i0 = 0, j0 = 0;
  if (task < kTiles) {
    i0 = 4 * (task / (NC / 2));
    j0 = 2 * (task % (NC / 2));
  } else if (task < kTiles + NC) {
    j0 = task - kTiles;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) cols[r] = 1 + (i0 + r < n ? i0 + r : n - 1);
#pragma unroll
  for (int c = 0; c < 2; ++c) cols[4 + c] = 1 + (j0 + c < n ? j0 + c : n - 1);
}

// Value task `task` (value_update's law and term order): a tile of V_xx'
// rows i0 .. i0+3, columns j0, j0 + 1, or entry j of V_x', into the carry.
// gc[s] holds column cols[s] of [g_u | G] (value_task_columns), gu column 0.
//   V_xx'[i][j] = Q_xx[i][j] - sum_q G[q][i] Q_ux[q][j] - reg sum_q G[q][i] G[q][j]
//   V_x'[j]     = Q_x[j] - sum_q G[q][j] inner[q] - sum_q Q_ux'[j][q] g_u[q]
template <int NC, int MC, typename T>
QT_HD void value_task(int task, int n, int m, T reg, WarpTiles<T, NC, MC>& w, const T (&gc)[6][MC],
                      const T (&gu)[MC], const T (&inner)[MC]) {
  using W = WarpTiles<T, NC, MC>;
  if (task < W::kValueTiles) {
    const int i0 = 4 * (task / (NC / 2)), j0 = 2 * (task % (NC / 2));
    T qux[MC][2];
#pragma unroll
    for (int q = 0; q < MC; ++q)
      if (q < m) load2(&w.q[(NC + q) * W::PS + j0], qux[q]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      T qxx[2];
      load2(&w.q[(i0 + r) * W::PS + j0], qxx);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        T acc1 = T(0), acc2 = T(0);
#pragma unroll
        for (int q = 0; q < MC; ++q) {
          if (q < m) {
            acc1 += gc[r][q] * qux[q][c];
            acc2 += gc[r][q] * gc[4 + c][q];
          }
        }
        const T v = qxx[c] - acc1 - reg * acc2;
        if (i0 + r < n && j0 + c < n) w.vt[(j0 + c) * W::RS + i0 + r] = v;
      }
    }
  } else if (task < W::kValueTasks) {
    const int j = task - W::kValueTiles;
    if (j >= n) return;
    T acc1 = T(0), acc2 = T(0);
#pragma unroll
    for (int q = 0; q < MC; ++q) {
      if (q < m) {
        acc1 += gc[4][q] * inner[q];
        acc2 += w.q[j * W::PS + NC + q] * gu[q];
      }
    }
    w.vt[j * W::RS + NC] = w.qrow[j] - acc1 - acc2;
  }
}

}  // namespace qt
