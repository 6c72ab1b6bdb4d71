// The backward Riccati recursion of K1 (fused_riccati_single.cu) and K3
// (fused_solve.cu), as riccati_step_tiles is shared by their TPU originals
// (quattro_tpu/ops/fused_riccati.py). K4 (fused_riccati_batched.cu) runs the
// same law in the same rounding for one warp per trajectory
// (riccati_warp.cuh, which reuses dot_n, rsqrt_t, the stage enumeration and
// step_shape from here).
//
// Law, JAX's algebraic form: the Q-expansion; a Cholesky-Crout factor of
// Q_uu + reg I that reads the upper triangle (rsqrt, then multiplies by the
// inverse diagonal); [g_u | G] by forward and back substitution;
// V_xx' = Q_xx - G'Q_ux - reg G'G (no symmetrize),
// V_x' = Q_x - G'(Q_u - Q_uu g_u) - Q_ux' g_u; gains k = -g_u, K = -G.
//
// What bounds it: the H steps are one chain, and one step is a few thousand
// flops on 12 x 12 tiles, so the time is the chain's latency per step. The
// design shortens that chain:
//   - Compile-time shapes. The step is a template on the capacity (NC, MC):
//     the quadrotor's (12, 4) and the cart-pole's (4, 1) run exact; one
//     instance at (kNMax, kMMax) masks entries beyond the runtime (n, m) for
//     any other shape (step_shape). Inner products are unrolled, their
//     operands loaded before the FMA chain.
//   - The stage data is off the chain. A ring of kRingDepth steps in shared
//     memory is filled by cp.async (tile_copy.cuh): step t - kRingDepth is
//     issued once step t has read its slot, so each step's data was in
//     flight for more than two steps before it is needed. Where the CTA has
//     warps that own no value entry (K1, K3), they issue the copies while
//     the others solve.
//   - Three CTA-wide barriers per step: S1 after the first products
//     (V_xx A, V_xx B, q_x, q_u), S2 after the Q-expansion, S3 after the
//     value update (which also publishes the next slot of the ring).
//   - Factor, solve and value update in registers, warp-synchronous, between
//     S2 and S3. Every warp that owns value outputs factors Q_uu + reg I in
//     registers in every lane (broadcast reads of the upper triangle); lane c
//     <= n solves column c of [Q_u | Q_ux]; warp 0's lanes write the gains;
//     each output of the value update fetches the columns of [g_u | G] it
//     needs from their lanes by shuffles, so nothing of the solve goes
//     through shared memory and no thread waits alone on the factor.
// Rounding: every sum runs from zero in the order q = 0, 1, ... (one FMA
// chain per output), the factor and the substitutions in the Crout order of
// the TPU step law. FP32 or FP64 FMAs only: no tensor cores, no TF32.
//
// The arithmetic (the per-output products, the factor, the substitutions and
// the value update) is QT_HD: csrc/riccati_step_host.cpp builds one step for
// the host from the same functions, and a CPU test holds it against the TPU
// step law. The ring, the barriers and the shuffles are device code.

#pragma once

#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#include "tile_copy.cuh"
#define QT_HD __host__ __device__ __forceinline__
#else
#define QT_HD inline
#endif

namespace qt {

constexpr int kNMax = 16;
constexpr int kMMax = 8;
constexpr int kRingDepth = 3;

QT_HD float rsqrt_t(float v) {
#if defined(__CUDA_ARCH__)
  return rsqrtf(v);
#else
  return 1.0f / std::sqrt(v);
#endif
}
QT_HD double rsqrt_t(double v) {
#if defined(__CUDA_ARCH__)
  return rsqrt(v);
#else
  return 1.0 / std::sqrt(v);
#endif
}

// ---------------------------------------------------------------------------
// Layout. The step's intermediates, with row strides NC and MC (padded where
// the runtime shape is smaller). Shared memory on the device, a local on the
// host.
template <typename T, int NC, int MC>
struct StepTiles {
  T vxx[NC * NC];   // carry: V_xx after this step on entry, at this step on exit
  T vx[NC];         // carry
  T t1[NC * NC];    // V_xx A       (n, n)
  T t3[NC * MC];    // V_xx B       (n, m)
  T qxx[NC * NC];   // (n, n)
  T qux[MC * NC];   // (m, n)
  T quxt[NC * MC];  // (n, m), its own product
  T quu[MC * MC];   // (m, m)
  T qx[NC];
  T qu[MC];
};

// One step's stage data in a ring slot: a (n,n), b (n,m), l_x (n), l_u (m),
// l_xx (n,n), l_uu (m,m), l_ux (m,n), each row-major with the runtime shape,
// at fixed offsets for the capacity.
enum StageTensor { kA, kB, kLx, kLu, kLxx, kLuu, kLux, kStageTensors };

QT_HD constexpr int stage_capacity(int nc, int mc) { return 2 * nc * nc + 2 * nc * mc + mc * mc + nc + mc; }

QT_HD constexpr int stage_offset(int k, int nc, int mc) {
  return k == kA ? 0
       : k == kB ? nc * nc
       : k == kLx ? nc * nc + nc * mc
       : k == kLu ? nc * nc + nc * mc + nc
       : k == kLxx ? nc * nc + nc * mc + nc + mc
       : k == kLuu ? 2 * nc * nc + nc * mc + nc + mc
                   : 2 * nc * nc + nc * mc + nc + mc + mc * mc;
}

QT_HD int stage_count(int k, int n, int m) {
  return k == kA || k == kLxx ? n * n : k == kB || k == kLux ? n * m : k == kLx ? n : k == kLu ? m : m * m;
}

// A stage tensor in a slot that holds values of the carry type.
template <typename T>
struct SlotView {
  const T* w;
  QT_HD T operator[](int e) const { return w[e]; }
};

// ---------------------------------------------------------------------------
// Arithmetic (host and device).

// sum_{q < n} x[q] y[q], from zero in the order q = 0, 1, ... (n <= NC).
template <int NC, typename T>
QT_HD T dot_n(int n, const T (&x)[NC], const T (&y)[NC]) {
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < NC; ++q)
    if (q < n) acc += x[q] * y[q];
  return acc;
}

// Entries of the first products: [0, NC^2) t1 = V_xx A, then t3 = V_xx B,
// q_x = l_x + A'v_x, q_u = l_u + B'v_x. Entries outside (n, m) do nothing.
template <int NC, int MC>
constexpr int kFirstEntries = NC * NC + NC * MC + NC + MC;

template <int NC, int MC, typename T, typename V>
QT_HD void first_product(int idx, int n, int m, StepTiles<T, NC, MC>& s, const V& a, const V& b,
                         const V& lx, const V& lu) {
  constexpr int NN = NC * NC, NM = NC * MC;
  T x[NC], y[NC];
  if (idx < NN) {
    const int r = idx / NC, c = idx % NC;
    if (r >= n || c >= n) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = s.vxx[r * NC + q], y[q] = a[q * n + c];
    s.t1[idx] = dot_n<NC>(n, x, y);
  } else if (idx < NN + NM) {
    const int e = idx - NN, r = e / MC, c = e % MC;
    if (r >= n || c >= m) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = s.vxx[r * NC + q], y[q] = b[q * m + c];
    s.t3[e] = dot_n<NC>(n, x, y);
  } else if (idx < NN + NM + NC) {
    const int c = idx - NN - NM;
    if (c >= n) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = s.vx[q], y[q] = a[q * n + c];
    s.qx[c] = lx[c] + dot_n<NC>(n, x, y);
  } else {
    const int c = idx - NN - NM - NC;
    if (c >= m) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = s.vx[q], y[q] = b[q * m + c];
    s.qu[c] = lu[c] + dot_n<NC>(n, x, y);
  }
}

// Entries of the Q-expansion: [0, NC^2) Q_xx = l_xx + A't1, then
// Q_ux = l_ux + B't1, Q_ux' = l_ux' + A't3, Q_uu = l_uu + B't3.
template <int NC, int MC>
constexpr int kQEntries = NC * NC + 2 * NC * MC + MC * MC;

template <int NC, int MC, typename T, typename V>
QT_HD void q_expansion(int idx, int n, int m, StepTiles<T, NC, MC>& s, const V& a, const V& b,
                       const V& lxx, const V& luu, const V& lux) {
  constexpr int NN = NC * NC, NM = NC * MC;
  T x[NC], y[NC];
  if (idx < NN) {
    const int i = idx / NC, j = idx % NC;
    if (i >= n || j >= n) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = a[q * n + i], y[q] = s.t1[q * NC + j];
    s.qxx[idx] = lxx[i * n + j] + dot_n<NC>(n, x, y);
  } else if (idx < NN + NM) {
    const int e = idx - NN, i = e / NC, j = e % NC;
    if (i >= m || j >= n) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = b[q * m + i], y[q] = s.t1[q * NC + j];
    s.qux[e] = lux[i * n + j] + dot_n<NC>(n, x, y);
  } else if (idx < NN + 2 * NM) {
    const int e = idx - NN - NM, i = e / MC, j = e % MC;
    if (i >= n || j >= m) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = a[q * n + i], y[q] = s.t3[q * MC + j];
    s.quxt[e] = lux[j * n + i] + dot_n<NC>(n, x, y);
  } else {
    const int e = idx - NN - 2 * NM, i = e / MC, j = e % MC;
    if (i >= m || j >= m) return;
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (q < n) x[q] = b[q * m + i], y[q] = s.t3[q * MC + j];
    s.quu[e] = luu[i * m + j] + dot_n<NC>(n, x, y);
  }
}

// Cholesky-Crout of Q_uu + reg I into registers, reading the upper triangle
// (Q_uu is symmetric in exact arithmetic): l[i][j] (j <= i) the lower factor,
// inv[j] = 1 / l[j][j] from rsqrt.
template <int NC, int MC, typename T>
QT_HD void chol_factor(int m, const StepTiles<T, NC, MC>& s, T reg, T (&l)[MC][MC], T (&inv)[MC]) {
  T up[MC][MC];
#pragma unroll
  for (int i = 0; i < MC; ++i)
#pragma unroll
    for (int j = i; j < MC; ++j)
      if (j < m) up[i][j] = s.quu[i * MC + j];
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

// Column c (0 <= c <= n) of [Q_u | Q_ux] into y, then y <- (Q_uu + reg I)^-1 y
// by forward and back substitution through the factor.
template <int NC, int MC, typename T>
QT_HD void chol_solve_column(int c, int m, const StepTiles<T, NC, MC>& s, const T (&l)[MC][MC],
                             const T (&inv)[MC], T (&y)[MC]) {
#pragma unroll
  for (int i = 0; i < MC; ++i)
    if (i < m) y[i] = c == 0 ? s.qu[i] : s.qux[i * NC + (c - 1)];
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

// inner[q] = Q_u[q] - sum_r Q_uu[q][r] g_u[r].
template <int NC, int MC, typename T>
QT_HD void inner_terms(int m, const StepTiles<T, NC, MC>& s, const T (&gu)[MC], T (&inner)[MC]) {
#pragma unroll
  for (int q = 0; q < MC; ++q) {
    if (q < m) {
      T row[MC];
#pragma unroll
      for (int r = 0; r < MC; ++r)
        if (r < m) row[r] = s.quu[q * MC + r];
      inner[q] = s.qu[q] - dot_n<MC>(m, row, gu);
    }
  }
}

// Entries of the value update: [0, NC^2) V_xx'[i][j], then V_x'[j].
template <int NC>
constexpr int kValueEntries = NC * NC + NC;

// The columns of [g_u | G] that entry idx reads: 1 + i and 1 + j (clamped to
// a column that exists, for entries that do nothing).
template <int NC>
QT_HD void value_columns(int idx, int n, int* ci, int* cj) {
  int i = 0, j = 0;
  if (idx < NC * NC) {
    i = idx / NC;
    j = idx % NC;
  } else if (idx < kValueEntries<NC>) {
    i = j = idx - NC * NC;
  }
  *ci = 1 + (i < n ? i : n - 1);
  *cj = 1 + (j < n ? j : n - 1);
}

// Entry idx of the value update into the carry (and into vxx_out / vx_out,
// row-major with the runtime n, unless null): gi, gj are columns 1 + i and
// 1 + j of [g_u | G], gu column 0.
//   V_xx'[i][j] = Q_xx[i][j] - sum_q G[q][i] Q_ux[q][j] - reg sum_q G[q][i] G[q][j]
//   V_x'[j]     = Q_x[j] - sum_q G[q][j] inner[q] - sum_q Q_ux'[j][q] g_u[q]
template <int NC, int MC, typename T>
QT_HD void value_update(int idx, int n, int m, T reg, StepTiles<T, NC, MC>& s, const T (&gi)[MC],
                        const T (&gj)[MC], const T (&gu)[MC], const T (&inner)[MC], T* vx_out,
                        T* vxx_out) {
  if (idx < NC * NC) {
    const int i = idx / NC, j = idx % NC;
    if (i >= n || j >= n) return;
    T acc1 = T(0), acc2 = T(0);
#pragma unroll
    for (int q = 0; q < MC; ++q) {
      if (q < m) {
        acc1 += gi[q] * s.qux[q * NC + j];
        acc2 += gi[q] * gj[q];
      }
    }
    const T v = s.qxx[idx] - acc1 - reg * acc2;
    s.vxx[idx] = v;
    if (vxx_out) vxx_out[i * n + j] = v;
  } else if (idx < kValueEntries<NC>) {
    const int j = idx - NC * NC;
    if (j >= n) return;
    T acc1 = T(0), acc2 = T(0);
#pragma unroll
    for (int q = 0; q < MC; ++q) {
      if (q < m) {
        acc1 += gj[q] * inner[q];
        acc2 += s.quxt[j * MC + q] * gu[q];
      }
    }
    const T v = s.qx[j] - acc1 - acc2;
    s.vx[j] = v;
    if (vx_out) vx_out[j] = v;
  }
}

// The step's instances: exact at the quadrotor's (12, 4) and the cart-pole's
// (4, 1), masked at (kNMax, kMMax) for any other n <= 16, m <= 8. K1 and K4
// both dispatch here, so a K4 lane runs K1's instance.
template <int NC_, int MC_, bool kMasked_>
struct StepShape {
  static constexpr int NC = NC_;
  static constexpr int MC = MC_;
  static constexpr bool kMasked = kMasked_;
};

template <typename F>
auto step_shape(int n, int m, F&& f) {
  if (n == 12 && m == 4) return f(StepShape<12, 4, false>{});
  if (n == 4 && m == 1) return f(StepShape<4, 1, false>{});
  return f(StepShape<kNMax, kMMax, true>{});
}

#if defined(__CUDACC__)

// ---------------------------------------------------------------------------
// Device: stage readers, the ring and the recursion.

// Stage readers: one stage tensor of one trajectory, entry e of step t at
// p[t * step + e * stride] of a stored type S (K1 and K3: contiguous stage
// data of the carry type, stride 1). copy() puts entry e of step t in flight
// into a ring slot (cp.async); view() reads a slot as the carry type.
template <typename T, typename S>
struct Strided;

template <typename T>
struct Strided<T, T> {
  using Word = T;
  using View = SlotView<T>;
  const T* p;
  long long step, stride;
  __device__ __forceinline__ void copy(T* dst, int t, int e) const {
    copy_async(dst, p + (long long)t * step + (long long)e * stride);
  }
  __device__ __forceinline__ View view(const T* slot, int) const { return View{slot}; }
};

template <typename Word, int NC, int MC>
struct StageRing {
  Word w[kRingDepth][stage_capacity(NC, MC)];
};

// cp.async of step t's seven stage tensors into a slot: `threads` issuing
// threads (this one is number `index`) run over the tensors' entries end to
// end, so each issues a few copies.
template <int NC, int MC, typename Reader>
__device__ __forceinline__ void issue_stage(typename Reader::Word* slot, int t, int n, int m,
                                            const Reader (&rd)[kStageTensors], int index, int threads) {
  int g = index, base = 0;
#pragma unroll
  for (int k = 0; k < kStageTensors; ++k) {
    const int count = stage_count(k, n, m);
    for (; g < base + count; g += threads) rd[k].copy(slot + stage_offset(k, NC, MC) + (g - base), t, g - base);
    base += count;
  }
}

// Factor, solve and value update of one step, warp-synchronous (between
// barriers S2 and S3). Warps that own no value entry return at once; the
// others each factor and solve the whole system in registers.
template <typename T, int NC, int MC>
__device__ __forceinline__ void solve_and_update(StepTiles<T, NC, MC>& s, int n, int m, T reg, T* k_out,
                                                 T* bigk_out, T* vx_out, T* vxx_out) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp_base = threadIdx.x - lane;
  if (warp_base >= kValueEntries<NC>) return;

  T l[MC][MC], inv[MC], y[MC];
  chol_factor<NC, MC>(m, s, reg, l, inv);
  chol_solve_column<NC, MC>(lane < n ? lane : n, m, s, l, inv, y);  // lane c <= n: column c
  if (warp_base == 0 && lane <= n) {
#pragma unroll
    for (int i = 0; i < MC; ++i) {
      if (i < m) {
        if (lane == 0)
          k_out[i] = -y[i];
        else
          bigk_out[i * n + (lane - 1)] = -y[i];
      }
    }
  }
  T gu[MC], inner[MC];
#pragma unroll
  for (int q = 0; q < MC; ++q) gu[q] = __shfl_sync(kFull, y[q], 0);
  inner_terms<NC, MC>(m, s, gu, inner);
  for (int base = warp_base; base < kValueEntries<NC>; base += blockDim.x) {
    const int idx = base + lane;
    int ci, cj;
    value_columns<NC>(idx, n, &ci, &cj);
    T gi[MC], gj[MC];
#pragma unroll
    for (int q = 0; q < MC; ++q) {
      gi[q] = __shfl_sync(kFull, y[q], ci);
      gj[q] = __shfl_sync(kFull, y[q], cj);
    }
    value_update<NC, MC>(idx, n, m, reg, s, gi, gj, gu, inner, vx_out, vxx_out);
  }
}

// The whole backward recursion over t = H-1 .. 0 for one CTA (blockDim.x a
// multiple of 32). On entry s.vx / s.vxx hold the terminal value function
// (written by the caller; the prologue's barrier orders them). Writes
// k_out (H, m), bigk_out (H, m, n) and, unless null, vx_out (H, n) and
// vxx_out (H, n, n), row-major with the runtime shape; on exit (after a
// barrier) s.vx / s.vxx hold the value function at step 0.
template <typename T, int NC, int MC, bool kMasked, typename Reader>
__device__ void riccati_pass(StepTiles<T, NC, MC>& s, StageRing<typename Reader::Word, NC, MC>& ring,
                             int H, int n_rt, int m_rt, T reg, const Reader (&rd)[kStageTensors],
                             T* k_out, T* bigk_out, T* vx_out, T* vxx_out) {
  const int n = kMasked ? n_rt : NC;
  const int m = kMasked ? m_rt : MC;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // Warps past those that own value entries refill the ring while the others
  // solve, off the chain; without such warps every thread
  // issues its copies first.
  constexpr int kValueThreads = (kValueEntries<NC> + 31) / 32 * 32;
  const int issue_first = nt >= kValueThreads + 32 ? kValueThreads : 0;
  // Ring: step t lives in slot t % kRingDepth. One commit group per step
  // (empty past step 0), so "step t - 1 has arrived" is always
  // wait_async_groups<kRingDepth - 1>.
#pragma unroll
  for (int j = 0; j < kRingDepth; ++j) {
    if (H - 1 - j >= 0) issue_stage<NC, MC>(ring.w[(H - 1 - j) % kRingDepth], H - 1 - j, n, m, rd, tid, nt);
    commit_async();
  }
  wait_async_groups<kRingDepth - 1>();
  __syncthreads();

  for (int t = H - 1; t >= 0; --t) {
    typename Reader::Word* slot = ring.w[t % kRingDepth];
    typename Reader::View st[kStageTensors];
#pragma unroll
    for (int k = 0; k < kStageTensors; ++k) st[k] = rd[k].view(slot + stage_offset(k, NC, MC), t);

    for (int idx = tid; idx < kFirstEntries<NC, MC>; idx += nt)
      first_product<NC, MC>(idx, n, m, s, st[kA], st[kB], st[kLx], st[kLu]);
    __syncthreads();  // S1
    for (int idx = tid; idx < kQEntries<NC, MC>; idx += nt)
      q_expansion<NC, MC>(idx, n, m, s, st[kA], st[kB], st[kLxx], st[kLuu], st[kLux]);
    __syncthreads();  // S2: the slot of step t is read; refill it with step t - kRingDepth
    if (tid >= issue_first && t - kRingDepth >= 0)
      issue_stage<NC, MC>(slot, t - kRingDepth, n, m, rd, tid - issue_first, nt - issue_first);
    commit_async();
    solve_and_update<T, NC, MC>(s, n, m, reg, k_out + (size_t)t * m, bigk_out + (size_t)t * m * n,
                                vx_out ? vx_out + (size_t)t * n : nullptr,
                                vxx_out ? vxx_out + (size_t)t * n * n : nullptr);
    wait_async_groups<kRingDepth - 1>();  // step t - 1 has arrived
    __syncthreads();  // S3
  }
}

#endif  // __CUDACC__

}  // namespace qt
