// One backward Riccati step for a whole CTA, shared by the single-trajectory
// backward pass (fused_riccati_single.cu), the whole-solve kernel
// (fused_solve.cu) and the batched backward pass (fused_riccati_batched.cu),
// as riccati_step_tiles is shared by their TPU originals
// (quattro_tpu/ops/fused_riccati.py).
//
// Per step: the Q-expansion, an unrolled m x m Cholesky of Q_uu + reg I
// (rsqrt), the solve for [g_u | G], and the value update
// V_xx' = Q_xx - G'Q_ux - reg G'G (no explicit symmetrize),
// V_x' = Q_x - G'(Q_u - Q_uu g_u) - Q_ux' g_u; gains k = -g_u, K = -G.
// Threads run over the output entries of each small product, one thread does
// the Cholesky, one thread per right-hand-side column the substitutions; six
// barriers per step. FP32 or FP64 FMAs only: no tensor cores, no TF32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace qt {

constexpr int kNMax = 16;
constexpr int kMMax = 8;

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

// Stage readers: entry e of one stage tensor in the carry type T. K1 and K3
// pass plain pointers to contiguous stage data of the carry type (p[e]); K4
// passes Strided, which reads p[e * stride] of a stored type S, so one step
// law serves the packed layout (stride tile_s * 128) and bf16 stage inputs,
// which are widened exactly at load.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, typename S>
struct Strided {
  const S* p;
  long long stride;
  __device__ __forceinline__ T operator[](int e) const {
    return static_cast<T>(widen(p[(long long)e * stride]));
  }
};

// Shared-memory state of the recursion: the (V_x, V_xx) carry and one step's
// intermediates. Declare one per CTA as __shared__.
template <typename T>
struct RiccatiScratch {
  T a[kNMax * kNMax];
  T b[kNMax * kMMax];
  T vxx[kNMax * kNMax];  // carry
  T vx[kNMax];           // carry
  T t1[kNMax * kNMax];   // V_xx A       (n, n)
  T t3[kNMax * kMMax];   // V_xx B       (n, m)
  T qxx[kNMax * kNMax];  // (n, n)
  T qux[kMMax * kNMax];  // (m, n)
  T quxt[kNMax * kMMax]; // (n, m), computed as its own product
  T quu[kMMax * kMMax];  // (m, m)
  T qx[kNMax];
  T qu[kMMax];
  T chol[kMMax * kMMax];  // lower factor of Q_uu + reg I
  T inv_diag[kMMax];
  T sol[kMMax * (kNMax + 1)];  // (m, 1+n) = [g_u | G]
  T inner[kMMax];              // Q_u - Q_uu g_u
};

// On entry s.vx / s.vxx hold the value function after this step (written by
// all threads before a barrier or by the previous call); on exit they hold
// the value function at this step. at (n,n), bt (n,m), lx (n), lu (m),
// lxx (n,n), luu (m,m), lux (m,n) are readers of this step's stage data in
// global memory (row-major entries); k_out (m) and bigk_out (m,n) receive
// the gains; vx_out (n) and vxx_out (n,n) receive the value function unless
// null. Ends with a barrier.
template <typename T, typename In>
__device__ __forceinline__ void riccati_step(RiccatiScratch<T>& s, int n, int m, T reg, In at, In bt,
                                             In lx, In lu, In lxx, In luu, In lux, T* k_out,
                                             T* bigk_out, T* vx_out, T* vxx_out) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nn = n * n;
  const int nm = n * m;
  const int mm = m * m;
  const int w = n + 1;  // row width of sol

  for (int i = tid; i < nn; i += nt) s.a[i] = at[i];
  for (int i = tid; i < nm; i += nt) s.b[i] = bt[i];
  __syncthreads();

  // Phase 1: t1 = V_xx A, t3 = V_xx B, q_x = l_x + A'v_x, q_u = l_u + B'v_x.
  for (int idx = tid; idx < nn + nm + n + m; idx += nt) {
    T acc = T(0);
    if (idx < nn) {
      const int r = idx / n, c = idx % n;
      for (int q = 0; q < n; ++q) acc += s.vxx[r * n + q] * s.a[q * n + c];
      s.t1[idx] = acc;
    } else if (idx < nn + nm) {
      const int e = idx - nn, r = e / m, c = e % m;
      for (int q = 0; q < n; ++q) acc += s.vxx[r * n + q] * s.b[q * m + c];
      s.t3[e] = acc;
    } else if (idx < nn + nm + n) {
      const int c = idx - nn - nm;
      for (int q = 0; q < n; ++q) acc += s.vx[q] * s.a[q * n + c];
      s.qx[c] = lx[c] + acc;
    } else {
      const int c = idx - nn - nm - n;
      for (int q = 0; q < n; ++q) acc += s.vx[q] * s.b[q * m + c];
      s.qu[c] = lu[c] + acc;
    }
  }
  __syncthreads();

  // Phase 2: Q_xx = l_xx + A't1, Q_ux = l_ux + B't1, Q_ux' = l_ux' + A't3,
  // Q_uu = l_uu + B't3.
  for (int idx = tid; idx < nn + 2 * nm + mm; idx += nt) {
    T acc = T(0);
    if (idx < nn) {
      const int i = idx / n, j = idx % n;
      for (int q = 0; q < n; ++q) acc += s.a[q * n + i] * s.t1[q * n + j];
      s.qxx[idx] = lxx[idx] + acc;
    } else if (idx < nn + nm) {
      const int e = idx - nn, i = e / n, j = e % n;
      for (int q = 0; q < n; ++q) acc += s.b[q * m + i] * s.t1[q * n + j];
      s.qux[e] = lux[e] + acc;
    } else if (idx < nn + 2 * nm) {
      const int e = idx - nn - nm, i = e / m, j = e % m;
      for (int q = 0; q < n; ++q) acc += s.a[q * n + i] * s.t3[q * m + j];
      s.quxt[e] = lux[j * n + i] + acc;
    } else {
      const int e = idx - nn - 2 * nm, i = e / m, j = e % m;
      for (int q = 0; q < n; ++q) acc += s.b[q * m + i] * s.t3[q * m + j];
      s.quu[e] = luu[e] + acc;
    }
  }
  __syncthreads();

  // Phase 3: Cholesky-Crout of Q_uu + reg I, reading the upper triangle as
  // the TPU step law does (Q_uu is symmetric in exact arithmetic).
  if (tid == 0) {
    for (int j = 0; j < m; ++j) {
      T diag = s.quu[j * m + j] + reg;
      for (int q = 0; q < j; ++q) diag -= s.chol[j * m + q] * s.chol[j * m + q];
      const T inv = rsqrt_t(diag);
      s.chol[j * m + j] = diag * inv;
      s.inv_diag[j] = inv;
      for (int i2 = j + 1; i2 < m; ++i2) {
        T off = s.quu[j * m + i2];
        for (int q = 0; q < j; ++q) off -= s.chol[i2 * m + q] * s.chol[j * m + q];
        s.chol[i2 * m + j] = off * inv;
      }
    }
  }
  __syncthreads();

  // Phase 4: forward and back substitution, one thread per column of
  // [Q_u | Q_ux].
  for (int c = tid; c < w; c += nt) {
    T y[kMMax];
    for (int i2 = 0; i2 < m; ++i2) {
      T acc = (c == 0) ? s.qu[i2] : s.qux[i2 * n + (c - 1)];
      for (int q = 0; q < i2; ++q) acc -= s.chol[i2 * m + q] * y[q];
      y[i2] = acc * s.inv_diag[i2];
    }
    for (int i2 = m - 1; i2 >= 0; --i2) {
      T acc = y[i2];
      for (int q = i2 + 1; q < m; ++q) acc -= s.chol[q * m + i2] * y[q];
      y[i2] = acc * s.inv_diag[i2];
    }
    for (int i2 = 0; i2 < m; ++i2) s.sol[i2 * w + c] = y[i2];
  }
  __syncthreads();

  // Phase 5: gains out, and inner = Q_u - Q_uu g_u.
  for (int idx = tid; idx < m + nm; idx += nt) {
    if (idx < m) {
      T acc = T(0);
      for (int r = 0; r < m; ++r) acc += s.quu[idx * m + r] * s.sol[r * w];
      s.inner[idx] = s.qu[idx] - acc;
      k_out[idx] = -s.sol[idx * w];
    } else {
      const int e = idx - m, i = e / n, j = e % n;
      bigk_out[e] = -s.sol[i * w + 1 + j];
    }
  }
  __syncthreads();

  // Phase 6: V_xx' = Q_xx - G'Q_ux - reg G'G,  V_x' = Q_x - G' inner - Q_ux' g_u.
  for (int idx = tid; idx < nn + n; idx += nt) {
    T acc1 = T(0), acc2 = T(0);
    if (idx < nn) {
      const int i = idx / n, j = idx % n;
      for (int q = 0; q < m; ++q) {
        const T g_qi = s.sol[q * w + 1 + i];
        acc1 += g_qi * s.qux[q * n + j];
        acc2 += g_qi * s.sol[q * w + 1 + j];
      }
      const T v = s.qxx[idx] - acc1 - reg * acc2;
      s.vxx[idx] = v;
      if (vxx_out) vxx_out[idx] = v;
    } else {
      const int j = idx - nn;
      for (int q = 0; q < m; ++q) {
        acc1 += s.sol[q * w + 1 + j] * s.inner[q];
        acc2 += s.quxt[j * m + q] * s.sol[q * w];
      }
      const T v = s.qx[j] - acc1 - acc2;
      s.vx[j] = v;
      if (vx_out) vx_out[j] = v;
    }
  }
  __syncthreads();
}

}  // namespace qt
