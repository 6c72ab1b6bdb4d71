// Single-trajectory backward Riccati recursion in one launch (kernel K1).
//
// Replaces the TPU kernel quattro_tpu/ops/fused_riccati.py::
// riccati_backward_fused_single (step law riccati_step_tiles). Same function
// in the same algebraic form: per step the Q-expansion, an unrolled m x m
// Cholesky of Q_uu + reg I (rsqrt), the solve for [g_u | G], and the value
// update V_xx' = Q_xx - G'Q_ux - reg G'G (no explicit symmetrize),
// V_x' = Q_x - G'(Q_u - Q_uu g_u) - Q_ux' g_u; gains k = -g_u, K = -G.
//
// What bounds it: the H steps form one dependency chain, and each step is a
// few thousand flops on 12 x 12 tiles. The data (about 170 KB at H=100,
// n=12, m=4 in f32) is far too small for bandwidth or arithmetic to matter,
// so the time is the chain's latency: H steps times (shared-memory phases +
// barriers). The design keeps the whole recursion in one CTA and one launch,
// with the (V_x, V_xx) carry in shared memory, threads over the output
// entries of each small product, and one thread for the m x m Cholesky.
// FP32 or FP64 FMAs only: no tensor cores, no TF32.
//
// C interface (no PyTorch header; bound with ctypes). All pointers are
// contiguous device arrays of the given dtype:
//   a (H,n,n), b (H,n,m), l_x (H,n), l_u (H,m), l_xx (H,n,n), l_uu (H,m,m),
//   l_ux (H,m,n), v_x_final (n), v_xx_final (n,n)
//   -> k (H,m), big_k (H,m,n), v_x (H+1,n), v_xx (H+1,n,n).
// Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kNMax = 16;
constexpr int kMMax = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) riccati_single_kernel(
    int H, int n, int m, T reg,
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux,
    const T* __restrict__ vxf, const T* __restrict__ vxxf,
    T* __restrict__ k_out, T* __restrict__ bigk_out,
    T* __restrict__ vx_out, T* __restrict__ vxx_out) {
  __shared__ T sA[kNMax * kNMax];
  __shared__ T sB[kNMax * kMMax];
  __shared__ T sVxx[kNMax * kNMax];
  __shared__ T sVx[kNMax];
  __shared__ T t1[kNMax * kNMax];    // V_xx A       (n, n)
  __shared__ T t3[kNMax * kMMax];    // V_xx B       (n, m)
  __shared__ T qxx[kNMax * kNMax];   // (n, n)
  __shared__ T qux[kMMax * kNMax];   // (m, n)
  __shared__ T quxt[kNMax * kMMax];  // (n, m), computed as its own product
  __shared__ T quu[kMMax * kMMax];   // (m, m)
  __shared__ T qx[kNMax];
  __shared__ T qu[kMMax];
  __shared__ T chol[kMMax * kMMax];  // lower factor of Q_uu + reg I
  __shared__ T inv_diag[kMMax];
  __shared__ T sol[kMMax * (kNMax + 1)];  // (m, 1+n) = [g_u | G]
  __shared__ T inner[kMMax];              // Q_u - Q_uu g_u

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nn = n * n;
  const int nm = n * m;
  const int mm = m * m;
  const int w = n + 1;  // row width of sol

  for (int i = tid; i < nn; i += nt) {
    const T v = vxxf[i];
    sVxx[i] = v;
    vxx_out[(size_t)H * nn + i] = v;
  }
  for (int i = tid; i < n; i += nt) {
    const T v = vxf[i];
    sVx[i] = v;
    vx_out[(size_t)H * n + i] = v;
  }

  for (int t = H - 1; t >= 0; --t) {
    const T* at = a + (size_t)t * nn;
    const T* bt = b + (size_t)t * nm;
    for (int i = tid; i < nn; i += nt) sA[i] = at[i];
    for (int i = tid; i < nm; i += nt) sB[i] = bt[i];
    __syncthreads();

    // Phase 1: t1 = V_xx A, t3 = V_xx B, q_x = l_x + A'v_x, q_u = l_u + B'v_x.
    for (int idx = tid; idx < nn + nm + n + m; idx += nt) {
      T acc = T(0);
      if (idx < nn) {
        const int r = idx / n, c = idx % n;
        for (int s = 0; s < n; ++s) acc += sVxx[r * n + s] * sA[s * n + c];
        t1[idx] = acc;
      } else if (idx < nn + nm) {
        const int q = idx - nn, r = q / m, c = q % m;
        for (int s = 0; s < n; ++s) acc += sVxx[r * n + s] * sB[s * m + c];
        t3[q] = acc;
      } else if (idx < nn + nm + n) {
        const int c = idx - nn - nm;
        for (int s = 0; s < n; ++s) acc += sVx[s] * sA[s * n + c];
        qx[c] = lx[(size_t)t * n + c] + acc;
      } else {
        const int c = idx - nn - nm - n;
        for (int s = 0; s < n; ++s) acc += sVx[s] * sB[s * m + c];
        qu[c] = lu[(size_t)t * m + c] + acc;
      }
    }
    __syncthreads();

    // Phase 2: Q_xx = l_xx + A't1, Q_ux = l_ux + B't1, Q_ux' = l_ux' + A't3,
    // Q_uu = l_uu + B't3.
    for (int idx = tid; idx < nn + 2 * nm + mm; idx += nt) {
      T acc = T(0);
      if (idx < nn) {
        const int i = idx / n, j = idx % n;
        for (int s = 0; s < n; ++s) acc += sA[s * n + i] * t1[s * n + j];
        qxx[idx] = lxx[(size_t)t * nn + idx] + acc;
      } else if (idx < nn + nm) {
        const int q = idx - nn, i = q / n, j = q % n;
        for (int s = 0; s < n; ++s) acc += sB[s * m + i] * t1[s * n + j];
        qux[q] = lux[(size_t)t * nm + q] + acc;
      } else if (idx < nn + 2 * nm) {
        const int q = idx - nn - nm, i = q / m, j = q % m;
        for (int s = 0; s < n; ++s) acc += sA[s * n + i] * t3[s * m + j];
        quxt[q] = lux[(size_t)t * nm + j * n + i] + acc;
      } else {
        const int q = idx - nn - 2 * nm, i = q / m, j = q % m;
        for (int s = 0; s < n; ++s) acc += sB[s * m + i] * t3[s * m + j];
        quu[q] = luu[(size_t)t * mm + q] + acc;
      }
    }
    __syncthreads();

    // Phase 3: Cholesky-Crout of Q_uu + reg I, reading the upper triangle as
    // the TPU step law does (Q_uu is symmetric in exact arithmetic).
    if (tid == 0) {
      for (int j = 0; j < m; ++j) {
        T diag = quu[j * m + j] + reg;
        for (int s = 0; s < j; ++s) diag -= chol[j * m + s] * chol[j * m + s];
        const T inv = rsqrt_t(diag);
        chol[j * m + j] = diag * inv;
        inv_diag[j] = inv;
        for (int i2 = j + 1; i2 < m; ++i2) {
          T off = quu[j * m + i2];
          for (int s = 0; s < j; ++s) off -= chol[i2 * m + s] * chol[j * m + s];
          chol[i2 * m + j] = off * inv;
        }
      }
    }
    __syncthreads();

    // Phase 4: forward and back substitution, one thread per column of
    // [Q_u | Q_ux].
    for (int c = tid; c < w; c += nt) {
      T y[kMMax];
      for (int i2 = 0; i2 < m; ++i2) {
        T acc = (c == 0) ? qu[i2] : qux[i2 * n + (c - 1)];
        for (int s = 0; s < i2; ++s) acc -= chol[i2 * m + s] * y[s];
        y[i2] = acc * inv_diag[i2];
      }
      for (int i2 = m - 1; i2 >= 0; --i2) {
        T acc = y[i2];
        for (int s = i2 + 1; s < m; ++s) acc -= chol[s * m + i2] * y[s];
        y[i2] = acc * inv_diag[i2];
      }
      for (int i2 = 0; i2 < m; ++i2) sol[i2 * w + c] = y[i2];
    }
    __syncthreads();

    // Phase 5: gains out, and inner = Q_u - Q_uu g_u.
    for (int idx = tid; idx < m + nm; idx += nt) {
      if (idx < m) {
        T acc = T(0);
        for (int r = 0; r < m; ++r) acc += quu[idx * m + r] * sol[r * w];
        inner[idx] = qu[idx] - acc;
        k_out[(size_t)t * m + idx] = -sol[idx * w];
      } else {
        const int q = idx - m, i = q / n, j = q % n;
        bigk_out[(size_t)t * nm + q] = -sol[i * w + 1 + j];
      }
    }
    __syncthreads();

    // Phase 6: V_xx' = Q_xx - G'Q_ux - reg G'G,  V_x' = Q_x - G' inner - Q_ux' g_u.
    for (int idx = tid; idx < nn + n; idx += nt) {
      T acc1 = T(0), acc2 = T(0);
      if (idx < nn) {
        const int i = idx / n, j = idx % n;
        for (int s = 0; s < m; ++s) {
          const T g_si = sol[s * w + 1 + i];
          acc1 += g_si * qux[s * n + j];
          acc2 += g_si * sol[s * w + 1 + j];
        }
        const T v = qxx[idx] - acc1 - reg * acc2;
        sVxx[idx] = v;
        vxx_out[(size_t)t * nn + idx] = v;
      } else {
        const int j = idx - nn;
        for (int s = 0; s < m; ++s) {
          acc1 += sol[s * w + 1 + j] * inner[s];
          acc2 += quxt[j * m + s] * sol[s * w];
        }
        const T v = qx[j] - acc1 - acc2;
        sVx[j] = v;
        vx_out[(size_t)t * n + j] = v;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(int H, int n, int m, double reg, const void* a, const void* b,
           const void* lx, const void* lu, const void* lxx, const void* luu,
           const void* lux, const void* vxf, const void* vxxf, void* k,
           void* bigk, void* vx, void* vxx, cudaStream_t stream) {
  riccati_single_kernel<T><<<1, kThreads, 0, stream>>>(
      H, n, m, static_cast<T>(reg), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(lx),
      static_cast<const T*>(lu), static_cast<const T*>(lxx),
      static_cast<const T*>(luu), static_cast<const T*>(lux),
      static_cast<const T*>(vxf), static_cast<const T*>(vxxf),
      static_cast<T*>(k), static_cast<T*>(bigk), static_cast<T*>(vx),
      static_cast<T*>(vxx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64.
extern "C" int qt_fused_riccati_single(
    int dtype, int H, int n, int m, double reg, const void* a, const void* b,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* vxf, const void* vxxf, void* k, void* bigk,
    void* vx, void* vxx, void* stream) {
  if (n < 1 || n > kNMax || m < 1 || m > kMMax || H < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(H, n, m, reg, a, b, lx, lu, lxx, luu, lux, vxf, vxxf,
                         k, bigk, vx, vxx, s);
  if (dtype == 1)
    return launch<double>(H, n, m, reg, a, b, lx, lu, lxx, luu, lux, vxf, vxxf,
                          k, bigk, vx, vxx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
