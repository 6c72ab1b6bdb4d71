// Cholesky factorize-and-solve of a batch of tiny SPD systems in one launch
// (kernel K8).
//
// Replaces the TPU kernel quattro_tpu/ops/smallchol.py::
// batched_cholesky_solve_pallas: for every system b of the batch,
//   A_b = L L^T (Cholesky-Crout),  L y = B_b,  L^T X_b = y
// with a (B, m, m) SPD, b (B, m, r) -> x (B, m, r). It serves the associative
// Riccati form, which solves l_uu^{-1} [l_u | l_ux | B^T] at every stage
// (r = 1 + 2n) and Q_uu^{-1} [Q_u | Q_ux] for the gains (r = 1 + n), each as
// one launch over all (batch, horizon) systems.
//
// The TPU kernel transposed the batch into structure-of-arrays and padded it
// with identity systems to fill its 128-wide lanes; on the card those would
// be two extra passes over memory. Here one thread solves one system, reading
// a and b in their natural layout; a bounds check replaces the padding.
// m is a template parameter (1..8), so L lives in registers; r is a runtime
// argument and its columns are solved one after the other, as in the TPU
// kernel. The operations and their order are the plain form's
// (ops/smallchol.py::batched_cholesky_solve_plain): sqrt for the diagonal,
// 1/L[j,j] as the column scale, substitutions dividing by L[i,i]. No
// fast-math; nvcc may contract a - b*c into an FMA, which the plain form does
// not, so the two differ by rounding only.
//
// What bounds it: at m=4, r=13 a system is 120 values in and out (480 B in
// float32) for about 1,000 flops, so the bytes bound it (0.15 ms for 2^20
// systems at 3.35 TB/s). A thread reads its own system's 16 + 52 contiguous
// values, so a warp's loads are strided by a whole system and are not
// coalesced; L1 serves the rest of each sector to the later loads of the same
// thread. Staging a tile of systems through shared memory would coalesce them.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays; B is 64-bit. Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 8;

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) cholesky_solve_kernel(long long batch, int r,
                                                                  const T* __restrict__ a,
                                                                  const T* __restrict__ b,
                                                                  T* __restrict__ x) {
  const long long sys = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (sys >= batch) return;
  const T* as = a + sys * (M * M);
  const T* bs = b + sys * ((long long)M * r);
  T* xs = x + sys * ((long long)M * r);

  // Cholesky-Crout, column by column; l[i][j] for j <= i.
  T l[M][M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T diag = as[j * M + j];
#pragma unroll
    for (int k = 0; k < j; ++k) diag = diag - l[j][k] * l[j][k];
    const T ljj = sqrt(diag);
    l[j][j] = ljj;
    const T inv_ljj = T(1) / ljj;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      T off = as[i * M + j];
#pragma unroll
      for (int k = 0; k < j; ++k) off = off - l[i][k] * l[j][k];
      l[i][j] = off * inv_ljj;
    }
  }

  for (int c = 0; c < r; ++c) {
    // Forward: L y = b[:, c].
    T y[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = bs[i * r + c];
#pragma unroll
      for (int t = 0; t < i; ++t) acc = acc - l[i][t] * y[t];
      y[i] = acc / l[i][i];
    }
    // Backward: L^T x = y.
    T v[M];
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      T acc = y[i];
#pragma unroll
      for (int t = i + 1; t < M; ++t) acc = acc - l[t][i] * v[t];
      v[i] = acc / l[i][i];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) xs[i * r + c] = v[i];
  }
}

template <typename T, int M>
int launch(long long batch, int r, const void* a, const void* b, void* x, cudaStream_t stream) {
  const long long blocks = (batch + kThreads - 1) / kThreads;
  cholesky_solve_kernel<T, M><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      batch, r, static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(long long batch, int m, int r, const void* a, const void* b, void* x, cudaStream_t stream) {
  switch (m) {
    case 1: return launch<T, 1>(batch, r, a, b, x, stream);
    case 2: return launch<T, 2>(batch, r, a, b, x, stream);
    case 3: return launch<T, 3>(batch, r, a, b, x, stream);
    case 4: return launch<T, 4>(batch, r, a, b, x, stream);
    case 5: return launch<T, 5>(batch, r, a, b, x, stream);
    case 6: return launch<T, 6>(batch, r, a, b, x, stream);
    case 7: return launch<T, 7>(batch, r, a, b, x, stream);
    case 8: return launch<T, 8>(batch, r, a, b, x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64. 1 <= m <= 8, r >= 1, batch >= 1.
extern "C" int qt_batched_cholesky(int dtype, long long batch, int m, int r, const void* a, const void* b,
                                   void* x, void* stream) {
  if (batch < 1 || m < 1 || m > kMaxM || r < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((batch + kThreads - 1) / kThreads > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(batch, m, r, a, b, x, s) : dispatch<double>(batch, m, r, a, b, x, s);
}
