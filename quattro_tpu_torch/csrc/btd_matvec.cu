// Symmetric block-tridiagonal matrix-vector product in one launch (kernel K9).
//
// Replaces the TPU kernel quattro_tpu/ops/blocktridiag.py::btd_matvec_pallas:
//   y_t = L_{t-1} x_{t-1} + D_t x_t + L_t^T x_{t+1}
// with diag (N, n, n) = D, lower (N-1, n, n) = L (block (t+1, t) is L_t, block
// (t, t+1) is L_t^T), x (N, n) -> y (N, n). It is the SpMV of the trajectory
// KKT system (ops/blocktridiag.py), which kkt_residual evaluates.
//
// The TPU kernel stacked the three bands host-side into one (N, n, 3n)
// operand, the shifted vectors into (N, 3n), and transposed both into
// structure-of-arrays for its 128-wide lanes; on the card those are extra
// passes over memory. Here one thread computes one output entry (t, i),
// reading D_t's row i, L_{t-1}'s row i and L_t's column i (L_t^T's row i)
// where they lie; N = 1 (no lower blocks) reads no band. The three partial
// sums are added as the plain form adds its three products,
// (D x + lower) + upper. No fast-math.
//
// What bounds it: each of the 3N - 2 blocks is read once (n^2 values) for
// 2 n^2 flops, so the bytes bound it (164 MB at N = 131,072, n = 12, float32:
// 0.05 ms at 3.35 TB/s). The n threads of a block row read n consecutive rows
// of D_t and L_{t-1} (each thread its own row: strided by n) and, for L_t^T,
// consecutive entries of each row of L_t (coalesced across the threads).
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays; N * n is 64-bit. Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads) btd_matvec_kernel(long long num_blocks, int n,
                                                              const T* __restrict__ diag,
                                                              const T* __restrict__ lower,
                                                              const T* __restrict__ x, T* __restrict__ y) {
  const long long entry = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (entry >= num_blocks * n) return;
  const long long t = entry / n;
  const int i = static_cast<int>(entry - t * n);
  const long long nn = (long long)n * n;

  const T* d_row = diag + t * nn + (long long)i * n;
  const T* x_t = x + t * n;
  T acc = T(0);
  for (int j = 0; j < n; ++j) acc = acc + d_row[j] * x_t[j];
  if (t > 0) {  // L_{t-1} x_{t-1}
    const T* l_row = lower + (t - 1) * nn + (long long)i * n;
    const T* x_prev = x + (t - 1) * n;
    T lo = T(0);
    for (int j = 0; j < n; ++j) lo = lo + l_row[j] * x_prev[j];
    acc = acc + lo;
  }
  if (t + 1 < num_blocks) {  // L_t^T x_{t+1}: column i of L_t
    const T* l_col = lower + t * nn + i;
    const T* x_next = x + (t + 1) * n;
    T up = T(0);
    for (int j = 0; j < n; ++j) up = up + l_col[(long long)j * n] * x_next[j];
    acc = acc + up;
  }
  y[entry] = acc;
}

template <typename T>
int launch(long long num_blocks, int n, const void* diag, const void* lower, const void* x, void* y,
           cudaStream_t stream) {
  const long long threads = num_blocks * n;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  btd_matvec_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      num_blocks, n, static_cast<const T*>(diag), static_cast<const T*>(lower), static_cast<const T*>(x),
      static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. num_blocks >= 1, n >= 1; lower may be null when num_blocks = 1.
extern "C" int qt_btd_matvec(int dtype, long long num_blocks, int n, const void* diag, const void* lower,
                             const void* x, void* y, void* stream) {
  if (num_blocks < 1 || n < 1 || dtype < 0 || dtype > 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((num_blocks * n + kThreads - 1) / kThreads > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(num_blocks, n, diag, lower, x, y, s)
                    : launch<double>(num_blocks, n, diag, lower, x, y, s);
}
