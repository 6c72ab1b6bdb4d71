// Symmetric block-tridiagonal matrix-vector product in one launch (kernel K9),
// and the KKT residual in the same launch.
//
// Replaces the TPU kernel quattro_tpu/ops/blocktridiag.py::btd_matvec_pallas:
//   y_t = L_{t-1} x_{t-1} + D_t x_t + L_t^T x_{t+1}
// with diag (N, n, n) = D, lower (N-1, n, n) = L (block (t+1, t) is L_t, block
// (t, t+1) is L_t^T), x (N, n) -> y (N, n). It is the SpMV of the trajectory
// KKT system (ops/blocktridiag.py). Given rhs (N, n), the same launch returns
// kkt_residual's max_i |y_t,i - rhs_t,i| per block row (N,) instead of y.
//
// The TPU kernel stacked the three bands host-side into one (N, n, 3n)
// operand, the shifted vectors into (N, 3n), and transposed both into
// structure-of-arrays for its 128-wide lanes; on the card those are extra
// passes over memory. Here one CTA takes a tile of T consecutive block rows
// t0 .. t0+T-1. What the tile needs is three contiguous ranges: D_t0..,
// L_{t0-1}.. L_{t0+T-1} and x_{t0-1} .. x_{t0+T}. They are staged into
// shared memory with coalesced asynchronous copies (cp.async, tile_copy.cuh),
// so each band block is read from device memory once (only the L at a tile's
// edge is read by two CTAs), and the rows are padded to a stride of n + 1 so
// that the n threads of a block row reading column j of D_t or L_{t-1} fall
// on distinct banks. Then one thread computes one output entry (t, i) from shared memory,
// adding the three partial sums as the plain form adds its three products,
// (D x + lower) + upper, and writes it coalesced; for the residual, the n
// entries of a block row are reduced in shared memory. No fast-math.
//
// n is a template parameter for the two plants' widths (12: quadrotor, 4:
// cart-pole), so the three dot products unroll; every other width up to
// kMaxTileN takes the runtime-n instantiation. T is chosen per launch: at most a
// 20 KB shared-memory budget and 512 threads, and at most N / (2 x number of
// SMs), so that a short system still spreads over every SM (N = 1,024 at
// n = 12: T = 3, 342 CTAs). The budget and the spread were set by a sweep on
// an H100 (budgets of 10-40 KB, one or two CTAs per SM).
//
// Blocks wider than kMaxTileN (one block row's tile would outgrow shared
// memory) take btd_matvec_rows: one CTA per block row, its threads striding
// over the n entries and reading the rows of D_t and L_{t-1} and the columns of
// L_t from device memory, with the same per-entry arithmetic (row_entry); only
// the residual's reduction uses shared memory (one value per thread). It has
// no width limit and is not tuned: no caller of the port has such blocks.
//
// What bounds it: each of the 2N - 1 blocks is read once (n^2 values) for
// 2 n^2 flops per use, so the bytes bound it (164 MB at N = 131,072, n = 12,
// float32: 0.049 ms at 3.35 TB/s). At the KKT route's N = 1,024 the data is
// 19 KB per SM; launch and one memory round trip are what is left.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays; N * n is 64-bit. Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "tile_copy.cuh"

namespace {

constexpr int kMaxTileN = 64;         // widest tiled block: one block row's tile (about 100 KB in float64) fits
constexpr int kMaxThreads = 512;      // one thread per output entry of the tile
constexpr int kRowThreads = 128;      // btd_matvec_rows: threads per block row (a power of two)
constexpr int kTileBytes = 20 * 1024;  // shared-memory budget that sets T (the last block row may exceed it)
constexpr int kCtasPerSm = 2;          // a short system is cut into at least this many CTAs per SM
constexpr int kDefaultSmem = 48 * 1024;

// Values of shared memory a tile of `tile` block rows takes (D, L, x, residual).
inline long long tile_values(int tile, int n, bool residual) {
  const long long padded = (long long)n * (n + 1);
  return tile * padded + (tile + 1) * padded + (long long)(tile + 2) * n + (residual ? (long long)tile * n : 0);
}

// Entry i of y_t: (D_t x_t + L_{t-1} x_{t-1}) + L_t^T x_{t+1}, each product summed over j in order. d_row and
// l_row are row i of D_t and L_{t-1}, l_col column i of L_t (entries col_stride apart); lo and up say whether
// L_{t-1} and L_t exist.
template <typename T, int NC>
__device__ inline T row_entry(int n_rt, const T* d_row, const T* l_row, const T* l_col, int col_stride,
                              const T* x_prev, const T* x_t, const T* x_next, bool lo, bool up) {
  const int n = NC > 0 ? NC : n_rt;
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < n; ++j) acc = acc + d_row[j] * x_t[j];
  if (lo) {
    T sum = T(0);
#pragma unroll
    for (int j = 0; j < n; ++j) sum = sum + l_row[j] * x_prev[j];
    acc = acc + sum;
  }
  if (up) {
    T sum = T(0);
#pragma unroll
    for (int j = 0; j < n; ++j) sum = sum + l_col[j * col_stride] * x_next[j];
    acc = acc + sum;
  }
  return acc;
}

// The larger of two |y - rhs| values; NaN propagates, as in amax.
template <typename T>
__device__ inline T worse(T a, T b) {
  return (b > a || b != b) ? b : a;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kMaxThreads) btd_matvec_kernel(long long num_blocks, int n_rt, int tile,
                                                                 const T* __restrict__ diag,
                                                                 const T* __restrict__ lower,
                                                                 const T* __restrict__ x,
                                                                 const T* __restrict__ rhs, T* __restrict__ out) {
  const int n = NC > 0 ? NC : n_rt;
  const int stride = n + 1;  // padded row stride of a staged block
  const int block = n * stride;
  const int nn = n * n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* d_s = reinterpret_cast<T*>(smem_raw);  // slot k: D_{t0+k}
  T* l_s = d_s + tile * block;               // slot k: L_{t0-1+k}
  T* x_s = l_s + (tile + 1) * block;         // slot k: x_{t0-1+k}
  T* r_s = x_s + (tile + 2) * n;             // |y - rhs| of the tile's entries (residual only)

  const long long t0 = (long long)blockIdx.x * tile;
  const int rows = static_cast<int>(num_blocks - t0 < tile ? num_blocks - t0 : tile);
  const long long l_lo = t0 > 0 ? t0 - 1 : 0;  // L_t exists for t < N - 1
  const long long l_hi = t0 + rows < num_blocks - 1 ? t0 + rows : num_blocks - 1;
  const long long x_lo = l_lo;
  const long long x_hi = t0 + rows + 1 < num_blocks ? t0 + rows + 1 : num_blocks;
  const int l_slot = static_cast<int>(l_lo - (t0 - 1));
  const int x_slot = l_slot;

  auto padded = [&](T* base, int e) -> T* {
    const int k = e / nn;
    const int rem = e - k * nn;
    const int i = rem / n;
    return base + k * block + i * stride + (rem - i * n);
  };
  qt::load_tile_async(diag + t0 * nn, rows * nn, [&](int e) { return padded(d_s, e); });
  if (l_hi > l_lo)
    qt::load_tile_async(lower + l_lo * nn, static_cast<int>(l_hi - l_lo) * nn,
                        [&](int e) { return padded(l_s + l_slot * block, e); });
  qt::load_tile_async(x + x_lo * n, static_cast<int>(x_hi - x_lo) * n, [&](int e) { return x_s + x_slot * n + e; });
  qt::wait_async();
  __syncthreads();

  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int k = e / n;
    const int i = e - k * n;
    const long long t = t0 + k;
    const T acc = row_entry<T, NC>(n, d_s + k * block + i * stride, l_s + k * block + i * stride,
                                   l_s + (k + 1) * block + i, stride, x_s + k * n, x_s + (k + 1) * n,
                                   x_s + (k + 2) * n, t > 0, t + 1 < num_blocks);
    if (rhs == nullptr) {
      out[t0 * n + e] = acc;
    } else {
      r_s[e] = fabs(acc - rhs[t0 * n + e]);
    }
  }
  if (rhs == nullptr) return;
  __syncthreads();
  for (int k = threadIdx.x; k < rows; k += blockDim.x) {
    T worst = r_s[k * n];
    for (int i = 1; i < n; ++i) worst = worse(worst, r_s[k * n + i]);
    out[t0 + k] = worst;
  }
}

// Blocks wider than kMaxTileN: one CTA per block row t, its threads striding over the entries i, the band read
// from device memory (the threads of a warp read the same x values, and neighbouring columns of L_t).
template <typename T>
__global__ void __launch_bounds__(kRowThreads) btd_matvec_rows(long long num_blocks, int n,
                                                               const T* __restrict__ diag,
                                                               const T* __restrict__ lower,
                                                               const T* __restrict__ x,
                                                               const T* __restrict__ rhs, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long t = blockIdx.x;
  const long long nn = (long long)n * n;
  const bool lo = t > 0, up = t + 1 < num_blocks;
  const T* l_prev = lo ? lower + (t - 1) * nn : lower;
  const T* l_next = up ? lower + t * nn : lower;
  const T* x_t = x + t * n;
  T worst = T(0);  // |y - rhs| >= 0
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T acc = row_entry<T, 0>(n, diag + t * nn + (long long)i * n, l_prev + (long long)i * n, l_next + i, n,
                                  lo ? x_t - n : x_t, x_t, up ? x_t + n : x_t, lo, up);
    if (rhs == nullptr) {
      out[t * n + i] = acc;
    } else {
      worst = worse(worst, fabs(acc - rhs[t * n + i]));
    }
  }
  if (rhs == nullptr) return;
  T* w_s = reinterpret_cast<T*>(smem_raw);
  w_s[threadIdx.x] = worst;
  __syncthreads();
  for (unsigned half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) w_s[threadIdx.x] = worse(w_s[threadIdx.x], w_s[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[t] = w_s[0];
}

// Block rows per CTA: as many as the shared-memory budget and 512 threads hold, and at most N / (number of
// SMs), so that a short system still spreads over every SM; one for the blocks of btd_matvec_rows.
inline long long tile_rows(int value_bytes, long long num_blocks, int n, bool residual) {
  if (n > kMaxTileN) return 1;  // btd_matvec_rows
  const long long per_row = tile_values(1, n, residual) - tile_values(0, n, residual);
  long long tile = kTileBytes / (per_row * value_bytes);
  if (tile > kMaxThreads / n) tile = kMaxThreads / n;
  const long long spread = num_blocks / (qt::sm_count() * kCtasPerSm);
  if (tile > spread) tile = spread;
  return tile < 1 ? 1 : tile;
}

template <typename T, int NC>
int launch(long long num_blocks, int n, const void* diag, const void* lower, const void* x, const void* rhs,
           void* out, cudaStream_t stream) {
  const bool residual = rhs != nullptr;
  const long long tile = tile_rows(sizeof(T), num_blocks, n, residual);
  const long long grid = (num_blocks + tile - 1) / tile;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = static_cast<int>((tile * n + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(tile_values(static_cast<int>(tile), n, residual)) * sizeof(T);
  auto kernel = btd_matvec_kernel<T, NC>;
  if (smem > kDefaultSmem) {
    const cudaError_t status =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      num_blocks, n, static_cast<int>(tile), static_cast<const T*>(diag), static_cast<const T*>(lower),
      static_cast<const T*>(x), static_cast<const T*>(rhs), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(long long num_blocks, int n, const void* diag, const void* lower, const void* x, const void* rhs,
                void* out, cudaStream_t stream) {
  if (num_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  btd_matvec_rows<T><<<static_cast<unsigned>(num_blocks), kRowThreads, rhs ? kRowThreads * sizeof(T) : 0, stream>>>(
      num_blocks, n, static_cast<const T*>(diag), static_cast<const T*>(lower), static_cast<const T*>(x),
      static_cast<const T*>(rhs), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(long long num_blocks, int n, const void* diag, const void* lower, const void* x, const void* rhs,
             void* out, cudaStream_t stream) {
  if (n > kMaxTileN) return launch_rows<T>(num_blocks, n, diag, lower, x, rhs, out, stream);
  switch (n) {
    case 12: return launch<T, 12>(num_blocks, n, diag, lower, x, rhs, out, stream);
    case 4: return launch<T, 4>(num_blocks, n, diag, lower, x, rhs, out, stream);
    default: return launch<T, 0>(num_blocks, n, diag, lower, x, rhs, out, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64. num_blocks >= 1, n >= 1; lower may be null when num_blocks = 1.
// rhs null: out is y (N, n). rhs (N, n): out is the residual (N,).
extern "C" int qt_btd_matvec(int dtype, long long num_blocks, int n, const void* diag, const void* lower,
                             const void* x, const void* rhs, void* out, void* stream) {
  if (num_blocks < 1 || n < 1 || dtype < 0 || dtype > 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(num_blocks, n, diag, lower, x, rhs, out, s)
                    : dispatch<double>(num_blocks, n, diag, lower, x, rhs, out, s);
}

// The number of block rows T one CTA takes for this launch (the tile edges the card tests probe).
extern "C" int qt_btd_matvec_tile(int dtype, long long num_blocks, int n, int residual) {
  if (num_blocks < 1 || n < 1 || dtype < 0 || dtype > 1) return -1;
  return static_cast<int>(tile_rows(dtype == 0 ? sizeof(float) : sizeof(double), num_blocks, n, residual != 0));
}
