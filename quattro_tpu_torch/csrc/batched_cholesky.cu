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
// be two extra passes over memory. Here one CTA takes a tile of S
// consecutive systems, whose a (S m^2 values) and b (S m r values) are two
// contiguous ranges: both are staged into shared memory with coalesced
// asynchronous copies (cp.async, tile_copy.cuh), a padded to a stride of
// m^2 + 1 per system; the ragged last tile copies what it has. One thread
// per system factors its a into L in place. Then the threads walk the tile's
// (system, column) pairs in memory order: a thread solves column c of system
// s, forward then back substitution, reading L (shared by the threads of one
// system) and overwriting its own column of b, which nothing else touches.
// The tile of x leaves in coalesced 16-byte stores. S is what a 16 KB
// shared-memory budget holds, at most 64 systems (m = 4, r = 25 in float32:
// 32 systems, 15 KB; r = 13: 56), set by a sweep on an H100 (budgets of
// 8-32 KB, 64-256 threads). m is a template parameter (1..8); r is a runtime
// argument; b wider than kMaxTileR (2,048 columns) takes cholesky_solve_columns,
// with the same factor and solve functions. The operations and their order are the
// plain form's (ops/smallchol.py::batched_cholesky_solve_plain): sqrt for
// the diagonal, 1/L[j,j] as the column scale, substitutions dividing by
// L[i,i]. No fast-math; nvcc may contract a - b*c into an FMA, which the
// plain form does not, so the two differ by rounding only.
//
// What bounds it: at m=4, r=13 a system is 120 values in and out (480 B in
// float32) for about 1,000 flops, so the bytes bound it (0.15 ms for 2^20
// systems at 3.35 TB/s). The earlier design (one thread per system, reading
// and writing its own columns in device memory) made each warp access touch
// 32 systems 4 m r bytes apart and reached 3 % of that.
//
// C interface (no PyTorch header; bound with ctypes). Contiguous device
// arrays; B is 64-bit. Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "tile_copy.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 8;
constexpr int kMaxTileR = 2048;  // widest tiled b: one system of m = 8 in float64 (132 KB) fits in shared memory
constexpr int kTileSystems = 64;       // at most one system per thread in the factor phase
constexpr int kTileBytes = 16 * 1024;  // shared-memory budget that sets S
constexpr int kDefaultSmem = 48 * 1024;

// Cholesky-Crout of one system, column by column: l[i][j] (j <= i) from a(i, j).
template <typename T, int M, typename A>
__device__ inline void factor(A a, T (&l)[M][M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T diag = a(j, j);
#pragma unroll
    for (int k = 0; k < j; ++k) diag = diag - l[j][k] * l[j][k];
    const T ljj = sqrt(diag);
    l[j][j] = ljj;
    const T inv_ljj = T(1) / ljj;
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      T off = a(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) off = off - l[i][k] * l[j][k];
      l[i][j] = off * inv_ljj;
    }
  }
}

// One right-hand side: L y = b (forward), then L^T x = y (back), dividing by L[i][i]. All of b is read before
// x is written, so x may overwrite b.
template <typename T, int M, typename L, typename B, typename X>
__device__ inline void solve_column(L l, B b, X x) {
  T y[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = b(i);
#pragma unroll
    for (int t = 0; t < i; ++t) acc = acc - l(i, t) * y[t];
    y[i] = acc / l(i, i);
  }
  T v[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int t = i + 1; t < M; ++t) acc = acc - l(t, i) * v[t];
    v[i] = acc / l(i, i);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) x(i, v[i]);
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) cholesky_solve_kernel(long long batch, int r, int tile,
                                                                  const T* __restrict__ a,
                                                                  const T* __restrict__ b,
                                                                  T* __restrict__ x) {
  constexpr int kMM = M * M;
  constexpr int kStride = kMM + 1;  // padded per-system stride of a / L
  const int mr = M * r;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b_s = reinterpret_cast<T*>(smem_raw);  // the tile's b, then x in place
  T* a_s = b_s + tile * mr;                  // the tile's a, then L in place (lower triangle)

  const long long s0 = (long long)blockIdx.x * tile;
  const int count = static_cast<int>(batch - s0 < tile ? batch - s0 : tile);
  qt::load_tile_async(a + s0 * kMM, count * kMM, [&](int e) { return a_s + e + e / kMM; });
  qt::load_tile_async(b + s0 * mr, count * mr, [&](int e) { return b_s + e; });
  qt::wait_async();
  __syncthreads();

  for (int s = threadIdx.x; s < count; s += blockDim.x) {
    T* as = a_s + s * kStride;
    T l[M][M];
    factor<T, M>([&](int i, int j) { return as[i * M + j]; }, l);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) as[i * M + j] = l[i][j];
  }
  __syncthreads();

  for (int p = threadIdx.x; p < count * r; p += blockDim.x) {
    const int s = p / r;
    const T* ls = a_s + s * kStride;
    T* col = b_s + s * mr + (p - s * r);  // column c of system s, entries r apart
    solve_column<T, M>([&](int i, int j) { return ls[i * M + j]; }, [&](int i) { return col[i * r]; },
                       [&](int i, T v) { col[i * r] = v; });
  }
  __syncthreads();
  qt::store_tile(x + s0 * mr, count * mr, [&](int e) { return b_s[e]; });
}

// b wider than kMaxTileR: one CTA per chunk of kThreads columns of one system, a thread per column. Every
// thread factors the system's a into registers (the threads of a warp read the same values) and solves its
// column, read and written in device memory (neighbouring threads on neighbouring columns). No shared memory,
// so r has no limit; not tuned, since no caller of the port solves such wide systems.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) cholesky_solve_columns(long long chunks, int r,
                                                                   const T* __restrict__ a,
                                                                   const T* __restrict__ b,
                                                                   T* __restrict__ x) {
  const long long s = blockIdx.x / chunks;
  const long long c = (blockIdx.x - s * chunks) * kThreads + threadIdx.x;
  if (c >= r) return;
  const T* as = a + s * (M * M);
  T l[M][M];
  factor<T, M>([&](int i, int j) { return as[i * M + j]; }, l);
  const T* bs = b + s * M * r + c;
  T* xs = x + s * M * r + c;
  solve_column<T, M>([&](int i, int j) { return l[i][j]; }, [&](int i) { return bs[(long long)i * r]; },
                     [&](int i, T v) { xs[(long long)i * r] = v; });
}

// Values of shared memory one system takes: b (then x) and a (then L), padded.
inline long long system_values(int m, int r) { return (long long)m * r + m * m + 1; }

// Systems per CTA: as many as the shared-memory budget holds, at most one per thread, a multiple of 4; one
// for cholesky_solve_columns.
inline long long tile_systems(int value_bytes, int m, int r) {
  if (r > kMaxTileR) return 1;
  long long tile = kTileBytes / (system_values(m, r) * value_bytes);
  if (tile > kTileSystems) tile = kTileSystems;
  if (tile > 4) tile -= tile % 4;
  return tile < 1 ? 1 : tile;
}

template <typename T, int M>
int launch(long long batch, int r, const void* a, const void* b, void* x, cudaStream_t stream) {
  if (r > kMaxTileR) {
    const long long chunks = (r + kThreads - 1) / kThreads;
    if (batch > 0x7fffffffLL / chunks) return static_cast<int>(cudaErrorInvalidValue);
    cholesky_solve_columns<T, M><<<static_cast<unsigned>(batch * chunks), kThreads, 0, stream>>>(
        chunks, r, static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x));
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_system = system_values(M, r);
  const long long tile = tile_systems(sizeof(T), M, r);
  const long long grid = (batch + tile - 1) / tile;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile * per_system) * sizeof(T);
  auto kernel = cholesky_solve_kernel<T, M>;
  if (smem > kDefaultSmem) {
    const cudaError_t status =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      batch, r, static_cast<int>(tile), static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x));
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(batch, m, r, a, b, x, s) : dispatch<double>(batch, m, r, a, b, x, s);
}

// The number of systems S one CTA takes at these widths (the tile edges the card tests probe).
extern "C" int qt_batched_cholesky_tile(int dtype, int m, int r) {
  if (m < 1 || m > kMaxM || r < 1 || dtype < 0 || dtype > 1) return -1;
  return static_cast<int>(tile_systems(dtype == 0 ? sizeof(float) : sizeof(double), m, r));
}
