// Coalesced copies of a contiguous range of device memory into and out of a
// CTA's shared-memory tile (kernels K8 and K9), the groups of copies that
// fill the Riccati stage ring (K1 and K3), and copies of a run-time size
// (K4's and K5's staging where the copy engine does not apply).
//
// All threads of the block take part, neighbouring threads on neighbouring
// values, and the shared-memory side is a functor of the value's index in the
// range, so a kernel can pad its tile (a stride of n + 1 per row against bank
// conflicts) while the device-memory side stays one coalesced stream.
//
// In: cp.async of one value per thread and step (load_tile_async). No
// register holds the value, so every copy of a thread is in flight before it
// waits once: at a short launch (K9 at N = 1,024) the whole tile arrives in
// one memory round trip, where 16-byte loads through registers took several;
// at a long one the copies keep more bytes in flight. On an H100 both K8 and
// K9 ran faster at every timed shape this way than with 16-byte loads
// through registers.
// Out: 16-byte vector stores (float4 / double2) from the tile for the aligned
// body of the range, single stores for the unaligned head and the tail
// (store_tile).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qt {

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int kLanes = 4;
  __device__ static float4 make(const float* p) { return make_float4(p[0], p[1], p[2], p[3]); }
};

template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int kLanes = 2;
  __device__ static double2 make(const double* p) { return make_double2(p[0], p[1]); }
};

// Values before the first 16-byte boundary of src (at most count).
template <typename T>
__device__ inline int head_count(const T* src, int count) {
  const int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / sizeof(T));
  return head < count ? head : count;
}

// dst[e] = load(e) for e in [0, count).
template <typename T, typename Load>
__device__ inline void store_tile(T* __restrict__ dst, int count, Load load) {
  using V = Vec16<T>;
  const int head = head_count(dst, count);
  const int body = (count - head) / V::kLanes;
  const int tail = head + body * V::kLanes;
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = load(e);
  typename V::type* vdst = reinterpret_cast<typename V::type*>(dst + head);
#pragma unroll 4
  for (int v = threadIdx.x; v < body; v += blockDim.x) {
    T parts[V::kLanes];
#pragma unroll
    for (int q = 0; q < V::kLanes; ++q) parts[q] = load(head + v * V::kLanes + q);
    vdst[v] = V::make(parts);
  }
  for (int e = tail + threadIdx.x; e < count; e += blockDim.x) dst[e] = load(e);
}

// Asynchronous copy of one value from device memory into shared memory (cp.async, sm_80 and later). No
// register holds the value, so a thread issues all of its copies and then waits once (wait_async).
template <typename T>
__device__ inline void copy_async(T* dst_shared, const T* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ inline void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// cp.async of 4, 8 or 16 bytes (src and dst aligned to it), the size chosen at run time (K4's and K5's staging).
__device__ inline void copy_async_bytes(int bytes, void* dst_shared, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Groups of copies (the Riccati stage ring, riccati_step.cuh): commit_async closes the thread's copies issued
// since the last commit into one group; wait_async_groups<N> waits until at most N of its groups are in flight.
__device__ inline void commit_async() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void wait_async_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async of src[e] to dst(e) for e in [0, count): neighbouring threads on neighbouring values, so each warp's
// copies are one coalesced 128- (float32) or 256-byte (float64) access. Call wait_async, then __syncthreads.
template <typename T, typename Dst>
__device__ inline void load_tile_async(const T* __restrict__ src, int count, Dst dst) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) copy_async(dst(e), src + e);
}

// Number of streaming multiprocessors of the current device (read once).
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (count < 1) count = 1;
  }
  return count;
}

}  // namespace qt
