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
// so the time is the chain's latency: H times one step's critical path. The
// design keeps the whole recursion in one CTA and one launch and shortens
// that path (riccati_step.cuh, shared with K3 and K4): compile-time shapes
// for the quadrotor and the cart-pole, the stage data copied into a
// shared-memory ring by cp.async steps ahead of its use, three barriers per
// step, and the factor, the solve and the value update in registers, one
// warp-synchronous phase. V_x and V_xx of each step leave in plain stores
// that nothing waits on. FP32 or FP64 FMAs only: no tensor cores, no TF32.
//
// C interface (no PyTorch header; bound with ctypes). All pointers are
// contiguous device arrays of the given dtype:
//   a (H,n,n), b (H,n,m), l_x (H,n), l_u (H,m), l_xx (H,n,n), l_uu (H,m,m),
//   l_ux (H,m,n), v_x_final (n), v_xx_final (n,n)
//   -> k (H,m), big_k (H,m,n), v_x (H+1,n), v_xx (H+1,n,n).
// Returns 0 or the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "riccati_step.cuh"

namespace {

using qt::kMMax;
using qt::kNMax;
constexpr int kThreads = 256;

template <typename T, int NC, int MC, bool kMasked>
__global__ void __launch_bounds__(kThreads) riccati_single_kernel(
    int H, int n_rt, int m_rt, T reg,
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ lx, const T* __restrict__ lu,
    const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux,
    const T* __restrict__ vxf, const T* __restrict__ vxxf,
    T* __restrict__ k_out, T* __restrict__ bigk_out,
    T* __restrict__ vx_out, T* __restrict__ vxx_out) {
  __shared__ qt::StepTiles<T, NC, MC> s;
  __shared__ qt::StageRing<T, NC, MC> ring;

  const int n = kMasked ? n_rt : NC;
  const int m = kMasked ? m_rt : MC;
  const int nn = n * n;
  for (int i = threadIdx.x; i < NC * NC; i += blockDim.x) {
    const int r = i / NC, c = i % NC;
    if (r < n && c < n) {
      const T v = vxxf[r * n + c];
      s.vxx[i] = v;
      vxx_out[(size_t)H * nn + r * n + c] = v;
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T v = vxf[i];
    s.vx[i] = v;
    vx_out[(size_t)H * n + i] = v;
  }

  const qt::Strided<T, T> rd[qt::kStageTensors] = {
      {a, nn, 1}, {b, n * m, 1}, {lx, n, 1}, {lu, m, 1}, {lxx, nn, 1}, {luu, m * m, 1}, {lux, m * n, 1}};
  qt::riccati_pass<T, NC, MC, kMasked>(s, ring, H, n, m, reg, rd, k_out, bigk_out, vx_out, vxx_out);
}

template <typename T>
int launch(int H, int n, int m, double reg, const void* a, const void* b,
           const void* lx, const void* lu, const void* lxx, const void* luu,
           const void* lux, const void* vxf, const void* vxxf, void* k,
           void* bigk, void* vx, void* vxx, cudaStream_t stream) {
  return qt::step_shape(n, m, [&](auto shape) {
    using Shape = decltype(shape);
    riccati_single_kernel<T, Shape::NC, Shape::MC, Shape::kMasked><<<1, kThreads, 0, stream>>>(
        H, n, m, static_cast<T>(reg), static_cast<const T*>(a),
        static_cast<const T*>(b), static_cast<const T*>(lx),
        static_cast<const T*>(lu), static_cast<const T*>(lxx),
        static_cast<const T*>(luu), static_cast<const T*>(lux),
        static_cast<const T*>(vxf), static_cast<const T*>(vxxf),
        static_cast<T*>(k), static_cast<T*>(bigk), static_cast<T*>(vx),
        static_cast<T*>(vxx));
    return static_cast<int>(cudaGetLastError());
  });
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
