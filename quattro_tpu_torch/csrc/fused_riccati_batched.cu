// Batched backward Riccati recursion in one launch (kernel K4).
//
// Replaces the TPU kernels quattro_tpu/ops/fused_riccati.py::
// riccati_backward_batched_fused (column-major, batch on lanes) and
// riccati_backward_batched_fused2d with _fused2d_packed_call (every matrix
// entry a (tile_s, 128) tile of trajectories). Both compute the same function
// for a batch of independent trajectories: per step the Q-expansion, an
// unrolled m x m Cholesky of Q_uu + reg I (rsqrt), the solve for [g_u | G] and
// V_xx' = Q_xx - G'Q_ux - reg G'G; gains k = -g_u, K = -G. Here one kernel
// serves both and runs K1's step (riccati_step.cuh) unchanged, so lane b is
// bit for bit one K1 launch on trajectory b. (The TPU batch2d kernel also
// re-symmetrizes its V_xx carry; in exact arithmetic that changes nothing.)
//
// What bounds it: each trajectory is a chain of H dependent steps of a few
// thousand flops on 12 x 12 tiles; the whole batch is about 170 MB of float32
// stage data at B=2048, H=50 (read once, 0.05 ms at the card's memory rate)
// and about 1.6 GFLOP (0.02 ms at its float32 rate). The time is the chain's
// latency, hidden by running many chains at once. Design: one CTA of 128
// threads per trajectory running riccati_pass of riccati_step.cuh, the step
// K1 and K3 run (dispatched on (n, m) as K1 dispatches, so every lane runs
// K1's instance): the (V_x, V_xx) carry and the step's tiles in shared
// memory, the stage data of the next steps in flight into a shared-memory
// ring by cp.async, three barriers per step; 7.5 KB of shared memory per CTA
// in float32 at (12, 4). 2048 CTAs fill the 132 SMs many deep, so the SMs
// switch between chains while one waits on a barrier. The TPU's lane layouts
// become addressing: a stage tensor is either natural, (B, H, entries), or
// K5's packed layout, (nb * h_pad, entries, tile_s * 128), where entry e of
// trajectory b lies chunk = tile_s * 128 elements from entry e + 1 and the
// first h_pad - H (identity) steps of each block are skipped: they come after
// every real step in the backward recursion and leave the carry unchanged.
// Stage inputs may be stored in bfloat16: the ring holds the 32-bit word of
// each value (cp.async moves at least 4 bytes) and the step widens it at use;
// the carry, the arithmetic and the outputs stay in the carry type. FP32 or
// FP64 FMAs only: no tensor cores, no TF32.
//
// C interface (no PyTorch header; bound with ctypes). Device arrays:
//   stage = host array of 7 device pointers a, b, l_xx, l_uu, l_ux, l_x, l_u
//   (entries n*n, n*m, n*n, m*m, m*n, n, m) in the stored type, natural or
//   packed;
//   v_x_final (B,n), v_xx_final (B,n,n) in the carry type
//   -> k (B,H,m), big_k (B,H,m,n) in the carry type.
// Returns 0 or the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "riccati_step.cuh"

namespace {

using qt::kMMax;
using qt::kNMax;
constexpr int kThreads = 128;
constexpr int kStages = 7;

template <typename S>
struct StagePtrs {
  const S* p[kStages];  // a, b, l_xx, l_uu, l_ux, l_x, l_u
};

struct Layout {
  int packed;  // 0: natural (B, H, e); 1: packed (nb * h_pad, e, chunk)
  int chunk;   // tile_s * 128 (packed only)
  int h_pad;   // padded horizon (packed only)
};

// Offset of entry 0 of step 0 of trajectory b in a stage tensor of e entries
// per step. Step t lies t * e (natural) or t * e * chunk (packed) further on.
__device__ __forceinline__ long long step0_offset(const Layout& l, int H, long long e, int b) {
  if (!l.packed) return (long long)b * H * e;
  const long long blk = b / l.chunk, lane = b % l.chunk;
  return ((blk * l.h_pad + (l.h_pad - H)) * e) * l.chunk + lane;
}

template <typename T, typename S, int NC, int MC, bool kMasked>
__global__ void __launch_bounds__(kThreads) riccati_batched_kernel(
    int B, int H, int n_rt, int m_rt, T reg, Layout layout, StagePtrs<S> stage,
    const T* __restrict__ vxf, const T* __restrict__ vxxf, T* __restrict__ k_out,
    T* __restrict__ bigk_out) {
  using Reader = qt::Strided<T, S>;
  __shared__ qt::StepTiles<T, NC, MC> s;
  __shared__ qt::StageRing<typename Reader::Word, NC, MC> ring;
  const int b = blockIdx.x;
  const int n = kMasked ? n_rt : NC;
  const int m = kMasked ? m_rt : MC;
  const int nn = n * n;
  const int nm = n * m;

  for (int i = threadIdx.x; i < NC * NC; i += blockDim.x) {
    const int r = i / NC, c = i % NC;
    if (r < n && c < n) s.vxx[i] = vxxf[(size_t)b * nn + r * n + c];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.vx[i] = vxf[(size_t)b * n + i];

  // Stage pointers come in the packed order (a, b, l_xx, l_uu, l_ux, l_x,
  // l_u); the step reads them as (a, b, l_x, l_u, l_xx, l_uu, l_ux).
  const int order[qt::kStageTensors] = {0, 1, 5, 6, 2, 3, 4};
  Reader rd[qt::kStageTensors];
#pragma unroll
  for (int k = 0; k < qt::kStageTensors; ++k) {
    const int q = order[k];
    const long long e = qt::stage_count(k, n, m);
    rd[k] = {stage.p[q] + step0_offset(layout, H, e, b), layout.packed ? e * layout.chunk : e,
             layout.packed ? layout.chunk : 1};
  }
  qt::riccati_pass<T, NC, MC, kMasked>(s, ring, H, n, m, reg, rd, k_out + (size_t)b * H * m,
                                       bigk_out + (size_t)b * H * nm, nullptr, nullptr);
}

template <typename T, typename S>
int launch(int B, int H, int n, int m, double reg, Layout layout, const void* const* stage,
           const void* vxf, const void* vxxf, void* k, void* bigk, cudaStream_t stream) {
  StagePtrs<S> ptrs;
  for (int q = 0; q < kStages; ++q) ptrs.p[q] = static_cast<const S*>(stage[q]);
  return qt::step_shape(n, m, [&](auto shape) {
    using Shape = decltype(shape);
    riccati_batched_kernel<T, S, Shape::NC, Shape::MC, Shape::kMasked><<<B, kThreads, 0, stream>>>(
        B, H, n, m, static_cast<T>(reg), layout, ptrs, static_cast<const T*>(vxf),
        static_cast<const T*>(vxxf), static_cast<T*>(k), static_cast<T*>(bigk));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// dtype (the carry and the outputs): 0 = float32, 1 = float64. stored (the
// stage inputs): 0 = as dtype, 2 = bfloat16. packed: 0 = natural layout,
// 1 = packed with chunk = tile_s * 128 and h_pad (B % chunk == 0, h_pad >= H).
extern "C" int qt_fused_riccati_batched(int dtype, int stored, int packed, int B, int H, int n, int m,
                                        int chunk, int h_pad, double reg, const void* const* stage,
                                        const void* vxf, const void* vxxf, void* k, void* bigk,
                                        void* stream) {
  if (n < 1 || n > kNMax || m < 1 || m > kMMax || H < 0 || B < 1 || dtype < 0 || dtype > 1 ||
      (stored != 0 && stored != 2) || (packed && (chunk < 1 || B % chunk || h_pad < H)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout layout{packed, chunk, h_pad};
#define QT_LAUNCH(T, S) launch<T, S>(B, H, n, m, reg, layout, stage, vxf, vxxf, k, bigk, s)
  if (dtype == 0) return stored == 2 ? QT_LAUNCH(float, __nv_bfloat16) : QT_LAUNCH(float, float);
  return stored == 2 ? QT_LAUNCH(double, __nv_bfloat16) : QT_LAUNCH(double, double);
#undef QT_LAUNCH
}
