// Batched backward Riccati recursion in one launch (kernel K4).
//
// Replaces the TPU kernels quattro_tpu/ops/fused_riccati.py::
// riccati_backward_batched_fused (column-major, batch on lanes) and
// riccati_backward_batched_fused2d with _fused2d_packed_call (every matrix
// entry a (tile_s, 128) tile of trajectories). Both compute the same function
// for a batch of independent trajectories: per step the Q-expansion, an
// unrolled m x m Cholesky of Q_uu + reg I (rsqrt), the solve for [g_u | G] and
// V_xx' = Q_xx - G'Q_ux - reg G'G; gains k = -g_u, K = -G. One kernel serves
// both layouts; lane b is bit for bit one K1 launch on trajectory b. (The TPU
// batch2d kernel also re-symmetrizes its V_xx carry; in exact arithmetic that
// changes nothing.)
//
// What bounds it: each trajectory is a chain of H dependent steps of about
// 7,000 FMAs on 12 x 12 tiles; the whole batch is about 170 MB of float32
// stage data at B=2048, H=50 (read once, 0.05 ms at the card's memory rate)
// and about 1.6 GFLOP (0.02 ms at its float32 rate). Thousands of chains run
// at once, but at B=2048 an SM holds only about 16 of them, 4 per scheduler,
// so the time is one step's latency divided by that overlap. Design:
//   - One compute warp per trajectory, kWarps consecutive trajectories per
//     CTA. The step (riccati_warp.cuh) gives each lane 4 x 2 tiles of
//     outputs, so per term of an inner product a lane loads 6 values (vectors
//     where contiguous) for 8 FMAs, with all of a tile's loads issued before
//     its FMA chains; the phases are separated by __syncwarp, the factor runs
//     in every lane of the trajectory's warp, the columns of [g_u | G] pass by
//     shuffles. No CTA-wide barrier inside the recursion.
//   - One producer warp per CTA keeps a ring of kDepth steps of stage data in
//     shared memory filled, so the compute warps never issue a copy. Its lane
//     0 moves each stage tensor of a step with one TMA instruction: natural
//     layout (B, H, entries), the box entries x 1 step x kWarps trajectories,
//     straight into the ring; packed layout (K5's (nb * h_pad, entries,
//     tile_s * 128)), the box kWarps neighbouring trajectories x entries, into
//     one of two staging slots, two steps ahead, from which the producer's
//     lanes unpack each trajectory's run into the ring, so that the compute
//     warps read every layout alike, four entries per vector load and free of
//     bank conflicts. Tensors the copy engine
//     cannot take (bfloat16 runs that are not whole 16-byte units, a packed
//     bfloat16 box of 8 bytes, unaligned bases) go by cp.async from all 32
//     producer lanes; bfloat16 is copied as stored and widened at use, so a
//     4-byte word carries two values (two entries, or two trajectories in the
//     packed layout), and runs that do not start on a 4-byte boundary are
//     copied as the aligned words that hold them. mbarriers synchronize the
//     ring: a slot's "full" barrier completes when the producer's 32 lanes
//     have arrived and the copy engine's bytes have landed; each compute warp
//     arrives on its "empty" barrier after the step's products, and the
//     producer refills it then. The first h_pad - H (identity) steps of each
//     packed block are skipped: they come after every real step and leave the
//     carry unchanged.
//   - The carry (transposed V_xx, v_x) and the step's tiles stay in shared
//     memory: 38 KB per CTA in float32 at (12, 4) (ring 27 KB; 51 KB with the
//     packed input's staging), so an SM holds 4 or 5 CTAs, 16 or 20
//     trajectories, and B=2048 runs in one wave.
// FP32 or FP64 FMAs only: no tensor cores, no TF32.
//
// C interface (no PyTorch header; bound with ctypes). Device arrays:
//   stage = host array of 7 device pointers a, b, l_xx, l_uu, l_ux, l_x, l_u
//   (entries n*n, n*m, n*n, m*m, m*n, n, m) in the stored type, natural or
//   packed;
//   v_x_final (B,n), v_xx_final (B,n,n) in the carry type
//   -> k (B,H,m), big_k (B,H,m,n) in the carry type.
// Stage bases aligned to their element (bfloat16: to 4 bytes). Returns 0 or
// the cudaError_t of the launch.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked up at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "riccati_warp.cuh"

namespace {

using qt::kMMax;
using qt::kNMax;
constexpr int kWarps = 4;                   // trajectories per CTA, one compute warp each
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kDepth = 4;                   // ring slots: steps of stage data in flight
constexpr int kStages = qt::kStageTensors;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// Entries of stage tensor k (the step's order kA, kB, kLx, kLu, kLxx, kLuu, kLux).
__host__ __device__ constexpr int entries(int k, int n, int m) {
  return k == qt::kA || k == qt::kLxx ? n * n : k == qt::kB || k == qt::kLux ? n * m : k == qt::kLx ? n
                                                                                 : k == qt::kLu ? m : m * m;
}

// A trajectory's part of a natural region when cp.async fills it: the run at
// capacity and 4 bytes of slack (a bfloat16 run copied from its aligned word).
template <int NC, int MC, int SZ>
__host__ __device__ constexpr int natural_part(int k) {
  return round16(entries(k, NC, MC) * SZ + (SZ == 2 ? 4 : 0));
}

// Bytes of tensor k's region in a ring slot, on a 128-byte boundary (a TMA
// destination). Natural: kWarps trajectory parts, each its run of the step
// (the copy engine's box packs them at the run's length, cp.async at
// natural_part). Packed: entry-major, the kWarps trajectories of an entry side
// by side as in device memory.
template <int NC, int MC, int SZ, bool kPacked>
__host__ __device__ constexpr int ring_region(int k) {
  return ((kPacked ? entries(k, NC, MC) * kWarps * SZ : kWarps * natural_part<NC, MC, SZ>(k)) + 127) / 128 * 128;
}

template <int NC, int MC, int SZ, bool kPacked>
struct Ring {
  static constexpr int o1 = ring_region<NC, MC, SZ, kPacked>(0);
  static constexpr int o2 = o1 + ring_region<NC, MC, SZ, kPacked>(1);
  static constexpr int o3 = o2 + ring_region<NC, MC, SZ, kPacked>(2);
  static constexpr int o4 = o3 + ring_region<NC, MC, SZ, kPacked>(3);
  static constexpr int o5 = o4 + ring_region<NC, MC, SZ, kPacked>(4);
  static constexpr int o6 = o5 + ring_region<NC, MC, SZ, kPacked>(5);
  static constexpr int kSlot = o6 + ring_region<NC, MC, SZ, kPacked>(6);
  // Offset of tensor k's region in a slot; k a constant after unrolling.
  __host__ __device__ static constexpr int offset(int k) {
    return k == 0 ? 0 : k == 1 ? o1 : k == 2 ? o2 : k == 3 ? o3 : k == 4 ? o4 : k == 5 ? o5 : o6;
  }
};

// The stage tensors in device memory and how they reach the ring. tma: the
// copy engine moves tensor k of a step in one instruction through maps.m[k]
// (natural: the box entries x 1 step x kWarps trajectories of the (B, H,
// entries) tensor; packed: the box kWarps trajectories x entries of the
// (rows, chunk) tensor). Otherwise cp.async in pieces of 4, 8 or 16 bytes,
// count of them per run (a trajectory's step, or all entries of a packed
// step); packed, 2^shift pieces per entry; natural bfloat16 runs off 4-byte
// boundaries copied as the aligned words that hold them (word; the count then
// depends on the run's first address).
struct Source {
  const unsigned char* p[kStages];  // the step's order
  int tma[kStages];
  int piece[kStages];
  int count[kStages];
  int shift[kStages];
  int word[kStages];
};

struct TensorMaps {
  CUtensorMap m[kStages];
};

struct Layout {
  int chunk;  // tile_s * 128 (packed only)
  int h_pad;  // padded horizon (packed only)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive when this thread's cp.async copies issued so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The barrier's phase also waits for `bytes` more from the copy engine.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA tile copies into shared memory, completing on the barrier.
__device__ __forceinline__ void tma_copy(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_copy(void* dst, const CUtensorMap* map, int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// Bytes between two trajectories' runs of tensor k in a ring slot (the
// natural layout's regions): the run's length where the copy engine or the
// producer's unpacking wrote it, natural_part where cp.async did.
template <typename S, int NC, int MC, bool kPacked>
__device__ __forceinline__ int natural_stride(const Source& src, int k, int e) {
  return kPacked || src.tma[k] ? e * static_cast<int>(sizeof(S)) : natural_part<NC, MC, sizeof(S)>(k);
}

// The packed staging slot ([entry][kWarps] per tensor) into a ring slot
// ([kWarps][entry] per tensor), by the producer warp's lanes: lane i reads
// entry i's kWarps values as one vector and writes them to the trajectories'
// runs, so neighbouring lanes touch neighbouring words on both sides.
template <typename S, int NC, int MC>
__device__ __forceinline__ void unpack(const unsigned char* staging, unsigned char* slot, int n, int m) {
  static_assert(kWarps == 4, "an entry's values are one 4-wide vector");
  struct alignas(4 * sizeof(S)) Entry {
    S v[kWarps];
  };
  using R = Ring<NC, MC, sizeof(S), false>;
  using P = Ring<NC, MC, sizeof(S), true>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    const int e = entries(k, n, m);
    const Entry* from = reinterpret_cast<const Entry*>(staging + P::offset(k));
    S* to = reinterpret_cast<S*>(slot + R::offset(k));
    for (int i = lane; i < e; i += 32) {
      const Entry q = from[i];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) to[w * e + i] = q.v[w];
    }
  }
}

// The producer warp's fill of step t into a slot, then its 32 arrivals on the
// slot's full barrier: lane 0 issues the copy engine's moves; the lanes split
// the cp.async pieces of the other tensors. Natural: trajectories b0 ..
// b0 + live - 1 (the box of a tail CTA reads zeros past B); packed: block
// blk, in-block lanes lane0 .. lane0 + kWarps - 1.
template <typename S, int NC, int MC, bool kPacked>
__device__ __forceinline__ void fill(unsigned char* slot, uint64_t* full, int t, int n, int m, int H,
                                     const Source& src, const TensorMaps& maps, const Layout& layout, int b0,
                                     int live, long long blk, int lane0) {
  using R = Ring<NC, MC, sizeof(S), kPacked>;
  const int lane = threadIdx.x & 31;
  const long long row = blk * layout.h_pad + (layout.h_pad - H) + t;  // packed
  if (lane == 0) {
    unsigned bytes = 0;
#pragma unroll
    for (int k = 0; k < kStages; ++k)
      if (src.tma[k]) bytes += entries(k, n, m) * kWarps * sizeof(S);
    if (bytes) mbar_expect_bytes(full, bytes);
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      if (!src.tma[k]) continue;
      if (kPacked)
        tma_copy(slot + R::offset(k), &maps.m[k], lane0, static_cast<int>(row * entries(k, n, m)), full);
      else
        tma_copy(slot + R::offset(k), &maps.m[k], 0, t, b0, full);
    }
  }
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    if (src.tma[k]) continue;
    const int e = entries(k, n, m), g = src.piece[k];
    if (!kPacked) {
      const long long bytes = (long long)e * sizeof(S);
      for (int w = 0; w < live; ++w) {
        const unsigned char* from = src.p[k] + ((long long)(b0 + w) * H + t) * bytes;
        unsigned char* to = slot + R::offset(k) + w * natural_part<NC, MC, sizeof(S)>(k);
        int count = src.count[k];
        if (sizeof(S) == 2 && src.word[k]) {
          const uintptr_t at = reinterpret_cast<uintptr_t>(from);
          count = static_cast<int>(((at & 2) / 2 + e + 1) / 2);
          from = reinterpret_cast<const unsigned char*>(at & ~uintptr_t(3));
        }
        for (int i = lane; i < count; i += 32) qt::copy_async_bytes(g, to + i * g, from + (long long)i * g);
      }
    } else {
      const unsigned char* from = src.p[k] + (row * e * layout.chunk + lane0) * (long long)sizeof(S);
      const long long entry_bytes = (long long)layout.chunk * sizeof(S);
      unsigned char* to = slot + R::offset(k);
      const int sh = src.shift[k];
      for (int i = lane; i < src.count[k]; i += 32) {
        const int entry = i >> sh, part = i & ((1 << sh) - 1);
        qt::copy_async_bytes(g, to + entry * (kWarps * static_cast<int>(sizeof(S))) + part * g,
                   from + entry * entry_bytes + part * g);
      }
    }
  }
  mbar_arrive_copies(full);
}

template <typename T, int NC, int MC>
__host__ __device__ constexpr int tiles_bytes() {
  return round16(static_cast<int>(sizeof(qt::WarpTiles<T, NC, MC>)));
}

// Shared memory: the ring (natural layout), for the packed input two staging
// slots (packed layout), the compute warps' tiles, the barriers.
template <typename S, int NC, int MC, bool kPacked>
__host__ __device__ constexpr int staging_bytes() {
  return kPacked ? 2 * Ring<NC, MC, sizeof(S), true>::kSlot : 0;
}

template <typename T, typename S, int NC, int MC, bool kPacked>
constexpr int smem_bytes() {
  return kDepth * Ring<NC, MC, sizeof(S), false>::kSlot + staging_bytes<S, NC, MC, kPacked>() +
         kWarps * tiles_bytes<T, NC, MC>() + (2 * kDepth + 2) * 8;
}

// S: the stored type of the stage inputs (T, or uint16_t for bfloat16).
template <typename T, typename S, int NC, int MC, bool kMasked, bool kPacked>
__global__ void __launch_bounds__(kThreads) riccati_batched_kernel(
    int B, int H, int n_rt, int m_rt, T reg, Layout layout, Source src, const __grid_constant__ TensorMaps maps,
    const T* __restrict__ vxf, const T* __restrict__ vxxf, T* __restrict__ k_out, T* __restrict__ bigk_out) {
  using R = Ring<NC, MC, sizeof(S), false>;
  using P = Ring<NC, MC, sizeof(S), true>;
  using W = qt::WarpTiles<T, NC, MC>;
  // Rows of A and B read four at a time as one vector: exact shapes whose row
  // blocks of 4 start on 4-value boundaries of a trajectory's own run.
  constexpr bool kVec4 = !kMasked && NC % 4 == 0 && MC % 4 == 0;
  using Ref = qt::StageRef<T, S, 1, kVec4>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = kMasked ? n_rt : NC;
  const int m = kMasked ? m_rt : MC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kWarps, b = b0 + warp;
  const int live = min(kWarps, B - b0);  // a natural tail CTA; a packed batch fills every CTA
  const long long blk = kPacked ? b0 / layout.chunk : 0;
  const int lane0 = kPacked ? b0 % layout.chunk : 0;
  unsigned char* ring = smem;
  unsigned char* staging = smem + kDepth * R::kSlot;
  unsigned char* tiles = staging + staging_bytes<S, NC, MC, kPacked>();
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kWarps * tiles_bytes<T, NC, MC>());
  uint64_t* empty = full + kDepth;
  uint64_t* staged = empty + kDepth;  // packed: the two staging slots
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) {
      mbar_init(&full[s], 32);      // the producer warp's lanes
      mbar_init(&empty[s], live);  // the compute warps
    }
    for (int s = 0; s < 2; ++s) mbar_init(&staged[s], 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // visible to the copy engine
  }
  __syncthreads();

  // Step t = H - 1 - u is ring fill u, in slot u % kDepth. The producer warp
  // refills a slot once every compute warp has released its previous fill.
  // Natural: straight into the slot. Packed: into staging slot u % 2 two
  // fills ahead, then unpacked into the ring slot (so the compute warps read
  // every layout as a trajectory's own runs).
  if (warp == kWarps) {
    if constexpr (kPacked) {
      for (int u = 0; u < 2 && u < H; ++u)
        fill<S, NC, MC, true>(staging + u * P::kSlot, &staged[u], H - 1 - u, n, m, H, src, maps, layout, b0, live,
                              blk, lane0);
      for (int u = 0; u < H; ++u) {
        const int s = u % kDepth, g = u & 1;
        if (u >= kDepth) mbar_wait(&empty[s], (u / kDepth - 1) & 1);
        mbar_wait(&staged[g], (u >> 1) & 1);
        unpack<S, NC, MC>(staging + g * P::kSlot, ring + s * R::kSlot, n, m);
        mbar_arrive(&full[s]);
        if (u + 2 < H) {
          // This lane's reads of the staging slot come before the copy engine's writes to it.
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          fill<S, NC, MC, true>(staging + g * P::kSlot, &staged[g], H - 3 - u, n, m, H, src, maps, layout, b0, live,
                                blk, lane0);
        }
      }
    } else {
      for (int u = 0; u < H; ++u) {
        const int s = u % kDepth;
        if (u >= kDepth) mbar_wait(&empty[s], (u / kDepth - 1) & 1);
        fill<S, NC, MC, false>(ring + s * R::kSlot, &full[s], H - 1 - u, n, m, H, src, maps, layout, b0, live, blk,
                               lane0);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  if (b >= B) return;

  W& w = *reinterpret_cast<W*>(tiles + warp * tiles_bytes<T, NC, MC>());
  for (int i = lane; i < n * n; i += 32) w.vt[(i % n) * W::RS + i / n] = vxxf[(size_t)b * n * n + i];
  for (int i = lane; i < n; i += 32) w.vt[i * W::RS + NC] = vxf[(size_t)b * n + i];
  __syncwarp();

  T* k_b = k_out + (size_t)b * H * m;
  T* bigk_b = bigk_out + (size_t)b * H * m * n;
  for (int u = 0; u < H; ++u) {
    const int t = H - 1 - u, s = u % kDepth;
    mbar_wait(&full[s], (u / kDepth) & 1);
    const unsigned char* slot = ring + s * R::kSlot;
    Ref st[kStages];
#pragma unroll
    for (int k = 0; k < kStages; ++k) {
      const int e = entries(k, n, m);
      const S* base = reinterpret_cast<const S*>(slot + R::offset(k) + warp * natural_stride<S, NC, MC, kPacked>(src, k, e));
      if (!kPacked && sizeof(S) == 2 && src.word[k])  // the run starts in the high half of its first word
        base += ((reinterpret_cast<uintptr_t>(src.p[k]) >> 1) + ((long long)b * H + t) * e) & 1;
      st[k] = Ref{base};
    }
    for (int tile = lane; tile < W::kFirstTiles; tile += 32)
      qt::first_products_tile<NC, MC, !kMasked>(tile, n, m, w, st[qt::kA], st[qt::kB], st[qt::kLx], st[qt::kLu]);
    __syncwarp();
    for (int tile = lane; tile < W::kQTiles; tile += 32)
      qt::q_expansion_tile<NC, MC, !kMasked>(tile, n, m, w, st[qt::kA], st[qt::kB], st[qt::kLxx], st[qt::kLuu],
                                             st[qt::kLux]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp has read the slot

    // Factor and solve: lane c <= n solves column c of [Q_u | Q_ux].
    T l[MC][MC], inv[MC], y[MC];
    qt::chol_factor_q<NC, MC>(m, w, reg, l, inv);
    qt::chol_solve_column_q<NC, MC>(lane < n ? lane : n, m, w, l, inv, y);
    if (lane <= n) {
#pragma unroll
      for (int i = 0; i < MC; ++i) {
        if (i < m) {
          if (lane == 0)
            k_b[(size_t)t * m + i] = -y[i];
          else
            bigk_b[((size_t)t * m + i) * n + (lane - 1)] = -y[i];
        }
      }
    }
    T gu[MC], inner[MC];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < MC; ++q) gu[q] = __shfl_sync(kFull, y[q], 0);
    qt::inner_terms_q<NC, MC>(m, w, gu, inner);
    for (int base = 0; base < W::kValueTasks; base += 32) {
      const int task = base + lane;
      int cols[6];
      qt::value_task_columns<NC>(task, n, cols);
      T gc[6][MC];
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 6; ++c)
#pragma unroll
        for (int q = 0; q < MC; ++q) gc[c][q] = __shfl_sync(kFull, y[q], cols[c]);
      qt::value_task<NC, MC>(task, n, m, reg, w, gc, gu, inner);
    }
    __syncwarp();
  }
}

template <typename T, typename S, int NC, int MC, bool kMasked, bool kPacked>
int run(int B, int H, int n, int m, T reg, Layout layout, const Source& src, const TensorMaps& maps, const T* vxf,
        const T* vxxf, T* k, T* bigk, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, S, NC, MC, kPacked>();
  auto kernel = riccati_batched_kernel<T, S, NC, MC, kMasked, kPacked>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(B + kWarps - 1) / kWarps, kThreads, smem, stream>>>(B, H, n, m, reg, layout, src, maps, vxf, vxxf, k,
                                                                 bigk);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The copy plan of each stage tensor. The copy engine takes a tensor whose
// base is 16-byte aligned and whose box rows are whole 16-byte units: natural,
// a run of entries * size bytes; packed, kWarps values (float32 and float64,
// not bfloat16). Otherwise cp.async in the widest piece (16, 8, 4 bytes) on
// which every run starts and ends. Stage pointers come in the packed order
// (a, b, l_xx, l_uu, l_ux, l_x, l_u); the step reads (a, b, l_x, l_u, l_xx,
// l_uu, l_ux).
template <typename S>
int plan(int packed, int B, int H, int n, int m, Layout layout, const void* const* stage, Source* src,
         TensorMaps* maps) {
  const int from[kStages] = {0, 1, 5, 6, 2, 3, 4};
  const CUtensorMapDataType type = sizeof(S) == 2   ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                   : sizeof(S) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
  for (int k = 0; k < kStages; ++k) {
    void* base = const_cast<void*>(stage[from[k]]);
    const uintptr_t at = reinterpret_cast<uintptr_t>(base);
    const int e = entries(k, n, m);
    const long long run = packed ? kWarps * (long long)sizeof(S) : e * (long long)sizeof(S);
    int g = 16;
    while (g > 4 && (at % g || run % g)) g /= 2;
    if (at % sizeof(S) || (sizeof(S) == 2 && at % 4)) return static_cast<int>(cudaErrorMisalignedAddress);
    src->p[k] = static_cast<const unsigned char*>(base);
    src->tma[k] = at % 16 == 0 && run % 16 == 0;
    if (src->tma[k]) {
      const EncodeTiled encode = encode_tiled();
      if (!encode) return static_cast<int>(cudaErrorNotSupported);
      const cuuint32_t unit[3] = {1, 1, 1};
      CUresult r;
      if (packed) {
        const cuuint64_t dims[2] = {static_cast<cuuint64_t>(layout.chunk),
                                    static_cast<cuuint64_t>(B / layout.chunk) * layout.h_pad * e};
        const cuuint64_t strides[1] = {static_cast<cuuint64_t>(layout.chunk) * sizeof(S)};
        const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWarps), static_cast<cuuint32_t>(e)};
        r = encode(&maps->m[k], type, 2, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      } else {
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(e), static_cast<cuuint64_t>(H),
                                    static_cast<cuuint64_t>(B)};
        const cuuint64_t strides[2] = {static_cast<cuuint64_t>(run), static_cast<cuuint64_t>(run) * H};
        const cuuint32_t box[3] = {static_cast<cuuint32_t>(e), 1, static_cast<cuuint32_t>(kWarps)};
        r = encode(&maps->m[k], type, 3, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      }
      if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    }
    src->piece[k] = g;
    src->word[k] = (at % g || run % g) ? 1 : 0;  // bfloat16 only: off 4-byte boundaries
    if (src->word[k] && packed) return static_cast<int>(cudaErrorMisalignedAddress);
    int shift = 0;
    while (packed && (g << shift) < run) ++shift;
    src->shift[k] = shift;
    src->count[k] = packed ? e << shift : static_cast<int>(run / g);
  }
  return 0;
}

template <typename T, typename S>
int launch(int packed, int B, int H, int n, int m, double reg, Layout layout, const void* const* stage,
           const void* vxf, const void* vxxf, void* k, void* bigk, cudaStream_t stream) {
  Source src;
  TensorMaps maps{};
  const int status = plan<S>(packed, B, H, n, m, layout, stage, &src, &maps);
  if (status) return status;
  return qt::step_shape(n, m, [&](auto shape) {
    using Shape = decltype(shape);
    auto go = [&](auto layout_kind) {
      return run<T, S, Shape::NC, Shape::MC, Shape::kMasked, decltype(layout_kind)::value>(
          B, H, n, m, static_cast<T>(reg), layout, src, maps, static_cast<const T*>(vxf), static_cast<const T*>(vxxf),
          static_cast<T*>(k), static_cast<T*>(bigk), stream);
    };
    return packed ? go(std::true_type{}) : go(std::false_type{});
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
      (stored != 0 && stored != 2) || (packed && (chunk < 1 || chunk % kWarps || B % chunk || h_pad < H)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout layout{chunk, h_pad};
#define QT_LAUNCH(T, S) launch<T, S>(packed, B, H, n, m, reg, layout, stage, vxf, vxxf, k, bigk, s)
  if (dtype == 0) return stored == 2 ? QT_LAUNCH(float, uint16_t) : QT_LAUNCH(float, float);
  return stored == 2 ? QT_LAUNCH(double, uint16_t) : QT_LAUNCH(double, double);
#undef QT_LAUNCH
}
