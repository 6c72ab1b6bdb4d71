// One closed-loop rollout of an in-repo plant, run by a group of G lanes:
// the body shared by the all-alpha rollout kernels (fused_rollout_single.cu,
// K2, and fused_rollout_batched.cu, K6/K7), so that each candidate of the
// batched kernel computes exactly what K2 computes for that trajectory:
//   u_t = u_ref_t + alpha (k_t + K_t (x_t - x_ref_t)),  x_{t+1} = f(x_t, u_t)
// with f the plant's Euler or RK4 step.
//
// What bounds one rollout is its chain: per RK4 step four evaluations of the
// vector field, each (for the quadrotor) three sincos, a tan and an IEEE
// division, and before them the feedback product. One thread per candidate
// runs every one of those serially (clock64 stamps on an H100, float32: a
// quadrotor field evaluation about 1,100 cycles, the step's loads from device
// memory about 900). A group of G lanes per candidate (G a compile-time
// constant per plant) shortens it:
//   - lane r of the group owns E = N / G state entries, does their RK4 stage
//     updates and its share of the feedback product; the partial sums are
//     combined by __shfl_xor_sync, so every lane of the group holds the same u;
//   - the quadrotor's independent transcendental work is spread over its four
//     lanes: the three lanes that own roll, pitch and yaw take sincos (and tan)
//     of their angle, and once per step lane r divides thrust by the mass
//     (r = 0) or torque r by its inertia (u is held over the step, so these do
//     not change between stages). The values each field entry needs reach
//     its owning lane by __shfl_sync(..., width = G);
//   - the cart-pole (one angle, a chain of divisions) keeps G = 1: its lane
//     runs plants.cuh's discrete_step.
// The parts below are QT_HD functions of one lane, so a host build can run a
// group lane after lane with arrays in place of the shuffles
// (rollout_group_host.cpp); the device side and the kernel follow under
// __CUDACC__. plants.cuh's field and discrete_step are not changed: K3, K5 and
// the host derivatives use them. No fast-math: sin, cos, tan and the
// divisions keep full accuracy.

#pragma once

#include "plants.cuh"

namespace qt {

QT_HD void sincos_t(float v, float* s, float* c) { sincosf(v, s, c); }
QT_HD void sincos_t(double v, double* s, double* c) { sincos(v, s, c); }

// Lane `role`'s share of the feedback product K_t (x - x_ref_t): for every
// control j the sum over its E entries (state index Grp::entry(role, e)), in
// entry order. k_rows is K_t (M, N).
template <typename T, typename Grp>
QT_HD void feedback_partials(int role, const T* x, const T* x_ref_row, const T* k_rows, T* p) {
#pragma unroll
  for (int j = 0; j < Grp::M; ++j) {
    T acc = T(0);
#pragma unroll
    for (int e = 0; e < Grp::E; ++e) {
      const int i = Grp::entry(role, e);
      acc += (x[e] - x_ref_row[i]) * k_rows[j * Grp::N + i];
    }
    p[j] = acc;
  }
}

template <typename T>
QT_HD T feedback_control(T u_ref, T k, T alpha, T product) {
  return u_ref + alpha * (k + product);
}

// RK4 (with zero-order-hold control) on a lane's own entries, in discrete_step's
// order: after the field of stage s gave k, update the sum acc and the next
// stage's input xt, or (s = 3) the state x.
template <typename T, int E>
QT_HD void rk4_after_stage(int s, const StepSizes<T>& h, T* x, T* acc, const T* k, T* xt) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (s == 0) {
      acc[e] = k[e];
      xt[e] = x[e] + h.half_dt * k[e];
    } else if (s == 1) {
      acc[e] = acc[e] + T(2) * k[e];
      xt[e] = x[e] + h.half_dt * k[e];
    } else if (s == 2) {
      acc[e] = acc[e] + T(2) * k[e];
      xt[e] = x[e] + h.dt * k[e];
    } else {
      x[e] = x[e] + h.sixth_dt * (acc[e] + k[e]);
    }
  }
}

template <typename T, int E>
QT_HD void euler_update(const StepSizes<T>& h, T* x, const T* k) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = x[e] + h.dt * k[e];
}

// The quotients of one step, held by every lane: thrust / mass and the three
// torques over their inertias.
template <typename T>
struct StepQuotients {
  T tm, roll, pitch, yaw;
};

// sin and cos of roll, pitch and yaw and tan(pitch), held by every lane.
template <typename T>
struct Attitude {
  T s_roll, c_roll, s_pitch, c_pitch, t_pitch, s_yaw, c_yaw;
};

// The body rates p, q, r of a stage input, held by every lane.
template <typename T>
struct Rates {
  T p, q, r;
};

// The quadrotor as a group of four lanes. Lane r owns x[r], x[r + 4] and
// x[r + 8]: lane 0 (p_x, v_y, yaw), 1 (p_y, v_z, p), 2 (p_z, roll, q),
// 3 (v_x, pitch, r). So the three angles lie in three lanes, which take their
// trig from their own entries, and each lane's three field entries are one
// of dx0..3 (three are copies of a velocity), one of dx4..7 and one of dx8..11.
// A stage's field takes two exchanges: (A) each lane takes the velocity its
// first entry copies from lane r - 1 and the three rates from lanes 1..3,
// while the trig runs; (B) every lane takes the seven attitude values from
// the lanes that computed them (kRollLane, kPitchLane, kYawLane).
template <typename T>
struct QuadrotorGroup {
  static constexpr int G = 4;
  static constexpr int E = 3;
  static constexpr int N = 12;
  static constexpr int M = 4;
  static constexpr int kRollLane = 2;
  static constexpr int kPitchLane = 3;
  static constexpr int kYawLane = 0;
  Quadrotor<T> p;
  T rate_roll, rate_pitch, rate_yaw;  // (iy - iz) / ix, (iz - ix) / iy, (ix - iy) / iz, as in the field

  QT_HD static int entry(int role, int e) { return role + G * e; }

  QT_HD static QuadrotorGroup from(const Quadrotor<T>& plant) {
    return {plant, (plant.iy - plant.iz) / plant.ix, (plant.iz - plant.ix) / plant.iy,
            (plant.ix - plant.iy) / plant.iz};
  }

  // Lane r's quotient of the step: r = 0 thrust / mass, r = 1..3 the torque
  // about axis r - 1 over its inertia (the field's expressions). Numerator and
  // denominator are chosen first, so the warp runs one division, not four.
  QT_HD T quotient(int role, const T* u) const {
    const T thrust = ((u[0] + u[1]) + u[2]) + u[3];
    const T tau_roll = p.arm * ((u[1] + u[2]) - (u[0] + u[3]));
    const T tau_pitch = p.arm * ((u[0] + u[1]) - (u[2] + u[3]));
    const T tau_yaw = p.k_yaw * (u[0] - u[1] + u[2] - u[3]);
    const T num = role == 0 ? thrust : (role == 1 ? tau_roll : (role == 2 ? tau_pitch : tau_yaw));
    const T den = role == 0 ? p.mass : (role == 1 ? p.ix : (role == 2 ? p.iy : p.iz));
    return num / den;
  }

  // The angle lane r takes the trig of: its own yaw, roll or pitch (lane 1
  // owns no angle; its results are not read).
  QT_HD static T angle(int role, const T* e) { return role == kYawLane ? e[2] : e[1]; }

  // What lane r offers lane r + 1 in exchange A: lane 3 its v_x, the others
  // their v_y, v_z (lane 2's roll is not read).
  QT_HD static T velocity_offer(int role, const T* e) { return role == 3 ? e[0] : e[1]; }

  QT_HD static void trig(T a, T* s, T* c, T* t) {
    sincos_t(a, s, c);
    *t = tan_t(a);
  }

  // Lane r's field entries from the velocity lane r - 1 offered, the rates,
  // the attitude values and the step's quotients. Every lane evaluates all
  // the formulas and keeps its own: one instruction stream with independent
  // chains (a branch per lane serialized the four lanes' formulas and made K2
  // 24 % slower on an H100).
  QT_HD void entries(int role, T velocity, const Rates<T>& w, const Attitude<T>& a, const StepQuotients<T>& q,
                     T* k) const {
    const T dx3 = q.tm * (a.s_yaw * a.s_roll + a.c_yaw * a.s_pitch * a.c_roll);
    const T dx4 = q.tm * (a.c_yaw * a.s_roll - a.s_yaw * a.s_pitch * a.c_roll);
    const T dx5 = -p.gravity + q.tm * (a.c_pitch * a.c_roll);
    const T dx6 = w.p + w.q * a.s_roll * a.t_pitch + w.r * a.c_roll * a.t_pitch;
    const T dx7 = w.q * a.c_roll - w.r * a.s_roll;
    const T dx8 = (w.q * a.s_roll + w.r * a.c_roll) / a.c_pitch;
    const T dx9 = rate_roll * w.q * w.r + q.roll;
    const T dx10 = rate_pitch * w.p * w.r + q.pitch;
    const T dx11 = rate_yaw * w.p * w.q + q.yaw;
    k[0] = role == 3 ? dx3 : velocity;  // dx0..2 = v_x, v_y, v_z
    k[1] = role == 0 ? dx4 : (role == 1 ? dx5 : (role == 2 ? dx6 : dx7));
    k[2] = role == 0 ? dx8 : (role == 1 ? dx9 : (role == 2 ? dx10 : dx11));
  }
};

// The cart-pole as a group of one lane: plants.cuh's step on the whole state.
template <typename T>
struct CartPoleGroup {
  static constexpr int G = 1;
  static constexpr int E = 4;
  static constexpr int N = 4;
  static constexpr int M = 1;
  CartPole<T> p;
  QT_HD static int entry(int, int e) { return e; }
  QT_HD static CartPoleGroup from(const CartPole<T>& plant) { return {plant}; }
};

template <typename T, typename P>
struct GroupOf;
template <typename T>
struct GroupOf<T, Quadrotor<T>> {
  using type = QuadrotorGroup<T>;
};
template <typename T>
struct GroupOf<T, CartPole<T>> {
  using type = CartPoleGroup<T>;
};

}  // namespace qt

#if defined(__CUDACC__)

#include <cuda_runtime.h>

#include "tile_copy.cuh"

namespace qt {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kGroupWarps = 4;  // warps per CTA; each warp stages its own trajectory's steps
constexpr int kGroupChunk = 8;  // steps per staged chunk; two chunks per warp alternate

template <int G, typename T>
__device__ __forceinline__ T from_lane(T v, int src) {
  return __shfl_sync(kFullMask, v, src, G);
}

template <int G, typename T>
__device__ __forceinline__ T xor_lane(T v, int mask) {
  return __shfl_xor_sync(kFullMask, v, mask, G);
}

// The quadrotor's field on the group: lane `role` gets its entries k of f(xt, u).
template <typename T>
__device__ __forceinline__ void group_field(const QuadrotorGroup<T>& grp, int role, const StepQuotients<T>& q,
                                            const T* e, T* k) {
  using Grp = QuadrotorGroup<T>;
  constexpr int G = Grp::G;
  const T velocity = from_lane<G>(Grp::velocity_offer(role, e), (role + G - 1) % G);
  const Rates<T> w{from_lane<G>(e[2], 1), from_lane<G>(e[2], 2), from_lane<G>(e[2], 3)};
  T s, c, t;
  Grp::trig(Grp::angle(role, e), &s, &c, &t);
  const Attitude<T> a{from_lane<G>(s, Grp::kRollLane),  from_lane<G>(c, Grp::kRollLane),
                      from_lane<G>(s, Grp::kPitchLane), from_lane<G>(c, Grp::kPitchLane),
                      from_lane<G>(t, Grp::kPitchLane), from_lane<G>(s, Grp::kYawLane),
                      from_lane<G>(c, Grp::kYawLane)};
  grp.entries(role, velocity, w, a, q, k);
}

// One Euler or RK4 step of lane `role`'s entries x under the group's u.
template <typename T>
__device__ __forceinline__ void group_step(const QuadrotorGroup<T>& grp, int role, int rk4,
                                           const StepSizes<T>& h, T* x, const T* u) {
  constexpr int G = QuadrotorGroup<T>::G;
  constexpr int E = QuadrotorGroup<T>::E;
  const T mine = grp.quotient(role, u);
  const StepQuotients<T> q{from_lane<G>(mine, 0), from_lane<G>(mine, 1), from_lane<G>(mine, 2),
                           from_lane<G>(mine, 3)};
  T k[E], acc[E], xt[E];
  group_field(grp, role, q, x, k);
  if (!rk4) {
    euler_update<T, E>(h, x, k);
    return;
  }
  rk4_after_stage<T, E>(0, h, x, acc, k, xt);
  group_field(grp, role, q, xt, k);
  rk4_after_stage<T, E>(1, h, x, acc, k, xt);
  group_field(grp, role, q, xt, k);
  rk4_after_stage<T, E>(2, h, x, acc, k, xt);
  group_field(grp, role, q, xt, k);
  rk4_after_stage<T, E>(3, h, x, acc, k, xt);
}

template <typename T>
__device__ __forceinline__ void group_step(const CartPoleGroup<T>& grp, int, int rk4, const StepSizes<T>& h,
                                           T* x, const T* u) {
  discrete_step(grp.p, rk4, h, x, u, x);
}

// cp.async of src[0, count) to dst by the 32 lanes of a warp.
template <typename T>
__device__ __forceinline__ void warp_copy_async(T* dst, const T* src, int count, int lane) {
  for (int e = lane; e < count; e += 32) copy_async(dst + e, src + e);
}

// All-alpha rollouts of B trajectories. Warp w rolls out candidates
// [cb * 32/G, (cb + 1) * 32/G) of trajectory b = w / n_blocks (cb = w % n_blocks,
// n_blocks = ceil(A / (32/G))), one group of G lanes per candidate. Groups past
// the last candidate run it again with their stores masked, so every shuffle
// names the whole warp. Each warp stages its trajectory's x_ref, u_ref, k and K
// into shared memory by cp.async in chunks of kGroupChunk steps, the next chunk
// in flight while the groups integrate the current one; all its groups read
// that one copy. Inputs (B, ...) with x_ref rows ref_rows apart; outputs
// cand_x (A, B, H+1, N), cand_u (A, B, H, M). K2 launches it with B = 1.
template <typename T, typename P>
__global__ void __launch_bounds__(kGroupWarps * 32)
    rollout_group_kernel(int B, int H, int n_alpha, int ref_rows, int rk4, typename GroupOf<T, P>::type grp,
                         StepSizes<T> h, const T* __restrict__ x0, const T* __restrict__ x_ref,
                         const T* __restrict__ u_ref, const T* __restrict__ k, const T* __restrict__ big_k,
                         const T* __restrict__ alphas, T* __restrict__ cand_x, T* __restrict__ cand_u) {
  using Grp = typename GroupOf<T, P>::type;
  constexpr int G = Grp::G, E = Grp::E, N = Grp::N, M = Grp::M;
  constexpr int kGroups = 32 / G;
  constexpr int kSlot = kGroupChunk * (N + 2 * M + M * N);  // one chunk: x_ref, u_ref, k, K
  __shared__ T ring[kGroupWarps][2][kSlot];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_blocks = (n_alpha + kGroups - 1) / kGroups;
  const long long w = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (w >= (long long)B * n_blocks) return;  // the whole warp: no shuffle or sync names it
  const long long b = w / n_blocks;
  const int cand = static_cast<int>(w % n_blocks) * kGroups + lane / G;
  const bool live = cand < n_alpha;
  const int c = live ? cand : n_alpha - 1;
  const int role = lane % G;

  const T* xr_b = x_ref + b * ref_rows * N;
  const T* ur_b = u_ref + b * H * M;
  const T* k_b = k + b * H * M;
  const T* bk_b = big_k + b * H * M * N;
  T* xo = cand_x + ((size_t)c * B + b) * (H + 1) * N;
  T* uo = cand_u + ((size_t)c * B + b) * H * M;
  const T alpha = alphas[c];

  T x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = x0[b * N + Grp::entry(role, e)];
    if (live) xo[Grp::entry(role, e)] = x[e];
  }

  auto stage = [&](T* slot, int t0, int len) {
    warp_copy_async(slot, xr_b + (size_t)t0 * N, len * N, lane);
    warp_copy_async(slot + kGroupChunk * N, ur_b + (size_t)t0 * M, len * M, lane);
    warp_copy_async(slot + kGroupChunk * (N + M), k_b + (size_t)t0 * M, len * M, lane);
    warp_copy_async(slot + kGroupChunk * (N + 2 * M), bk_b + (size_t)t0 * M * N, len * M * N, lane);
  };
  const int n_chunks = (H + kGroupChunk - 1) / kGroupChunk;
  if (n_chunks > 0) stage(ring[warp][0], 0, min(kGroupChunk, H));
  commit_async();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kGroupChunk;
    const int len = min(kGroupChunk, H - t0);
    if (ch + 1 < n_chunks)  // its slot's last reader was chunk ch - 1, before the __syncwarp that ended it
      stage(ring[warp][(ch + 1) & 1], t0 + kGroupChunk, min(kGroupChunk, H - t0 - kGroupChunk));
    commit_async();
    wait_async_groups<1>();  // chunk ch has arrived
    __syncwarp();
    const T* xs = ring[warp][ch & 1];
    const T* us = xs + kGroupChunk * N;
    const T* ks = xs + kGroupChunk * (N + M);
    const T* bks = xs + kGroupChunk * (N + 2 * M);
    for (int j = 0; j < len; ++j) {
      const int t = t0 + j;
      T p[M];
      feedback_partials<T, Grp>(role, x, xs + j * N, bks + j * M * N, p);
#pragma unroll
      for (int mask = 1; mask < G; mask <<= 1) {
#pragma unroll
        for (int jj = 0; jj < M; ++jj) p[jj] = p[jj] + xor_lane<G>(p[jj], mask);
      }
      T u[M];
#pragma unroll
      for (int jj = 0; jj < M; ++jj) {
        u[jj] = feedback_control(us[j * M + jj], ks[j * M + jj], alpha, p[jj]);
        if (live && jj % G == role) uo[(size_t)t * M + jj] = u[jj];
      }
      group_step(grp, role, rk4, h, x, u);
      if (live) {
#pragma unroll
        for (int e = 0; e < E; ++e) xo[(size_t)(t + 1) * N + Grp::entry(role, e)] = x[e];
      }
    }
    __syncwarp();  // every lane is done with this slot before it is refilled
  }
}

// Launch of rollout_group_kernel: one warp per (trajectory, block of 32/G
// candidates), kGroupWarps warps per CTA (fewer when there are fewer warps).
template <typename T, template <typename> class Plant>
int launch_group_rollouts(int B, int H, int n_alpha, int ref_rows, int rk4, const double* params, double dt,
                          const void* x0, const void* x_ref, const void* u_ref, const void* k, const void* big_k,
                          const void* alphas, void* cand_x, void* cand_u, cudaStream_t stream) {
  using Grp = typename GroupOf<T, Plant<T>>::type;
  const long long warps = (long long)B * ((n_alpha + 32 / Grp::G - 1) / (32 / Grp::G));
  const int cta_warps = static_cast<int>(warps < kGroupWarps ? warps : kGroupWarps);
  const long long blocks = (warps + cta_warps - 1) / cta_warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rollout_group_kernel<T, Plant<T>><<<static_cast<unsigned>(blocks), cta_warps * 32, 0, stream>>>(
      B, H, n_alpha, ref_rows, rk4, Grp::from(Plant<T>::from(params)), StepSizes<T>::from(dt),
      static_cast<const T*>(x0), static_cast<const T*>(x_ref), static_cast<const T*>(u_ref),
      static_cast<const T*>(k), static_cast<const T*>(big_k), static_cast<const T*>(alphas),
      static_cast<T*>(cand_x), static_cast<T*>(cand_u));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qt

#endif  // __CUDACC__
