// A whole iLQR solve in one launch (kernel K3).
//
// Replaces the TPU kernel quattro_tpu/ops/fused_solve.py::
// fused_ilqr_solve_kernel. Up to max_iter trips, each
//   1. linearize + quadratize along the current trajectory,
//   2. backward Riccati (riccati_step.cuh, shared with K1 and K4),
//   3. closed-loop rollouts for every step size alpha, then their running
//      costs, summed per alpha in time order with the final cost added last,
//   4. first-accept select (the first alpha with total <= current cost) and
//      the convergence bookkeeping, which sets `done`.
// The loop leaves after the trip that sets `done`, where the TPU kernel runs
// every trip under a `done` mask and discards those after convergence: such a
// trip writes nothing (no update, no gains, the cost carried, no iteration
// counted), so the outputs are the masked loop's bit for bit and only the
// time differs. A solve that does not converge still runs max_iter trips, so
// max_iter bounds the latency; below that bound it follows the data. Gains
// returned are those of the last trip. stats = [cost, iterations, converged],
// and iterations are the trips run.
//
// The TPU kernel traces the user's dynamics and costs; here the plant
// (plants.cuh: quadrotor or cart-pole, Euler or RK4, Jacobians by dual
// numbers) and the cost family (costs.cuh: quadratic plus softplus^2 barrier,
// analytic expansion) are device functions, and every number (parameters, dt,
// Q, R, Qf, references, barrier, reg, tol, max_iter, alphas) is an argument.
//
// What bounds it: latency. One solve is a few hundred KB and a few MFLOP; the
// trips are sequential, and inside a trip the Riccati recursion and the
// rollouts are chains over H: clock stamps on an H100 (quadrotor, H=50,
// float32) put half a trip in the rollouts' integrator chain and a third in
// the Riccati recursion. Design: one CTA of 256 threads per solve, the phases
// separated by barriers.
//   - linearize: one thread per (time step, tangent direction), H (n + m)
//     scalar-dual integrator steps; then one thread per time step for the
//     cost expansion. The cost tables are staged in shared memory once per
//     launch. (At H=50 the 800 columns take four rounds of 256, the last
//     nearly idle; 288 and 416 threads take three and two, but made the whole
//     solve 5.6 % and 3.2 % slower on an H100, quadrotor, float32.)
//   - Riccati: riccati_pass of riccati_step.cuh, the stage data streamed from
//     the workspace through its cp.async ring.
//   - rollouts: one thread per alpha, state in registers, reading the trip's
//     x, u, k and K from shared memory. They are staged by cp.async in chunks
//     of steps into dynamic shared memory: the whole trajectory in one chunk
//     where it fits in kStageBytes (H=50 float32: 13.6 KB; H=100 float64:
//     54.4 KB), else two slots that alternate, the next chunk in flight while
//     the lanes integrate the current one. The chain of a step is the
//     feedback law and the integrator step only.
//   - costs: every (alpha, step) running cost at once, on all threads, into a
//     block of shared memory; each alpha's lane sums its block in time order.
//   - select: one thread; the copy of the accepted candidate: all threads.
// The trajectory lives in the output buffers, the stage data, the trip's
// gains and the candidates in a global workspace the caller allocates (about
// 110 KB for the quadrotor at H=50 in float32: it stays in L2), so no horizon
// is too long for the kernel. Buffers that are written and read inside the
// launch are not declared const __restrict__, so no read goes through the
// non-coherent path. FP32 or FP64 FMAs only, no fast-math.
//
// A launch given x0 in place of x_init and cost_init starts with a prologue:
// warp 0 rolls u_init out from x0 with K2's lane-group step (rollout_group.cuh;
// at zero gains and alpha 1 K2's candidate is this rollout, so the trajectory
// equals K2's), then every step's running cost on all threads, summed by one
// thread in time order with the final cost last, as phase 3b sums each alpha's.
// It takes the host's initial rollout and cost, and their launches, off the
// MPC step; the trips that follow are the same code either way.
//
// C interface (no PyTorch header; bound with ctypes); contiguous device
// arrays of the given dtype, n and m the plant's:
//   x_init (H+1,n), u_init (H,m), cost_init (1), q (n,n), r (m,m), x_ref (n),
//   qf (n,n), xf_ref (n), alphas (A), x0 (n): either x_init and cost_init with
//   x0 null, or x0 with x_init and cost_init null
//   -> x (H+1,n), u (H,m), k (H,m), big_k (H,m,n), stats (3);
//   workspace of qt_fused_solve_workspace(plant, H, A) elements.

#include <cuda_runtime.h>

#include "costs.cuh"
#include "plants.cuh"
#include "riccati_step.cuh"
#include "rollout_group.cuh"
#include "tile_copy.cuh"

namespace {

constexpr int kMaxAlphas = 64;
// Dynamic shared memory for the rollouts' staged trajectory (and then the
// block of running costs).
constexpr int kStageBytes = 64 * 1024;

constexpr int kThreads = 256;

template <typename T>
struct SolveArgs {
  int H, n_alpha, max_iter, rk4;
  int chunk, slots, cost_steps;  // rollout staging: steps per chunk, 1 or 2 slots; steps per cost block
  qt::StepSizes<T> h;
  T reg, tol, barrier_alpha, barrier_beta;
  const T *x_init, *u_init, *cost_init, *q, *r, *x_ref, *qf, *xf_ref, *alphas, *x0;  // x_init null: roll out from x0
  T *x, *u, *k, *big_k, *stats;
  // Workspace, carved by carve().
  T *a, *b, *lx, *lu, *lxx, *luu, *lux, *kt, *big_kt, *cand_x, *cand_u;
};

// Elements of one (time step)'s stage data and gains, and of the whole workspace.
constexpr long long per_step(int n, int m) {
  return (long long)n * n + n * m + n + m + n * n + m * m + m * n + m + m * n;
}
constexpr long long workspace_count(int n, int m, int H, int n_alpha) {
  return H * per_step(n, m) + (long long)n_alpha * ((H + 1) * n + H * m);
}

// Values one rollout step reads: x_t (n), u_t (m), k_t (m), K_t (m, n).
QT_HD constexpr int staged_per_step(int n, int m) { return n + 2 * m + m * n; }

template <typename T>
void carve(SolveArgs<T>& g, T* ws, int n, int m) {
  const long long H = g.H;
  g.a = ws;               ws += H * n * n;
  g.b = ws;               ws += H * n * m;
  g.lx = ws;              ws += H * n;
  g.lu = ws;              ws += H * m;
  g.lxx = ws;             ws += H * n * n;
  g.luu = ws;             ws += H * m * m;
  g.lux = ws;             ws += H * m * n;
  g.kt = ws;              ws += H * m;
  g.big_kt = ws;          ws += H * m * n;
  g.cand_x = ws;          ws += (long long)g.n_alpha * (H + 1) * n;
  g.cand_u = ws;
}

// Staging of the rollouts, and the elements of dynamic shared memory it needs.
template <typename T>
long long plan_staging(SolveArgs<T>& g, int n, int m) {
  const int per = staged_per_step(n, m);
  const int fit = kStageBytes / (per * (int)sizeof(T));
  if (g.H <= fit) {
    g.chunk = g.H > 0 ? g.H : 1;
    g.slots = 1;
  } else {
    g.chunk = fit / 2;
    g.slots = 2;
  }
  const long long stage = (long long)g.slots * g.chunk * per;
  const long long steps = stage / g.n_alpha;
  g.cost_steps = (int)(steps < 1 ? 1 : steps < g.H ? steps : (g.H > 0 ? g.H : 1));
  const long long costs = (long long)g.n_alpha * g.cost_steps;
  return stage > costs ? stage : costs;
}

// The address of a cost table in shared memory, in float64 hidden from the
// optimizer anew in each iteration of the loops that read it. Nothing in those
// loops writes the tables, so the compiler hoists all their loads (Q alone is
// 144 values) out of the loop into registers. In float32 they fit (249
// registers, no spill) and the solve is 3-7 % faster on an H100 than with
// the loads kept in the loop; in float64 the quadrotor kernel spilled 880 bytes.
template <typename T>
__device__ __forceinline__ const T* reloaded(const T* table) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 8) asm volatile("" : "+l"(table));
#endif
  return table;
}

// cp.async of steps [t0, t0 + len) of x, u, k and K into a staging slot laid
// out as x (chunk, n), u (chunk, m), k (chunk, m), K (chunk, m, n).
template <typename T, int N, int M>
__device__ __forceinline__ void stage_chunk(const SolveArgs<T>& g, T* slot, int t0, int len) {
  const int c = g.chunk;
  qt::load_tile_async(g.x + (size_t)t0 * N, len * N, [&](int e) { return slot + e; });
  qt::load_tile_async(g.u + (size_t)t0 * M, len * M, [&](int e) { return slot + c * N + e; });
  qt::load_tile_async(g.kt + (size_t)t0 * M, len * M, [&](int e) { return slot + c * (N + M) + e; });
  qt::load_tile_async(g.big_kt + (size_t)t0 * M * N, len * M * N, [&](int e) { return slot + c * (N + 2 * M) + e; });
}

// The prologue's rollout: u_init from x0 into x, by one warp with the lane
// group of K2 (u_t = u_init_t, what K2 computes at zero gains and alpha 1).
// Every group of the warp runs the same rollout, since the group's shuffles
// name the whole warp; group 0 stores it. u_init's next step is loaded while
// the current one integrates.
template <typename T, typename P>
__device__ __forceinline__ void roll_out_u_init(const SolveArgs<T>& g, const P& plant, int lane) {
  using Grp = typename qt::GroupOf<T, P>::type;
  constexpr int G = Grp::G, E = Grp::E, N = Grp::N, M = Grp::M;
  const Grp grp = Grp::from(plant);
  const int role = lane % G;
  const bool store = lane < G;
  T x[E], u[M], u_next[M];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = g.x0[Grp::entry(role, e)];
    if (store) g.x[Grp::entry(role, e)] = x[e];
  }
#pragma unroll
  for (int j = 0; j < M; ++j) u_next[j] = g.H > 0 ? g.u_init[j] : T(0);
  for (int t = 0; t < g.H; ++t) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      u[j] = u_next[j];
      if (t + 1 < g.H) u_next[j] = g.u_init[(size_t)(t + 1) * M + j];
    }
    qt::group_step(grp, role, g.rk4, g.h, x, u);
    if (store) {
#pragma unroll
      for (int e = 0; e < E; ++e) g.x[(size_t)(t + 1) * N + Grp::entry(role, e)] = x[e];
    }
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) solve_kernel(SolveArgs<T> g, P plant) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  constexpr int NN = N * N;
  constexpr int NM = N * M;
  constexpr int MM = M * M;
  constexpr int kStaged = staged_per_step(N, M);
  __shared__ qt::StepTiles<T, N, M> s;
  __shared__ qt::StageRing<T, N, M> ring;
  __shared__ T q_s[NN], r_s[MM], xref_s[N], qf_s[NN], xfref_s[N];
  __shared__ T totals[kMaxAlphas];
  __shared__ T cur_cost;
  __shared__ int done, iters, chosen, update, active;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  T* dyn = reinterpret_cast<T*>(dyn_raw);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int H = g.H;

  const bool roll_out = g.x_init == nullptr;
  if (!roll_out)
    for (int i = tid; i < (H + 1) * N; i += nt) g.x[i] = g.x_init[i];
  for (int i = tid; i < H * M; i += nt) {
    g.u[i] = g.u_init[i];
    g.k[i] = T(0);
  }
  for (int i = tid; i < H * NM; i += nt) g.big_k[i] = T(0);
  for (int i = tid; i < NN; i += nt) {
    q_s[i] = g.q[i];
    qf_s[i] = g.qf[i];
  }
  for (int i = tid; i < MM; i += nt) r_s[i] = g.r[i];
  for (int i = tid; i < N; i += nt) {
    xref_s[i] = g.x_ref[i];
    xfref_s[i] = g.xf_ref[i];
  }
  if (tid == 0) {
    if (!roll_out) cur_cost = g.cost_init[0];
    done = 0;
    iters = 0;
  }
  if (roll_out && tid < 32) roll_out_u_init(g, plant, tid);
  __syncthreads();
  if (roll_out) {
    // The rollout's cost: running costs of a block of steps on all threads,
    // then thread 0 adds them in time order and the final cost last.
    T run = T(0);
    for (int t0 = 0; t0 < H; t0 += g.cost_steps) {
      const int len = min(g.cost_steps, H - t0);
      for (int j = tid; j < len; j += nt)
        dyn[j] = qt::running_cost<N, M>(reloaded(q_s), reloaded(r_s), reloaded(xref_s), g.barrier_alpha,
                                        g.barrier_beta, g.x + (size_t)(t0 + j) * N, g.u_init + (size_t)(t0 + j) * M);
      __syncthreads();
      if (tid == 0)
        for (int j = 0; j < len; ++j) run = run + dyn[j];
      __syncthreads();
    }
    if (tid == 0) cur_cost = run + qt::final_cost<N>(qf_s, xfref_s, g.x + (size_t)H * N);
    __syncthreads();
  }

  for (int trip = 0; trip < g.max_iter; ++trip) {
    // ---- 1. linearize: column d of [A_t | B_t] per thread ------------------
    for (int task = tid; task < H * (N + M); task += nt) {
      const int t = task / (N + M), d = task % (N + M);
      T x[N], u[M], col[N];
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = g.x[t * N + i];
#pragma unroll
      for (int j = 0; j < M; ++j) u[j] = g.u[t * M + j];
      qt::discrete_step_jacobian_column(plant, g.rk4, g.h, x, u, d, col);
      if (d < N) {
#pragma unroll
        for (int i = 0; i < N; ++i) g.a[(size_t)t * NN + i * N + d] = col[i];
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) g.b[(size_t)t * NM + i * M + (d - N)] = col[i];
      }
    }
    // ---- 1b. quadratize: one time step per thread --------------------------
    for (int t = tid; t < H; t += nt) {
      T x[N], u[M];
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = g.x[t * N + i];
#pragma unroll
      for (int j = 0; j < M; ++j) u[j] = g.u[t * M + j];
      qt::running_cost_expansion<N, M>(reloaded(q_s), reloaded(r_s), reloaded(xref_s), g.barrier_alpha, g.barrier_beta, x, u,
                                       g.lx + (size_t)t * N, g.lu + (size_t)t * M,
                                       g.lxx + (size_t)t * NN, g.luu + (size_t)t * MM,
                                       g.lux + (size_t)t * NM);
    }
    // Terminal value function into the Riccati carry.
    if (tid == 0) {
      T xf[N];
#pragma unroll
      for (int i = 0; i < N; ++i) xf[i] = g.x[(size_t)H * N + i];
      qt::final_cost_expansion<N>(qf_s, xfref_s, xf, s.vx, s.vxx);
    }
    __syncthreads();

    // ---- 2. backward Riccati ------------------------------------------------
    {
      // Readers of the workspace's stage data, made here so that they hold no
      // registers while the linearize phase needs them all.
      const qt::Strided<T, T> rd[qt::kStageTensors] = {{g.a, NN, 1},  {g.b, NM, 1},   {g.lx, N, 1},  {g.lu, M, 1},
                                                       {g.lxx, NN, 1}, {g.luu, MM, 1}, {g.lux, NM, 1}};
      qt::riccati_pass<T, N, M, false>(s, ring, H, N, M, g.reg, rd, g.kt, g.big_kt, nullptr, nullptr);
    }

    // ---- 3. all-alpha rollouts ----------------------------------------------
    // Lane c < n_alpha carries candidate c's state across the chunks.
    const int c = tid;
    const T alpha = c < g.n_alpha ? g.alphas[c] : T(0);
    T* xo = g.cand_x + (size_t)c * (H + 1) * N;
    T* uo = g.cand_u + (size_t)c * H * M;
    T x[N];
    if (c < g.n_alpha) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x[i] = g.x[i];
        xo[i] = x[i];
      }
    }
    const int n_chunks = (H + g.chunk - 1) / g.chunk;
    if (n_chunks > 0) stage_chunk<T, N, M>(g, dyn, 0, min(g.chunk, H));
    qt::commit_async();
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int t0 = ch * g.chunk;
      const int len = min(g.chunk, H - t0);
      T* slot = dyn + (size_t)(g.slots == 2 ? (ch & 1) : 0) * g.chunk * kStaged;
      if (ch + 1 < n_chunks) {  // its slot's last reader was chunk ch - 1, before the barrier that ended it
        const int t1 = t0 + g.chunk;
        stage_chunk<T, N, M>(g, dyn + (size_t)((ch + 1) & 1) * g.chunk * kStaged, t1, min(g.chunk, H - t1));
      }
      qt::commit_async();
      qt::wait_async_groups<1>();  // chunk ch has arrived
      __syncthreads();
      if (c < g.n_alpha) {
        const T* xs = slot;
        const T* us = slot + g.chunk * N;
        const T* ks = slot + g.chunk * (N + M);
        const T* bks = slot + g.chunk * (N + 2 * M);
        for (int j = 0; j < len; ++j) {
          const int t = t0 + j;
          T dxr[N], u[M];
#pragma unroll
          for (int i = 0; i < N; ++i) dxr[i] = x[i] - xs[j * N + i];
#pragma unroll
          for (int jj = 0; jj < M; ++jj) {
            const T* kr = bks + (j * M + jj) * N;
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < N; ++i) acc += dxr[i] * kr[i];
            u[jj] = us[j * M + jj] + alpha * (ks[j * M + jj] + acc);
            uo[(size_t)t * M + jj] = u[jj];
          }
          qt::discrete_step(plant, g.rk4, g.h, x, u, x);
#pragma unroll
          for (int i = 0; i < N; ++i) xo[(size_t)(t + 1) * N + i] = x[i];
        }
      }
      __syncthreads();
    }

    // ---- 3b. running costs of every (alpha, step), summed per alpha -----------
    // Blocks of cost_steps steps; lane c sums its row of each block in time
    // order, so the totals round as a step-by-step sum does.
    T run = T(0);
    for (int t0 = 0; t0 < H; t0 += g.cost_steps) {
      const int len = min(g.cost_steps, H - t0);
      for (int task = tid; task < g.n_alpha * len; task += nt) {
        const int a = task / len, j = task % len, t = t0 + j;
        dyn[task] = qt::running_cost<N, M>(reloaded(q_s), reloaded(r_s), reloaded(xref_s), g.barrier_alpha, g.barrier_beta,
                                           g.cand_x + ((size_t)a * (H + 1) + t) * N,
                                           g.cand_u + ((size_t)a * H + t) * M);
      }
      __syncthreads();
      if (c < g.n_alpha)
        for (int j = 0; j < len; ++j) run = run + dyn[c * len + j];
      __syncthreads();
    }
    if (c < g.n_alpha) totals[c] = run + qt::final_cost<N>(qf_s, xfref_s, x);
    __syncthreads();

    // ---- 4. first-accept select and bookkeeping -----------------------------
    if (tid == 0) {
      const T cur = cur_cost;
      int first = -1;
      for (int a = 0; a < g.n_alpha; ++a) {
        if (totals[a] <= cur) {
          first = a;
          break;
        }
      }
      const bool is_active = done == 0;
      const bool found = first >= 0;
      const bool upd = is_active && found;
      const T cost_next = upd ? totals[first] : cur;
      const T diff = cur - cost_next;
      const bool small = (diff < T(0) ? -diff : diff) < g.tol;
      if (is_active) {
        done = (!found || small) ? 1 : 0;
        iters += 1;
      }
      cur_cost = cost_next;
      chosen = first;
      update = upd ? 1 : 0;
      active = is_active ? 1 : 0;
    }
    __syncthreads();
    if (update) {
      const T* xc = g.cand_x + (size_t)chosen * (H + 1) * N;
      const T* uc = g.cand_u + (size_t)chosen * H * M;
      for (int i = tid; i < (H + 1) * N; i += nt) g.x[i] = xc[i];
      for (int i = tid; i < H * M; i += nt) g.u[i] = uc[i];
    }
    if (active) {
      for (int i = tid; i < H * M; i += nt) g.k[i] = g.kt[i];
      for (int i = tid; i < H * NM; i += nt) g.big_k[i] = g.big_kt[i];
    }
    __syncthreads();
    // Every thread reads the same `done`: thread 0 writes it only in phase 4,
    // past the next trip's first barrier, which no thread reaches after this.
    if (done) break;
  }

  if (tid == 0) {
    g.stats[0] = cur_cost;
    g.stats[1] = static_cast<T>(iters);
    g.stats[2] = static_cast<T>(done);
  }
}

template <typename T, template <typename> class Plant>
int launch(int H, int n_alpha, int max_iter, int rk4, const double* params, double dt, double reg,
           double tol, double barrier_alpha, double barrier_beta, const void* const* in,
           void* const* out, void* workspace, cudaStream_t stream) {
  using P = Plant<T>;
  SolveArgs<T> g;
  g.H = H;
  g.n_alpha = n_alpha;
  g.max_iter = max_iter;
  g.rk4 = rk4;
  g.h = qt::StepSizes<T>::from(dt);
  g.reg = static_cast<T>(reg);
  g.tol = static_cast<T>(tol);
  g.barrier_alpha = static_cast<T>(barrier_alpha);
  g.barrier_beta = static_cast<T>(barrier_beta);
  const T* const* i = reinterpret_cast<const T* const*>(in);
  g.x_init = i[0];
  g.u_init = i[1];
  g.cost_init = i[2];
  g.q = i[3];
  g.r = i[4];
  g.x_ref = i[5];
  g.qf = i[6];
  g.xf_ref = i[7];
  g.alphas = i[8];
  g.x0 = i[9];
  T* const* o = reinterpret_cast<T* const*>(out);
  g.x = o[0];
  g.u = o[1];
  g.k = o[2];
  g.big_k = o[3];
  g.stats = o[4];
  carve(g, static_cast<T*>(workspace), P::N, P::M);
  const size_t dyn_bytes = plan_staging(g, P::N, P::M) * sizeof(T);
  // Above 48 KB of shared memory a kernel must opt in; the largest size set
  // so far is kept, so the attribute is set once per size that grows.
  static size_t opted = 0;
  if (dyn_bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(solve_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(dyn_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = dyn_bytes;
  }
  solve_kernel<T, P><<<1, kThreads, dyn_bytes, stream>>>(g, P::from(params));
  return static_cast<int>(cudaGetLastError());
}

bool plant_dims(int plant, int* n, int* m) {
  if (plant == 0) {
    *n = qt::Quadrotor<float>::N;
    *m = qt::Quadrotor<float>::M;
    return true;
  }
  if (plant == 1) {
    *n = qt::CartPole<float>::N;
    *m = qt::CartPole<float>::M;
    return true;
  }
  return false;
}

}  // namespace

// Elements (not bytes) of the workspace one solve needs; -1 for an unknown plant.
extern "C" long long qt_fused_solve_workspace(int plant, int H, int n_alpha) {
  int n, m;
  if (!plant_dims(plant, &n, &m) || H < 0 || n_alpha < 1) return -1;
  return workspace_count(n, m, H, n_alpha);
}

// dtype: 0 = float32, 1 = float64. plant and params as in qt_fused_rollout
// (0 = quadrotor, 1 = cart-pole). rk4: 1 = RK4, 0 = forward Euler.
// in: the ten input arrays in the order of the header comment; out: the five
// outputs (host arrays of device pointers). workspace_elems is the size of the
// workspace that was allocated. Returns 0 or the cudaError_t of the launch.
extern "C" int qt_fused_solve(int dtype, int plant, int H, int n_alpha, int max_iter, int rk4,
                              const double* params, double dt, double reg, double tol,
                              double barrier_alpha, double barrier_beta, const void* const* in,
                              void* const* out, void* workspace, long long workspace_elems,
                              void* stream) {
  const long long need = qt_fused_solve_workspace(plant, H, n_alpha);
  const bool from_x0 = in[0] == nullptr;  // x_init with cost_init, or x0 alone
  if (need < 0 || workspace_elems < need || n_alpha > kMaxAlphas || max_iter < 0 || dtype < 0 ||
      dtype > 1 || from_x0 != (in[2] == nullptr) || from_x0 == (in[9] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_LAUNCH(T, Plant)                                                                      \
  launch<T, Plant>(H, n_alpha, max_iter, rk4, params, dt, reg, tol, barrier_alpha, barrier_beta, \
                   in, out, workspace, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
