// A whole iLQR solve in one launch (kernel K3).
//
// Replaces the TPU kernel quattro_tpu/ops/fused_solve.py::
// fused_ilqr_solve_kernel. max_iter fixed trips, each
//   1. linearize + quadratize along the current trajectory,
//   2. backward Riccati (the step of riccati_step.cuh, shared with K1),
//   3. closed-loop rollouts for every step size alpha, the running cost
//      summed step by step inside the rollout and the final cost added last,
//   4. first-accept select (the first alpha with total <= current cost) and
//      the convergence bookkeeping,
// under a `done` mask: trips after convergence recompute on the frozen
// trajectory and are discarded, so the launch always does the same work and
// the step latency does not depend on the data. Gains returned are those of
// the last active trip. stats = [cost, iterations, converged].
//
// The TPU kernel traces the user's dynamics and costs; here the plant
// (plants.cuh: quadrotor or cart-pole, Euler or RK4, Jacobians by dual
// numbers) and the cost family (costs.cuh: quadratic plus softplus^2 barrier,
// analytic expansion) are device functions, and every number (parameters, dt,
// Q, R, Qf, references, barrier, reg, tol, max_iter, alphas) is an argument.
//
// What bounds it: latency. One solve is a few hundred KB and a few MFLOP; the
// trips are sequential, and inside a trip the Riccati recursion and the
// rollouts are chains over H. Design: one CTA of 256 threads per solve, the
// phases separated by barriers.
//   - linearize: one thread per (time step, tangent direction), H (n + m)
//     scalar-dual integrator steps, then one thread per time step for the
//     cost expansion;
//   - Riccati: the CTA-wide step, the (V_x, V_xx) carry in shared memory;
//   - rollouts: one thread per alpha, state in registers;
//   - select: one thread; the copy of the accepted candidate: all threads.
// The trajectory lives in the output buffers, the stage data, the trip's
// gains and the candidates in a global workspace the caller allocates (about
// 110 KB for the quadrotor at H=50 in float32: it stays in L2), so no horizon
// is too long for shared memory. Buffers that are written and read inside the
// launch are not declared const __restrict__, so no read goes through the
// non-coherent path. FP32 or FP64 FMAs only, no fast-math.
//
// C interface (no PyTorch header; bound with ctypes); contiguous device
// arrays of the given dtype, n and m the plant's:
//   x_init (H+1,n), u_init (H,m), cost_init (1), q (n,n), r (m,m), x_ref (n),
//   qf (n,n), xf_ref (n), alphas (A)
//   -> x (H+1,n), u (H,m), k (H,m), big_k (H,m,n), stats (3);
//   workspace of qt_fused_solve_workspace(plant, H, A) elements.

#include <cuda_runtime.h>

#include "costs.cuh"
#include "plants.cuh"
#include "riccati_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAlphas = 64;

template <typename T>
struct SolveArgs {
  int H, n_alpha, max_iter, rk4;
  qt::StepSizes<T> h;
  T reg, tol, barrier_alpha, barrier_beta;
  const T *x_init, *u_init, *cost_init, *q, *r, *x_ref, *qf, *xf_ref, *alphas;
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

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) solve_kernel(SolveArgs<T> g, P plant) {
  constexpr int N = P::N;
  constexpr int M = P::M;
  constexpr int NN = N * N;
  constexpr int NM = N * M;
  constexpr int MM = M * M;
  __shared__ qt::RiccatiScratch<T> s;
  __shared__ T totals[kMaxAlphas];
  __shared__ T cur_cost;
  __shared__ int done, iters, chosen, update, active;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int H = g.H;

  for (int i = tid; i < (H + 1) * N; i += nt) g.x[i] = g.x_init[i];
  for (int i = tid; i < H * M; i += nt) {
    g.u[i] = g.u_init[i];
    g.k[i] = T(0);
  }
  for (int i = tid; i < H * NM; i += nt) g.big_k[i] = T(0);
  if (tid == 0) {
    cur_cost = g.cost_init[0];
    done = 0;
    iters = 0;
  }
  __syncthreads();

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
      qt::running_cost_expansion<N, M>(g.q, g.r, g.x_ref, g.barrier_alpha, g.barrier_beta, x, u,
                                       g.lx + (size_t)t * N, g.lu + (size_t)t * M,
                                       g.lxx + (size_t)t * NN, g.luu + (size_t)t * MM,
                                       g.lux + (size_t)t * NM);
    }
    // Terminal value function into the Riccati carry.
    if (tid == 0) {
      T xf[N];
#pragma unroll
      for (int i = 0; i < N; ++i) xf[i] = g.x[(size_t)H * N + i];
      qt::final_cost_expansion<N>(g.qf, g.xf_ref, xf, s.vx, s.vxx);
    }
    __syncthreads();

    // ---- 2. backward Riccati ------------------------------------------------
    for (int t = H - 1; t >= 0; --t) {
      qt::riccati_step<T>(s, N, M, g.reg, g.a + (size_t)t * NN, g.b + (size_t)t * NM,
                          g.lx + (size_t)t * N, g.lu + (size_t)t * M, g.lxx + (size_t)t * NN,
                          g.luu + (size_t)t * MM, g.lux + (size_t)t * NM, g.kt + (size_t)t * M,
                          g.big_kt + (size_t)t * NM, nullptr, nullptr);
    }

    // ---- 3. all-alpha rollouts with the running cost ------------------------
    for (int c = tid; c < g.n_alpha; c += nt) {
      const T alpha = g.alphas[c];
      T* xo = g.cand_x + (size_t)c * (H + 1) * N;
      T* uo = g.cand_u + (size_t)c * H * M;
      T x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x[i] = g.x[i];
        xo[i] = x[i];
      }
      T run = T(0);
      for (int t = 0; t < H; ++t) {
        T dxr[N], u[M];
#pragma unroll
        for (int i = 0; i < N; ++i) dxr[i] = x[i] - g.x[(size_t)t * N + i];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const T* kr = g.big_kt + ((size_t)t * M + j) * N;
          T acc = T(0);
#pragma unroll
          for (int i = 0; i < N; ++i) acc += dxr[i] * kr[i];
          u[j] = g.u[(size_t)t * M + j] + alpha * (g.kt[(size_t)t * M + j] + acc);
          uo[(size_t)t * M + j] = u[j];
        }
        run = run + qt::running_cost<N, M>(g.q, g.r, g.x_ref, g.barrier_alpha, g.barrier_beta, x, u);
        qt::discrete_step(plant, g.rk4, g.h, x, u, x);
#pragma unroll
        for (int i = 0; i < N; ++i) xo[(size_t)(t + 1) * N + i] = x[i];
      }
      totals[c] = run + qt::final_cost<N>(g.qf, g.xf_ref, x);
    }
    __syncthreads();

    // ---- 4. first-accept select and bookkeeping -----------------------------
    if (tid == 0) {
      const T cur = cur_cost;
      int first = -1;
      for (int c = 0; c < g.n_alpha; ++c) {
        if (totals[c] <= cur) {
          first = c;
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
  T* const* o = reinterpret_cast<T* const*>(out);
  g.x = o[0];
  g.u = o[1];
  g.k = o[2];
  g.big_k = o[3];
  g.stats = o[4];
  carve(g, static_cast<T*>(workspace), Plant<T>::N, Plant<T>::M);
  solve_kernel<T, Plant<T>><<<1, kThreads, 0, stream>>>(g, Plant<T>::from(params));
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
// in: the nine input arrays in the order of the header comment; out: the five
// outputs (host arrays of device pointers). workspace_elems is the size of the
// workspace that was allocated. Returns 0 or the cudaError_t of the launch.
extern "C" int qt_fused_solve(int dtype, int plant, int H, int n_alpha, int max_iter, int rk4,
                              const double* params, double dt, double reg, double tol,
                              double barrier_alpha, double barrier_beta, const void* const* in,
                              void* const* out, void* workspace, long long workspace_elems,
                              void* stream) {
  const long long need = qt_fused_solve_workspace(plant, H, n_alpha);
  if (need < 0 || workspace_elems < need || n_alpha > kMaxAlphas || max_iter < 0 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_LAUNCH(T, Plant)                                                                      \
  launch<T, Plant>(H, n_alpha, max_iter, rk4, params, dt, reg, tol, barrier_alpha, barrier_beta, \
                   in, out, workspace, s)
  if (plant == 0) return dtype == 0 ? QT_LAUNCH(float, qt::Quadrotor) : QT_LAUNCH(double, qt::Quadrotor);
  return dtype == 0 ? QT_LAUNCH(float, qt::CartPole) : QT_LAUNCH(double, qt::CartPole);
#undef QT_LAUNCH
}
