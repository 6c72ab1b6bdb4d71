"""The plain reference: iLQR with an all-alpha first-accept line search, in plain PyTorch.

It solves the configuration's problem from the inputs the benchmark handed to
the program (the start state and the warm-start controls) and never reads
anything the program made. Every lane of a batch is one problem; the loop runs
them in lockstep over fixed trips under a ``done`` mask, the stopping rule
being: no step size accepted, or |J - J_new| < tol.

The program decides in float32, so where a decision of the reference lies
within the rounding of a float32 cost (a candidate's cost against the current
one, or |dJ| against tol), either outcome is a sound solve. ``solve`` then
follows both, and returns every such leaf of a problem; the judge compares the
program's answer with the nearest leaf. ``Precision`` says how the reference
computes: float64 for the reference itself; float32 with the operands of every
matrix product rounded to TF32 (10 mantissa bits, as the tensor cores read
them) for the control.

Derivatives: the dynamics' Jacobians by reverse-mode autograd of the RK4
step, one backward pass per state row over every (lane, t) at once (forward
mode imports ``torch._dynamo`` on its first call, seconds of every run); the
cost's expansion in closed form (quadratic tracking plus the
softplus-squared control barrier). Nothing here imports the program.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from bench_cuda.reference.plants import FIELDS, rk4_step

TIE_REL = 2e-6  # a float32 sum of a trajectory's costs is good to a few 1e-7 of its size
TIE_ABS = 1e-9
MAX_LEAVES = 32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class Precision(NamedTuple):
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


REFERENCE = Precision()
CONTROL_TF32 = Precision(torch.float32, True)


def _softplus(z, beta):
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-beta * z.abs())) / beta


class Problem:
    """The configuration's plant, cost tables and solver constants, on ``device`` in ``precision``."""

    def __init__(self, config: dict, precision: Precision = REFERENCE, device="cpu"):
        self.precision = precision
        dtype = precision.dtype
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        self.field = FIELDS[config["plant"]]
        self.params = config["params"]
        self.dt = float(config["dt"])
        self.q, self.r, self.qf = torch.diag(t(config["q"])), torch.diag(t(config["r"])), torch.diag(t(config["qf"]))
        self.x_ref = t(config["x_ref"])
        self.barrier_alpha = float(config["barrier_alpha"])
        self.barrier_beta = float(config["barrier_beta"])
        self.reg = float(config["reg"])
        self.alphas = t(config["alphas"])
        self.n, self.m = len(config["q"]), len(config["r"])
        self.dtype, self.device = dtype, device

    def tensor(self, value) -> torch.Tensor:
        return torch.as_tensor(value).to(dtype=self.dtype, device=self.device)

    def step(self, x, u):
        return rk4_step(self.field, x, u, self.params, self.dt, torch)

    def rollout(self, x0, u):
        """Open-loop rollouts: x0 (..., n), u (..., H, m) -> (..., H+1, n)."""
        xs = [x0]
        for t in range(u.shape[-2]):
            xs.append(self.step(xs[-1], u[..., t, :]))
        return torch.stack(xs, -2)

    def _quad(self, d, w):
        return (d * self.precision.mm(d, w)).sum(-1)

    def running_cost(self, x, u):
        value = self._quad(x - self.x_ref, self.q) + self._quad(u, self.r)
        if self.barrier_alpha > 0.0:
            value = value + self.barrier_alpha * (_softplus(-u, self.barrier_beta) ** 2).sum(-1)
        return value

    def final_cost(self, x):
        return self._quad(x - self.x_ref, self.qf)

    def trajectory_cost(self, xs, us):
        """Running costs summed in time order, the final cost last: (..., H+1, n), (..., H, m) -> (...)."""
        total = torch.zeros(xs.shape[:-2], dtype=self.dtype, device=self.device)
        for t in range(us.shape[-2]):
            total = total + self.running_cost(xs[..., t, :], us[..., t, :])
        return total + self.final_cost(xs[..., -1, :])

    def jacobians(self, xs, us):
        """(A, B) of the RK4 step at every (lane, t): (L, H, n, n), (L, H, n, m)."""
        lanes, horizon = us.shape[:2]
        x = xs[:, :-1].reshape(-1, self.n).detach().requires_grad_(True)
        u = us.reshape(-1, self.m).detach().requires_grad_(True)
        with torch.enable_grad():
            out = self.step(x, u)
            # Rows are independent, so the gradient of a row's sum over them is that row of every Jacobian.
            rows = [torch.autograd.grad(out[:, i].sum(), (x, u), retain_graph=i + 1 < self.n, materialize_grads=True)
                    for i in range(self.n)]
        a, b = torch.stack([row[0] for row in rows], -2), torch.stack([row[1] for row in rows], -2)
        return a.reshape(lanes, horizon, self.n, self.n), b.reshape(lanes, horizon, self.n, self.m)

    def cost_expansion(self, xs, us):
        """(l_x, l_u, l_xx, l_uu) of the running cost in closed form; l_ux is zero."""
        q2, r2 = self.q + self.q.T, self.r + self.r.T
        l_x = self.precision.mm(xs[:, :-1] - self.x_ref, q2.T)
        l_u = self.precision.mm(us, r2.T)
        l_uu = r2.expand(us.shape[:2] + r2.shape).clone()
        if self.barrier_alpha > 0.0:
            beta = self.barrier_beta
            sp, sig = _softplus(-us, beta), torch.sigmoid(-beta * us)
            l_u = l_u - 2.0 * self.barrier_alpha * sp * sig
            curv = 2.0 * self.barrier_alpha * (sig * sig + beta * sp * sig * (1.0 - sig))
            l_uu = l_uu + torch.diag_embed(curv)
        return l_x, l_u, q2, l_uu

    def backward(self, xs, us):
        """Sequential Riccati recursion: gains from Q_uu + reg I, value update with the raw Q_uu, V_xx symmetrized."""
        mm = self.precision.mm
        tr = lambda z: z.transpose(-1, -2)
        a, b = self.jacobians(xs, us)
        l_x, l_u, l_xx, l_uu = self.cost_expansion(xs, us)
        qf2 = self.qf + self.qf.T
        v_x = mm(xs[:, -1] - self.x_ref, qf2.T)[..., None]
        v_xx = qf2.expand(xs.shape[:1] + qf2.shape)
        lanes, horizon = us.shape[:2]
        k = torch.empty((lanes, horizon, self.m), dtype=self.dtype, device=self.device)
        big_k = torch.empty((lanes, horizon, self.m, self.n), dtype=self.dtype, device=self.device)
        eye = torch.eye(self.m, dtype=self.dtype, device=self.device)
        for t in reversed(range(horizon)):
            at, bt = a[:, t], b[:, t]
            q_x = l_x[:, t, :, None] + mm(tr(at), v_x)
            q_u = l_u[:, t, :, None] + mm(tr(bt), v_x)
            vxx_a, vxx_b = mm(v_xx, at), mm(v_xx, bt)
            q_xx = l_xx + mm(tr(at), vxx_a)
            q_ux = mm(tr(bt), vxx_a)
            q_uu = l_uu[:, t] + mm(tr(bt), vxx_b)
            chol = torch.linalg.cholesky(q_uu + self.reg * eye)
            sol = -torch.cholesky_solve(torch.cat([q_u, q_ux], -1), chol)
            kt, big_kt = sol[..., :1], sol[..., 1:]
            v_x = q_x + mm(tr(big_kt), mm(q_uu, kt)) + mm(tr(big_kt), q_u) + mm(tr(q_ux), kt)
            v_xx = q_xx + mm(tr(big_kt), mm(q_uu, big_kt)) + mm(tr(big_kt), q_ux) + mm(tr(q_ux), big_kt)
            v_xx = 0.5 * (v_xx + tr(v_xx))
            k[:, t], big_k[:, t] = kt[..., 0], big_kt
        return k, big_k

    def line_search_candidates(self, xs, us, k, big_k):
        """Closed-loop rollouts u = u_bar + alpha (k + K (x - x_bar)) for every alpha: (L, A, H+1, n), (L, A, H, m), costs (L, A)."""
        alphas = self.alphas[None, :, None]
        x = xs[:, None, 0].expand(-1, len(self.alphas), -1)
        cx, cu = [x], []
        for t in range(us.shape[1]):
            du = k[:, None, t] + self.precision.mm(big_k[:, None, t], (x - xs[:, None, t])[..., None])[..., 0]
            u = us[:, None, t] + alphas * du
            x = self.step(x, u)
            cx.append(x)
            cu.append(u)
        cand_x, cand_u = torch.stack(cx, -2), torch.stack(cu, -2)
        return cand_x, cand_u, self.trajectory_cost(cand_x, cand_u)


class Leaf(NamedTuple):
    x_seq: torch.Tensor  # (H+1, n)
    u_seq: torch.Tensor  # (H, m)
    cost: float
    iterations: int
    nominal: bool  # every decision as the reference itself takes it


def _near(a: float, b: float) -> bool:
    return abs(a - b) <= TIE_REL * max(abs(a), abs(b)) + TIE_ABS


def _outcomes(cur: float, totals: List[float], tol: float, follow_ties: bool):
    """The (chosen alpha index or None, done, nominal) outcomes of one trip's select and stopping rule."""
    picks = []  # (index or None, nominal)
    nominal_pick = next((j for j, tot in enumerate(totals) if tot <= cur), None)
    for j, tot in enumerate(totals):
        if follow_ties and _near(tot, cur):
            picks.append(j)
            continue
        if tot <= cur:
            picks.append(j)
            break
    else:
        picks.append(None)
    if not follow_ties:
        picks = [nominal_pick]
    out = []
    for j in dict.fromkeys([nominal_pick] + picks):
        new = cur if j is None else totals[j]
        diff = abs(cur - new)
        smalls = [diff < tol]
        # |dJ| is a difference of two costs: it carries their rounding, not its own.
        if follow_ties and j is not None and abs(diff - tol) <= TIE_REL * max(abs(cur), abs(new)) + TIE_ABS:
            smalls.append(not smalls[0])
        for small in smalls:
            out.append((j, j is None or small, j == nominal_pick and small == (diff < tol)))
    return out


class _Lanes:
    """The lockstep state: one row per followed branch of a problem (its owner)."""

    def __init__(self, xs, us, cur, count):
        self.xs, self.us, self.cur = xs, us, cur
        self.owner = list(range(count))
        self.done = [False] * count
        self.nominal = [True] * count
        self.iters = [0] * count


def _branch(problem: Problem, lanes: _Lanes, subset: List[int], candidates, tol: float, follow_ties: bool) -> _Lanes:
    """One select over the ``subset`` of lanes with their ``candidates`` (cand_x, cand_u, totals); others pass through."""
    cand_x, cand_u, totals = candidates
    n_alpha = totals.shape[1]
    totals_h, cur_h = totals.tolist(), lanes.cur.tolist()
    slot = {lane: a for a, lane in enumerate(subset)}
    per_owner = {}
    for owner in lanes.owner:
        per_owner[owner] = per_owner.get(owner, 0) + 1
    out = dict(src=[], pick=[], done=[], nominal=[], iters=[], owner=[])
    for i in range(len(lanes.owner)):
        if i not in slot:
            choices = [(None, lanes.done[i], True, 0)]
        else:
            choices = [(j, stop, nom, 1) for j, stop, nom in _outcomes(cur_h[i], totals_h[slot[i]], tol, follow_ties)]
        for n_choice, (j, now_done, nom, step) in enumerate(choices):
            owner = lanes.owner[i]
            if n_choice:
                if per_owner[owner] >= MAX_LEAVES:
                    break
                per_owner[owner] += 1
            out["src"].append(i)
            out["pick"].append(-1 if (i not in slot or j is None) else slot[i] * n_alpha + j)
            out["done"].append(now_done)
            out["nominal"].append(lanes.nominal[i] and nom)
            out["iters"].append(lanes.iters[i] + step)
            out["owner"].append(owner)
    src = torch.tensor(out["src"], device=problem.device)
    pick = torch.tensor(out["pick"], device=problem.device)
    chosen, safe = pick >= 0, pick.clamp(min=0)
    flat = lambda c: c.reshape((-1,) + c.shape[2:])
    mask = chosen[:, None, None]
    new = _Lanes(torch.where(mask, flat(cand_x)[safe], lanes.xs[src]),
                 torch.where(mask, flat(cand_u)[safe], lanes.us[src]),
                 torch.where(chosen, totals.reshape(-1)[safe], lanes.cur[src]), 0)
    new.owner, new.done, new.nominal, new.iters = out["owner"], out["done"], out["nominal"], out["iters"]
    return new


def solve(problem: Problem, x0: torch.Tensor, u_init: torch.Tensor, max_iter: int, tol: float,
          follow_ties: bool = True) -> List[List[Leaf]]:
    """Solve each lane of x0 (L, n), u_init (L, H, m) over up to ``max_iter`` trips; returns each lane's leaves.

    The first trip starts from the open-loop rollout of ``u_init`` and its
    cost. With ``follow_ties`` every
    outcome within float32 rounding of a decision is followed, up to
    ``MAX_LEAVES`` per lane, the reference's own outcome first; without, one
    leaf per lane.
    """
    x0, u_init = problem.tensor(x0), problem.tensor(u_init)
    xs = problem.rollout(x0, u_init)
    lanes = _Lanes(xs, u_init, problem.trajectory_cost(xs, u_init), len(x0))
    for _ in range(max_iter):
        active = [i for i in range(len(lanes.owner)) if not lanes.done[i]]
        if not active:
            break
        idx = torch.tensor(active, device=problem.device)
        k, big_k = problem.backward(lanes.xs[idx], lanes.us[idx])
        candidates = problem.line_search_candidates(lanes.xs[idx], lanes.us[idx], k, big_k)
        lanes = _branch(problem, lanes, active, candidates, tol, follow_ties)
    leaves: List[List[Leaf]] = [[] for _ in range(len(x0))]
    cur_h = lanes.cur.tolist()
    for i in range(len(lanes.owner)):
        leaves[lanes.owner[i]].append(Leaf(lanes.xs[i], lanes.us[i], cur_h[i], lanes.iters[i], lanes.nominal[i]))
    for lane in leaves:
        lane.sort(key=lambda leaf: not leaf.nominal)
    return leaves
