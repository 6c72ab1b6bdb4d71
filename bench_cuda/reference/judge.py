"""The comparison that decides ``correct``: the program's answers against the plain reference's.

Two numbers for every judged answer, each the widest over the sample:

- ``u_gap`` (controls' units), compared: the largest |u - u_ref| over the
  horizon and the controls, against the nearest of the reference's leaves
  (the solves that differ from the reference's own only by a decision within
  float32 rounding, see ``ilqr.solve``). It covers the dynamics and their
  derivatives, the backward pass, the line search and the stopping rule.
- ``plan_gap`` (states' units), reported and not compared: the largest
  |x - x_ref| between the program's planned trajectory and the reference's
  float64 rollout of the program's own controls from the same start. The
  control reads it as the program does (the plants hold no matrix product for
  TF32 to round), so no limit could separate the two.

The control for a configuration stated in float32 with TF32 off is the
reference itself in TF32 (``ilqr.CONTROL_TF32``), put in the program's place
on the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench_cuda.reference import ilqr


def control_answers(config: dict, x0, u_init, max_iter: int, tol: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The control's answers (x (L, H+1, n), u (L, H, m)): the reference solved in TF32, its own decisions."""
    leaves = ilqr.solve(ilqr.Problem(config, ilqr.CONTROL_TF32), x0, u_init, max_iter, tol, follow_ties=False)
    return torch.stack([lane[0].x_seq for lane in leaves]), torch.stack([lane[0].u_seq for lane in leaves])


def gaps(config: dict, x0, u_init, x_answer, u_answer, max_iter: int, tol: float) -> Tuple[Dict[str, float], List[int]]:
    """({"u_gap": compared, "plan_gap": reported}, the iterations of the leaf nearest each answer)."""
    problem = ilqr.Problem(config)
    leaves = ilqr.solve(problem, x0, u_init, max_iter, tol)
    u_answer, x_answer = problem.tensor(u_answer), problem.tensor(x_answer)
    plan = problem.rollout(problem.tensor(x0), u_answer)
    u_gap, iterations = 0.0, []
    for lane, answer in zip(leaves, u_answer):
        nearest = min(lane, key=lambda leaf: float((answer - leaf.u_seq).abs().max()))
        u_gap = max(u_gap, float((answer - nearest.u_seq).abs().max()))
        iterations.append(nearest.iterations)
    plan_gap = float((x_answer - plan).abs().max())
    if not (torch.isfinite(u_answer).all() and torch.isfinite(x_answer).all()):
        u_gap = plan_gap = float("inf")
    return {"u_gap": u_gap, "plan_gap": plan_gap}, iterations
