"""Port parity: the horizon-partitioned and pod-scale Riccati passes against quattro_tpu, on virtual CPU meshes.

JAX's own mesh functions (``shard_map``) compile for minutes on a CPU mesh,
so they are never called here. Each phase of the port's pass is held to the
JAX function of that phase at rtol 1e-9 (the condensing fold to
``horizon._local_block_element``, each exchange round to chains of
``riccati._combine``, each block's solve to ``riccati_backward``), and the
whole pass to JAX's sequential ``riccati_backward`` at the tolerances of
``tests/test_parallel.py`` (the two forms place reg differently). Inputs
come from numpy seeds, float64; the port runs on meshes that name the CPU
8 times.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quattro_tpu import solver as jsolver
from quattro_tpu import systems as jsystems
from quattro_tpu.parallel import horizon as jhorizon
from quattro_tpu.solver import riccati as jric
from quattro_tpu.solver.derivatives import CostExpansion as JCostExpansion
from quattro_tpu_torch.parallel import collectives, horizon, make_mesh, podscale_riccati_backward
from quattro_tpu_torch.parallel import sharded_riccati_backward, sharded_suffix_value_functions
from quattro_tpu_torch.solver import riccati as tric
from quattro_tpu_torch.solver.derivatives import CostExpansion
from quattro_tpu_torch.utils import verify_halo_exchange

RTOL = 1e-9
ATOL = 1e-11

# JAX's phase functions, jitted: eagerly they dispatch the unrolled LU op by op.
j_combine = jax.jit(jric._combine)
j_stage_elements = jax.jit(jric._stage_elements)
j_stage_factors = jax.jit(jric._stage_elements_with_factors)
j_block_element = jax.jit(jhorizon._local_block_element)
j_suffix_scan = jax.jit(jhorizon._local_suffix_scan)


def cpu_mesh(shape, names=("traj", "horizon")):
    return make_mesh(shape, names, devices=["cpu"] * int(np.prod(shape)))


def random_lq(horizon, n=12, m=4, seed=7, batch=()):
    """``tests/test_parallel.py::random_lq``'s distribution from a numpy seed: numpy (a, b, exp fields, v_x, v_xx)."""
    rng = np.random.default_rng(seed)
    lead = tuple(batch) + (horizon,)
    tr = lambda x: np.swapaxes(x, -1, -2)
    a = np.eye(n) + 0.01 * rng.standard_normal(lead + (n, n))
    b = 0.05 * rng.standard_normal(lead + (n, m))
    w, wu = rng.standard_normal(lead + (n, n)), rng.standard_normal(lead + (m, m))
    exp = (rng.standard_normal(lead + (n,)), rng.standard_normal(lead + (m,)), 0.1 * w @ tr(w) + 0.1 * np.eye(n),
           0.1 * wu @ tr(wu) + np.eye(m), 0.1 * rng.standard_normal(lead + (m, n)))
    wf = rng.standard_normal(tuple(batch) + (n, n))
    return a, b, exp, rng.standard_normal(tuple(batch) + (n,)), wf @ tr(wf) + np.eye(n)


def to_torch(a, b, exp, v_x, v_xx):
    t = lambda v: torch.from_numpy(np.asarray(v))
    return t(a), t(b), CostExpansion(*(t(e) for e in exp)), t(v_x), t(v_xx)


def to_jax(a, b, exp, v_x, v_xx):
    j = jnp.asarray
    return j(a), j(b), JCostExpansion(*(j(e) for e in exp)), j(v_x), j(v_xx)


def close(out, ref, rtol=RTOL, atol=ATOL):
    for o, r in zip(out, ref):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=rtol, atol=atol)


def blocks(stages, num):
    """The numpy stages cut into ``num`` horizon blocks: [(a, b, exp)]."""
    a, b, exp = stages[:3]
    size = a.shape[0] // num
    cut = lambda x, d: x[d * size:(d + 1) * size]
    return [(cut(a, d), cut(b, d), tuple(cut(e, d) for e in exp)) for d in range(num)]


def port_block_elements(stages, num):
    """The port's phase 1 on each block (terminal tail on the last): the block elements, by shard index."""
    n = stages[3].shape[-1]
    out = []
    for d, (a, b, exp) in enumerate(blocks(stages, num)):
        elems, b_f, p_f = tric._stage_elements_with_factors(*to_torch(a, b, exp, stages[3], stages[4])[:3], 1e-6)
        tail = (tric._terminal_element(torch.from_numpy(stages[3]), torch.from_numpy(stages[4])) if d == num - 1
                else horizon._identity_element(n, torch.float64))
        out.append(horizon._local_block_element(elems, b_f, p_f, tail))
    return out


@pytest.mark.parametrize("num", [2, 8])
def test_block_fold_matches_jax(num):
    """Phase 1: each block's condensing fold (stage elements, then the Woodbury fold) against JAX's."""
    stages = random_lq(64)
    ours = port_block_elements(stages, num)
    jterm = jric._terminal_element(jnp.asarray(stages[3]), jnp.asarray(stages[4]))
    for d, (a, b, exp) in enumerate(blocks(stages, num)):
        ja, jb, jexp = to_jax(a, b, exp, stages[3], stages[4])[:3]
        elems, b_f, p_f = j_stage_factors(ja, jb, jexp, 1e-6)
        tail = jterm if d == num - 1 else jhorizon._identity_element(12, jnp.float64)
        close(ours[d], j_block_element(elems, b_f, p_f, tail))


def jax_chain(elems):
    """``e_0 ∘ e_1 ∘ ... ∘ e_k`` by JAX's ``_combine``, composed from the right."""
    acc = elems[-1]
    for e in reversed(elems[:-1]):
        acc = j_combine(e, acc)
    return acc


class RecordingComm(collectives.AxisComm):
    """An ``AxisComm`` that keeps each round's payloads, by shard index."""

    def __init__(self, *args):
        super().__init__(*args)
        self.rounds = []

    def ppermute(self, values, perm):
        self.rounds.append({self.axis_index(c): v for c, v in values.items()})
        return super().ppermute(values, perm)


@pytest.mark.parametrize("mode", ["tree", "ring"])
@pytest.mark.parametrize("num", [2, 3, 8])
def test_exchange_rounds_match_combine_chains(num, mode):
    """Phase 2: what each shard sends in each round, and what it receives at the end, against chains of JAX's
    ``_combine`` over the block elements: tree round r sends the inclusive suffix over [d, min(d + 2^r, D)),
    ring hop r forwards block d + r - 1 (mod D); shard d ends with block[d+1] ∘ ... ∘ block[D-1]."""
    stages = random_lq(8 * num, seed=3)
    ours = port_block_elements(stages, num)
    mesh = cpu_mesh((num,), ("horizon",))
    comm = RecordingComm(mesh, "horizon", mesh.coords(("horizon",)))
    ident = {c: horizon._identity_element(12, torch.float64) for c in comm.local}
    out = horizon.cross_device_exclusive_suffix({c: ours[c[0]] for c in comm.local}, comm, ident, mode)
    jblocks = [jric.ValueElement(*(jnp.asarray(f.numpy()) for f in e)) for e in ours]
    for r, sent in enumerate(comm.rounds):
        for d, value in sent.items():
            if mode == "ring":
                close(value, jblocks[(d + r) % num])
            else:  # the last round sends the whole inclusive suffix
                close(value, jax_chain(jblocks[d:min(d + 2 ** r, num)] if r < len(comm.rounds) - 1 else jblocks[d:]))
    expect_rounds = num - 1 if mode == "ring" else math.ceil(math.log2(num)) + 1
    assert len(comm.rounds) == expect_rounds
    for (c,), value in out.items():
        if c == num - 1:
            close(value, ident[(c,)], rtol=0, atol=0)
        else:
            close(value, jax_chain(jblocks[c + 1:]))


def test_block_solves_match_jax_riccati():
    """Phase 3: each shard's block against JAX's ``riccati_backward`` from the right-edge value the exchange gave."""
    stages = random_lq(64)
    num = 4
    ours = sharded_riccati_backward(cpu_mesh((1, num)), *to_torch(*stages))
    ours_blocks = port_block_elements(stages, num)
    size = 64 // num
    for d, (a, b, exp) in enumerate(blocks(stages, num)):
        if d == num - 1:
            v_x, v_xx = jnp.asarray(stages[3]), jnp.asarray(stages[4])
        else:
            edge = jax_chain([jric.ValueElement(*(jnp.asarray(f.numpy()) for f in e)) for e in ours_blocks[d + 1:]])
            v_x, v_xx = -edge.eta, edge.j
        ref = jric.riccati_backward(*to_jax(a, b, exp, stages[3], stages[4])[:3], v_x, v_xx, 1e-6)
        sl = slice(d * size, (d + 1) * size)
        close((ours.k_seq[sl], ours.big_k_seq[sl], ours.v_x_seq[sl], ours.v_xx_seq[sl]),
              (ref.k_seq, ref.big_k_seq, ref.v_x_seq[:-1], ref.v_xx_seq[:-1]))


@pytest.mark.parametrize("shards,horizon_len", [(2, 64), (4, 64), (8, 256)])
def test_horizon_partitioned_riccati_matches_jax_sequential(shards, horizon_len):
    """``tests/test_parallel.py``'s shapes and tolerances, against JAX's sequential pass."""
    stages = random_lq(horizon_len)
    par = sharded_riccati_backward(cpu_mesh((8 // shards, shards)), *to_torch(*stages))
    seq = jric.riccati_backward(*to_jax(*stages))
    np.testing.assert_allclose(par.v_x_seq.numpy(), np.asarray(seq.v_x_seq), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(par.k_seq.numpy(), np.asarray(seq.k_seq), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(par.big_k_seq.numpy(), np.asarray(seq.big_k_seq), rtol=1e-3, atol=1e-5)
    v_x, v_xx = sharded_suffix_value_functions(cpu_mesh((8 // shards, shards)), *to_torch(*stages))
    close((v_x, v_xx), (par.v_x_seq[:-1], par.v_xx_seq[:-1]), rtol=0, atol=0)


def test_horizon_partitioned_riccati_cartpole():
    """The cart-pole LQ subproblem of ``tests/test_parallel.py`` (JAX's solve, linearization and expansions)."""
    dyn = jsystems.make_discrete(jsystems.cartpole_dynamics, 0.01, "rk4")
    cost = jsolver.make_quadratic_cost(jnp.array([5.0, 0.1, 10.0, 0.1]), jnp.array([0.001]), jnp.zeros(4))
    fcost = jsolver.make_quadratic_final_cost(jnp.array([50.0, 6.0, 100.0, 0.1]), jnp.zeros(4))
    sol = jsolver.ilqr_solve(dyn, cost, fcost, jnp.array([0.2, 0.0, 0.3, 0.0]), jnp.zeros((32, 1)),
                             jsolver.ILQRConfig(tol=1e-1))
    a, b = jsolver.linearize_dynamics(dyn, sol.x_seq, sol.u_seq)
    exp = jsolver.quadratize_cost(cost, sol.x_seq, sol.u_seq)
    fexp = jsolver.quadratize_final_cost(fcost, sol.x_seq[-1])
    stages = tuple(np.array(x) for x in (a, b)) + (tuple(np.array(e) for e in exp),
                                                    np.array(fexp.v_x), np.array(fexp.v_xx))
    seq = jric.riccati_backward(a, b, exp, fexp.v_x, fexp.v_xx)
    par = sharded_riccati_backward(cpu_mesh((1, 8)), *to_torch(*stages))
    np.testing.assert_allclose(par.k_seq.numpy(), np.asarray(seq.k_seq), rtol=3e-3, atol=1e-4)
    np.testing.assert_allclose(par.big_k_seq.numpy(), np.asarray(seq.big_k_seq), rtol=3e-3, atol=1e-3)


def test_tree_and_ring_halo_schedules_agree():
    """``tests/test_parallel.py``'s case: tree and ring agree to 1e-12 and both match the sequential pass;
    an unknown schedule raises."""
    mesh = cpu_mesh((1, 8))
    stages = to_torch(*random_lq(48, n=6, m=2, seed=11))
    tree = sharded_riccati_backward(mesh, *stages, scan_mode="tree")
    ring = sharded_riccati_backward(mesh, *stages, scan_mode="ring")
    seq = jric.riccati_backward(*to_jax(*random_lq(48, n=6, m=2, seed=11)))
    np.testing.assert_allclose(tree.k_seq.numpy(), ring.k_seq.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tree.v_x_seq.numpy(), ring.v_x_seq.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tree.k_seq.numpy(), np.asarray(seq.k_seq), rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError, match="butterfly"):
        sharded_riccati_backward(mesh, *stages, scan_mode="butterfly")


@pytest.mark.parametrize("mode", ["tree", "ring"])
@pytest.mark.parametrize("num", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [4, 12])
def test_halo_schedule_spec_equals_jax(n, dtype, num, mode):
    ours = horizon.halo_schedule_spec(n, getattr(torch, dtype), num, mode)
    assert ours == jhorizon.halo_schedule_spec(n, getattr(jnp, dtype), num, mode)


@pytest.mark.parametrize("mode", ["tree", "ring"])
@pytest.mark.parametrize("num", [1, 2, 4, 8])
def test_hop_counter_of_one_pass_equals_the_spec(num, mode):
    """The hops one pass makes: ``rounds`` ppermutes, each of ``payload_bytes_per_hop`` bytes."""
    stages = to_torch(*random_lq(8 * num, n=4, m=2))
    collectives.hops.reset()
    sharded_riccati_backward(cpu_mesh((num,), ("horizon",)), *stages, scan_mode=mode)
    spec = horizon.halo_schedule_spec(4, torch.float64, num, mode)
    assert collectives.hops.rounds == spec["rounds"]
    assert collectives.hops.bytes_per_hop == [spec["payload_bytes_per_hop"]] * spec["rounds"]
    with pytest.raises(ValueError):
        horizon.halo_schedule_spec(4, torch.float64, num, mode="butterfly")


def test_local_suffix_scan_matches_jax():
    stages = random_lq(9, n=6, m=2, seed=5)
    elems = tric._stage_elements(*to_torch(*stages)[:3], 1e-6)
    ref = j_suffix_scan(jric.ValueElement(*(jnp.asarray(f.numpy()) for f in elems)))
    close(horizon._local_suffix_scan(elems), ref)


def podscale_problem():
    """``tests/test_parallel.py::test_podscale_riccati_2d_mesh``'s problem from a numpy seed."""
    batch, horizon_len, n, m = 4, 32, 6, 2
    rng = np.random.default_rng(11)
    a = np.eye(n) + 0.01 * rng.standard_normal((batch, horizon_len, n, n))
    b = 0.05 * rng.standard_normal((batch, horizon_len, n, m))
    w = rng.standard_normal((batch, horizon_len, n, n))
    exp = (rng.standard_normal((batch, horizon_len, n)), rng.standard_normal((batch, horizon_len, m)),
           0.1 * w @ np.swapaxes(w, -1, -2) + 0.1 * np.eye(n),
           np.broadcast_to(np.eye(m), (batch, horizon_len, m, m)).copy(),
           0.05 * rng.standard_normal((batch, horizon_len, m, n)))
    wf = rng.standard_normal((batch, n, n))
    return a, b, exp, rng.standard_normal((batch, n)), wf @ np.swapaxes(wf, -1, -2) + np.eye(n)


def test_podscale_matches_jax_sequential_per_trajectory():
    stages = podscale_problem()
    pod = podscale_riccati_backward(cpu_mesh((2, 4)), *to_torch(*stages))
    a, b, exp, v_x, v_xx = to_jax(*stages)
    for i in range(a.shape[0]):
        seq = jric.riccati_backward(a[i], b[i], JCostExpansion(*(f[i] for f in exp)), v_x[i], v_xx[i])
        np.testing.assert_allclose(pod.k_seq[i].numpy(), np.asarray(seq.k_seq), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(pod.big_k_seq[i].numpy(), np.asarray(seq.big_k_seq), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(pod.v_x_seq[i].numpy(), np.asarray(seq.v_x_seq), rtol=1e-3, atol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_podscale(num_h, reg=1e-6):
    """The pod-scale pass on ``podscale_problem`` written from JAX's phase functions, one trajectory at a time,
    blocks in a loop."""
    a, b, exp, v_x, v_xx = to_jax(*podscale_problem())
    n, horizon_len = v_x.shape[-1], a.shape[1]
    size = horizon_len // num_h
    ident = jhorizon._identity_element(n, jnp.float64)
    q_gains = jax.jit(jax.vmap(lambda *q: jric._gains_and_value(*jric._q_expansion(*q), reg)[:2]))
    combine_all = jax.jit(jax.vmap(jric._combine, in_axes=(0, None)))
    out = []
    for i in range(a.shape[0]):
        local, block = [], []
        for h in range(num_h):
            sl = slice(h * size, (h + 1) * size)
            elems = j_stage_elements(a[i, sl], b[i, sl], JCostExpansion(*(f[i, sl] for f in exp)), reg)
            tail = jric._terminal_element(v_x[i], v_xx[i]) if h == num_h - 1 else ident
            elems = jric.ValueElement(*(jnp.concatenate([e, t[None]]) for e, t in zip(elems, tail)))
            suffix = j_suffix_scan(elems)
            block.append(jax.tree.map(lambda x: x[0], suffix))
            local.append(jax.tree.map(lambda x: x[:-1], suffix))
        values = []
        for h in range(num_h):
            acc = jax_chain(block[h + 1:]) if h < num_h - 1 else ident
            combined = combine_all(local[h], acc)
            values.append((-combined.eta, combined.j))
        v_x_all = jnp.concatenate([v for v, _ in values] + [v_x[i][None]])
        v_xx_all = jnp.concatenate([v for _, v in values] + [v_xx[i][None]])
        k, big_k = q_gains(a[i], b[i], *(f[i] for f in exp), v_x_all[1:], v_xx_all[1:])
        out.append((k, big_k, v_x_all, v_xx_all))
    return [np.stack([np.asarray(o[j]) for o in out]) for j in range(4)]


@pytest.mark.parametrize("mode", ["tree", "ring"])
def test_podscale_matches_jax_phase_functions(mode):
    """At 1e-9 against the same computation written from JAX's ``_stage_elements``, ``_local_suffix_scan``,
    ``_combine``, ``_q_expansion`` and ``_gains_and_value``."""
    stages = podscale_problem()
    pod = podscale_riccati_backward(cpu_mesh((2, 4)), *to_torch(*stages), scan_mode=mode)
    close(pod, jax_podscale(4))


def test_verify_halo_exchange_flags_one_flipped_bit():
    """A clean hop checks 0.0 on every shard; one bit flipped in one shard's received payload gives 1.0 there."""
    mesh = cpu_mesh((4,), ("horizon",))
    comm = collectives.AxisComm(mesh, "horizon", mesh.coords(("horizon",)))
    ours = port_block_elements(random_lq(16), 4)
    sent = {c: ours[c[0]] for c in comm.local}
    perm = [(i, (i - 1) % 4) for i in range(4)]
    received = comm.ppermute(sent, perm)
    assert all(float(v) == 0.0 for v in verify_halo_exchange(sent, received, comm, perm).values())
    corrupted = dict(received)
    j = corrupted[(2,)].j.clone()
    j.view(torch.int64)[1, 3] ^= 1  # the lowest mantissa bit of one entry
    corrupted[(2,)] = corrupted[(2,)]._replace(j=j)
    flags = verify_halo_exchange(sent, corrupted, comm, perm)
    assert {c[0]: float(v) for c, v in flags.items()} == {0: 0.0, 1: 0.0, 2: 1.0, 3: 0.0}
    assert all(v.dtype == torch.float32 for v in flags.values())
