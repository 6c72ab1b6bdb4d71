"""The port's multi-process runtime: the single-process no-op and a real two-process run over gloo.

As ``tests/test_distributed.py`` does for the JAX package, two OS processes
join one process group on this host (the gloo backend, CPU tensors): a
cross-process ``psum`` over a global mesh fed host-locally, and the
horizon-partitioned Riccati pass over a 2-rank ``"horizon"`` mesh, each
process holding one horizon block, equal to the single-process pass on a
virtual 2-shard CPU mesh. The workers import the port only.
"""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest

from quattro_tpu_torch.parallel import distributed

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 120


def test_single_process_is_clean_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not distributed.is_initialized()
    assert distributed.process_info() == (0, 1)
    distributed.barrier()  # must not hang or require a runtime
    mesh = distributed.global_mesh((2,), ("traj",), local_devices=["cpu", "cpu"])
    assert mesh.shape == {"traj": 2} and not mesh.spans_processes()


def test_initialize_needs_the_process_counts(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("127.0.0.1:1")


_WORKER = textwrap.dedent(
    """
    import sys
    port, pid = sys.argv[1], int(sys.argv[2])
    import numpy as np
    import torch

    from quattro_tpu_torch.parallel import collectives, distributed, make_mesh, sharded_riccati_backward
    from quattro_tpu_torch.solver import CostExpansion, riccati_backward
    from quattro_tpu_torch.utils import verify_halo_exchange

    ok = distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    assert ok and distributed.is_initialized()
    assert distributed.process_info() == (pid, 2)

    # Host-local -> global, then a cross-process psum over the traj axis.
    mesh = distributed.global_mesh((2,), ("traj",), local_devices=["cpu"])
    assert mesh.spans_processes() and mesh.rank((pid,)) == pid
    garr = distributed.host_local_to_global(mesh, "traj", np.full((2, 4), float(pid + 1)))
    assert garr.shape == (4, 4) and list(garr.shards) == [(pid,)]
    comm = collectives.AxisComm(mesh, "traj", mesh.coords(("traj",)))
    total = comm.psum({c: x.sum() for c, x in garr.shards.items()})
    print("PSUM", float(total[(pid,)]), flush=True)

    # The horizon-partitioned pass, one block per process, fed host-locally.
    mesh = distributed.global_mesh((2,), ("horizon",), local_devices=["cpu"])
    h, n, m = 32, 4, 2
    rng = np.random.default_rng(7)
    t = torch.from_numpy
    a = t(np.eye(n) * 0.9 + 0.05 * rng.standard_normal((h, n, n)))
    b = t(0.1 * rng.standard_normal((h, n, m)))
    exp = CostExpansion(
        l_x=t(0.1 * rng.standard_normal((h, n))), l_u=t(0.1 * rng.standard_normal((h, m))),
        l_xx=t(np.broadcast_to(np.eye(n), (h, n, n)).copy()), l_uu=t(np.broadcast_to(np.eye(m), (h, m, m)).copy()),
        l_ux=t(np.zeros((h, m, n))),
    )
    v_x, v_xx = t(rng.standard_normal(n)), t(np.eye(n) * 2.0)
    half = slice(pid * (h // 2), (pid + 1) * (h // 2))
    g = lambda x: distributed.host_local_to_global(mesh, "horizon", x[half])
    collectives.hops.reset()
    res = sharded_riccati_backward(mesh, g(a), g(b), CostExpansion(*(g(f) for f in exp)), v_x, v_xx)
    assert collectives.hops.rounds == 2, collectives.hops.rounds  # tree, D = 2
    single = sharded_riccati_backward(make_mesh((2,), ("horizon",), devices=["cpu", "cpu"]), a, b, exp, v_x, v_xx)
    ref = riccati_backward(a, b, exp, v_x, v_xx)
    values = half if pid == 0 else slice(half.start, None)  # the last block also holds the terminal entry
    for name, sl in (("k_seq", half), ("big_k_seq", half), ("v_x_seq", values), ("v_xx_seq", values)):
        local = distributed.global_to_host_local(mesh, "horizon", getattr(res, name))
        torch.testing.assert_close(local, getattr(single, name)[sl], rtol=1e-12, atol=0)
        torch.testing.assert_close(local, getattr(ref, name)[sl], rtol=0, atol=1e-6)

    # The halo check across the two processes: clean, then one bit flipped on process 1.
    comm = collectives.AxisComm(mesh, "horizon", mesh.coords(("horizon",)))
    perm = [(0, 1), (1, 0)]
    sent = {c: (a[half][0], v_x) for c in comm.local}
    received = comm.ppermute(sent, perm)
    clean = verify_halo_exchange(sent, received, comm, perm)
    if pid == 1:
        bad = received[(1,)][0].clone()
        bad.view(torch.int64)[0, 0] ^= 1
        received = {(1,): (bad, received[(1,)][1])}
    flagged = verify_halo_exchange(sent, received, comm, perm)
    distributed.barrier()
    print("HALO", float(clean[(pid,)]), float(flagged[(pid,)]), flush=True)
    print("RICCATI-SHARD-OK", flush=True)
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_psum_and_sharded_riccati(tmp_path):
    """Two OS processes, one gloo process group: psum = 8 * 1 + 8 * 2 on both; each process's horizon block of
    the sharded pass equals the single-process pass (rtol 1e-12) and the sequential one (atol 1e-6, as JAX's
    test); the halo check flags the flipped bit on process 1 only."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, str(script), str(port), str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("distributed workers timed out")
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed:\n{out}\n{err}"
        assert "PSUM 24.0" in out, f"unexpected output:\n{out}\n{err}"
        assert f"HALO 0.0 {1.0 if pid == 1 else 0.0}" in out, f"unexpected output:\n{out}\n{err}"
        assert "RICCATI-SHARD-OK" in out, f"unexpected output:\n{out}\n{err}"
