"""The port's multi-host layer (``parallel.multihost`` and
``python -m omg_tools_torch.tools.multihost_launch``) on the CPU over gloo,
in float64.

The launcher's processes join a gloo group on 127.0.0.1 at a free port
(the process group's timeout is 120 s; each process has a timeout of its
own here), one torch thread each (``OMP_NUM_THREADS=1``); the pytest
worker joins no process group.  Each program's processes are started once,
by the first test that asks for them:

- ``fleet``: 4 processes as 2 hosts of 2 (``LOCAL_WORLD_SIZE=2``): a
  (data 2, fleet 2) mesh, N = 4 vehicles, B = 2 instances, one dual
  iteration at outer_iter 1.  Beside them, 2 ranks of
  ``tests/torch_mesh_rank.py --program dual`` compute
  ``make_mesh_dual_update`` on the same fleet; each data row of the
  launcher's result must equal it within 1e-12 (the same lanes, the same
  arithmetic: only the batch's shape differs).
- ``rollout``: 2 processes as 2 hosts of 1 (``LOCAL_WORLD_SIZE=1``: a
  (data 2, fleet 1) mesh), B = 4 scenarios, one step; each rank's rows
  must equal this process's single-process ``BatchedP2PRunner`` rollout of
  the same 4 lanes within 1e-10.  Every decision of that rollout is taken
  lane by lane (no rescue lanes: the launcher's settings), so a shard
  computes what the whole batch computes.

The comparison with the JAX package's hybrid update (one JAX mesh
program, minutes on this CPU) is ``slow``, as tests/test_multihost.py is.
"""

import os
import sys

import numpy as np
import pytest
import torch

from omg_tools_torch.parallel import multihost

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.join(HERE, "..")
sys.path.insert(0, HERE)
import torch_mesh_rank as rank_script  # noqa: E402

TOL_FLEET = 1e-12
TOL_ROLLOUT = 1e-10
FLEET_N, FLEET_B = 4, 2
ROLLOUT_B, ROLLOUT_STEPS = 4, 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def launch(n, program, *flags, **env):
    port = rank_script.free_port()
    return rank_script.Processes(
        [[sys.executable, "-m", "omg_tools_torch.tools.multihost_launch",
          "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
          "--process-id", str(i), "--program", program, "--device", "cpu",
          *flags] for i in range(n)], "MULTIHOST_RESULT", **env)


@pytest.fixture(scope="module")
def fleet_run():
    """The launcher's fleet program on 4 processes and the 2-rank
    ``make_mesh_dual_update`` it is held to, all started together."""
    dual = rank_script.world(2, program="dual")
    fleet = launch(4, "fleet", "--fleet-n", str(FLEET_N), "--batch",
                   str(FLEET_B), LOCAL_WORLD_SIZE="2")
    yield fleet, dual
    fleet.kill()
    dual.kill()


@pytest.fixture(scope="module")
def rollout_run():
    """One process's rollout of the program's 4 lanes, then the program on
    2 processes (whose runners find this one's host tensors in the
    cache)."""
    from omg_tools_torch.tools.multihost_launch import rollout_batch
    runner, (x0, p0, state) = rollout_batch(ROLLOUT_B, "cpu")
    consts = runner.consts()
    st = runner.init_solver_state(x0, p0, consts)
    carry, states = runner.rollout_fn(ROLLOUT_STEPS, outer_iter=1)(
        st, p0, state, consts)
    run = launch(2, "rollout", "--batch", str(ROLLOUT_B), "--steps",
                 str(ROLLOUT_STEPS), LOCAL_WORLD_SIZE="1")
    yield states.numpy(), float(carry[0].feas.max()), run
    run.kill()


def test_launcher_fleet_matches_the_mesh_dual_update(fleet_run):
    """Each rank of the (2, 2) hybrid mesh holds its slab of the whole
    batch's one-iteration result; every instance (data row) equals the
    2-rank ``make_mesh_dual_update`` of the same fleet within 1e-12, and
    the residuals, reduced over the whole mesh, agree across processes."""
    fleet, dual = fleet_run
    ref = dual.results()
    for r in ref[1:]:
        assert r["dual"] == ref[0]["dual"]
    ref = ref[0]["dual"]
    X = np.asarray(ref["X"])
    results = fleet.results()
    blk = FLEET_N // 2
    for r in results:
        pid = r["process_id"]
        assert r["distributed"] is True and r["num_processes"] == 4
        assert r["mesh"] == {"data": 2, "fleet": 2}
        assert r["x_shape"] == [FLEET_B, FLEET_N, X.shape[1]]
        d, f = divmod(pid, 2)
        want = X[None, f * blk:(f + 1) * blk]     # one instance a data row
        got = np.asarray(r["x_local"])
        assert got.shape == want.shape
        assert float(np.max(np.abs(got - want))) <= TOL_FLEET, pid
        assert abs(r["x_local_sum"] - float(np.sum(want))) <= \
            TOL_FLEET * max(1.0, abs(float(np.sum(want))))
        for key in ("pri", "dua"):
            assert abs(r[key] - ref[key]) <= TOL_FLEET, (pid, key)
            assert r[key] == results[0][key]


def test_launcher_rollout_matches_one_process(rollout_run):
    """The scenario-parallel rollout on 2 processes: each rank's rows
    equal one process's rollout of the same 4 lanes within 1e-10, and the
    batch's largest violation is the same on every rank."""
    states, feas_max, run = rollout_run
    results = run.results()
    half = ROLLOUT_B // 2
    for r in results:
        pid = r["process_id"]
        assert r["mesh"] == {"data": 2, "fleet": 1}
        assert r["states_shape"] == list(states.shape)
        want = states[pid * half:(pid + 1) * half]
        got = np.asarray(r["states_local"])
        assert float(np.max(np.abs(got - want))) <= TOL_ROLLOUT, pid
        assert abs(r["feas_max"] - feas_max) <= TOL_ROLLOUT
        assert r["feas_max"] == results[0]["feas_max"]
    assert np.isfinite(states).all()


def test_initialize_without_a_job_is_a_no_op(monkeypatch):
    """No launcher variables and no arguments: a single process joins no
    job (the JAX package's ``initialize`` returns False there too)."""
    import torch.distributed as dist
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert multihost.initialize("127.0.0.1:1", 1, 0, device="cpu") is False
    assert not dist.is_initialized()


class _Mesh:
    """A stand-in (data, fleet) DeviceMesh at one coordinate: what the
    placement functions read of a mesh."""

    def __init__(self, shape, coord, names=("data", "fleet")):
        self.mesh_dim_names, self.shape, self.coord = names, shape, coord
        self.device_type = "cpu"

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


def test_placement_splits_and_replicates():
    """shard_batch splits the leading axis over the flattened mesh (and
    replicates an array it does not divide), shard_hybrid_state splits
    (B, N) over (data, fleet), process_local_batch passes a process's own
    rows: over every coordinate of a (2, 3) mesh the pieces tile the
    whole."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((12, 5)), "odd": np.arange(7.0),
             "n": 3}
    state = rng.standard_normal((4, 6, 2))
    rows, slabs = [], {}
    for d in range(2):
        for f in range(3):
            mesh = _Mesh((2, 3), (d, f))
            part = multihost.shard_batch(mesh, batch)
            assert part["n"] == 3
            np.testing.assert_array_equal(part["odd"].numpy(), batch["odd"])
            rows.append(part["x"].numpy())
            (slab,) = multihost.shard_hybrid_state(mesh, state)
            slabs[d, f] = slab.numpy()
            local = multihost.process_local_batch(
                mesh, {"x": (12, 5)}, {"x": part["x"]})
            np.testing.assert_array_equal(local["x"].numpy(), rows[-1])
    np.testing.assert_array_equal(np.concatenate(rows), batch["x"])
    whole = np.concatenate([np.concatenate([slabs[d, f] for f in range(3)],
                                           axis=1) for d in range(2)])
    np.testing.assert_array_equal(whole, state)
    with pytest.raises(AssertionError, match="local rows"):
        multihost.process_local_batch(_Mesh((2, 3), (0, 0)), {"x": (10, 5)},
                                      {"x": np.zeros((2, 5))})


@pytest.mark.slow
def test_launcher_fleet_matches_jax_hybrid(fleet_run):
    """The launcher's fleet program against the JAX package's
    ``make_hybrid_dual_update`` on a (2, 2) mesh of 4 CPU devices (the JAX
    launcher's formation, B = 2): the residuals and each rank's checksum,
    as tests/test_multihost.py checks them (1e-6 relative)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from multihost_launch import build_formation
    from omg_tools_tpu.parallel.multihost import (make_hybrid_dual_update,
                                                  shard_hybrid_state)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "fleet"))
    admm = build_formation(FLEET_N)
    grp = admm.groups[0]
    step, rel = make_hybrid_dual_update(admm, mesh, outer_iter=1)
    P0 = admm._pack_params(grp, 0.0)
    B = FLEET_B
    args = [jnp.broadcast_to(jnp.asarray(a), (B,) + a.shape)
            for a in (grp.X, P0, admm.Z, admm.L, np.asarray(rel))]
    Xn, _, _, pri, dua = step(*shard_hybrid_state(mesh, *args))
    Xref = np.asarray(Xn)
    blk = FLEET_N // 2
    for r in fleet_run[0].results():
        d, f = divmod(r["process_id"], 2)
        want = float(np.sum(Xref[d, f * blk:(f + 1) * blk]))
        assert abs(r["x_local_sum"] - want) < 1e-6 * max(1.0, abs(want))
        for key, ref in (("pri", float(pri)), ("dua", float(dua))):
            assert abs(r[key] - ref) < 1e-6 * max(1.0, abs(ref)), key
