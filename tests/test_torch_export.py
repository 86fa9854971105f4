"""The port's embedded C++ runtime export held to the JAX package's.

``ExportP2P`` on examples/p2p_holonomic_export.py's scene, and
``ExportFormation`` and ``ExportRendezVous`` on tests/test_export.py's
scenes (four Holonomic vehicles in an empty 5 m room), are written by both
packages.  Against the JAX exporter's directory, ``manifest.json``'s
scalars and array shapes, ``meta.txt`` and every index array (``*_idx``)
must be equal, and every value array within 1e-12 of its largest entry.
The two packages' host AD round differently, so the files are not asked to
be byte-equal; ``_sparse_coo`` drops entries at or below 1e-12, and an
entry within rounding of that threshold could make an index array differ:
such entries are shown and the values compared over the union of indices.

The JAX problems' transcription f and g are compiled with ``jax.jit``
before the JAX exporter's host AD runs (``torch_bench_configs.jax_compiled``:
the same functions; op by op the three JAX exports took ~210 s on one CPU
core instead of ~100 s); the files it writes are unchanged to the bit.

The port's exports are then built and run as tests/test_export.py does
(``make`` and ``./test .`` on the bench scene, ``make formation`` and
``make rendezvous``), each printing PASSED; these need ``g++`` and
``make``.  The port's copy of the C++ runtime is byte-identical to the
JAX package's.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import omg_tools_torch as T
from omg_tools_torch.environment.shapes import RegularPolyhedron

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402  the bench scene
from torch_bench_configs import jax_compiled  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUE_TOL = 1e-12          # of each value array's largest entry
COO_TOL = 1e-12            # _sparse_coo's threshold
NEEDS_BUILD = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("make") is None,
    reason="needs g++ and make")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX package (float64)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    return pytest.importorskip("omg_tools_tpu")


def _p2p_scene(m):
    """examples/p2p_holonomic_export.py's scene."""
    vehicle = m.Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = m.Environment(room={"shape": m.Square(5.0)})
    environment.add_obstacle(m.Obstacle(
        {"position": [0.4, 0.2]}, shape=m.Rectangle(width=0.4, height=1.0)))
    problem = m.Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()
    return problem


def _fleet_scene(m, kind, **options):
    """tests/test_export.py's formation or rendezvous scene."""
    N = 4
    vehicles = [m.Holonomic() for _ in range(N)]
    fleet = m.Fleet(vehicles)
    if kind == "formation":
        configuration = RegularPolyhedron(0.4 * np.sqrt(2), N,
                                          np.pi / 4).vertices.T
        fleet.set_configuration(configuration.tolist())
        fleet.set_initial_conditions(
            (np.array([-1.5, -1.5]) + configuration).tolist())
        fleet.set_terminal_conditions(
            (np.array([2.0, 2.0]) + configuration).tolist())
        cls = m.FormationPoint2point
    else:
        rel = np.array([[0.3, 0.3], [0.3, -0.3], [-0.3, -0.3], [-0.3, 0.3]])
        fleet.set_configuration(rel.tolist())
        starts = np.array([[-1.6, -1.6], [1.6, -1.6], [1.6, 1.6],
                           [-1.6, 1.6]])
        fleet.set_initial_conditions(starts.tolist())
        fleet.set_terminal_conditions((starts * 0).tolist())
        cls = m.RendezVous
    env = m.Environment(room={"shape": m.Square(5.0)})
    problem = cls(fleet, env, options={"horizon_time": 10, "rho": 1.0,
                                       **options})
    problem.set_options({"verbose": 0})
    problem.init()
    return problem


def _write(problem, directory):
    """Both packages' ``export`` hooks: the p2p hook returns an exporter
    whose ``run`` writes; the fleets' too."""
    return problem.export({"directory": str(directory)}).run()


@pytest.fixture(scope="module")
def exports(J, tmp_path_factory):
    """{scene: (port directory, JAX directory)}; the JAX package's host
    tensors go to a private cache directory."""
    from omg_tools_tpu.export.export_formation import ExportADMM
    from omg_tools_tpu.export.export_rendezvous import ExportRendezVous
    root = tmp_path_factory.mktemp("exports")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMG_CACHE_DIR", str(root / "jax_cache"))
        for cls in (ExportADMM, ExportRendezVous):
            local = cls.__dict__["_local_problem"]
            mp.setattr(cls, "_local_problem",
                       lambda self, local=local: jax_compiled(local(self)))
        jax_dirs = {"p2p": _write(jax_compiled(_p2p_scene(J)),
                                  root / "jax_p2p")}
        for kind in ("formation", "rendezvous"):
            jax_dirs[kind] = _write(_fleet_scene(J, kind),
                                    root / f"jax_{kind}")
    out = {"p2p": (_write(_p2p_scene(T), root / "port_p2p"),
                   jax_dirs["p2p"])}
    for kind in ("formation", "rendezvous"):
        out[kind] = (_write(_fleet_scene(T, kind, device="cpu"),
                            root / f"port_{kind}"), jax_dirs[kind])
    return out


def _load(directory):
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {name: np.fromfile(os.path.join(directory, info["file"]),
                                dtype=info["dtype"]).reshape(info["shape"])
              for name, info in manifest["arrays"].items()}
    with open(os.path.join(directory, "meta.txt")) as f:
        meta = f.read()
    return manifest, arrays, meta


def _coo(idx, val):
    return {tuple(row): v for row, v in zip(idx.astype(np.int64), val)}


def _compare(port_dir, jax_dir):
    pm, pa, pmeta = _load(port_dir)
    jm, ja, jmeta = _load(jax_dir)
    assert pm["scalars"] == jm["scalars"]
    assert {k: v["shape"] for k, v in pm["arrays"].items()} == \
        {k: v["shape"] for k, v in jm["arrays"].items()}
    assert pmeta == jmeta
    for name, want in ja.items():
        got = pa[name]
        if name.endswith("_idx"):
            continue
        scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
        val_name = name[:-4] + "_idx" if name.endswith("_val") else None
        if val_name is not None and not np.array_equal(pa[val_name],
                                                       ja[val_name]):
            # entries at the COO threshold: show them, compare the union
            p, j = _coo(pa[val_name], got), _coo(ja[val_name], want)
            odd = {k: (p.get(k, 0.0), j.get(k, 0.0))
                   for k in set(p) ^ set(j)}
            print(f"{name}: entries in one package's COO only: {odd}")
            assert all(max(abs(a), abs(b)) <= COO_TOL + VALUE_TOL * scale
                       for a, b in odd.values()), odd
            keys = sorted(set(p) | set(j))
            got = np.array([p.get(k, 0.0) for k in keys])
            want = np.array([j.get(k, 0.0) for k in keys])
        assert np.abs(got - want).max(initial=0.0) <= VALUE_TOL * scale, \
            (name, float(np.abs(got - want).max()), scale)
    for name in ja:
        if name.endswith("_idx"):
            if name[:-4] + "_val" in ja and not np.array_equal(pa[name],
                                                               ja[name]):
                continue            # shown and compared above
            np.testing.assert_array_equal(pa[name], ja[name], err_msg=name)


@pytest.mark.parametrize("scene", ("p2p", "formation", "rendezvous"))
def test_export_matches_jax(exports, scene):
    _compare(*exports[scene])


def test_fleet_exports_carry_the_admm_extras(exports):
    for kind in ("formation", "rendezvous"):
        manifest, arrays, meta = _load(exports[kind][0])
        for key in ("n_sh", "n_slots", "rho_admm", "init_iter"):
            assert f"scalar {key} " in meta and key in manifest["scalars"]
        for name in ("S_idx", "z_proj", "sh_shift"):
            assert name in arrays
        n_sh = manifest["scalars"]["n_sh"]
        assert arrays["S_idx"].shape == (n_sh,)
        assert arrays["z_proj"].shape == (n_sh, n_sh)


def test_hooks_return_the_jax_packages_exporters():
    problem = _p2p_scene(T)
    assert type(problem.export()).__name__ == "ExportP2P"
    assert isinstance(problem.export(), T.ExportP2P)


def test_cpp_runtime_is_the_jax_packages():
    port = os.path.join(ROOT, "omg_tools_torch", "export", "cpp")
    jax_cpp = os.path.join(ROOT, "omg_tools_tpu", "export", "cpp")
    names = sorted(os.listdir(jax_cpp))
    assert sorted(os.listdir(port)) == names
    match, mismatch, errors = filecmp.cmpfiles(jax_cpp, port, names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _build_and_run(directory, target, program):
    subprocess.run(["make", "-j2"] + ([target] if target else []),
                   cwd=directory, check=True, capture_output=True,
                   timeout=300)
    res = subprocess.run([program, "."], cwd=directory, check=True,
                         capture_output=True, text=True, timeout=600)
    assert "PASSED" in res.stdout, res.stdout[-2000:]


@NEEDS_BUILD
def test_port_export_builds_and_runs(tmp_path):
    """tests/test_export.py:99-118 on the port: the bench scene's export,
    built, and its 50-iteration MPC harness."""
    out = T.ExportP2P(chip_smoke.build_problem(T),
                      {"directory": str(tmp_path)}).run()
    _build_and_run(out, None, "./test")


@NEEDS_BUILD
@pytest.mark.parametrize("kind", ("formation", "rendezvous"))
def test_port_fleet_export_builds_and_runs(exports, kind):
    _build_and_run(exports[kind][0], kind, f"./test_{kind}")
