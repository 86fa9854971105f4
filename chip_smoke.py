#!/usr/bin/env python3
"""Smoke run of omg_tools_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card: the card's name and power limit (nvidia-smi); CUDA must exist;
2. build: compile the CUDA kernels from ``omg_tools_torch/csrc``;
3. kernels: every kernel against its plain PyTorch version on random SPD
   inputs at the shapes of the main path (and of its rescue batch), with
   CUDA-event times of the kernel, the plain version and a one-call
   library yardstick (``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``,
   never used by the port) beside the least time the card could take;
4. main path: the bench scene (``bench.py``'s p2p_holonomic: one Holonomic
   vehicle, 5 m room, two 3.0x0.2 m rectangles and a 0.4 m circle, 10 s
   horizon at 10 Hz) as a B = 4096, 20-step batched rollout in float32 on
   the card, at the bench settings (budgets 3x8/1x7, 2 outer rounds,
   128 rescue lanes x 6 outer rounds, recover_tol 0.01); the kernel launch
   counters are zeroed before and read after, and each kernel must have
   run;
5. profile: one MPC step traced with torch.profiler -- the device's kernel
   time against the step's wall time, and the host time of each span;
6. cross-check: the one-period-ahead planned state of the cold solve for
   64 of those scenarios, card (float32) against the port on the CPU
   (float64), within the 2 cm parity bound of ``bench.py``.

The last two lines before the final one are the ``kernels`` JSON object and
the card's name and power limit as nvidia-smi prints them; the final line
is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

BATCH = 4096
N_STEPS = 20
INNER_ITER = 5
OUTER_ITER = 2
RESCUE = 128
RESCUE_OUTER = 6
RECOVER_TOL = 0.01
BUDGETS = ((3, 8), (1, 7))
ROLLOUT = dict(outer_iter=OUTER_ITER, rescue_lanes=RESCUE,
               rescue_outer=RESCUE_OUTER, recover_tol=RECOVER_TOL,
               budgets=BUDGETS)
CROSS_LANES = 64
TOL_REL = 5e-5            # kernel vs plain: max |diff| <= TOL_REL * max |plain|
FEAS_P99_GATE = 1e-3      # bench.py:446
PARITY_GATE_M = 0.02      # bench.py:443

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# (name, entry point, TPU kernel it replaces, main shape, rescue shape);
# shapes are (N systems, n, r)
KERNELS = (
    ("K1 chol_solve r=1 (psd_solve)", "psd_solve",
     "omg_tools_tpu/ops/pallas_kernels.py:40", (4096, 26, 1), (128, 26, 1)),
    ("K2 chol_solve multi-RHS (psd_solve_multi)", "psd_solve_multi",
     "omg_tools_tpu/ops/pallas_kernels.py:118", (20480, 33, 27),
     (640, 33, 27)),
)
SOURCE = "omg_tools_torch/csrc/chol_solve.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=25, warmup=3):
    """Median of ``reps`` single-launch CUDA-event timings, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _recorded_event():
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def timed_call_ms(fn):
    """Wall time of one call of ``fn``, from the card idle to the card idle."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def spd_inputs(N, n, r, seed, device):
    """Random SPD systems H = A A' / n + I and panels G (float32)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((N, n, n), generator=gen, device=device)
    H = A @ A.transpose(1, 2) / n + torch.eye(n, device=device)
    G = torch.randn((N, n, r), generator=gen, device=device)
    return H.contiguous(), G.contiguous()


def kernel_phase(device):
    """Phase 3: returns one record per kernel (main-path shape) and prints
    the rescue-shape checks."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    records = []
    for name, entry, replaces, main_shape, rescue_shape in KERNELS:
        rec = None
        for tag, (N, n, r) in (("main", main_shape), ("rescue", rescue_shape)):
            H, G = spd_inputs(N, n, r, seed=N + n + r, device=device)
            if entry == "psd_solve":
                args = (H, G[..., 0].contiguous())
                kern, plain = pk.psd_solve, pk.psd_solve_plain
            else:
                # the arrow step's layout: (B, k, b, b) blocks, (B, k, b, r)
                k = 5
                args = (H.reshape(N // k, k, n, n),
                        G.reshape(N // k, k, n, r))
                kern, plain = pk.psd_solve_multi, pk.psd_solve_multi_plain
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= TOL_REL * scale,
                  f"{name} {tag}: max |kernel - plain| {err} > "
                  f"{TOL_REL} * {scale}")

            def library():
                L, _ = torch.linalg.cholesky_ex(H)
                return torch.cholesky_solve(G, L)
            lib_err = float((library().reshape(got.shape) - want).abs().max())
            ms = time_ms(lambda: kern(*args))
            plain_ms = time_ms(lambda: plain(*args), reps=5, warmup=1)
            library_ms = time_ms(library)
            # the lower triangle of H is all the function reads of it
            nbytes = 4 * (N * n * (n + 1) // 2 + 2 * N * n * r)
            flops = N * (n ** 3 / 3.0 + 2.0 * n * n * r)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            line = {"name": name, "shape": tag, "N": N, "n": n, "r": r,
                    "max_abs_err": err, "scale": scale,
                    "library_err": lib_err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops}
            print("kernel_check " + json.dumps(line), flush=True)
            if tag == "main":
                rec = {"name": name, "route": "cuda", "source": SOURCE,
                       "replaces": replaces, "launches": None,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": line["bound_ms"],
                       "bound_by": line["bound_by"],
                       "library_ms": library_ms, "shape": [N, n, r]}
        records.append((entry, rec))
    return records


def build_problem(T):
    vehicle = T.Holonomic()
    vehicle.set_initial_conditions([-1.5, -1.5])
    vehicle.set_terminal_conditions([2.0, 2.0])
    environment = T.Environment(room={"shape": T.Square(5.0)})
    environment.add_obstacle(T.Obstacle(
        {"position": [-2.1, -0.5]}, shape=T.Rectangle(width=3.0, height=0.2)))
    environment.add_obstacle(T.Obstacle(
        {"position": [1.7, -0.5]}, shape=T.Rectangle(width=3.0, height=0.2)))
    environment.add_obstacle(T.Obstacle(
        {"position": [1.5, 0.5]}, shape=T.Circle(0.4)))
    problem = T.Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()
    return problem


def scenarios(B):
    """bench.py's randomized starts/goals (numpy seed 0)."""
    rng = np.random.default_rng(0)
    starts = np.tile([-1.5, -1.5], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    goals = np.tile([2.0, 2.0], (B, 1)) + rng.uniform(-0.3, 0.3, (B, 2))
    return starts, goals


def planned_state(runner, x):
    """One-period-ahead planned position (B, 2) commanded by solutions x."""
    import torch
    s0 = int(runner.i_splines[0])
    n_coef, n_spl = runner.spline_shape
    cfs = x[:, s0:s0 + n_coef * n_spl].reshape(-1, n_coef, n_spl)
    E1 = torch.as_tensor(runner.model.E0[1], dtype=x.dtype, device=x.device)
    return torch.einsum("c,bcs->bs", E1, cfs)


def main_path_phase(T, device, B=BATCH, n_steps=N_STEPS, timed_runs=3):
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    t0 = time.time()
    problem = build_problem(T)
    runner = T.BatchedP2PRunner(
        problem, dtype=torch.float32, device=device,
        alm_options=T.ALMOptions(inner_iter=INNER_ITER, rho_init=10.0))
    check(runner.structure == "compact-arrow",
          f"structure {runner.structure}")
    starts, goals = scenarios(B)
    x0, p0, state = runner.make_batch(starts, goals)
    consts = runner.consts()
    roll = runner.rollout_fn(n_steps, **ROLLOUT)
    pk.psd_solve.launches = pk.psd_solve_multi.launches = 0
    st = runner.init_solver_state(x0, p0, consts)
    torch.cuda.synchronize()
    init_launches = {"psd_solve": pk.psd_solve.launches,
                     "psd_solve_multi": pk.psd_solve_multi.launches}
    setup_s = time.time() - t0
    # the main path's counted run: the first rollout
    pk.psd_solve.launches = pk.psd_solve_multi.launches = 0
    t1 = time.time()
    carry, states = roll(st, p0, state, consts)
    torch.cuda.synchronize()
    first_s = time.time() - t1
    launches = {"psd_solve": pk.psd_solve.launches,
                "psd_solve_multi": pk.psd_solve_multi.launches}
    times, step_ms = [], []
    for _ in range(timed_runs):
        # a CUDA event at each step boundary, read once after the rollout
        events = [torch.cuda.Event(enable_timing=True)]
        t1 = time.time()
        events[0].record()
        carry, states = roll(st, p0, state, consts,
                             on_step=lambda k: events.append(
                                 _recorded_event()))
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        step_ms.extend(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    run_s = float(np.median(times))
    states_np = states.double().cpu().numpy()
    feas = carry[0].feas.double().cpu().numpy()
    feas_raw = carry[0].feas_raw.double().cpu().numpy()
    d0 = np.linalg.norm(starts - goals, axis=1)
    d1 = np.linalg.norm(states_np[:, -1] - goals, axis=1)
    out = {
        "structure": runner.structure, "batch": B, "n_steps": n_steps,
        "setup_s": setup_s, "first_rollout_s": first_s,
        "rollout_s": run_s, "rollout_s_all": times,
        "solves_per_s": B * n_steps / run_s,
        # time of one MPC step of the whole batch between the CUDA events
        # at its boundaries, over every step of the timed runs; p80 is the
        # highest percentile with ten samples beyond it at 3 x 20 steps
        "step_samples": len(step_ms),
        "p50_step_latency_ms": float(np.median(step_ms)),
        "p80_step_latency_ms": float(np.percentile(step_ms, 80)),
        "max_step_latency_ms": float(np.max(step_ms)),
        # bench.py's p50_step_latency_ms: rollout time per step per scenario
        "amortized_ms_per_solve": run_s / n_steps / B * 1000.0,
        "feas_p50": float(np.median(feas)),
        "feas_p99": float(np.percentile(feas, 99)),
        "feas_max": float(np.max(feas)),
        "feas_raw_p99": float(np.percentile(feas_raw, 99)),
        "feas_raw_max": float(np.max(feas_raw)),
        "diverged_lanes": int(np.sum(feas_raw > 1e-2)),
        "mean_progress_frac": float(np.mean((d0 - d1) / d0)),
        "n_iter_p50": float(np.median(carry[0].n_iter.cpu().numpy())),
        "init_launches": init_launches, "rollout_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print("main_path " + json.dumps(out), flush=True)
    check(bool(np.isfinite(states_np).all()), "non-finite states")
    check(out["feas_p99"] < FEAS_P99_GATE,
          f"feas_p99 {out['feas_p99']} >= {FEAS_P99_GATE}")
    check(out["mean_progress_frac"] > 0.0, "no progress toward the goals")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")
    return runner, st, p0, state, starts, goals, launches


def profile_phase(runner, st, p0, state):
    """One traced MPC step (k = 0, with its rescue) under torch.profiler:
    the device's kernel time against the same step's untraced wall time,
    the kernels launched, and the host time of each span of the port."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    roll = runner.rollout_fn(1, **ROLLOUT)
    untraced_ms = timed_call_ms(lambda: roll(st, p0, state))
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = timed_call_ms(lambda: roll(st, p0, state))
    events = prof.key_averages()
    kernel_us, kernels, spans = 0.0, 0, {}
    for e in events:
        span = e.key.startswith(("alm.", "rollout."))
        if e.device_type == DeviceType.CUDA and not span:
            kernel_us += e.self_device_time_total
            kernels += e.count
            continue
        if span and e.device_type == DeviceType.CPU:
            spans[e.key] = {"count": e.count,
                            "host_ms": e.cpu_time_total / 1e3,
                            "device_ms": e.device_time_total / 1e3}
    top = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("alm.", "rollout."))),
                 key=lambda e: -e.self_device_time_total)[:8]
    out = {"step": 0, "untraced_step_ms": untraced_ms,
           "traced_step_ms": traced_ms, "device_kernel_ms": kernel_us / 1e3,
           "device_busy_share": kernel_us / 1e3 / untraced_ms,
           "kernels_launched": kernels, "spans": spans,
           "top_kernels": [{"name": e.key[:100], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top],
           "analysis_s": time.time() - t0}
    print("profile " + json.dumps(out), flush=True)
    check(kernel_us > 0, "the traced step shows no device time")


def cross_check_phase(T, runner, st, starts, goals):
    """Card f32 vs port on the CPU in f64: the one-period-ahead planned
    state of the cold solve for the first CROSS_LANES scenarios."""
    import torch
    t0 = time.time()
    cpu_runner = T.BatchedP2PRunner(
        build_problem(T), dtype=torch.float64, device="cpu",
        alm_options=T.ALMOptions(inner_iter=INNER_ITER, rho_init=10.0))
    x0, p0, _ = cpu_runner.make_batch(starts[:CROSS_LANES],
                                      goals[:CROSS_LANES])
    st_cpu = cpu_runner.init_solver_state(x0, p0)
    want = planned_state(cpu_runner, st_cpu.x).numpy()
    got = planned_state(runner, st.x[:CROSS_LANES]).double().cpu().numpy()
    err = np.max(np.abs(got - want), axis=1)
    out = {"lanes": CROSS_LANES, "max_err_m": float(err.max()),
           "p90_err_m": float(np.percentile(err, 90)),
           "cpu_feas_max": float(st_cpu.feas.max()),
           "seconds": time.time() - t0}
    print("cross_check " + json.dumps(out), flush=True)
    check(out["max_err_m"] < PARITY_GATE_M,
          f"card vs CPU planned states differ by {out['max_err_m']} m")


def main():
    sys.path.insert(0, HERE)
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    card = card_line()
    print(card, flush=True)
    import omg_tools_torch as T
    from omg_tools_torch.ops import _build
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0], flush=True)

    t0 = time.time()
    libs = _build.build_all()
    print(f"build: {time.time() - t0:.1f} s {sorted(libs)}", flush=True)
    for name in libs:
        log = _build.BUILD_DIR / f"{name}.log"
        if log.exists():
            print(f"ptxas[{name}]: " + " | ".join(
                l.strip() for l in log.read_text().splitlines()
                if "registers" in l or "smem" in l), flush=True)

    device = torch.device("cuda")
    records = kernel_phase(device)
    runner, st, p0, state, starts, goals, launches = main_path_phase(
        T, device)
    for entry, rec in records:
        rec["launches"] = launches[entry]
    profile_phase(runner, st, p0, state)
    cross_check_phase(T, runner, st, starts, goals)
    print(json.dumps({"kernels": [rec for _, rec in records]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
