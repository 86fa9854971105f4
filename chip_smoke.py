#!/usr/bin/env python3
"""Smoke run of omg_tools_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card: the card's name and power limit (nvidia-smi); CUDA must exist;
2. build: compile the CUDA kernels from ``omg_tools_torch/csrc``, one
   ``nvcc`` per source, all started together; ptxas' registers, stack
   frame and spills of every kernel instance;
3. kernels K1/K2: each against its plain PyTorch version on random SPD
   inputs at the shapes of the compact-arrow path, of its rescue batch and
   (K1) of the dense and generic ALM modes and of the formation's
   x-update (4 x 85), in float32, and at the main shapes in float64; the variant each shape runs (a register class at
   the main shapes); one-call CUDA-event times (``call_ms``) and the plain
   version's; and K1's global variant (systems beyond a block's shared
   memory: float64 1 x 178, 1 x 186, 4 x 186, 1 x 203, 1 x 262, 1 x 395,
   float32 1 x 262, ``k1_shapes_phase``), which ``variant`` must pick
   there, and K1 float64 at the G-code window (1 x 50, ``reg64``);
4. setup: the bench scene (``bench.py``'s p2p_holonomic: one Holonomic
   vehicle, 5 m room, two 3.0x0.2 m rectangles and a 0.4 m circle, 10 s
   horizon at 10 Hz) and its float32 runner, which must pick the
   ``compact-arrow-fused`` structure; B = 4096 scenarios; the host
   tensors must not come from the cache: the script points
   ``OMG_CACHE_DIR`` at an empty directory of its own, removed at its end;
5. cache: the same setup again, its host tensors now from the cache (a
   hit is required); the second runner's device tensors must equal the
   first's bit for bit; ``setup_s`` cold and cached;
6. kernel K3: the fused inner loop on those scenarios' cold-solve inputs
   (phase 0, zero multipliers, rho_init) at the main shape (B = 4096,
   8 inner iterations) and the rescue shape (128 lanes, 5): with a
   well-conditioned ridge, the kernel against its plain float32 version
   within a small tolerance (step, g, gradient norm); with the bench
   options, the merit it reaches and its x against a float64 run of the
   plain version (``k3_kernel_phase``); the least time from the plan's
   non-zero arithmetic (``k3_work``); the lanes a block serves and its
   shared memory (held to the CUDA side's count), and the share of each
   phase of an iteration in the blocks' clock cycles (a launch with the
   clock profile on, whose outputs must equal the unprofiled launch's bit
   for bit);
7. main path: the B = 4096, 20-step batched rollout in float32 on the
   fused structure, at the bench settings (budgets 3x8/1x7, 2 outer
   rounds, 128 rescue lanes x 6 outer rounds, recover_tol 0.01); the launch
   counters are zeroed before and read after: K3 must have run, K1 and K2
   not;
8. parity (its gate after 19): bench.py's gate (bench.py:404-446) on
   that runner, built again from the cache (its batch held equal to the
   main path's): the open-loop control parity of scenario 0 along the
   reference rollout of the port's scipy solver (``tools/parity.py``, 20
   steps, computed in this run by this script in a process of its own,
   started after 4 and run beside the device phases; its time printed),
   through K3;
9. profile: one fused MPC step traced with torch.profiler -- the device's
   kernel time against the step's wall time, the device time of K1, K2 and
   K3, and the host time of each span;
10. compact-arrow path: the same runner with its fused plan taken off
    (``runner.fused_plan = None``, the one selector of the path), a 3-step
    rollout of the same batch; K1 and K2 must have run; then one of its
    steps traced as in 9;
11. cross-check: the one-period-ahead planned state of the cold solve of
    64 of those scenarios by the port on the CPU in float64, against the
    card's float32 fused solve and against the same float64 runner on the
    card (``runner.to``: compact-arrow, K1 and K2 in float64, launches
    counted), each within the 2 cm parity bound of ``bench.py``, beside the
    CPU solve's own sensitivity to a 1e-15 perturbation of its start;
12. closed loop: the Quick Start (``Point2point`` + ``Simulator``) on the
    bench scene in float64 on the card, 15 updates in the dense quadratic
    mode (tests/test_p2p.py's progress and clearance criteria), and three
    in the default generic mode on a cut budget (its Newton steps CUDA
    graphs, ``ops.alm``), every solver call's iterate within 1e-8 of the
    quadratic mode's on that budget; K1 (float64, one 151-row system a
    launch) must run in every update; and
    ``examples_torch/p2p_holonomic.py`` in smoke mode in a process of its
    own, beside 11's CPU solves;
13. the other bench configurations, ``p2p_3dquadrotor`` and ``p2p_dubins``
    (bench.py:233-345), each on an empty host-tensor cache of its own:
    setup (the float32 runner must take ``compact-arrow-fused``; its
    plan's sizes, K3's shared bytes a lane and lanes a block), K3 against
    its plain version on that plan with the three checks of 6, the
    clock-profiled launch held bit for bit to the unprofiled one and the
    curvature check (``k3_curvature_check``: on a state where the line
    search's d'Q d term decides some lanes' step, the kernel must match
    the plain version on the lanes float32 resolves, where a plain
    version without that term does not), the B = 4096, 20-step rollout at
    bench.py's settings for the configuration (K3 only), 3 compact-arrow
    steps (K1 and K2), and the cross-check of 11 on 16 lanes;
14. the formation: bench.py's formation_holonomic (bench.py:125-230: four
    Holonomic vehicles, rho 0.5, a 0.4 m circle) through
    ``parallel.FleetRunner`` in float32 at bench.py's settings (2 outer
    rounds of the template's 16 inner iterations an x-update, 20 ADMM
    iterations, a 20-period rollout at one iteration a period; one timed
    run of each loop, not 3): bench.py's fields (iterations/s, the
    residual curves and decrease, consensus_rms_m < 0.02,
    rollout_periods_per_s, setup_s); K1 (4 x 85, float32) must launch in
    every x-update and every vehicle end the rollout > 0.2 m nearer its
    goal; a generic Newton iteration of the x-update timed three ways
    (its CUDA graph, which must equal the eager step bit for bit and take
    <= 100 ms; the eager step; the per-op evaluations it replaced); one
    ADMM iteration traced (device busy share); the float32 Z after 20
    iterations within 2 cm of a float64 FleetRunner's on the card (K1 in
    float64 at 4 x 85, launches counted), and that run's Z after 2
    iterations within 2 cm of the port's float64 run on the CPU from the
    same carry, beside the CPU run's own sensitivity to a 1e-15
    perturbation; with ``examples_torch/formation_holonomic.py`` in
    smoke mode in a process of its own beside the float64 runs;
16. the examples' free-time and rotating-obstacle closed loops in float64
    on the card (``scene_loop``): p2p_dubins and p2p_bicycle
    (``FreeTPoint2point``) and revolving_door (a rectangle rotating at
    pi/6 rad/s), each through ``Problem.solve`` + ``Simulator`` in the
    default generic mode at its full budget, to its stop criterion
    (Dubins) or SCENE_UPDATES updates: K1 (float64, one n_x-row system a launch) in
    every update, no K2 or K3; the update times, iterations, ms an
    iteration, the final position against the goal; the first solve on a
    cut budget against the CPU's, beside the CPU's own sensitivity; the
    three examples' copies in ``examples_torch/`` in smoke mode (their
    three processes started together).  Then
    (``obstacle_phase``) the B = 4096, 20-step float32 rollouts at the
    bench settings of bench.py's scene with its circle moving at a
    per-scenario velocity (``make_batch(obstacle_states=)``: K3 must run,
    K1 and K2 not) and of the obstraj example's spline-trajectory circle
    (whatever structure K3's limits give it: ``compact-arrow``, its head
    has 105 rows; 11 steps, to its first knot passage), each with the
    cross-check of 11 on 16 lanes;
17. the vast-environment closed loops in float64 on the card
    (``vast_phase``): the scenes of examples/test_multiframe.py (a
    MultiFrameProblem over two rooms, n_x 120), schedulerproblem_example1.py
    (a SchedulerProblem with shift frames and local FreeTPoint2points, n_x
    93) and schedulerproblem_example2.py (two-frame corridors, local
    MultiFrameProblems of 186 variables: K1's global variant), the first
    VAST_UPDATES updates of each through ``scene_loop`` as in 16: K1 in
    every update, no K2 or K3, the frame switches, problem builds and
    CUDA-graph captures of each update (scheduler2 must switch at least
    once; a switch onto a cached problem must capture nothing, every
    solved problem captures its two graphs once), the card's first solve
    against the CPU's;
18. G-code machining and the central formation in float64 on the card
    (``gcode_phase``): the scenes of
    examples/GCode_examples/gcodeproblem_slot_multi.py and
    gcodeproblem_rsq5.py (a Tool in a GCodeSchedulerProblem's rolling
    window of two segments, local GCodeProblems of 50 variables: K1
    reg64) and examples/formation_holonomic_central.py (three Holonomic
    vehicles in one FormationPoint2pointCentral, n_x 203: K1's global
    variant), the first GCODE_UPDATES updates of each through
    ``scene_loop`` as in 16: K1 in every update, no K2 or K3, the window
    rolls, problem builds and CUDA-graph captures of each update; every
    update feasible to < 1e-3, slot_multi's window rolls at least once,
    rsq5's tool stays in its first tube, the formation's centres agree to
    1e-3 m; the card's first solve against the CPU's; within 150 s;
19. rendezvous, dual decomposition, generic ADMM and the interior-point
    backend in float64 on the card (``distributed_phase``), at the
    examples' own settings (fleets, horizons, the templates' full ALM
    budget): examples/rendezvous_holonomic.py (three Holonomic, rho 1.0:
    ``initialize``'s 5 dual updates in the first of 12 closed-loop
    updates), platform_landing.py (two Quadrotors and a Holonomic1D, two
    vehicle-type groups, 12 updates) and formation_holonomic_dualdec.py
    (12 updates), the generic ADMM scene of tests/test_distributed.py:238
    (rigid edge offsets; ``initialize``, 8 dual updates) and
    examples/p2p_holonomic_solvertest.py's scene with ``solver="ipm"``,
    and the same scene without its circle (12 closed-loop updates each;
    an IPM iteration is two CUDA graphs with the eigensolver between
    them).  Every x-update is recorded (K1 launches
    and variant, feasibility, iterations, time): each must launch K1 and
    be feasible (< 1e-3), no K2 or K3; the rendezvous residual must fall
    below half its first value, the DD residual must not rise over
    ``initialize``, the generic scene's residual must halve and its
    offsets hold within 0.1 m; the first x-update of each group and the
    first IPM solve, on a cut budget, against the CPU's within 4x the
    CPU's own 1e-15 sensitivity (or 1e-8).  The IPM's KKT error, its
    failed updates and retries are reported: on the example's scene the
    method does not converge, in the JAX package either (ROADMAP.md Queue
    3); without the circle every update's KKT error must be within 100
    tol (Problem's failure level); within 150 s;
20. the batched runner's other structures and the export
    (``structures_phase``): (a) bench.py's generic branch
    (bench.py:303-322) on its p2p_dubins scene without the substitution
    lift (the exact-integral Dubins, n_x 190, n_g 856: no quadratic
    structure, so the float32 runner takes ``generic``; its setup from
    the cache that a one-thread process of this script filled,
    ``StructuresReference``, started after phase 7's timed rollouts,
    which times the cold setup apart): a
    B = 1024, 12-step rollout (bench.py's 20 cut to the first knot
    passage and a step after it) at bench.py's settings for it (inner 8,
    budgets 4x10/2x8, 256 rescue lanes x 8 outer rounds, recover_tol 0.01
    raw), its steps timed by CUDA events, the CUDA-graph captures after
    every step (none after the first step of each budget class and of the
    rescue), K1 only (the block variant at 1024 x 190), no non-finite
    lane, progress; 16 lanes' cut-budget cold solve in float32 and
    float64 on the card against the float64 CPU runner's (the reference
    process), within 2 cm, beside the CPU's own 1e-15 sensitivity; (b)
    phase 4's runner rebuilt from the cache and forced onto
    ``quadratic`` and then ``compact`` (``runner.compact = None``, then
    ``runner.compact.arrow = None``, a new solver each): CA_STEPS steps
    from phase 7's cold solve, every lane's planned states within 2 cm of
    phase 10's at every step, or within 4x the lane's own move in
    compact-arrow's rollout from a rounding-sized move of that cold solve;
    K1 (151-row block variant) only, its launches counted by width; (c) ``ExportP2P`` of the
    bench scene from a float64 runner on the card and on the CPU, the
    directories byte-identical, and where the machine has g++ and make
    the harness built and run (``./test .``: PASSED); within 150 s;
21. the fleet mesh path and the multi-host layer on one rank
    (``mesh_phase``), in one process group (NCCL, gloo beside it for the
    CPU, 127.0.0.1 at a free port, a 120 s timeout), destroyed at the
    phase's end: (a) phase 14's formation on a one-rank ``"fleet"`` mesh
    in float32, ``FleetRunner.mesh_iterate_fn(20)`` through ``prepare``
    and ``run_placed`` (median of 3 after a warm run) and
    ``mesh_rollout_fn(20)`` from the iterated state: ADMM iterations/s,
    rollout periods/s, consensus_rms_m < 0.02 with the last primal
    residual below the first, the rollout finite, every vehicle nearer its
    goal and its last primal residual < 0.1, K1 only (K2 and K3 not
    launched, no library Cholesky kernel in a traced iteration), the
    collective counts (all-reduces and all-gathers > 0; no p2p on one
    rank); (b) the multi-host launcher's hybrid update
    (``make_hybrid_dual_update``, outer_iter 1) on a (1, 1) hybrid mesh
    for 256 identical instances of that formation, 3 iterations, K1 at
    1,024 x 85: finite, the instances equal, instance 0 against the four
    vehicles' own ``make_mesh_dual_update`` within 4x that update's move
    under a float32-rounding move of its start; (c) ``mesh_iterate_fn(2)``
    in float64 on the cut budget (2 x 4) on the card and on a CPU mesh
    from the card's cold solves, Z within 2 cm, beside the CPU's own move
    under a 1e-15 move of that start; with
    ``examples_torch/fleet_mesh_admm_tpu.py`` in a process of its own
    beside the phase; within 75 s;
15. times (after 21 and 8): the device time of K1 and K2 at every shape of 3
    and 13 (``device_ms``: the profiler's self CUDA time of the kernel's
    own name over 20 launches, over 20) and of ``cholesky_ex`` +
    ``cholesky_solve``'s kernels on the same inputs, K3's at both shapes of
    6 and of each plan of 13, and K1's in float64 at the closed loop's
    shape (1 x 151), at the formation's (4 x 85), at phase 16's, 17's
    and 18's (1 x n_x), at phase 19's x-updates (B x n_x), in float32
    at phase 20's (1024 x 190, 256 x 190, 4096 x 151) and 21's
    (1024 x 85) and of K1's
    global variant and of K1 at the G-code window (1 x 50) at the shapes
    of 3; taken last, so that no profiler
    session but 9's (and 14's trace) precedes the timed runs.

``--kernels-only`` runs phases 1-3 with the device times and stops (no
final line); run from the root of another checkout of the port it times
that tree's kernels with the same yardstick.  ``--scenes-only`` runs
phases 1-3 (the checks), 16 and its K1 device times, and stops;
``--vast-only`` the same with phase 17, ``--gcode-only`` with phase 18
and ``--distributed-only`` with phase 19 (each prints its kernels line,
no final line).  ``--structures-only`` runs phases 1-3, 4, 10 (on the
fused runner's cold solve) and 20, then phase 20's K1 device times, and
prints its kernels line (no final line).  ``--mesh-only`` runs phases 1-3
and 21 (on phase 14's scene, built for it), K1's device times at 4 x 85
and 1,024 x 85, and prints its kernels line (no final line).

The line before the ``kernels`` JSON object gives the script's wall time
(``elapsed``, the build included); the last two lines before the final
one are the ``kernels`` object and the card's name and power limit as
nvidia-smi prints them; the final line is ``{"ok": true, "device":
{...}}``.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
CA_STEPS = 3              # compact-arrow path: depth cut from 20
CROSS_LANES = 64
K3_WELL_RIDGE = 1e-2      # gn_delta_rel of the well-conditioned K3 check
K3_TOL_DX = 2e-3          # its kernel vs plain f32 tolerances: the step,
K3_TOL_GV = 1e-3          # ... g (both of their largest value)
K3_TOL_STAT = 1e-3        # ... and each lane's gradient norm
K3_MERIT_GATE = 0.25      # bench options: p99 merit error / f64 decrease
K3_GATE_FACTOR = 10.0     # kernel p99 error <= 10x the plain f32 version's
K3_GATE_FLOOR = 1e-6      # ... or this fraction of max |x|
K3_SHAPES = (("main", BATCH, BUDGETS[0][1]), ("rescue", RESCUE, INNER_ITER))
TOL_REL = 5e-5            # kernel vs plain: max |diff| <= TOL_REL * max |plain|
TOL_REL_F64 = 1e-10       # the same in float64
DEVICE_REPS = 20          # launches a device time is taken over
F64_PERTURB = 1e-15       # relative perturbation of x0: the cold solve's
                          # own sensitivity to rounding, on the CPU
FEAS_P99_GATE = 1e-3      # bench.py:446
PARITY_GATE_M = 0.02      # bench.py:443
PARITY_P90_GATE_M = 5e-3  # bench.py:444
REF_FEAS_GATE = 1e-3      # bench.py:445
# parity depth: bench.py's min(N_STEPS, 20) steps (bench.py:413); the
# reference runs in a one-thread process of its own beside the device
# phases, where its 12 steps took 14.5 s on the card's host
PARITY_STEPS = 20
# the reference (host float64, minutes) runs in a process of its own from
# phase 4 on, beside the device phases; the gate waits at most this long
PARITY_REFERENCE_TIMEOUT_S = 900
CL_UPDATES = 15           # closed loop, quadratic mode (tests/test_p2p.py)
# the generic mode, three updates on a cut budget: on the card's host an
# iteration of it (J, g and the objective's Hessian by torch.func every
# iteration) costs ~0.85 s, and it runs its full 320 iterations every
# update on this scene (~265 s an update)
CL_GENERIC_UPDATES = 3
CL_GENERIC_BUDGET = {"outer_iter": 1, "inner_iter": 8}
# its iterates against the quadratic mode's on the same budget: the same
# Gauss-Newton steps, J by AD against J = A + 2 Q x, equal to rounding
# until a solve starts amplifying it at its 12th iteration
# (tests/test_torch_closed_loop.py); a call here runs 8
CL_GENERIC_TOL = 1e-8
EXAMPLE_TIMEOUT_S = 400
# bench.py's formation_holonomic (bench.py:125-230) at its settings: N = 4
# Holonomic vehicles, rho 0.5, 2 outer ALM rounds of the template's 16
# inner iterations an x-update, 20 ADMM iterations, a 20-period rollout
# at one iteration a period; one timed run of each loop (bench.py: 3)
FLEET_N = 4
FLEET_RHO = 0.5
FLEET_OUTER = 2
ADMM_ITERS = 20
FLEET_STEPS = 20
CONSENSUS_GATE_M = 0.02   # bench.py:211-212 (the p2p parity standard)
FLEET_PROGRESS_M = 0.2    # tests/test_fleet_runner.py:90-103
FLEET_PARITY_M = 0.02     # float32 card / float64 card / float64 CPU Z
FLEET_CPU_ITERS = 2       # the CPU's float64 run (~1 s a Newton iteration)
NEWTON_MS_GATE = 100.0    # a generic Newton iteration of the x-update
NEWTON_REPS = 10
# phase 16: the examples' free-time (p2p_dubins, p2p_bicycle) and
# rotating-obstacle (revolving_door) closed loops in float64, the default
# generic mode at its full budget (20 outer x 16 inner), at most
# SCENE_UPDATES updates each: Dubins to its stop criterion (~75 updates,
# ~1.2 s each), the others cut for the script's time (their motions take
# ~90-100 updates at 1-1.35 s); a loop that stops must end within
# SCENE_GOAL_M of its goal
SCENE_LOOPS = ("p2p_dubins", "revolving_door", "p2p_bicycle")
SCENE_UPDATES = {"p2p_dubins": 120, "revolving_door": 12, "p2p_bicycle": 12}
SCENE_GOAL_M = 0.05
# the first solve on the card against the CPU's from the same inputs, on
# a cut budget (a full-budget solve on the CPU takes ~0.3 s a Newton
# iteration x 320), beside the CPU solve's own move under a 1e-15
# perturbation of its start: within 4x that move (as in
# tests/test_torch_free_time.py), or SCENE_FLOOR where rounding alone
# separates them.  Both start from the
# first solve's x0 plus a seeded 1e-2: the straight-line guess puts rows
# on their bounds, where the CPU's own 8-iteration solve moves by 0.7-2.5
# under a 1e-15 move of its start (measured on a CPU)
SCENE_CHECK_BUDGET = {"outer_iter": 1, "inner_iter": 8}
SCENE_CHECK_NOISE = 1e-2
SCENE_SPREAD_FACTOR = 4.0
SCENE_FLOOR = 1e-8
# phase 17: the vast-environment closed loops in float64, the default
# generic mode at its full budget, the first VAST_UPDATES[scene] updates
# of each (the examples run to their goals: minutes each); scheduler2 past
# its first frame switch (the 17th update in the JAX package on a CPU).
# The examples' copies are not run here: in smoke mode the four took 110
# s of a 971 s run on the card (their scenes are the loops'; run them with
# OMG_SMOKE=1 python examples_torch/<name>.py)
VAST_SCENES = ("multiframe", "scheduler1", "scheduler2", "scheduler_dubins")
VAST_LOOPS = ("multiframe", "scheduler1", "scheduler2")
VAST_UPDATES = {"multiframe": 12, "scheduler1": 12, "scheduler2": 18}
# phase 18: G-code machining and the central formation in float64, the
# default generic mode at its full budget, the first 12 updates each: the
# scenes of examples/GCode_examples/gcodeproblem_slot_multi.py (its first
# two blocks have zero length: the window rolls in updates 0 and 1) and
# gcodeproblem_rsq5.py (rings, the machining velocity limit), both at the
# examples' simulator settings, and examples/formation_holonomic_central.py
# (three Holonomic vehicles in one NLP, n_x 203: K1's global variant).
# The gates: every update feasible (GCODE_FEAS_GATE), slot_multi's window
# rolls at least once on K1 reg64, rsq5's tool stays in its first tube
# (|y| < GCODE_TUBE_Y m, the tube's half width 0.4 m), the formation takes
# K1 global and its centres spread less than FORMATION_SPREAD_M
# (tests/test_distributed.py:47-53)
GCODE_PROGRAMS = {
    "gcode_slot_multi": ("slot_multi.nc", {"tolerance": 0.3}),
    "gcode_rsq5": ("rsq5.nc", {"tolerance": 0.4,
                               "options": {"vel_limit": "machining"}})}
GCODE_LOOPS = ("gcode_slot_multi", "gcode_rsq5", "formation_central")
GCODE_UPDATES = {"gcode_slot_multi": 12, "gcode_rsq5": 12,
                 "formation_central": 12}
GCODE_SIMULATOR = {"sample_time": 0.002, "update_time": 0.02}
GCODE_FEAS_GATE = 1e-3
GCODE_TUBE_Y = 0.4
FORMATION_SPREAD_M = 1e-3
GCODE_PHASE_BUDGET_S = 150.0
# phase 19: the distributed layer's host-consensus problems and the
# interior-point backend in float64 on the card, at the examples' own
# settings (their fleets and horizons, the templates' full ALM budget of
# 20 outer x 16 inner iterations, the IPM's 60 iterations a solve):
# examples/rendezvous_holonomic.py (initialize's 5 dual updates inside
# the first of DIST_UPDATES closed-loop updates), platform_landing.py
# (two vehicle-type groups) and formation_holonomic_dualdec.py, the
# generic ADMM scene of tests/test_distributed.py:238 (initialize only, 8
# dual updates) and examples/p2p_holonomic_solvertest.py's scene with
# solver="ipm" (IPM_UPDATES closed-loop updates), where the method does not
# converge (in the JAX package either: its KKT error is reported, not
# gated), and the same scene without its circle, where it converges (every
# update's KKT error within 100 tol, Problem's failure level, is gated;
# the CPU's 12 updates: at most 7.7e-4).  The gates: every
# x-update feasible (DIST_FEAS_GATE, Problem's failure level) with K1 in
# every one; the rendezvous residual below half its first value
# (tests/test_distributed.py:90-92), the DD residual not increasing over
# initialize's updates (within 1e-9), the generic scene's residual halved
# and its offsets within GENERIC_OFFSET_GATE_M (tests/test_distributed.py:
# 276-285); the card's first x-update of each group and its first IPM
# solve against the CPU's from the same inputs on a cut budget, within
# SCENE_SPREAD_FACTOR x the CPU's own move under a 1e-15 perturbation of
# its start (or SCENE_FLOOR)
DIST_LOOPS = ("rendezvous_holonomic", "platform_landing",
              "formation_holonomic_dualdec", "generic_admm")
DIST_UPDATES = 12
DIST_INITIALIZE_ONLY = ("generic_admm",)
DIST_FEAS_GATE = 1e-3
GENERIC_OFFSET_GATE_M = 0.1
IPM_SCENE = "p2p_holonomic_solvertest"
IPM_SCENES = (IPM_SCENE, IPM_SCENE + "_rectangle")
IPM_CONVERGING = (IPM_SCENE + "_rectangle",)
IPM_UPDATES = 12
IPM_CHECK_BUDGET = 8      # IPM iterations of the card-vs-CPU check
DIST_PHASE_BUDGET_S = 150.0
# phase 20: the batched runner's other structures.  (a) bench.py's
# generic branch (bench.py:303-322) on bench.py's p2p_dubins scene without
# its substitution lift (the exact-integral Dubins: no quadratic
# structure, so the float32 runner takes ``generic``): ALMOptions(
# inner_iter=8), budgets 4x10 on knot passage and 2x8 otherwise, 2 outer
# rounds, 256 rescue lanes x 8 outer rounds, recover_tol 0.01 on the raw
# metric, B = 1024 (bench.py's own cap), 20 steps; 16 lanes' cold solve on
# a cut budget (4 outer x 8 inner, from make_batch's start plus a seeded
# 1e-2: that start puts rows on their bounds, where the CPU's own solve
# moves by centimetres under a 1e-15 move) against the port's float64
# CPU runner within the 2 cm parity bound (its CPU side in a one-thread
# process of its own, ``StructuresReference``, started after phase 7's
# timed rollouts, which also times the cold setup).  (b) the bench
# scene's runner forced onto ``quadratic`` and then ``compact`` from phase
# 7's cold solve: CA_STEPS steps each at the bench settings, timed, every
# lane's planned states within 2 cm of phase 10's compact-arrow states,
# or within its own spread (DENSE_SPREAD_DRAWS).  (c) ExportP2P of the bench
# scene from a float64 runner on the card and on the CPU: the directories
# byte-identical; the harness built and run where the machine has g++ and
# make.  Within STRUCT_PHASE_BUDGET_S, its setup from the warm cache
STRUCT_BATCH = 1024
# (a)'s depth, cut from bench.py's 20 steps to keep the script within 900 s
# with phase 21: the knot passage (k = 10, the hard budget's first step)
# and one easy step after it, whose capture count is checked
STRUCT_STEPS = 12
STRUCT_INNER = 8
STRUCT_ROLLOUT = dict(outer_iter=2, rescue_lanes=256, rescue_outer=8,
                      recover_tol=0.01, recover_metric="raw",
                      budgets=((4, 10), (2, 8)))
STRUCT_CHECK_LANES = 16
STRUCT_CHECK_BUDGET = {"outer_iter": 4, "inner_iter": 8}
STRUCT_CHECK_NOISE = 1e-2
STRUCT_PHASE_BUDGET_S = 150.0
STRUCT_REFERENCE_TIMEOUT_S = 900
DENSE_STRUCTURES = ("quadratic", "compact")
# (b)'s per-lane rule: a lane whose planned states lie 2 cm or more from
# compact-arrow's must lie within DENSE_SPREAD_FACTOR x its own move in
# compact-arrow's rollout under DENSE_SPREAD_DRAWS float32 rounding-sized
# moves (F32_PERTURB, relative) of the cold solve it starts from: a lane
# at an active-set decision amplifies rounding (on an NVIDIA H100 such a
# move took one of compact-arrow's 4,096 lanes 2.8 cm away in 3 steps,
# while the lanes' p99 moved 0.38 mm)
DENSE_SPREAD_DRAWS = 2
DENSE_SPREAD_FACTOR = 4.0
F32_PERTURB = 1e-6
# the batched runs with moving obstacles: bench.py's p2p_holonomic with
# its circle's velocity drawn per scenario (numpy seed 0: speed uniform in
# 0-0.2 m/s, as the warehouse example's obstacles move, direction
# uniform), and the obstraj example's spline-trajectory circle
OBSTACLE_SPEED_MAX = 0.2
# the obstraj rollout's depth (compact-arrow, ~0.6-0.7 s a step), cut from
# 20 to keep the script within 900 s with phase 21: the knot passage
# (k = 10) is its last step
OBSTRAJ_STEPS = 11

# phase 21: the fleet mesh path and the multi-host layer on one rank (one
# process group: NCCL, gloo beside it for the CPU, 127.0.0.1, a 120 s
# timeout).  (a) phase 14's formation on a one-rank "fleet" mesh in
# float32: mesh_iterate_fn(20) timed as bench.py times it (median of 3
# after a warm run), mesh_rollout_fn(20) from the iterated state;
# consensus_rms_m < 0.02 m with the last primal residual below the first,
# the rollout finite, every vehicle nearer its goal, its last primal
# residual < 0.1 (tests/test_fleet_runner.py:164); K1 only.  (b) the
# hybrid update of the multi-host launcher (outer_iter 1) on a (1, 1)
# hybrid mesh for HYBRID_B identical instances of (a)'s formation: one
# batched x-update of HYBRID_B * 4 lanes (K1 at 1,024 x 85), 3 iterations;
# finite, identical instances equal, instance 0 against the four vehicles'
# own make_mesh_dual_update within 4x that update's move under a
# float32-rounding move of its start, or 16 float32 epsilons of its
# largest |Z|.  (c) mesh_iterate_fn(2) in float64 on the cut budget on the
# card and on the CPU (gloo) from the card's cold solves, Z within
# FLEET_PARITY_M, beside the CPU's own move under F64_PERTURB; the example
# copy examples_torch/fleet_mesh_admm_tpu.py in a process of its own beside
# the phase
MESH_ITERS = ADMM_ITERS
MESH_STEPS = FLEET_STEPS
MESH_TIMED_RUNS = 3
MESH_ROLLOUT_PRI_GATE = 0.1
MESH_CUT_BUDGET = {"outer_iter": 2, "inner_iter": 4}
MESH_CPU_ITERS = 2
HYBRID_B = 256
HYBRID_OUTER = 1
HYBRID_ITERS = 3
HYBRID_SAME_REL = 1e-6
HYBRID_SPREAD_FACTOR = 4.0
HYBRID_EPS_FLOOR = 16
MESH_PHASE_BUDGET_S = 75.0
# library kernels that must not appear in the mesh path's trace
LIBRARY_CHOLESKY = ("potrf", "potrs", "cusolver", "magma", "trsm")

# NVIDIA H100 SXM data sheet: HBM3 rate, the f32 rate outside the tensor
# cores and the f64 rate through them (IEEE float64; 34e12 outside them):
# the card's peak for each type
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 67e12

# (name, entry point, TPU kernel it replaces, shapes); a shape is (tag,
# (N systems, n, r)): the compact-arrow path's (main), its rescue batch's
# and, for K1, the size of the dense and generic ALM modes' head solve
KERNELS = (
    ("K1 chol_solve r=1 (psd_solve)", "psd_solve",
     "omg_tools_tpu/ops/pallas_kernels.py:40",
     (("main", (4096, 26, 1)), ("rescue", (128, 26, 1)),
      ("dense", (256, 151, 1)), ("formation", (4, 85, 1)))),
    ("K2 chol_solve multi-RHS (psd_solve_multi)", "psd_solve_multi",
     "omg_tools_tpu/ops/pallas_kernels.py:118",
     (("main", (20480, 33, 27)), ("rescue", (640, 33, 27)))),
)
SOURCE = "omg_tools_torch/csrc/chol_solve.cu"
CHOL_KERNEL = "chol"      # a substring of the K1/K2 kernels' names
K3_KERNEL = "fused_alm_kernel"
K3_NAME = "K3 fused ALM inner loop (fused_inner)"
K3_SOURCE = "omg_tools_torch/csrc/fused_alm.cu"
K3_REPLACES = "omg_tools_tpu/ops/fused_alm.py:297"
# K1 in float64 at the closed loop's shape: Problem.solve's Newton system
# of the bench scene, one system a call (n_x = 4*13 + 3*3*11)
K1_F64_NAME = "K1 chol_solve r=1 (psd_solve) float64, Problem.solve"
K1_F64_SOURCE = "omg_tools_torch/csrc/chol_solve_f64.cu"
K1_F64_SHAPE = (1, 151, 1)
# K1's global variant (systems beyond a block's shared memory), float64
# unless named: the scheduler's two-frame local problems (the maze test's
# 178 rows; example2's 186, also four at once), the central formation of
# examples/formation_holonomic_central.py (203), a system of 262 rows (in
# float64 and float32: float32 K1 leaves its block variant above 236 rows)
# and the free-time warehouse (395)
K1_GLOBAL_NAME = "K1 chol_solve r=1 (psd_solve), global variant"
K1_GLOBAL_SHAPES = (("scheduler_maze", (1, 178, "float64")),
                    ("scheduler2", (1, 186, "float64")),
                    ("scheduler2_x4", (4, 186, "float64")),
                    ("formation_central", (1, 203, "float64")),
                    ("n262", (1, 262, "float64")),
                    ("warehouse", (1, 395, "float64")),
                    ("n262_f32", (1, 262, "float32")))
# K1 float64 in a register class at phase 18's G-code window (n_x 50: the
# right-hand side rides as a row, 51 <= 64), with the variant it must take
K1_REG_SHAPES = (("gcode_window", (1, 50, "float64"), "reg64"),)
# K1 at the formation's x-update: the generic mode's Newton system of the
# four vehicles' template (n_x = 85), one system a lane; and at phase 21's
# hybrid update, HYBRID_B instances of four vehicles in one batched solve
K1_FLEET_NAME = "K1 chol_solve r=1 (psd_solve), formation x-update"
K1_HYBRID_NAME = "K1 chol_solve r=1 (psd_solve), hybrid fleet update"
# K1 float64 at phase 19's x-updates (B vehicles of a group, n_x rows)
K1_DIST_NAME = "K1 chol_solve r=1 (psd_solve) float64, x-update"
K1_FLEET_SHAPE = (4, 85, 1)
# K1 at phase 20's shapes, float32, the block variant: the generic
# structure's Newton systems of the exact Dubins (n_x 190) at bench.py's
# B = 1024 and in its 256-lane rescue, and the bench scene's dense
# Newton systems (n_x 151) of the quadratic and compact structures
K1_STRUCT_NAME = "K1 chol_solve r=1 (psd_solve), dense structures"
K1_STRUCT_SHAPES = (("generic", (1024, 190, 1)),
                    ("generic_rescue", (256, 190, 1)),
                    ("quadratic_compact", (4096, 151, 1)))

# bench.py's other single-vehicle configurations (bench.py:233-345) at
# bench.py's settings for each: budgets, rescue, recovery metric and
# tolerances (bench.py:291-302, 325-335); the K3 shapes are the hard
# budget's inner iterations at B and the rescue's lanes at INNER_ITER.
# Diverged lanes are counted as bench.py:465-467 counts them: the scaled
# violation above recover_tol for the scaled metric, raw above 1e-2
# otherwise.  The feasibility gate (feas_p99 < 1e-3, no diverged lane)
# holds for the quadrotor (the JAX package met it on its chip); Dubins'
# float32 tail sat at 1.39e-3 in the JAX package's own sweep
# (bench.py:295-297), so there only finite values are gated.  K3's checks
# on the Dubins plan start 1e-3 off make_batch's start, where rows sit
# exactly on their bounds (tests/torch_bench_configs.py): there the plain
# version's float32 step leaves its float64 step by 2.1e-2 of its size at
# the main shape, as far as the kernel leaves the plain version (2.2e-2;
# the ``at_make_batch_start`` of its kernel_check line, NVIDIA H100 80GB
# HBM3, 700.00 W).  From the moved start a few lanes still switch
# activity on a float32 tie (the kernel's step error 2.6e-4 at p99 and
# 6.2e-2 at most), so the first check gates its p99 over lanes there.
CONFIGS = {
    "p2p_3dquadrotor": dict(
        start=[-1.5, -1.5, -1.5], goal=[2.0, 2.0, 1.5],
        rollout=dict(outer_iter=2, rescue_lanes=128, rescue_outer=6,
                     recover_tol=5e-3, recover_metric="scaled",
                     rescue_tol=5e-4, streak_tol=1e-3,
                     budgets=((3, 8), (1, 7))),
        feas_gate=True),
    "p2p_dubins": dict(
        start=[-1.5, -1.5], goal=[2.0, 2.0],
        rollout=dict(outer_iter=2, rescue_lanes=256, rescue_outer=8,
                     recover_tol=0.01, recover_metric="raw",
                     budgets=((4, 10), (2, 8))),
        feas_gate=False, k3_start_noise=1e-3, k3_well_quantile=0.99),
}
CONFIG_CROSS_LANES = 16
K3_CURV_WARM = 3          # curvature check: plain iterations to its state
K3_CURV_INNER = 2         # ... and the iterations it compares
K3_CURV_RESOLVED = 1e-3   # lanes whose plain f32 step is within this of f64
K3_CURV_RATIO = 0.25      # the kernel's lanes off the plain version's step,
                          # at most this share of the blind mutant's


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, name=None, reps=DEVICE_REPS, warmup=3):
    """Device time of one call of ``fn``: the self CUDA time that
    torch.profiler records for the kernels of ``reps`` calls after
    warm-up (only those whose name holds ``name``, if given).  Each
    kernel's mean time a launch counts as often as the kernel runs a call
    (its launches over ``reps``, rounded, at least once), so that a launch
    the profiler failed to record does not lower the figure.  Returns (ms,
    {kernel name: launches recorded}).  Where three profiler sessions
    record no kernel (as happened after a long run on the card), the time
    is taken by CUDA events around the ``reps`` calls instead (host time
    between launches included, so an upper bound), and the names are
    None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the profiler now and then records a session's launches but none of
    # its kernels: such a session is taken again, at most twice
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, names = 0.0, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count and (
                    name is None or name in e.key):
                us += e.self_device_time_total / e.count \
                    * max(1, round(e.count / reps))
                names[e.key[:90]] = e.count
        if us > 0:
            return us / 1e3, names
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    print("device_ms_by_events " + json.dumps(
        {"kernel": name, "ms": ms, "profiler_saw": sorted(
            e.key[:60] for e in prof.key_averages())[:8]}), flush=True)
    return ms, None


def ptxas_report(log):
    """One record per compiled kernel of an ``nvcc -Xptxas -v`` log: its
    (demangled where c++filt exists) name, registers, stack frame, spill
    stores and loads, and shared memory."""
    import re
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(e["kernel"] for e in entries),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(entries):
            for e, nm in zip(entries, names):
                e["kernel"] = nm.replace("(anonymous namespace)::",
                                         "").split("(")[0]
    except OSError:
        pass
    return entries


def time_ms(fn, reps=25, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings, after warm-up:
    from the card idle, so the wrapper's host time is in it."""
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


def spd_inputs(N, n, r, seed, device, dtype=None):
    """Random SPD systems H = A A' / n + I and panels G (float32 unless
    ``dtype`` says otherwise)."""
    import torch
    dtype = dtype or torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((N, n, n), generator=gen, device=device, dtype=dtype)
    H = A @ A.transpose(1, 2) / n + torch.eye(n, device=device, dtype=dtype)
    G = torch.randn((N, n, r), generator=gen, device=device, dtype=dtype)
    return H.contiguous(), G.contiguous()


def _chol_call(pk, entry, H, G):
    """(kernel wrapper, plain version, arguments) of one K1/K2 call; K2
    takes the arrow step's layout, (B, k, b, b) blocks with (B, k, b, r)
    panels, k = 5 or 4 where N allows it."""
    N, n, r = G.shape
    if entry == "psd_solve":
        return pk.psd_solve, pk.psd_solve_plain, (H, G[..., 0].contiguous())
    k = next(k for k in (5, 4, 1) if N % k == 0)
    return (pk.psd_solve_multi, pk.psd_solve_multi_plain,
            (H.reshape(N // k, k, n, n), G.reshape(N // k, k, n, r)))


def kernel_phase(device, timed=True, kernels=KERNELS):
    """K1 and K2 against their plain versions at each shape of
    ``KERNELS``, in float32 and, at the main shapes, in float64; prints one
    ``kernel_check`` line per check and returns one (entry, record) per
    kernel at its main shape and one for K1 at the formation's x-update
    (entry ``psd_solve_fleet``).  The checks run first (phase 3, ``timed=False``: no
    device times); the device times are taken at the end (``timed=True``),
    after the timed rollouts, so that no profiler session precedes those.

    ``ms`` is the kernel's device time (``device_ms``: the profiler's self
    CUDA time of the kernel's own name over DEVICE_REPS launches), with the
    inputs warm in L2 where they fit (K1: 6.6 MB at the main shape; K2's
    192 MB do not fit); ``call_ms`` the median CUDA-event time of one
    wrapper call from the card idle (host time included); ``library_ms``
    the device time of every kernel of ``cholesky_ex`` + ``cholesky_solve``
    on the same inputs, a yardstick the port never calls."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    # an older tree's wrappers (float32 only, no variant()) can be timed
    # with the same yardstick: ``--kernels-only`` run from its root
    variant = getattr(pk, "variant", None)
    records = []
    for name, entry, replaces, shapes in kernels:
        rec = None
        for tag, (N, n, r) in shapes:
            H, G = spd_inputs(N, n, r, seed=N + n + r, device=device)
            kern, plain, args = _chol_call(pk, entry, H, G)
            var = variant(n, r, torch.float32) if variant else None
            if variant and tag not in ("dense", "formation"):
                check(var.startswith("reg"),
                      f"{name} {tag}: ran the {var} variant, not a register "
                      "class")
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
            ms = library_ms = None
            names, library_kernels = {}, {}
            if timed:
                ms, names = device_ms(lambda: kern(*args), CHOL_KERNEL)
                check(names is None or (len(names) == 1 and sum(
                    names.values()) <= DEVICE_REPS),
                      f"{name} {tag}: {names} launched, not one kernel a "
                      "call")
                library_ms, library_kernels = device_ms(library)
            call_ms = time_ms(lambda: kern(*args))
            plain_ms = time_ms(lambda: plain(*args), reps=3, warmup=1)
            # the lower triangle of H is all the function reads of it
            nbytes = 4 * (N * n * (n + 1) // 2 + 2 * N * n * r)
            flops = N * (n ** 3 / 3.0 + 2.0 * n * n * r)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            line = {"name": name, "shape": tag, "N": N, "n": n, "r": r,
                    "dtype": "float32", "variant": var,
                    "kernel": None if names is None else sorted(names),
                    "max_abs_err": err,
                    "scale": scale, "library_err": lib_err, "ms": ms,
                    "call_ms": call_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library_kernels": None if library_kernels is None
                    else len(library_kernels),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "flops": flops}
            print("kernel_check " + json.dumps(line), flush=True)
            if tag in ("main", "formation"):
                shape_rec = {"name": name, "route": "cuda", "source": SOURCE,
                             "replaces": replaces, "launches": None,
                             "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms,
                             "bound_ms": line["bound_ms"],
                             "bound_by": line["bound_by"],
                             "library_ms": library_ms, "call_ms": call_ms,
                             "variant": var, "shape": [N, n, r]}
            if tag == "main":
                rec = shape_rec
            if tag == "formation":
                records.append(("psd_solve_fleet",
                                {**shape_rec, "name": K1_FLEET_NAME}))
            if tag == "main" and variant:
                kernel_phase_f64(name, entry, N, n, r, device, timed)
        records.append((entry, rec))
    return records


def kernel_phase_f64(name, entry, N, n, r, device, timed, shape="main",
                     dtype="float64"):
    """The float64 instance (or that of ``dtype``) against the plain
    version in the same type; with ``timed``, its device time, one call's
    time, the library's device time and the bound (operations over the
    card's peak for the type: float64 that of its tensor cores).  Returns
    the kernel_check line."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    tdtype = getattr(torch, dtype)
    tol, peak, size = ((TOL_REL_F64, PEAK_F64_FLOPS, 8) if dtype == "float64"
                       else (TOL_REL, PEAK_F32_FLOPS, 4))
    H, G = spd_inputs(N, n, r, seed=N + n + r, device=device, dtype=tdtype)
    kern, plain, args = _chol_call(pk, entry, H, G)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()),
          f"{name} {dtype}: non-finite output")
    check(err <= tol * scale,
          f"{name} {dtype}: max |kernel - plain| {err} > {tol} * {scale}")

    def library():
        L, _ = torch.linalg.cholesky_ex(H)
        return torch.cholesky_solve(G, L)
    nbytes = size * (N * n * (n + 1) // 2 + 2 * N * n * r)
    flops = N * (n ** 3 / 3.0 + 2.0 * n * n * r)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    line = {"name": name, "shape": shape, "N": N, "n": n, "r": r,
            "dtype": dtype, "variant": pk.variant(n, r, tdtype),
            "max_abs_err": err, "scale": scale,
            "library_err": float((library().reshape(got.shape)
                                  - want).abs().max()),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
    if timed:
        line["ms"] = device_ms(lambda: kern(*args), CHOL_KERNEL)[0]
        line["call_ms"] = time_ms(lambda: kern(*args))
        line["library_ms"] = device_ms(library)[0]
        line["plain_ms"] = time_ms(lambda: plain(*args), reps=3, warmup=1)
    print("kernel_check " + json.dumps(line), flush=True)
    return line


def k1_shapes_phase(device, timed):
    """K1's global variant (systems beyond a block's shared memory) at
    K1_GLOBAL_SHAPES, and K1 at K1_REG_SHAPES, against its plain version,
    with the tolerances of the K1 rows in the same type; each shape must
    take its variant.  With ``timed``, the times of ``kernel_phase_f64``.
    Returns the kernel_check lines."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    lines = []
    shapes = [(K1_GLOBAL_NAME, tag, shape, "global")
              for tag, shape in K1_GLOBAL_SHAPES] + \
        [(K1_F64_NAME, tag, shape, var) for tag, shape, var in K1_REG_SHAPES]
    for name, tag, (N, n, dtype), want in shapes:
        var = pk.variant(n, 1, getattr(torch, dtype))
        check(var == want,
              f"K1 {tag}: {N} x {n} {dtype} takes {var}, not {want}")
        lines.append(kernel_phase_f64(name, "psd_solve", N, n, 1,
                                      device, timed, shape=tag,
                                      dtype=dtype))
    return lines


def k1_f64_record(device, launches, per_update, name=K1_F64_NAME,
                  shape=K1_F64_SHAPE, tag="problem_solve"):
    """The kernels-line record of K1 in float64 at one of its shapes
    (phase 15: device times; by default Problem.solve's on the bench
    scene), with the launches of the path that runs it (in all, and in
    each of its updates or iterations)."""
    N, n, r = shape
    line = kernel_phase_f64(name, "psd_solve", N, n, r, device,
                            timed=True, shape=tag)
    return {"name": name, "route": "cuda", "source": K1_F64_SOURCE,
            "replaces": KERNELS[0][2], "launches": launches,
            "max_abs_err": line["max_abs_err"], "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": line["library_ms"],
            "call_ms": line["call_ms"], "variant": line["variant"],
            "shape": [N, n, r], "dtype": "float64",
            "launches_per_update": per_update}


def build_problem(T, config="p2p_holonomic"):
    """bench.py's scene of ``config``, letter for letter
    (bench.py:233-277), or phase 16's ``obstraj`` scene; initialized."""
    if config == "obstraj":
        problem = build_scene(T, config)
        problem.init()
        return problem
    if config == "p2p_dubins":
        vehicle = T.Dubins(shapes=T.Circle(0.1),
                           options={"substitution": True},
                           bounds={"vmax": 0.7, "wmax": np.pi / 3.0,
                                   "wmin": -np.pi / 3.0})
        vehicle.set_initial_conditions([-1.5, -1.5, 0.0])
        vehicle.set_terminal_conditions([2.0, 2.0, 0.0])
        environment = T.Environment(room={"shape": T.Square(5.0)})
        environment.add_obstacle(T.Obstacle(
            {"position": [0.5, 0.2]}, shape=T.Circle(0.4)))
    elif config == "p2p_3dquadrotor":
        vehicle = T.SimpleQuadrotor3D()
        vehicle.set_initial_conditions([-1.5, -1.5, -1.5])
        vehicle.set_terminal_conditions([2.0, 2.0, 1.5])
        environment = T.Environment(room={"shape": T.Cube(5.0)})
        environment.add_obstacle(T.Obstacle(
            {"position": [0.2, 0.2, 0.0]}, shape=T.Sphere(0.5)))
    else:
        vehicle = T.Holonomic()
        vehicle.set_initial_conditions([-1.5, -1.5])
        vehicle.set_terminal_conditions([2.0, 2.0])
        environment = T.Environment(room={"shape": T.Square(5.0)})
        environment.add_obstacle(T.Obstacle(
            {"position": [-2.1, -0.5]},
            shape=T.Rectangle(width=3.0, height=0.2)))
        environment.add_obstacle(T.Obstacle(
            {"position": [1.7, -0.5]},
            shape=T.Rectangle(width=3.0, height=0.2)))
        environment.add_obstacle(T.Obstacle(
            {"position": [1.5, 0.5]}, shape=T.Circle(0.4)))
    problem = T.Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0})
    problem.init()
    return problem


def build_structures_problem(T, options=None):
    """Phase 20's scene: bench.py's p2p_dubins scene (bench.py:239-251: a
    5 m room, a 0.4 m circle at (0.5, 0.2), vmax 0.7, |w| <= pi/3) without
    ``substitution``, the exact-integral Dubins whose cubic tan-half-angle
    rows leave no quadratic structure; initialized."""
    vehicle = T.Dubins(shapes=T.Circle(0.1),
                       bounds={"vmax": 0.7, "wmax": np.pi / 3.0,
                               "wmin": -np.pi / 3.0})
    vehicle.set_initial_conditions([-1.5, -1.5, 0.0])
    vehicle.set_terminal_conditions([2.0, 2.0, 0.0])
    environment = T.Environment(room={"shape": T.Square(5.0)})
    environment.add_obstacle(T.Obstacle({"position": [0.5, 0.2]},
                                        shape=T.Circle(0.4)))
    problem = T.Point2point(vehicle, environment, freeT=False)
    problem.set_options({"verbose": 0, **(options or {})})
    problem.init()
    return problem


def build_scene(T, scene, options=None):
    """One of the example scenes of phase 16 in the package ``T`` (the
    port, or in the tests the JAX package), not yet initialized:
    ``p2p_dubins`` and ``p2p_bicycle`` (free time), ``revolving_door`` (a
    rectangle rotating at pi/6 rad/s, fixed time) and ``obstraj`` (a
    rectangle and a circle on a caller-given spline trajectory), as the
    examples of the same names build them (examples/p2p_dubins.py,
    p2p_bicycle.py, revolving_door.py, p2p_holonomic_obstraj_export.py)."""
    if scene == "p2p_dubins":
        vehicle = T.Dubins(bounds={"vmax": 0.7, "wmax": np.pi / 3,
                                   "wmin": -np.pi / 3})
        vehicle.define_knots(knot_intervals=5)
        vehicle.set_initial_conditions([0.0, 0.0, 0.0])
        vehicle.set_terminal_conditions([3.0, 3.0, 0.0])
        env = T.Environment(room={"shape": T.Square(5.0),
                                  "position": [1.5, 1.5]})
        env.add_obstacle(T.Obstacle({"position": [1.0, 1.0]},
                                    shape=T.Circle(0.5)))
        freeT = True
    elif scene == "p2p_bicycle":
        vehicle = T.Bicycle(length=0.4, bounds={"vmax": 0.8,
                                                "dmax": np.pi / 6,
                                                "dmin": -np.pi / 6})
        vehicle.define_knots(knot_intervals=5)
        vehicle.set_initial_conditions([0.0, 0.0, 0.0, 0.0])
        vehicle.set_terminal_conditions([3.0, 3.0, 0.0])
        env = T.Environment(room={"shape": T.Square(5.0),
                                  "position": [1.5, 1.5]})
        env.add_obstacle(T.Obstacle({"position": [1.0, 1.0]},
                                    shape=T.Circle(0.4)))
        freeT = True
    elif scene == "revolving_door":
        vehicle = T.Holonomic()
        vehicle.set_initial_conditions([-1.8, -1.8])
        vehicle.set_terminal_conditions([2.0, 2.0])
        env = T.Environment(room={"shape": T.Square(5.0)})
        env.add_obstacle(T.Obstacle(
            {"position": [0.0, 0.0], "angular_velocity": np.pi / 6.0},
            shape=T.Rectangle(width=1.6, height=0.25),
            options={"horizon_time": 10.0}))
        freeT = False
    elif scene == "obstraj":
        vehicle = T.Holonomic(options={"safety_distance": 0.1})
        vehicle.set_initial_conditions([-1.5, -1.5])
        vehicle.set_terminal_conditions([2.0, 2.0])
        n_b = len(vehicle.basis)
        # drift from (1.5, 0.5) toward (0.5, 0.9) over the horizon
        coeffs = np.stack([np.linspace(1.5, 0.5, n_b),
                           np.linspace(0.5, 0.9, n_b)], axis=1)
        env = T.Environment(room={"shape": T.Square(5.0)})
        env.add_obstacle(T.Obstacle({"position": [1.7, -0.5]},
                                    shape=T.Rectangle(width=3.0, height=0.2)))
        obstacle = T.Obstacle({"position": [1.5, 0.5]}, shape=T.Circle(0.4))
        obstacle.set_options({"spline_traj": True, "spline_params": {
            "knots": vehicle.basis.knots, "degree": vehicle.basis.degree,
            "coeffs": coeffs}})
        env.add_obstacle(obstacle)
        freeT = False
    elif scene in VAST_SCENES or scene in GCODE_LOOPS:
        problem = (build_vast_scene(T, scene) if scene in VAST_SCENES
                   else build_gcode_scene(T, scene))
        problem.set_options({"verbose": 0, **(options or {})})
        return problem
    else:
        raise ValueError(f"unknown scene {scene!r}")
    problem = T.Point2point(vehicle, env, freeT=freeT)
    problem.set_options({"verbose": 0, **(options or {})})
    return problem


def build_vast_scene(T, scene):
    """One of phase 17's vast-environment scenes, as the examples of the
    same names build them (examples/test_multiframe.py,
    schedulerproblem_example1.py, schedulerproblem_example2.py,
    schedulerproblem_dubins.py): ``multiframe`` (two rooms, a
    MultiFrameProblem), ``scheduler1`` (shift frames, local free-time
    problems), ``scheduler2`` (two-frame corridors in a 60 x 30 m hall, a
    slow mover at the corner) and ``scheduler_dubins``; not initialized."""
    if scene == "multiframe":
        vehicle = T.Holonomic()
        vehicle.set_initial_conditions([-3.0, 0.0])
        vehicle.set_terminal_conditions([3.0, 0.0])
        env = T.Environment(room=[
            {"shape": T.Rectangle(width=5.0, height=2.0),
             "position": [-1.5, 0.0]},
            {"shape": T.Rectangle(width=5.0, height=2.0),
             "position": [1.5, 0.0]}])
        env.add_obstacle(T.Obstacle({"position": [0.0, 0.6]},
                                    shape=T.Circle(0.2)))
        return T.MultiFrameProblem(vehicle, env, n_frames=2)
    if scene == "scheduler1":
        vehicle = T.Holonomic(shapes=T.Circle(0.1))
        vehicle.set_initial_conditions([-4.0, -4.0])
        vehicle.set_terminal_conditions([4.0, 4.0])
        env = T.Environment(room={"shape": T.Square(10.0)})
        env.add_obstacle(T.Obstacle({"position": [-2.0, -2.0]},
                                    shape=T.Rectangle(width=0.4, height=3.0)))
        env.add_obstacle(T.Obstacle({"position": [2.0, 2.0]},
                                    shape=T.Circle(0.6)))
        return T.SchedulerProblem(vehicle, env, frame_size=4.0,
                                  n_cells=[20, 20])
    if scene == "scheduler2":
        vehicle = T.Holonomic(shapes=T.Circle(0.5), bounds={
            "vmax": 2, "vmin": -2, "amax": 4, "amin": -4})
        vehicle.set_initial_conditions([5.0, 0.0])
        vehicle.set_terminal_conditions([40.0, 20.0])
        env = T.Environment(room={"shape": T.Rectangle(width=60, height=30),
                                  "position": [30, 10]})
        env.add_obstacle(T.Obstacle({"position": [10.0, 0.0]},
                                    shape=T.Rectangle(width=2.0, height=2.0)))
        trajectories = {"velocity": {"time": [0.0], "values": [[0.0, -0.1]]}}
        env.add_obstacle(T.Obstacle({"position": [22.5, 12.5]},
                                    shape=T.Rectangle(width=2.0, height=2.0),
                                    simulation={"trajectories": trajectories}))
        return T.SchedulerProblem(vehicle, env, frame_type="corridor",
                                  n_frames=2, n_cells=[25, 25])
    vehicle = T.Dubins(shapes=T.Circle(0.3), bounds={
        "vmax": 0.7, "wmax": np.pi / 3.0, "wmin": -np.pi / 3.0})
    vehicle.define_knots(knot_intervals=10)
    vehicle.set_initial_conditions([2.0, 2.0, 0.0])
    vehicle.set_terminal_conditions([8.0, 8.0, 0.0])
    env = T.Environment(room={"shape": T.Rectangle(width=10, height=10),
                              "position": [5, 5]})
    env.add_obstacle(T.Obstacle({"position": [6.0, 2.0]},
                                shape=T.Rectangle(width=1.0, height=1.0)))
    env.add_obstacle(T.Obstacle({"position": [4.0, 2.0]},
                                shape=T.Circle(0.4)))
    env.add_obstacle(T.Obstacle({"position": [5.0, 6.0]},
                                shape=T.Circle(0.4)))
    return T.SchedulerProblem(vehicle, env, frame_type="corridor",
                              n_frames=2, n_cells=[10, 10])


def build_gcode_scene(T, scene):
    """One of phase 18's scenes, as the examples of the same names build
    them: ``gcode_slot_multi`` and ``gcode_rsq5``
    (examples/GCode_examples/gcodeproblem_slot_multi.py and
    gcodeproblem_rsq5.py: a Tool and a GCodeSchedulerProblem over the
    program's blocks, two segments a window; the .nc files are read where
    they lie) and ``formation_central``
    (examples/formation_holonomic_central.py: three Holonomic vehicles in
    one FormationPoint2pointCentral); not initialized."""
    if scene == "formation_central":
        n = 3
        vehicles = [T.Holonomic() for _ in range(n)]
        fleet = T.Fleet(vehicles)
        configuration = T.environment.shapes.RegularPolyhedron(
            0.2, n, np.pi / 4).vertices.T
        fleet.set_configuration(configuration.tolist())
        fleet.set_initial_conditions(
            (np.array([-1.5, -1.5]) + configuration).tolist())
        fleet.set_terminal_conditions(
            (np.array([2.0, 2.0]) + configuration).tolist())
        env = T.Environment(room={"shape": T.Square(5.0)})
        env.add_obstacle(T.Obstacle({"position": [1.5, 0.5]},
                                    shape=T.Circle(0.4)))
        return T.FormationPoint2pointCentral(fleet, env,
                                             options={"horizon_time": 10})
    program, tool_args = GCODE_PROGRAMS[scene]
    reader = T.GCodeReader()
    reader.load_file(os.path.join(HERE, "examples", "GCode_examples",
                                  program))
    blocks = reader.parse()
    tool = T.Tool(**tool_args)
    tool.define_knots(knot_intervals=5)
    tool.set_initial_conditions(blocks[0].start)
    return T.GCodeSchedulerProblem(tool, blocks, n_segments=2)


def scenarios(B, config="p2p_holonomic"):
    """bench.py's randomized starts/goals (numpy seed 0,
    bench.py:337-345)."""
    c = CONFIGS.get(config, dict(start=[-1.5, -1.5], goal=[2.0, 2.0]))
    rng = np.random.default_rng(0)
    dim = len(c["start"])
    starts = np.tile(c["start"], (B, 1)) + rng.uniform(-0.3, 0.3, (B, dim))
    goals = np.tile(c["goal"], (B, 1)) + rng.uniform(-0.3, 0.3, (B, dim))
    return starts, goals


def planned_state(runner, x, p):
    """One-period-ahead planned position (B, n_dim) commanded by solutions
    x at parameters p: the runner's plant update one period ahead."""
    s0 = int(runner.i_splines[0])
    n_coef, n_spl = runner.spline_shape
    cfs = x[:, s0:s0 + n_coef * n_spl].reshape(-1, n_coef, n_spl)
    return runner.model.update(p, cfs, 1, runner.horizon)[1]


def launch_counts():
    """The launch counters of every kernel, by wrapper name."""
    from omg_tools_torch.ops import fused_alm as fa
    from omg_tools_torch.ops import psd_kernels as pk
    return {"psd_solve": pk.psd_solve.launches,
            "psd_solve_multi": pk.psd_solve_multi.launches,
            "fused_inner": fa.fused_inner.launches}


def k1_launches_by_systems():
    """K1's launch counter by the number of systems a launch solved."""
    from omg_tools_torch.ops import psd_kernels as pk
    return {str(n): c for n, c in sorted(pk.psd_solve.by_systems.items())}


def zero_launch_counts():
    from omg_tools_torch.ops import fused_alm as fa
    from omg_tools_torch.ops import psd_kernels as pk
    pk.psd_solve.launches = pk.psd_solve_multi.launches = 0
    pk.psd_solve.by_systems.clear()
    fa.fused_inner.launches = 0


def setup_phase(T, device, B=BATCH, config="p2p_holonomic"):
    """The bench scene's float32 runner on ``device`` and B scenarios;
    ``setup_s`` is the problem's and the runner's build, the batch and the
    device tensors, and ``cache_hit`` says whether the host tensors came
    from the cache (``utils.cache``)."""
    import torch
    from omg_tools_torch.utils import cache
    t0 = time.time()
    problem = build_problem(T, config)
    cache_hit = cache.load_tensors(problem.transcription.fingerprint,
                                   "affine_v") is not None
    runner = T.BatchedP2PRunner(
        problem, dtype=torch.float32, device=device,
        alm_options=T.ALMOptions(inner_iter=INNER_ITER, rho_init=10.0))
    check(runner.structure == "compact-arrow-fused",
          f"structure {runner.structure}: {runner.structure_reason}")
    starts, goals = scenarios(B, config)
    x0, p0, state = runner.make_batch(starts, goals)
    consts = runner.consts()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"setup: {setup_s:.3f} s, structure {runner.structure}, "
          f"cache_hit {cache_hit}", flush=True)
    if config != "p2p_holonomic":
        from omg_tools_torch.ops import fused_alm as fa
        plan = runner.fused_plan
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        print("setup_config " + json.dumps({
            "config": config, "setup_s": setup_s, "cache_hit": cache_hit,
            "structure": runner.structure,
            "structure_reason": runner.structure_reason,
            "n_x": plan.n_x, "m": plan.m, "head": plan.head[1],
            "tail_blocks": [sz for _, sz in plan.blocks],
            "j_positions": plan.n_j, "values_per_phase": plan.values_len,
            "desc_words": int(consts.FS["desc_host"].size),
            "smem_bytes_one_lane": plan.smem_bytes(1),
            "lanes_per_block": fa.lanes_per_block(B, n_sm, plan.smem_bytes)}),
            flush=True)
    return runner, consts, starts, goals, x0, p0, state, setup_s, cache_hit


def _tensors(tree):
    import torch
    leaves = torch.utils._pytree.tree_flatten(tree)[0]
    return [a for a in leaves if isinstance(a, torch.Tensor)]


def cache_phase(T, device, consts, setup_s):
    """The same setup again: the host tensors must now come from the cache
    that the first build filled, and the second runner's device tensors
    must equal the first's bit for bit."""
    runner2, consts2, *_, setup2_s, hit = setup_phase(T, device)
    a, b = _tensors(consts), _tensors(consts2)
    same = len(a) == len(b) and all(
        u.dtype == v.dtype and u.shape == v.shape and bool((u == v).all())
        for u, v in zip(a, b))
    out = {"setup_s_cold": setup_s, "setup_s_cached": setup2_s,
           "cache_hit": hit, "tensors": len(a), "bit_identical": same}
    print("cache " + json.dumps(out), flush=True)
    check(hit, "the second build did not load its host tensors from the "
          "cache")
    check(same, "the cached runner's consts differ from the first build's")
    return out


class ReferenceProcess:
    """A reference computed by this script in a one-thread process of its
    own (``python chip_smoke.py FLAG ARG``), beside the device phases.
    ``wait()`` waits for it and returns (its last line's JSON, the seconds
    waited); the process is stopped on exit."""

    def __init__(self, flag, arg, timeout_s, what):
        self.timeout_s, self.what = timeout_s, what
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, arg], cwd=HERE,
            stdout=subprocess.PIPE, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1"})

    def wait(self):
        t0 = time.time()
        out, _ = self.proc.communicate(timeout=self.timeout_s)
        check(self.proc.returncode == 0,
              f"the {self.what}'s process exited {self.proc.returncode}")
        return json.loads(out.strip().splitlines()[-1]), time.time() - t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class ParityReference(ReferenceProcess):
    """Phase 8's reference rollout (the port's scipy solver on the bench
    scene's scenario 0, float64 on the host: minutes), started after
    setup (``--parity-reference``).  The process stores the record in the
    host-tensor cache, where ``parity_phase`` reads it."""

    def __init__(self, runner, x0, p0, workdir):
        from omg_tools_torch.tools.parity import reference_key
        from omg_tools_torch.utils import cache
        self.x0 = x0[0].double().cpu().numpy()
        self.p0 = p0[0].double().cpu().numpy()
        # reference_s is the reference's computation, never a cache load
        check(cache.load_tensors(reference_key(runner, self.x0, self.p0,
                                               PARITY_STEPS),
                                 "refroll") is None,
              "the parity reference is already in the cache")
        inputs = os.path.join(workdir, "parity_inputs.npz")
        np.savez(inputs, x0=self.x0, p0=self.p0)
        super().__init__("--parity-reference", inputs,
                         PARITY_REFERENCE_TIMEOUT_S, "parity reference")

    def result(self):
        """(the reference's own seconds, the seconds waited for it)."""
        line, waited_s = self.wait()
        return line["reference_s"], waited_s


def parity_reference(inputs):
    """``--parity-reference INPUTS``: the process of ``ParityReference``.
    Builds the bench scene's runner on the CPU (its host tensors from the
    cache the parent filled), computes the reference rollout record of the
    saved scenario into the cache, and prints its seconds."""
    sys.path.insert(0, HERE)
    import torch
    import omg_tools_torch as T
    from omg_tools_torch.tools.parity import cached_reference_rollout
    torch.set_num_threads(1)
    runner = T.BatchedP2PRunner(
        build_problem(T), dtype=torch.float32, device="cpu",
        alm_options=T.ALMOptions(inner_iter=INNER_ITER, rho_init=10.0))
    data = np.load(inputs)
    t0 = time.time()
    cached_reference_rollout(runner, data["x0"], data["p0"], PARITY_STEPS)
    print(json.dumps({"reference_s": time.time() - t0}), flush=True)


def parity_phase(T, device, reference, x0, p0, feas_p99):
    """bench.py's gate (bench.py:404-446) on the main path's float32 fused
    runner (built again from the cache, its batch equal to the main
    path's): open-loop control parity of scenario 0 along the reference
    rollout of the port's scipy solver (float64 on the host, ``reference``),
    with the bench budgets, through the runner's own structure (K3)."""
    from omg_tools_torch.tools.parity import (cached_reference_rollout,
                                              openloop_parity, reference_key)
    from omg_tools_torch.utils import cache
    runner, _, _, _, x0_again, p0_again, *_ = setup_phase(T, device)
    check(runner.structure == "compact-arrow-fused",
          f"parity on {runner.structure}")
    check(bool((x0_again == x0).all() and (p0_again == p0).all()),
          "the rebuilt runner's batch differs from the main path's")
    x0n, p0n = reference.x0, reference.p0
    ref_s, wait_s = reference.result()
    check(cache.load_tensors(reference_key(runner, x0n, p0n, PARITY_STEPS),
                             "refroll") is not None,
          "the parity reference's process stored no record")
    ref = cached_reference_rollout(runner, x0n, p0n, PARITY_STEPS)
    zero_launch_counts()
    t1 = time.time()
    res = openloop_parity(runner, x0n, p0n, PARITY_STEPS,
                          outer_iter=OUTER_ITER, budgets=BUDGETS, ref=ref)
    launches = launch_counts()
    p90 = float(np.percentile(res["per_step"], 90))
    out = {"steps": PARITY_STEPS, "parity_max_err": res["openloop_max_err"],
           "parity_p90_err": p90, "parity_ref_feas_max": res["ref_feas_max"],
           "per_step": res["per_step"].tolist(), "feas_p99": feas_p99,
           "reference_s": ref_s, "reference_wait_s": wait_s,
           "parity_s": time.time() - t1,
           "launches": launches}
    print("parity " + json.dumps(out), flush=True)
    check(launches["fused_inner"] > 0, "parity: K3 never launched")
    check(out["parity_max_err"] < PARITY_GATE_M and p90 < PARITY_P90_GATE_M
          and out["parity_ref_feas_max"] < REF_FEAS_GATE
          and feas_p99 < FEAS_P99_GATE,
          f"parity gate (bench.py:442-446) failed: {out}")
    return out


def _recorded(problem):
    """Record every state the problem's solver returns."""
    solver, states = problem._solver, []

    def record(*args, **kwargs):
        states.append(solver(*args, **kwargs))
        return states[-1]
    problem._solver = record
    return states


def _closed_loop(device, mode, n_updates, solver_options=None):
    """``n_updates`` Simulator updates of the bench scene in ``mode``, the
    counters zeroed before and read after each; returns (problem, line,
    K1 launches a update, solver states)."""
    import torch
    from omg_tools_torch import Simulator
    from omg_tools_torch.tools.parity import build_p2p_holonomic
    t0 = time.time()
    problem = build_p2p_holonomic(
        solver_options=solver_options,
        options={"device": device,
                 "exploit_structure": mode == "quadratic"})
    init_s = time.time() - t0
    check(problem._structure == mode, f"structure {problem._structure}")
    states = _recorded(problem)
    sim = Simulator(problem)
    wall_ms, k1, feas, iters = [], [], [], []
    for _ in range(n_updates):
        zero_launch_counts()
        t1 = time.perf_counter()
        sim.update()
        torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t1))
        c = launch_counts()
        check(c["psd_solve_multi"] == 0 and c["fused_inner"] == 0,
              f"closed loop ({mode}) launched {c}")
        k1.append(c["psd_solve"])
        feas.append(problem.solver_stats["feas"])
        iters.append(problem.solver_stats["iterations"])
    solve_ms = [1e3 * t for t in problem.update_times]
    x = states[-1].x
    line = {"mode": mode, "updates": n_updates, "budget": solver_options,
            "init_s": init_s, "solve_ms": solve_ms,
            "solve_ms_p50": float(np.median(solve_ms)),
            "solve_ms_max": float(np.max(solve_ms)),
            "update_wall_ms": wall_ms,
            "update_wall_ms_p50": float(np.median(wall_ms)),
            "update_wall_ms_max": float(np.max(wall_ms)),
            "k1_launches_per_update": k1, "iterations": iters,
            "solver_calls": len(states), "feas": feas,
            "dtype": str(x.dtype), "device": str(x.device)}
    check(all(k > 0 for k in k1), f"{mode}: an update launched no K1")
    check(x.is_cuda and x.dtype == torch.float64,
          f"{mode}: solved on {x.device} in {x.dtype}")
    return problem, line, k1, states


def closed_loop_phase(device):
    """The Quick Start closed loop (Point2point, Simulator) on the bench
    scene in float64 on the card: (a) the dense quadratic mode
    (``exploit_structure``), CL_UPDATES Simulator updates, held to
    tests/test_p2p.py's progress and clearance criteria; (b) the default
    generic mode, CL_GENERIC_UPDATES updates on the cut budget
    CL_GENERIC_BUDGET, every solver call's iterate held to the quadratic
    mode's on the same budget within CL_GENERIC_TOL.  Every update's solve runs K1 (float64, one
    151-row system a launch).  Returns K1's launches over (a) and (b),
    and in each update of (a)."""
    problem, line, per_update, _ = _closed_loop(device, "quadratic",
                                                CL_UPDATES)
    vehicle = problem.vehicles[0]
    S = np.asarray(vehicle.signals["state"], np.float64)
    d_start = float(np.linalg.norm(S[:, 0] - vehicle.poseT))
    d_end = float(np.linalg.norm(S[:, -1] - vehicle.poseT))
    clearance = float(np.min(np.linalg.norm(
        S - np.array([1.5, 0.5])[:, None], axis=0)))
    line.update(d_start=d_start, d_end=d_end, circle_clearance=clearance)
    print("closed_loop " + json.dumps(line), flush=True)
    check(bool(np.isfinite(S).all()), "quadratic: non-finite states")
    check(d_end < 0.9 * d_start and d_end < d_start - 0.35,
          f"no progress: {d_start} -> {d_end}")
    check(clearance > 0.49, f"circle clearance {clearance}")
    k1_total = sum(per_update)
    runs = {}
    for mode in ("generic", "quadratic"):
        _, line, k1, states = _closed_loop(device, mode, CL_GENERIC_UPDATES,
                                           CL_GENERIC_BUDGET)
        runs[mode] = states
        k1_total += sum(k1)
        if mode == "generic":
            # the updates' wall time over their solver calls' iterations
            n_it = sum(int(st.n_iter.sum()) for st in states)
            line["ms_per_iteration"] = sum(line["update_wall_ms"]) / n_it
            print("closed_loop " + json.dumps(line), flush=True)
    check(len(runs["generic"]) == len(runs["quadratic"]),
          "generic and quadratic solver calls differ in number")
    err = max(float((a.x - b.x).abs().max())
              for a, b in zip(runs["generic"], runs["quadratic"]))
    print("closed_loop_generic_vs_quadratic " + json.dumps(
        {"max_abs_err_x": err, "tol": CL_GENERIC_TOL,
         "solver_calls": len(runs["generic"])}), flush=True)
    check(err <= CL_GENERIC_TOL,
          f"generic vs quadratic iterates differ by {err}")
    return k1_total, per_update


def example_phase(*scripts):
    """``examples_torch/<script>`` in smoke mode (two updates), each in a
    process of its own on the card, all started together; ``seconds`` is
    each process's own wall time."""
    finish_examples(start_examples(*scripts))


def start_examples(*scripts):
    """Start ``examples_torch/<script>`` in smoke mode, each in a process
    of its own; :func:`finish_examples` waits for them."""
    procs = []
    for script in scripts:
        path = os.path.join("examples_torch", script)
        procs.append((path, time.time(), subprocess.Popen(
            [sys.executable, os.path.join(HERE, path)],
            env={**os.environ, "OMG_SMOKE": "1"}, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=HERE)))
    return procs


def finish_examples(procs):
    """Wait for the processes of :func:`start_examples`, print one
    ``example`` line each and fail on a non-zero exit."""
    try:
        for path, t0, proc in procs:
            stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            line = {"example": path, "rc": proc.returncode,
                    "seconds": time.time() - t0, "together_with": len(procs),
                    "stdout": stdout.strip().splitlines()[-1:]}
            print("example " + json.dumps(line), flush=True)
            check(proc.returncode == 0, f"{path} failed: {stderr[-2000:]}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build_formation(T, device, solver_options=None):
    """bench.py's formation_holonomic scene (bench.py:136-157): four
    Holonomic vehicles on a 0.2 m square formation from (-1.5, -1.5) to
    (2, 2), a 5 m room, a 0.4 m circle at (1.5, 0.5), 10 s horizon, rho
    0.5, the host loop off (the runners below drive the device loop); the
    template's x-update budget cut to ``solver_options`` where given."""
    from omg_tools_torch.environment.shapes import RegularPolyhedron
    vehicles = [T.Holonomic() for _ in range(FLEET_N)]
    fleet = T.Fleet(vehicles)
    configuration = RegularPolyhedron(0.2, FLEET_N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    fleet.set_initial_conditions(
        (np.array([-1.5, -1.5]) + configuration).tolist())
    fleet.set_terminal_conditions(
        (np.array([2.0, 2.0]) + configuration).tolist())
    env = T.Environment(room={"shape": T.Square(5.0)})
    env.add_obstacle(T.Obstacle({"position": [1.5, 0.5]},
                                shape=T.Circle(0.4)))
    problem = T.FormationPoint2point(
        fleet, env, options={"horizon_time": 10, "verbose": 0,
                             "rho": FLEET_RHO, "device_loop": False,
                             "device": device,
                             **({"solver_options": solver_options}
                                if solver_options else {})})
    problem.init()
    return problem, np.array([2.0, 2.0]) + configuration


def _newton_inputs(runner, carry):
    """One x-update's generic Newton step arguments (group 0), as
    ``_solve_groups`` hands them to the solver."""
    import torch
    g = runner._g[0]
    X, st, P = carry.X[0], carry.st[0], carry.Pp[0].clone()
    P[:, g["i_z"]] = carry.Z[g["edges"]].reshape(X.shape[0], -1)
    P[:, g["i_l"]] = carry.L[g["rows"]].reshape(X.shape[0], -1)
    solver = g["solver"]
    lb, ub = solver.scale_bounds(g["lb"], g["ub"], X.dtype, X.device)
    rho = torch.clamp(st.rho, max=runner.alm_rho_cap)
    return solver, (X, st.lam, rho, lb, ub, P)


def newton_timing(runner, carry):
    """A generic Newton iteration of the formation's x-update (B = 4 lanes,
    float32) two ways, each as wall time from the card idle to the card
    idle over NEWTON_REPS calls: the CUDA graph the solver replays
    (``CapturedCall``: one launch a kernel, no host work) and the same
    step eager.  The captured step must equal the eager one bit for
    bit."""
    import torch
    from omg_tools_torch.ops.alm import CapturedCall
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    solver, args = _newton_inputs(runner, carry)
    eager = solver.generic_step(*args)
    graphed = CapturedCall(solver.generic_step, args)
    replayed = [o.clone() for o in graphed(*args)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(eager, replayed))

    def per_rep(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NEWTON_REPS):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / NEWTON_REPS
    graph_ms = per_rep(lambda: graphed(*args))
    eager_ms = per_rep(lambda: solver.generic_step(*args))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graphed(*args)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    line = {"B": int(args[0].shape[0]), "n_x": int(args[0].shape[1]),
            "dtype": str(args[0].dtype), "captured_ms": graph_ms,
            "eager_ms": eager_ms,
            "kernels_per_captured_step": kernels,
            "k1_launches_per_step": graphed.k1_launches,
            "captured_equals_eager": same}
    print("newton_iteration " + json.dumps(line), flush=True)
    check(same, "the captured Newton step differs from the eager one")
    check(graphed.k1_launches == 1,
          f"a captured step holds {graphed.k1_launches} K1 launches")
    check(graph_ms <= NEWTON_MS_GATE,
          f"a generic Newton iteration takes {graph_ms} ms")
    return line


def _trace_admm_iteration(runner, carry):
    """One ADMM iteration traced: the device's kernel time over the same
    iteration's untraced wall time, and the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    it = runner.iterate_fn(1)
    untraced_ms = timed_call_ms(lambda: it(carry))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms = timed_call_ms(lambda: it(carry))
    kernel_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.key.startswith("alm."):
            kernel_us += e.self_device_time_total
            kernels += e.count
    out = {"untraced_ms": untraced_ms, "traced_ms": traced_ms,
           "device_kernel_ms": kernel_us / 1e3,
           "device_busy_share": kernel_us / 1e3 / untraced_ms,
           "kernels_launched": kernels}
    print("formation_profile " + json.dumps(out), flush=True)
    check(kernel_us > 0, "the traced ADMM iteration shows no device time")
    return out


def _carry_to(carry, device):
    import torch
    return torch.utils._pytree.tree_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, carry)


def formation_phase(T, device):
    """Phase 14: bench.py's formation_holonomic on the card in float32
    through the port's FleetRunner (K1 in every x-update), with bench.py's
    fields, the float64 runs it is held to, the traced iteration, the
    Newton-iteration timing and the example.  Returns K1's launches over
    the float32 main run and per ADMM iteration, the Newton-step timing
    and K1's launches in the float64 card run."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.parallel import FleetRunner
    t_setup = time.time()
    problem, goals = build_formation(T, device)
    tr = problem.template.transcription
    check(problem.template._structure == "generic",
          f"template structure {problem.template._structure}")
    runner = FleetRunner(problem, dtype=torch.float32,
                         outer_iter=FLEET_OUTER, device=device)
    check(len(problem.groups) == 1,
          f"{len(problem.groups)} vehicle groups: one x-update an iteration "
          "is expected")
    zero_launch_counts()
    carry = runner.make_state(0.0)
    k1_cold = pk.psd_solve.launches
    it = runner.iterate_fn(ADMM_ITERS)
    carry_w, (pri, dua) = it(carry)
    torch.cuda.synchronize()
    setup_s = time.time() - t_setup
    t0 = time.perf_counter()
    carry_w, (pri, dua) = it(carry)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # K1's launches in each x-update (the one group's solve of an ADMM
    # iteration): single iterations on from the warm carry
    k1, c, one = [], carry_w, runner.iterate_fn(1)
    for _ in range(ADMM_ITERS):
        before = pk.psd_solve.launches
        c, _ = one(c)
        k1.append(pk.psd_solve.launches - before)
    carry2, _ = it(carry)
    roll = runner.rollout_fn(FLEET_STEPS, iters_per_update=1)
    roll(carry2)
    torch.cuda.synchronize()
    before = pk.psd_solve.launches
    t0 = time.perf_counter()
    _, out = roll(carry2)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    k1_roll = pk.psd_solve.launches - before
    counts = launch_counts()
    check(counts["psd_solve_multi"] == 0 and counts["fused_inner"] == 0,
          f"the formation launched {counts}")
    # after the cold solves: 4 x 20 iterations + 2 x 20 periods (one
    # iteration a period)
    n_admm = 4 * ADMM_ITERS + 2 * FLEET_STEPS
    check(all(n > 0 for n in k1), f"K1 launches per x-update {k1}")
    # every x-update of the rollout runs at least one outer round, a K1
    # launch a Newton step
    inner = problem.template._solver.options.inner_iter
    check(k1_roll >= FLEET_STEPS * inner,
          f"{k1_roll} K1 launches over {FLEET_STEPS} rollout periods")
    pri = pri.cpu().numpy().astype(np.float64)
    dua = dua.cpu().numpy().astype(np.float64)
    consensus_rms_m = float(pri[-1] / np.sqrt(2 * runner.N * runner.n_sh))
    states = out["states"].cpu().numpy().astype(np.float64)
    d0 = np.linalg.norm(states[:, 0] - goals, axis=1)
    d1 = np.linalg.norm(states[:, -1] - goals, axis=1)
    line = {
        "metric": "formation_holonomic_admm_iterations_per_s",
        "value": ADMM_ITERS / run_s, "unit": "iterations/s",
        "fleet_n": FLEET_N, "device": torch.cuda.get_device_name(0),
        "n_x": tr.n_x, "n_g": tr.n_g, "n_p": tr.n_p, "n_sh": runner.n_sh,
        "residual_curve_pri": pri.tolist(),
        "residual_curve_dua": dua.tolist(),
        "residual_decrease": float(pri[0] / max(pri[-1], 1e-12)),
        "consensus_rms_m": consensus_rms_m,
        "consensus_ok": consensus_rms_m < CONSENSUS_GATE_M,
        "rollout_periods_per_s": FLEET_STEPS / roll_s,
        "rollout_pri": out["pri"].cpu().numpy().tolist(),
        "goal_distance_start": d0.tolist(), "goal_distance_end": d1.tolist(),
        "setup_s": setup_s, "run_s": run_s, "rollout_s": roll_s,
        "k1_launches": counts["psd_solve"], "admm_iterations": n_admm,
        "k1_launches_per_admm_iteration":
            (counts["psd_solve"] - k1_cold) / n_admm,
        "k1_launches_per_x_update_min_max": [min(k1), max(k1)],
        "k1_launches_per_rollout_period": k1_roll / FLEET_STEPS}
    print("formation " + json.dumps(line), flush=True)
    check(bool(np.isfinite(pri).all() and np.isfinite(states).all()),
          "non-finite formation residuals or states")
    check(consensus_rms_m < CONSENSUS_GATE_M,
          f"consensus rms {consensus_rms_m} m")
    check(bool((d1 < d0 - FLEET_PROGRESS_M).all()),
          f"no progress to the goals: {d0} -> {d1}")
    launches = counts["psd_solve"]

    newton = newton_timing(runner, carry_w)
    _trace_admm_iteration(runner, carry_w)

    # the example, in a process of its own beside the float64 checks (no
    # time is taken there)
    examples = start_examples("formation_holonomic.py")
    try:
        k1_f64, err32, err_cpu = formation_f64_checks(problem, carry_w,
                                                      device)
    finally:
        finish_examples(examples)
    check(err32 < FLEET_PARITY_M, f"float32 vs float64 Z: {err32} m")
    check(err_cpu < FLEET_PARITY_M, f"card vs CPU float64 Z: {err_cpu} m")
    return (launches, line["k1_launches_per_admm_iteration"], newton, k1_f64,
            (problem, goals))


def formation_f64_checks(problem, carry_w, device):
    """Phase 14's float64 runs: on the card from its own cold state (K1 in
    float64 at 4 x 85, launches counted), its Z after ADMM_ITERS
    iterations against the float32 run's (``carry_w``), and after
    FLEET_CPU_ITERS against the port's float64 run on the CPU from the
    same carry, beside the CPU run's own sensitivity to a 1e-15
    perturbation.  Returns (K1 launches, the two Z differences)."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.parallel import FleetRunner
    kernel_phase_f64(K1_FLEET_NAME, "psd_solve", *K1_FLEET_SHAPE, device,
                     timed=False, shape="formation")
    runner64 = FleetRunner(problem, dtype=torch.float64,
                           outer_iter=FLEET_OUTER, device=device)
    k1_before = pk.psd_solve.launches
    carry64 = runner64.make_state(0.0)
    c64_2, _ = runner64.iterate_fn(FLEET_CPU_ITERS)(carry64)
    c64, _ = runner64.iterate_fn(ADMM_ITERS)(carry64)
    torch.cuda.synchronize()
    k1_f64 = pk.psd_solve.launches - k1_before
    check(k1_f64 > 0, "the float64 formation launched no K1")
    err32 = float((carry_w.Z.double() - c64.Z).abs().max())
    # the float64 CPU run from the card's float64 cold state
    cpu = torch.device("cpu")
    runner_cpu = FleetRunner(problem, dtype=torch.float64,
                             outer_iter=FLEET_OUTER, device=cpu)
    carry_cpu = _carry_to(carry64, cpu)
    t0 = time.time()
    cc, _ = runner_cpu.iterate_fn(FLEET_CPU_ITERS)(carry_cpu)
    cpu_s = time.time() - t0
    rng = np.random.default_rng(0)
    moved = carry_cpu._replace(X=tuple(
        x * (1.0 + F64_PERTURB * torch.as_tensor(
            rng.standard_normal(tuple(x.shape)), dtype=x.dtype))
        for x in carry_cpu.X))
    cp, _ = runner_cpu.iterate_fn(FLEET_CPU_ITERS)(moved)
    err_cpu = float((c64_2.Z.cpu() - cc.Z).abs().max())
    sens = float((cp.Z - cc.Z).abs().max())
    check_line = {"f32_vs_f64_card_Z": err32, "iterations": ADMM_ITERS,
                  "f64_card_vs_cpu_Z": err_cpu,
                  "cpu_iterations": FLEET_CPU_ITERS,
                  "cpu_sensitivity_1e-15": sens, "cpu_s": cpu_s,
                  "k1_f64_launches": k1_f64, "tol_m": FLEET_PARITY_M}
    print("formation_check " + json.dumps(check_line), flush=True)
    return k1_f64, err32, err_cpu


def mesh_loops(device, problem, goals, mesh):
    """Phase 21 (a): mesh_iterate_fn(MESH_ITERS) of phase 14's formation
    on the one-rank fleet mesh in float32, through ``prepare`` and
    ``run_placed``, timed as bench.py times it, then mesh_rollout_fn from
    the iterated state; one iteration traced (K1's kernel, no library
    Cholesky).  Returns the formation_mesh line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.parallel import FleetRunner, fleet_mesh
    runner = FleetRunner(problem, dtype=torch.float32,
                         outer_iter=FLEET_OUTER, device=device, mesh=mesh)
    g = problem.groups[0]
    X0, P0 = g.X, problem._pack_params(g, 0.0)
    it = runner.mesh_iterate_fn(MESH_ITERS)
    placed = it.prepare(X0, P0, problem.Z, problem.L)
    zero_launch_counts()
    fleet_mesh.collectives.update(p2p=0, all_reduce=0, all_gather=0)
    it.run_placed(placed)                       # warm run
    times = []
    for _ in range(MESH_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (X, Z, L), (pri, dua) = it.run_placed(placed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    run_s = float(np.median(times))
    k1_iterate = pk.psd_solve.launches
    collectives_iterate = dict(fleet_mesh.collectives)
    roll = runner.mesh_rollout_fn(MESH_STEPS)
    placed_r = roll.prepare(X, P0, Z, L)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, (rpri, rdua, states) = roll.run_placed(placed_r)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    counts = launch_counts()
    collectives = dict(fleet_mesh.collectives)
    by_systems = k1_launches_by_systems()
    # one iteration traced: the card's kernels
    one = runner.mesh_iterate_fn(1)
    placed_1 = one.prepare(X0, P0, problem.Z, problem.L)
    one.run_placed(placed_1)
    untraced_ms = timed_call_ms(lambda: one.run_placed(placed_1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one.run_placed(placed_1)
        torch.cuda.synchronize()
    kernel_us, names = 0.0, set()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.key.startswith("alm."):
            kernel_us += e.self_device_time_total
            names.add(e.key)
    library = sorted(n for n in names
                     if any(m in n.lower() for m in LIBRARY_CHOLESKY))
    pri = pri.cpu().numpy().astype(np.float64)
    dua = dua.cpu().numpy().astype(np.float64)
    rpri = rpri.cpu().numpy().astype(np.float64)
    states = states.cpu().numpy().astype(np.float64)
    consensus_rms_m = float(pri[-1] / np.sqrt(2 * runner.N * runner.n_sh))
    d0 = np.linalg.norm(states[:, 0] - goals, axis=1)
    d1 = np.linalg.norm(states[:, -1] - goals, axis=1)
    n_iter = (1 + MESH_TIMED_RUNS) * MESH_ITERS
    line = {
        "metric": "formation_holonomic_mesh_admm_iterations_per_s",
        "value": MESH_ITERS / run_s, "unit": "iterations/s",
        "ranks": mesh.size(), "fleet_n": runner.N,
        "run_s_runs": times, "run_s": run_s,
        "residual_curve_pri": pri.tolist(),
        "residual_curve_dua": dua.tolist(),
        "consensus_rms_m": consensus_rms_m,
        "rollout_periods_per_s": MESH_STEPS / roll_s, "rollout_s": roll_s,
        "rollout_pri": rpri.tolist(),
        "goal_distance_start": d0.tolist(), "goal_distance_end": d1.tolist(),
        "k1_launches": counts["psd_solve"],
        "k1_launches_per_admm_iteration": k1_iterate / n_iter,
        "k1_launches_by_systems": by_systems,
        "collectives_iterate": collectives_iterate,
        "collectives": collectives,
        "collectives_per_admm_iteration": {
            k: v / n_iter for k, v in collectives_iterate.items()},
        "traced_iteration": {"untraced_ms": untraced_ms,
                             "device_kernel_ms": kernel_us / 1e3,
                             "device_busy_share":
                                 kernel_us / 1e3 / untraced_ms,
                             "k1_kernel": sorted(
                                 n[:60] for n in names if CHOL_KERNEL in n),
                             "library_cholesky": library}}
    print("formation_mesh " + json.dumps(line), flush=True)
    check(bool(np.isfinite(pri).all() and np.isfinite(states).all()
               and np.isfinite(rpri).all()),
          "non-finite mesh residuals or states")
    check(consensus_rms_m < CONSENSUS_GATE_M,
          f"mesh consensus rms {consensus_rms_m} m")
    check(pri[-1] < pri[0], f"mesh primal residual {pri[0]} -> {pri[-1]}")
    check(bool((d1 < d0).all()), f"mesh rollout: no progress {d0} -> {d1}")
    check(rpri[-1] < MESH_ROLLOUT_PRI_GATE,
          f"mesh rollout's last primal residual {rpri[-1]}")
    check(counts["psd_solve"] > 0 and counts["psd_solve_multi"] == 0
          and counts["fused_inner"] == 0, f"the mesh path launched {counts}")
    check(line["traced_iteration"]["k1_kernel"] and not library,
          f"the traced mesh iteration ran {library}, K1 "
          f"{line['traced_iteration']['k1_kernel']}")
    check(collectives["all_reduce"] > 0 and collectives["all_gather"] > 0
          and collectives["p2p"] == 0, f"collectives {collectives}")
    return line


def hybrid_update(device, problem, mesh):
    """Phase 21 (b): the multi-host launcher's hybrid update on a (1, 1)
    hybrid mesh for HYBRID_B identical instances of phase 14's formation,
    HYBRID_ITERS iterations, each timed; against the four vehicles' own
    make_mesh_dual_update on ``mesh``.  Returns the hybrid line."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.parallel import (hybrid_mesh,
                                          make_hybrid_dual_update,
                                          make_mesh_dual_update,
                                          shard_hybrid_state)
    hmesh = hybrid_mesh(device=device)
    check(tuple(hmesh.shape) == (1, 1), f"hybrid mesh {hmesh}")
    step, rel = make_hybrid_dual_update(problem, hmesh,
                                        outer_iter=HYBRID_OUTER)
    g = problem.groups[0]
    f32 = dict(dtype=torch.float32, device=device)
    start = [torch.as_tensor(a, **f32) for a in (
        g.X, problem._pack_params(g, 0.0), problem.Z, problem.L, rel)]
    X, Pp, Z, L, relb = shard_hybrid_state(hmesh, *(
        a.expand((HYBRID_B,) + tuple(a.shape)).contiguous() for a in start))
    k1_before = pk.psd_solve.launches
    times = []
    for _ in range(HYBRID_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, Z, L, pri, dua = step(X, Pp, Z, L, relb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1 = pk.psd_solve.launches - k1_before
    Xh = X.reshape(HYBRID_B, -1).double()
    Zh = Z.reshape(HYBRID_B, -1).double()
    same_bits = bool((Xh == Xh[:1]).all() and (Zh == Zh[:1]).all())
    same_rel = float((Xh - Xh[:1]).abs().max() / Xh[:1].abs().max())

    # instance 0 against the four vehicles alone, and that run's move
    # under a float32-rounding move of its start
    alone = make_mesh_dual_update(problem, mesh, outer_iter=HYBRID_OUTER)

    def run_alone(X0):
        Xa, Za, La = X0, start[2], start[3]
        for _ in range(HYBRID_ITERS):
            Xa, Za, La, _, _ = alone(Xa, start[1], Za, La)
        return Xa.double(), Za.double()
    Xa, Za = run_alone(start[0])
    eps = float(torch.finfo(torch.float32).eps)
    sens = 0.0
    gen = torch.Generator(device=device).manual_seed(0)
    for _ in range(2):
        noise = torch.randn(start[0].shape, generator=gen, **f32)
        sens = max(sens, float((run_alone(start[0] * (1 + eps * noise))[1]
                                - Za).abs().max()))
    err = float((Z[0].double() - Za).abs().max())
    tol = max(HYBRID_SPREAD_FACTOR * sens,
              HYBRID_EPS_FLOOR * eps * float(Za.abs().max()))
    line = {"B": HYBRID_B, "vehicles": HYBRID_B * problem.N,
            "mesh": {n: int(s) for n, s in zip(hmesh.mesh_dim_names,
                                               hmesh.shape)},
            "outer_iter": HYBRID_OUTER, "iterations": HYBRID_ITERS,
            "iteration_s": times, "k1_launches": k1,
            "k1_launches_by_systems": k1_launches_by_systems(),
            "pri": float(pri), "dua": float(dua),
            "instances_equal_bitwise": same_bits,
            "instances_max_rel_diff": same_rel,
            "instance0_vs_alone_Z_m": err,
            "alone_float32_sensitivity_Z_m": sens, "tol_m": tol}
    print("hybrid " + json.dumps(line), flush=True)
    check(bool(torch.isfinite(X).all() and torch.isfinite(Z).all()
               and torch.isfinite(L).all()), "non-finite hybrid update")
    check(same_rel <= HYBRID_SAME_REL,
          f"identical instances differ by {same_rel} (relative)")
    check(err <= tol, f"instance 0 vs the fleet alone: {err} m > {tol} m")
    check(k1_launches_by_systems().get(str(HYBRID_B * problem.N), 0) > 0,
          f"no K1 launch at {HYBRID_B * problem.N} systems")
    return line


def mesh_card_vs_cpu(T, device, mesh):
    """Phase 21 (c): mesh_iterate_fn(MESH_CPU_ITERS) in float64 on the
    cut budget on the one-rank CUDA mesh and on a one-rank CPU mesh
    (gloo), from the same cold state (the card's cold solves of
    ``make_state``: from the straight-line guess, where rows sit on their
    bounds, the CPU's own Z moves by centimetres under F64_PERTURB); Z's
    largest difference beside the CPU's own move when its start moves by
    F64_PERTURB."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from omg_tools_torch.parallel import FleetRunner
    problem, _ = build_formation(T, device, solver_options=MESH_CUT_BUDGET)
    cuda = FleetRunner(problem, dtype=torch.float64, outer_iter=FLEET_OUTER,
                       device=device, mesh=mesh)
    carry = cuda.make_state(0.0)
    start = tuple(a.cpu() for a in (carry.st[0].x, carry.Pp[0], carry.Z,
                                    carry.L))
    (_, Zg, _), (pri, _) = cuda.mesh_iterate_fn(MESH_CPU_ITERS)(*start)
    mesh_cpu = init_device_mesh("cpu", (1,), mesh_dim_names=("fleet",))
    cpu = FleetRunner(problem, dtype=torch.float64, outer_iter=FLEET_OUTER,
                      device="cpu", mesh=mesh_cpu)
    t0 = time.time()
    (_, Zc, _), _ = cpu.mesh_iterate_fn(MESH_CPU_ITERS)(*start)
    cpu_s = time.time() - t0
    rng = np.random.default_rng(0)
    moved = start[0] * (1.0 + F64_PERTURB * torch.as_tensor(
        rng.standard_normal(tuple(start[0].shape))))
    (_, Zm, _), _ = cpu.mesh_iterate_fn(MESH_CPU_ITERS)(moved, *start[1:])
    err = float((Zg.cpu() - Zc).abs().max())
    sens = float((Zm - Zc).abs().max())
    line = {"f64_card_vs_cpu_Z": err, "iterations": MESH_CPU_ITERS,
            "budget": MESH_CUT_BUDGET, "cpu_sensitivity_1e-15": sens,
            "cpu_s": cpu_s, "pri": pri.cpu().numpy().tolist(),
            "tol_m": FLEET_PARITY_M}
    print("mesh_check " + json.dumps(line), flush=True)
    check(bool(torch.isfinite(Zg).all()), "non-finite float64 mesh Z")
    check(err < FLEET_PARITY_M, f"mesh card vs CPU float64 Z: {err} m")
    return line


def mesh_phase(T, device, formation):
    """Phase 21: the fleet mesh path and the multi-host layer on one rank
    (``mesh_loops``, ``hybrid_update``, ``mesh_card_vs_cpu``) in one
    process group, destroyed at the phase's end, and the example copy.
    ``formation``: phase 14's (problem, goals).  Returns K1's launches
    over (a) and (b) by the number of systems a launch solved, and the
    phase's lines."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from omg_tools_torch.parallel import fleet_mesh
    t0 = time.time()
    check(fleet_mesh.one_rank_group(device),
          "a process group existed before phase 21")
    # the example copy beside the phase: its process spends its first ~20 s
    # on the host (imports, the template's build) while (a) replays its
    # graphs, which keep the card busy
    examples = start_examples("fleet_mesh_admm_tpu.py")
    try:
        mesh = init_device_mesh(device.type, (1,),
                                mesh_dim_names=("fleet",))
        loops = mesh_loops(device, *formation, mesh)
        hybrid = hybrid_update(device, formation[0], mesh)
        by_systems = k1_launches_by_systems()
        card_cpu = mesh_card_vs_cpu(T, device, mesh)
    finally:
        try:
            finish_examples(examples)
        finally:
            dist.destroy_process_group()
    seconds = time.time() - t0
    print("mesh_phase " + json.dumps(
        {"seconds": seconds, "budget_s": MESH_PHASE_BUDGET_S}), flush=True)
    check(seconds <= MESH_PHASE_BUDGET_S,
          f"phase 21 took {seconds} s > {MESH_PHASE_BUDGET_S} s")
    return {"k1_by_systems": by_systems, "loops": loops, "hybrid": hybrid,
            "card_vs_cpu": card_cpu}


def mesh_records(device, mesh):
    """Phase 15's record of K1 at the hybrid update's shape (float32,
    HYBRID_B * 4 systems of 85 rows), with its launches in (b)."""
    N = HYBRID_B * FLEET_N
    n = mesh["hybrid"]["k1_launches_by_systems"]
    line = kernel_phase_f64(K1_HYBRID_NAME, "psd_solve", N, K1_FLEET_SHAPE[1],
                            1, device, timed=True, shape="hybrid",
                            dtype="float32")
    check(line["variant"] == "block",
          f"K1 hybrid: {N} x 85 takes {line['variant']}, not block")
    return [("psd_solve", {
        "name": K1_HYBRID_NAME, "route": "cuda", "source": SOURCE,
        "replaces": KERNELS[0][2], "launches": n.get(str(N), 0),
        "max_abs_err": line["max_abs_err"], "ms": line["ms"],
        "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
        "bound_by": line["bound_by"], "library_ms": line["library_ms"],
        "call_ms": line["call_ms"], "variant": line["variant"],
        "shape": [N, K1_FLEET_SHAPE[1], 1], "dtype": "float32"})]


class recorded_solves:
    """Within the block, every solve (ALM or IPM) of every problem
    (``Problem._run_solver``) as (problem, x0, p, lb, ub, state): the
    scheduler's local problems are built and swapped inside the loop."""

    def __enter__(self):
        from omg_tools_torch.problems.problem import Problem
        self.orig, self.calls = Problem._run_solver, []
        orig, calls = self.orig, self.calls

        def run(problem, parameters, lb, ub, state=None, **kw):
            x0 = np.array(problem._x_result, np.float64)
            st = orig(problem, parameters, lb, ub, state, **kw)
            calls.append((problem, x0, np.array(parameters, np.float64),
                          lb, ub, st))
            return st
        Problem._run_solver = run
        return self.calls

    def __exit__(self, *exc):
        from omg_tools_torch.problems.problem import Problem
        Problem._run_solver = self.orig


def _loop_counts(problem):
    """(frame switches, problem builds, window rolls) so far: a
    scheduler's frames and cached problems, or a G-code scheduler's window
    (each roll builds a new window problem)."""
    if hasattr(problem, "window_start"):
        return 0, problem.cnt_windows, problem.window_start
    return (getattr(problem, "cnt_frame_switches", 0),
            getattr(problem, "cnt_problem_builds", 0), 0)


def formation_spread(problem):
    """The largest spread over the horizon of the fleet centres that the
    vehicles of a central formation perceive (coefficient-wise, as
    tests/test_distributed.py:47-53 measures it)."""
    centers = [problem.get_variables(v, "splines_seg0")
               + np.asarray(v.rel_pos_c)[None, :] for v in problem.vehicles]
    return float(np.max(np.ptp(np.stack(centers), axis=0)))


def scene_loop(T, device, scene, n_updates=None):
    """Phase 16 (a), 17 and 18: one example scene's closed loop
    (``Problem.solve`` + ``Simulator``) in float64 on the card in the
    default generic mode, ``n_updates`` (SCENE_UPDATES[scene]) updates or
    to its stop criterion, the launch counters zeroed before and read
    after each update (K1 in every one, no K2 or K3); for a scheduler also
    its frame switches (a G-code scheduler: its window rolls), problem
    builds and CUDA-graph captures a update: a switch onto a cached local
    problem must capture nothing, and every solved problem captures its
    two graphs once.  Then the first solve on a cut budget against the
    CPU's from the same inputs.  Returns the loop's line."""
    import torch
    from omg_tools_torch import Simulator
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.ops.alm import (ALMOptions, CapturedCall,
                                         make_alm_solver)
    t0 = time.time()
    problem = build_scene(T, scene, {"device": device})
    vehicle = problem.vehicles[0]
    gcode = isinstance(problem, T.GCodeSchedulerProblem)
    # the global goal: a scheduler points poseT at its frames' goals (a
    # G-code scheduler at its window's end: its progress is the tool's
    # path, gated by phase 18)
    goal = None if gcode else np.asarray(vehicle.poseT, np.float64)[:2]
    problem.init()
    init_s = time.time() - t0
    sched = hasattr(problem, "local_problem")
    first = problem.local_problem if sched else problem
    tr = first.transcription
    check(first._structure == "generic",
          f"{scene}: structure {first._structure}")
    sim = Simulator(problem, **(GCODE_SIMULATOR if gcode else {}))
    counts = {"frame_switches": [], "problem_builds": [],
              "window_rolls": [], "graph_captures": [],
              "n_x_per_update": [], "k1_variant_per_update": []}
    wall_ms, solve_ms, k1, iters, feas, spread = [], [], [], [], [], []
    central = isinstance(problem, T.FormationPoint2pointCentral)
    stopped = False
    switches0 = getattr(problem, "cnt_frame_switches", 0)
    with recorded_solves() as calls:
        for _ in range(n_updates or SCENE_UPDATES[scene]):
            zero_launch_counts()
            before = (*_loop_counts(problem), CapturedCall.captures)
            t1 = time.perf_counter()
            stopped = sim.update()
            torch.cuda.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t1))
            c = launch_counts()
            check(c["psd_solve_multi"] == 0 and c["fused_inner"] == 0,
                  f"{scene}: the closed loop launched {c}")
            k1.append(c["psd_solve"])
            iters.append(problem.solver_stats["iterations"])
            feas.append(problem.solver_stats["feas"])
            solve_ms.append(1e3 * problem.solver_stats["time"])
            if central:
                spread.append(formation_spread(problem))
            after = (*_loop_counts(problem), CapturedCall.captures)
            for key, a, b in zip(("frame_switches", "problem_builds",
                                  "window_rolls", "graph_captures"),
                                 before, after):
                counts[key].append(b - a)
            n_x = (problem.local_problem if sched
                   else problem).transcription.n_x
            counts["n_x_per_update"].append(n_x)
            counts["k1_variant_per_update"].append(
                pk.variant(n_x, 1, torch.float64))
            if stopped:
                break
    pose = np.asarray(vehicle.signals["pose"], np.float64)
    if gcode:
        goal = np.asarray(vehicle.poseT, np.float64)[:2]
    d_start = float(np.linalg.norm(pose[:2, 0] - goal))
    d_end = float(np.linalg.norm(pose[:2, -1] - goal))
    n_it = sum(int(st.n_iter.sum()) for *_, st in calls)
    x = calls[-1][-1].x
    solved = {id(c[0]) for c in calls}
    line = {"scene": scene, "problem": type(problem).__name__,
            "local_problem": type(first).__name__,
            "structure": first._structure,
            "n_x": tr.n_x, "n_g": tr.n_g, "n_p": tr.n_p,
            "k1_variant": pk.variant(tr.n_x, 1, torch.float64),
            "updates": len(wall_ms), "stopped": stopped, "init_s": init_s,
            "solve_ms": solve_ms,
            "solve_ms_p50": float(np.median(solve_ms)),
            "solve_ms_max": float(np.max(solve_ms)),
            "update_wall_ms_p50": float(np.median(wall_ms)),
            "update_wall_ms_max": float(np.max(wall_ms)),
            "iterations": iters, "solver_calls": len(calls),
            "ms_per_iteration": sum(wall_ms) / max(n_it, 1),
            "k1_launches_per_update": k1, "feas": feas,
            "goal": goal.tolist(), "final_position": pose[:2, -1].tolist(),
            "goal_distance_start": d_start, "goal_distance_end": d_end,
            "dtype": str(x.dtype), "device": str(x.device)}
    for key in ("n_x_per_update", "k1_variant_per_update"):
        line[key] = counts.pop(key)
    if sched:
        switches, builds, _ = _loop_counts(problem)
        line.update(counts, frame_switches_at_init=switches0,
                    problems_solved=len(solved),
                    frame_switches_total=switches,
                    problem_builds_total=builds)
    if gcode:
        state = np.asarray(vehicle.signals["state"], np.float64)
        line.update(window_start=problem.window_start,
                    segments=len(problem.segments_all),
                    path_m=float(np.sum(np.linalg.norm(
                        np.diff(state, axis=1), axis=0))),
                    max_abs_y=float(np.max(np.abs(state[1]))))
    if central:
        line["center_spread_m"] = spread
    if type(first).__name__ == "FreeTPoint2point":
        line["motion_time_left_s"] = float(
            first.get_variables(first, "T")[0])
    print("scene_loop " + json.dumps(line), flush=True)
    check(all(k > 0 for k in k1), f"{scene}: an update launched no K1: {k1}")
    check(x.is_cuda and x.dtype == torch.float64,
          f"{scene}: solved on {x.device} in {x.dtype}")
    check(bool(np.isfinite(pose).all()), f"{scene}: non-finite poses")
    if gcode:
        check(line["path_m"] > 0.0, f"{scene}: the tool did not move")
    else:
        check(d_end < d_start,
              f"{scene}: no progress: {d_start} -> {d_end}")
    check(d_end < SCENE_GOAL_M or not stopped,
          f"{scene}: stopped {d_end} m from the goal")
    if sched:
        check(sum(counts["graph_captures"]) == 2 * len(solved),
              f"{scene}: {counts['graph_captures']} captures for "
              f"{len(solved)} solved problems (two graphs each, once)")
        for sw, bu, cap in zip(counts["frame_switches"],
                               counts["problem_builds"],
                               counts["graph_captures"]):
            check(not (sw and not bu and cap),
                  f"{scene}: a switch onto a cached problem captured {cap} "
                  "graphs")

    # the first solve on the cut budget: the card against the CPU (a
    # G-code window may have rolled before it: the problem it solved)
    solved0, x0, p, lb, ub = calls[0][:5]
    tr = solved0.transcription

    def cut_solve(x0_, p_):
        cut = make_alm_solver(
            tr.objective, tr.constraints, tr.n_x, tr.lb, tr.ub,
            ALMOptions(**SCENE_CHECK_BUDGET), row_scale=solved0._row_scale,
            obj_scale=solved0._obj_scale, fg=tr.objective_and_constraints)
        return cut(x0_, p_, lb, ub).x.double().cpu().numpy()
    card_vs_cpu("scene_check", cut_solve, x0[None], p[None], device,
                scene=scene, budget=SCENE_CHECK_BUDGET)
    return line


def scene_phase(T, device, cache_root):
    """Phase 16: the three closed loops, the examples' port copies in
    smoke mode, and the batched obstacle runs.  Returns the loops'
    lines."""
    loops = {scene: scene_loop(T, device, scene) for scene in SCENE_LOOPS}
    example_phase(*[scene + ".py" for scene in SCENE_LOOPS])
    obstacle_phase(T, device, cache_root)
    return loops


def vast_phase(T, device):
    """Phase 17: the vast-environment closed loops (``VAST_LOOPS``, the
    first VAST_UPDATES[scene] updates each).  Returns the loops' lines."""
    loops = {scene: scene_loop(T, device, scene, VAST_UPDATES[scene])
             for scene in VAST_LOOPS}
    s2 = loops["scheduler2"]
    check("global" in s2["k1_variant_per_update"],
          f"scheduler2 ran K1's {set(s2['k1_variant_per_update'])}, not "
          "global")
    check(sum(s2["frame_switches"]) >= 1,
          "scheduler2 saw no frame switch")
    return loops


def gcode_phase(T, device):
    """Phase 18: the G-code and central-formation closed loops
    (``GCODE_LOOPS``, the first GCODE_UPDATES[scene] updates each) and
    their gates.  Returns the loops' lines."""
    t0 = time.time()
    loops = {scene: scene_loop(T, device, scene, GCODE_UPDATES[scene])
             for scene in GCODE_LOOPS}
    for scene, loop in loops.items():
        check(max(loop["feas"]) < GCODE_FEAS_GATE,
              f"{scene}: an update's feasibility {max(loop['feas'])}")
    slot = loops["gcode_slot_multi"]
    check(sum(slot["window_rolls"]) >= 1, "slot_multi's window never rolled")
    check(set(slot["k1_variant_per_update"]) == {"reg64"},
          f"slot_multi ran K1's {set(slot['k1_variant_per_update'])}, "
          "not reg64")
    check(loops["gcode_rsq5"]["max_abs_y"] < GCODE_TUBE_Y,
          f"rsq5's tool left its first tube: |y| "
          f"{loops['gcode_rsq5']['max_abs_y']}")
    central = loops["formation_central"]
    check(set(central["k1_variant_per_update"]) == {"global"},
          f"formation_central ran K1's "
          f"{set(central['k1_variant_per_update'])}, not global")
    check(max(central["center_spread_m"]) < FORMATION_SPREAD_M,
          f"formation_central's centres spread "
          f"{max(central['center_spread_m'])} m")
    seconds = time.time() - t0
    print("gcode_phase " + json.dumps({
        "seconds": seconds, "budget_s": GCODE_PHASE_BUDGET_S,
        "updates": {s: loop["updates"] for s, loop in loops.items()}}),
        flush=True)
    check(seconds <= GCODE_PHASE_BUDGET_S,
          f"phase 18 took {seconds} s > {GCODE_PHASE_BUDGET_S} s")
    return loops


def loop_records(device, loops):
    """The kernels-line records of K1 float64 at each closed loop's
    shape, with the loop's launches (phase 15)."""
    return [("psd_solve", k1_f64_record(
        device, sum(loop["k1_launches_per_update"]),
        loop["k1_launches_per_update"], name=f"{K1_F64_NAME}, {scene}",
        shape=(1, loop["n_x"], 1), tag=scene))
        for scene, loop in loops.items()]


def build_distributed_scene(T, scene, options=None):
    """One of phase 19's scenes in the package ``T``, as the examples of
    the same names (and tests/test_distributed.py:238 for
    ``generic_admm``) build it; not initialized."""
    from omg_tools_torch.environment.shapes import RegularPolyhedron
    options = dict(options or {})
    if scene in IPM_SCENES:
        vehicle = T.Holonomic(options={"safety_distance": 0.1})
        vehicle.set_initial_conditions([-1.5, -1.5])
        vehicle.set_terminal_conditions([2.0, 2.0])
        env = T.Environment(room={"shape": T.Square(5.0)})
        env.add_obstacle(T.Obstacle({"position": [1.7, -0.5]},
                                    shape=T.Rectangle(width=3.0,
                                                      height=0.2)))
        if scene == IPM_SCENE:
            env.add_obstacle(T.Obstacle({"position": [1.5, 0.5]},
                                        shape=T.Circle(0.4)))
        return T.Point2point(vehicle, env, {"verbose": 0, "solver": "ipm",
                                            **options}, freeT=False)
    if scene == "platform_landing":
        quadrotors = [T.Quadrotor(0.2) for _ in range(2)]
        fleet = T.Fleet(quadrotors + [T.Holonomic1D()])
        fleet.set_configuration([[0.25], [-0.25], [0.0]])
        fleet.set_initial_conditions([[1.5, 3.0], [-2.0, 2.0], [1.0]])
        fleet.set_terminal_conditions([[0.0, 0.1], [0.0, 0.1], [0.0]])
        env = T.Environment(room={"shape": T.Square(5.0),
                                  "position": [0., 2.]})
        env.add_obstacle(T.Obstacle({"position": [1.0, 1.5]},
                                    shape=T.Rectangle(width=1.0,
                                                      height=0.2)))
        problem = T.RendezVous(fleet, env, options={
            "horizon_time": 5.0, "rho": 3.0, **options})
        problem.set_options({"verbose": 0})
        return problem
    N = 3
    vehicles = [T.Holonomic() for _ in range(N)]
    fleet = T.Fleet(vehicles)
    configuration = RegularPolyhedron(0.2, N, np.pi / 4).vertices.T
    fleet.set_configuration(configuration.tolist())
    env = T.Environment(room={"shape": T.Square(5.0)})
    if scene == "rendezvous_holonomic":
        fleet.set_initial_conditions(
            [[-2.0, -2.0], [2.0, -1.5], [-1.0, 2.0]])
        for veh in vehicles:
            veh.set_terminal_conditions([0.0, 0.0])
        problem = T.RendezVous(fleet, env, options={
            "horizon_time": 10, "rho": 1.0, **options})
    else:
        fleet.set_initial_conditions(
            (np.array([-1.5, -1.5]) + configuration).tolist())
        fleet.set_terminal_conditions(
            (np.array([2.0, 2.0]) + configuration).tolist())
    if scene == "formation_holonomic_dualdec":
        problem = T.FormationPoint2pointDualDecomposition(
            fleet, env, options={"horizon_time": 10, **options})
    elif scene == "generic_admm":
        rel = {v: np.asarray(sorted(fleet.configuration[v].items()))[:, 1]
               for v in vehicles}

        def shared_fn(problem, vehicle, splines):
            return [splines[0], splines[1]]

        def edge_constraint(problem, veh_i, veh_j):
            n = problem.n_sh // 2
            eye = np.eye(2 * n)
            r = rel[veh_i] - rel[veh_j]            # z_i - z_j = r_ij
            return (np.concatenate([eye, -eye], axis=1),
                    np.concatenate([np.full(n, r[0]), np.full(n, r[1])]))
        problem = T.GenericADMMProblem(
            fleet, env, shared_fn=shared_fn, edge_constraint=edge_constraint,
            options={"horizon_time": 10, "rho": 1.0, "init_iter": 8,
                     **options})
        problem.rel = rel
    problem.set_options({"verbose": 0})
    return problem


class recorded_x_updates:
    """Within the block, every x-update of an ADMM-engine ``problem``
    (``ADMMProblem._x_update``: one batched ALM solve of a vehicle-type
    group): its group, batch, n_x, K1 launches and variant, the result's
    feasibility and iterations and its wall time; the inputs of each
    group's first (cold) x-update are kept for the CPU check."""

    def __init__(self, problem):
        self.problem = problem

    def __enter__(self):
        import torch
        from omg_tools_torch.ops import psd_kernels as pk
        problem, calls, first = self.problem, [], {}
        orig = problem._x_update
        self.calls, self.first = calls, first

        def run(group, current_time):
            g = problem.groups.index(group)
            n_x = group.template.transcription.n_x
            if g not in first:
                first[g] = (np.array(group.X), problem._pack_params(
                    group, current_time))
            torch.cuda.synchronize()
            k1, t0 = pk.psd_solve.launches, time.perf_counter()
            orig(group, current_time)
            torch.cuda.synchronize()
            st = group.alm_state
            calls.append({
                "group": g, "B": len(group.indices), "n_x": n_x,
                "k1": pk.psd_solve.launches - k1,
                "variant": pk.variant(n_x, 1, st.x.dtype),
                "feas": float(st.feas.max()),
                "iterations": int(st.n_iter.max()),
                "ms": 1e3 * (time.perf_counter() - t0),
                "device": str(st.x.device), "dtype": str(st.x.dtype)})
        problem._x_update = run
        return self

    def __exit__(self, *exc):
        del self.problem._x_update


def card_vs_cpu(tag, solve, x0, p, device, noise=SCENE_CHECK_NOISE,
                **fields):
    """``solve(x0, p)`` (a cut-budget solve on a batch, returning x as
    float64 numpy) on the card against the CPU from x0 plus a seeded
    ``noise``, beside the CPU's own move under a 1e-15 relative
    perturbation of that start: the card must land within
    SCENE_SPREAD_FACTOR x that move, or SCENE_FLOOR.  Prints the line,
    ``fields`` first, after ``tag``, and returns it."""
    import torch
    gen = torch.Generator().manual_seed(0)
    x0 = torch.as_tensor(x0, dtype=torch.float64)
    p = torch.as_tensor(p, dtype=torch.float64)
    x0 = x0 + noise * torch.randn(x0.shape, generator=gen, dtype=x0.dtype)
    card = solve(x0.to(device), p.to(device))
    t1 = time.time()
    cpu = solve(x0, p)
    cpu_s = time.time() - t1
    moved = solve(x0 * (1 + F64_PERTURB * torch.randn(
        x0.shape, generator=gen, dtype=x0.dtype)), p)
    err = float(np.abs(card - cpu).max())
    sens = float(np.abs(moved - cpu).max())
    tol = max(SCENE_SPREAD_FACTOR * sens, SCENE_FLOOR)
    line = {**fields, "card_vs_cpu_max_abs_x": err,
            "cpu_sensitivity_1e-15": sens, "tol": tol, "noise": noise,
            "cpu_s": cpu_s}
    print(f"{tag} " + json.dumps(line), flush=True)
    check(bool(np.isfinite(card).all()), f"{fields}: non-finite card solve")
    check(err <= tol, f"{fields}: card vs CPU first solve {err} > {tol}")
    return line


def dist_loop(T, device, scene):
    """Phase 19 (a): one ADMM-engine scene's loop in float64 on the card:
    ``initialize`` alone (DIST_INITIALIZE_ONLY) or DIST_UPDATES
    closed-loop updates (``Simulator``: the first runs ``initialize``),
    every x-update recorded; then each group's first x-update on a cut
    budget against the CPU's.  Returns the loop's line."""
    import torch
    from omg_tools_torch import Simulator
    from omg_tools_torch.ops.alm import ALMOptions, make_alm_solver
    t0 = time.time()
    problem = build_distributed_scene(T, scene, {"device": device})
    problem.init()
    init_s = time.time() - t0
    wall_ms, dual_per_update = [], []
    zero_launch_counts()
    with recorded_x_updates(problem) as rec:
        if scene in DIST_INITIALIZE_ONLY:
            t1 = time.perf_counter()
            problem.initialize(0.0)
            torch.cuda.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t1))
            dual_per_update.append(len(problem.residuals))
        else:
            sim = Simulator(problem)
            for _ in range(DIST_UPDATES):
                n_res = len(problem.residuals)
                t1 = time.perf_counter()
                sim.update()
                torch.cuda.synchronize()
                wall_ms.append(1e3 * (time.perf_counter() - t1))
                dual_per_update.append(len(problem.residuals) - n_res)
    c = launch_counts()
    calls = rec.calls
    res = np.asarray(problem.residuals, np.float64)
    groups = []
    for g, group in enumerate(problem.groups):
        mine = [call for call in calls if call["group"] == g]
        groups.append({
            "vehicles": type(group.template.vehicles[0]).__name__,
            "B": len(group.indices), "n_x": mine[0]["n_x"],
            "variant": mine[0]["variant"],
            "x_updates": len(mine),
            "k1_launches": sum(m["k1"] for m in mine),
            "k1_launches_per_x_update": [m["k1"] for m in mine],
            "x_update_ms_p50": float(np.median([m["ms"] for m in mine])),
            "x_update_ms_max": float(np.max([m["ms"] for m in mine])),
            "iterations": [m["iterations"] for m in mine],
            "ms_per_iteration": sum(m["ms"] for m in mine)
            / max(sum(m["iterations"] for m in mine), 1),
            "feas_max": max(m["feas"] for m in mine)})
    line = {"scene": scene, "problem": type(problem).__name__,
            "N": problem.N, "n_sh": problem.n_sh, "init_s": init_s,
            "updates": len(wall_ms), "dual_updates": len(res),
            "dual_updates_per_update": dual_per_update,
            "update_wall_ms_p50": float(np.median(wall_ms)),
            "update_wall_ms_max": float(np.max(wall_ms)),
            "update_wall_ms": wall_ms,
            "primal_residuals": res[:, 0].tolist(), "groups": groups,
            "x_update_device": sorted({m["device"] for m in calls}),
            "x_update_dtype": sorted({m["dtype"] for m in calls}),
            "launches": c}
    if scene == "generic_admm":
        S = np.stack([problem._s_of_vehicle(i) for i in range(problem.N)])
        n = problem.n_sh // 2
        off = 0.0
        for e in range(problem.n_edges):
            i, j = e, (e + 1) % problem.N
            r = problem.rel[problem.vehicles[i]] \
                - problem.rel[problem.vehicles[j]]
            off = max(off, float(np.max(np.abs(np.r_[
                S[i][:n] - S[j][:n] - r[0], S[i][n:] - S[j][n:] - r[1]]))))
        line["max_offset_error_m"] = off
    print("dist_loop " + json.dumps(line), flush=True)
    check(all(m["device"].startswith("cuda") and m["dtype"] ==
              "torch.float64" for m in calls),
          f"{scene}: x-updates ran on {line['x_update_device']} in "
          f"{line['x_update_dtype']}")
    check(c["psd_solve_multi"] == 0 and c["fused_inner"] == 0,
          f"{scene}: the loop launched {c}")
    check(all(m["k1"] > 0 for m in calls),
          f"{scene}: an x-update launched no K1")
    check(max(m["feas"] for m in calls) <= DIST_FEAS_GATE,
          f"{scene}: an x-update's feasibility "
          f"{max(m['feas'] for m in calls)} > {DIST_FEAS_GATE}")
    check(bool(np.isfinite(res[:, 0]).all()), f"{scene}: non-finite residual")
    if scene == "formation_holonomic_dualdec":
        k = problem.init_iter
        check(res[k - 1, 0] <= res[0, 0] + 1e-9,
              f"{scene}: the DD residual rose over initialize: "
              f"{res[:k, 0].tolist()}")
    else:
        check(res[-1, 0] < 0.5 * res[0, 0],
              f"{scene}: the residual did not halve: {res[0, 0]} -> "
              f"{res[-1, 0]}")
    if scene == "generic_admm":
        check(line["max_offset_error_m"] < GENERIC_OFFSET_GATE_M,
              f"{scene}: offsets held to {line['max_offset_error_m']} m")

    # each group's first (cold) x-update on the cut budget: card vs CPU
    line["checks"] = []
    for g, (X0, P) in sorted(rec.first.items()):
        tmpl = problem.groups[g].template
        tr = tmpl.transcription
        lb, ub = problem.groups[g].lb, problem.groups[g].ub

        def cut_solve(x0, p):
            cut = make_alm_solver(
                tr.objective, tr.constraints, tr.n_x, tr.lb, tr.ub,
                ALMOptions(**SCENE_CHECK_BUDGET),
                row_scale=tmpl._row_scale, obj_scale=tmpl._obj_scale,
                fg=tr.objective_and_constraints)
            return cut(x0, p, lb, ub).x.double().cpu().numpy()
        line["checks"].append(card_vs_cpu(
            "dist_check", cut_solve, X0, P, device, scene=scene, group=g))
    return line


def ipm_loop(T, device, scene=IPM_SCENE):
    """Phase 19 (b): examples/p2p_holonomic_solvertest.py's scene (or the
    same without its circle) with the interior-point backend, IPM_UPDATES
    closed-loop updates in float64 on the card (every solve recorded: its
    KKT error, iterations and whether it failed and retried; on a scene of
    IPM_CONVERGING none may fail), then the first solve on a cut budget
    (IPM_CHECK_BUDGET iterations) against the CPU's.  Returns the loop's
    line."""
    import torch
    from omg_tools_torch import Simulator
    from omg_tools_torch.ops.solver import IPOptions, make_ip_solver
    t0 = time.time()
    problem = build_distributed_scene(T, scene, {"device": device})
    problem.init()
    init_s = time.time() - t0
    vehicle = problem.vehicles[0]
    goal = np.asarray(vehicle.poseT, np.float64)[:2]
    tol = problem.options["solver_options"]["tol"]
    sim = Simulator(problem)
    wall_ms, kkt, iters, solver_calls = [], [], [], []
    zero_launch_counts()
    with recorded_solves() as calls:
        for _ in range(IPM_UPDATES):
            n_calls = len(calls)
            t1 = time.perf_counter()
            sim.update()
            torch.cuda.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t1))
            kkt.append(problem.solver_stats["kkt_err"])
            iters.append(problem.solver_stats["iterations"])
            solver_calls.append(len(calls) - n_calls)
    c = launch_counts()
    pose = np.asarray(vehicle.signals["pose"], np.float64)
    n_it = sum(int(st.n_iter.sum()) for *_, st in calls)
    x = calls[-1][-1].x
    line = {"scene": scene, "solver": "ipm",
            "n_x": problem.transcription.n_x,
            "n_g": problem.transcription.n_g, "init_s": init_s,
            "updates": len(wall_ms), "kkt_err": kkt, "iterations": iters,
            "solver_calls_per_update": solver_calls,
            "failed_updates": sum(k > 100 * tol for k in kkt),
            "kkt_gate": 100 * tol,
            "update_wall_ms_p50": float(np.median(wall_ms)),
            "update_wall_ms_max": float(np.max(wall_ms)),
            "ms_per_iteration": sum(wall_ms) / max(n_it, 1),
            "goal_distance_start": float(np.linalg.norm(pose[:2, 0] - goal)),
            "goal_distance_end": float(np.linalg.norm(pose[:2, -1] - goal)),
            "launches": c, "dtype": str(x.dtype), "device": str(x.device)}
    print("ipm_loop " + json.dumps(line), flush=True)
    check(x.is_cuda and x.dtype == torch.float64,
          f"ipm: solved on {x.device} in {x.dtype}")
    check(all(bool(torch.isfinite(st.x).all()) for *_, st in calls),
          "ipm: a non-finite iterate")
    check(bool(np.isfinite(pose).all()), "ipm: non-finite poses")
    check(c["psd_solve_multi"] == 0 and c["fused_inner"] == 0,
          f"ipm: the loop launched {c}")
    if scene in IPM_CONVERGING:
        check(line["failed_updates"] == 0,
              f"{scene}: KKT errors {kkt} above {100 * tol}")

    # the first solve on the cut budget: the card against the CPU
    solved0, x0, p, lb, ub = calls[0][:5]
    tr = solved0.transcription

    def cut_solve(x0_, p_):
        cut = make_ip_solver(
            tr.objective, tr.constraints, tr.n_x, tr.lb, tr.ub,
            IPOptions(max_iter=IPM_CHECK_BUDGET, tol=tol),
            row_scale=solved0._row_scale, obj_scale=solved0._obj_scale,
            fg=tr.objective_and_constraints)
        return cut(x0_, p_, lb, ub).x.double().cpu().numpy()
    line["check"] = card_vs_cpu("dist_check", cut_solve, x0[None], p[None],
                                device, noise=0.0, scene=scene)
    return line


def distributed_phase(T, device):
    """Phase 19: the ADMM-engine loops (``DIST_LOOPS``) and the IPM loop,
    and their gates, within DIST_PHASE_BUDGET_S.  Returns the lines."""
    t0 = time.time()
    loops = {scene: dist_loop(T, device, scene) for scene in DIST_LOOPS}
    for scene in IPM_SCENES:
        loops[scene] = ipm_loop(T, device, scene)
    seconds = time.time() - t0
    print("distributed_phase " + json.dumps({
        "seconds": seconds, "budget_s": DIST_PHASE_BUDGET_S,
        "updates": {s: loop["updates"] for s, loop in loops.items()}}),
        flush=True)
    check(seconds <= DIST_PHASE_BUDGET_S,
          f"phase 19 took {seconds} s > {DIST_PHASE_BUDGET_S} s")
    return loops


def dist_records(device, loops):
    """The kernels-line records of K1 float64 at each x-update shape of
    phase 19 (B systems of n_x rows), with the launches of its loop
    (phase 15)."""
    records = []
    for scene, loop in loops.items():
        for g, group in enumerate(loop.get("groups", ())):
            rec = k1_f64_record(
                device, group["k1_launches"],
                group["k1_launches_per_x_update"],
                name=f"{K1_DIST_NAME}, {scene} ({group['vehicles']})",
                shape=(group["B"], group["n_x"], 1), tag=f"{scene}_{g}")
            rec["launches_per_x_update"] = rec.pop("launches_per_update")
            records.append(("psd_solve", rec))
    return records


class StructuresReference(ReferenceProcess):
    """Phase 20's CPU side (``--structures-reference``): the exact Dubins'
    cold setup (its host tensors into the run's cache, where phase 20 then
    finds them), and the float64 CPU runner's cut-budget cold solve of
    STRUCT_CHECK_LANES scenarios with its own sensitivity to a 1e-15
    perturbation of the start."""

    def __init__(self, workdir):
        self.out = os.path.join(workdir, "structures_reference.npz")
        super().__init__("--structures-reference", self.out,
                         STRUCT_REFERENCE_TIMEOUT_S, "structures reference")

    def result(self):
        """(the process's JSON line, its arrays, the seconds waited)."""
        line, waited_s = self.wait()
        return line, dict(np.load(self.out)), waited_s


def structures_check_batch(runner):
    """The cut-budget check's inputs: the first STRUCT_CHECK_LANES of
    phase 20's scenarios, make_batch's start plus a seeded 1e-2."""
    import torch
    starts, goals = scenarios(STRUCT_BATCH, "p2p_dubins")
    x0, p0, _ = runner.make_batch(starts[:STRUCT_CHECK_LANES],
                                  goals[:STRUCT_CHECK_LANES])
    noise = np.random.default_rng(0).standard_normal(tuple(x0.shape))
    return x0 + STRUCT_CHECK_NOISE * torch.as_tensor(noise, dtype=x0.dtype,
                                                     device=x0.device), p0


def structures_reference(out):
    """``--structures-reference OUT``: the process of
    ``StructuresReference``: the cold setup of the exact Dubins' float64
    CPU runner (problem and runner, nothing from the cache), then its
    cut-budget cold solve and the same from the start moved by 1e-15
    (relative); writes the planned states to OUT, prints its seconds."""
    sys.path.insert(0, HERE)
    import torch
    import omg_tools_torch as T
    from omg_tools_torch.utils import cache
    torch.set_num_threads(1)
    t0 = time.time()
    problem = build_structures_problem(T, {"device": "cpu"})
    hit = cache.load_tensors(problem.transcription.fingerprint,
                             "quadQ") is not None
    runner = T.BatchedP2PRunner(
        problem, dtype=torch.float64, device="cpu",
        alm_options=T.ALMOptions(**STRUCT_CHECK_BUDGET))
    setup_s = time.time() - t0
    x0, p0 = structures_check_batch(runner)
    t1 = time.time()
    st = runner.init_solver_state(x0, p0)
    solve_s = time.time() - t1
    gen = torch.Generator().manual_seed(0)
    moved = x0 * (1 + F64_PERTURB * torch.randn(x0.shape, generator=gen,
                                                dtype=x0.dtype))
    st_p = runner.init_solver_state(moved, p0)
    np.savez(out, x0=x0.numpy(), p0=p0.numpy(),
             planned=planned_state(runner, st.x, p0).numpy(),
             planned_moved=planned_state(runner, st_p.x, p0).numpy(),
             feas=st.feas.numpy())
    print(json.dumps({"setup_cold_s": setup_s, "cache_hit": hit,
                      "structure": runner.structure,
                      "structure_reason": runner.structure_reason,
                      "n_x": runner.n_x, "n_g": runner.tr.n_g,
                      "solve_s": solve_s, "threads": 1}), flush=True)


def generic_phase(T, device, reference):
    """Phase 20 (a): bench.py's generic branch on the exact Dubins (see
    STRUCT_ROLLOUT), its setup from the cache the reference's process
    filled, one counted and timed 20-step rollout (CUDA events at the step
    boundaries, the captures after every step), and the cut-budget check
    of the card's float32 and float64 cold solves against the CPU's."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    from omg_tools_torch.ops.alm import CapturedCall
    from omg_tools_torch.utils import cache
    ref, ref_arrays, waited_s = reference.result()
    t0 = time.time()
    problem = build_structures_problem(T)
    hit = cache.load_tensors(problem.transcription.fingerprint,
                             "quadQ") is not None
    runner = T.BatchedP2PRunner(
        problem, dtype=torch.float32, device=device,
        alm_options=T.ALMOptions(inner_iter=STRUCT_INNER))
    starts, goals = scenarios(STRUCT_BATCH, "p2p_dubins")
    x0, p0, state = runner.make_batch(starts, goals)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    check(not ref["cache_hit"], "the exact Dubins' cold setup found its "
          "host tensors in the cache")
    check(hit, "phase 20's setup did not find the exact Dubins' host "
          "tensors (no Q) in the cache")
    check(runner.structure == "generic",
          f"exact Dubins float32: structure {runner.structure} "
          f"({runner.structure_reason}), not generic")
    n_x, n_g = runner.n_x, runner.tr.n_g
    roll = runner.rollout_fn(STRUCT_STEPS, **STRUCT_ROLLOUT)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    c0 = CapturedCall.captures
    t1 = time.time()
    st = runner.init_solver_state(x0, p0)
    torch.cuda.synchronize()
    init_s = time.time() - t1
    init_launches = launch_counts()
    init_captures = CapturedCall.captures - c0
    # the counted and timed run
    zero_launch_counts()
    c1 = CapturedCall.captures
    events, captures = [_recorded_event()], []

    def on_step(k):
        events.append(_recorded_event())
        captures.append(CapturedCall.captures - c1)
    t2 = time.time()
    carry, states = roll(st, p0, state, on_step=on_step)
    torch.cuda.synchronize()
    rollout_s = time.time() - t2
    launches = launch_counts()
    by_systems = k1_launches_by_systems()
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    states_np = states.double().cpu().numpy()
    feas_raw = carry[0].feas_raw.double().cpu().numpy()
    d0 = np.linalg.norm(starts - goals, axis=1)
    d1 = np.linalg.norm(states_np[:, -1] - goals, axis=1)
    spk = runner.steps_per_knot
    # a capture is due at the first step of each budget class (and its
    # rescue): the easy budget's at k = 0, the hard one's at the first
    # knot passage; none after
    first = {0, spk} if STRUCT_STEPS > spk else {0}
    late = [k for k in range(1, STRUCT_STEPS) if k not in first
            and captures[k] != captures[k - 1]]
    out = {"config": "p2p_dubins_exact", "structure": runner.structure,
           "structure_reason": runner.structure_reason,
           "n_x": n_x, "n_g": n_g, "batch": STRUCT_BATCH,
           "n_steps": STRUCT_STEPS, "rollout": STRUCT_ROLLOUT,
           "inner_iter": STRUCT_INNER,
           "setup_cold_s": ref["setup_cold_s"],
           "setup_cold_threads": ref["threads"],
           "setup_cold_cache_hit": ref["cache_hit"],
           "setup_s": setup_s, "setup_cache_hit": hit,
           "reference_waited_s": waited_s,
           "cold_solve_s": init_s, "rollout_s": rollout_s,
           "solves_per_s": STRUCT_BATCH * STRUCT_STEPS / rollout_s,
           "p50_step_latency_ms": float(np.median(step_ms)),
           "max_step_latency_ms": float(np.max(step_ms)),
           "step_ms": step_ms,
           "feas_raw_p99": float(np.percentile(feas_raw, 99)),
           "feas_raw_max": float(np.max(feas_raw)),
           "diverged_lanes": int(np.sum(feas_raw > 1e-2)),
           "nan_lanes": int(np.sum(~np.isfinite(feas_raw)
                                   | ~np.isfinite(states_np).all((1, 2)))),
           "mean_progress_frac": float(np.mean((d0 - d1) / d0)),
           "k1_launches": launches["psd_solve"],
           "k1_launches_per_step": launches["psd_solve"] / STRUCT_STEPS,
           "k1_launches_by_systems": by_systems,
           "k1_variant": pk.variant(n_x, 1, torch.float32),
           "init_launches": init_launches, "rollout_launches": launches,
           "captures_cold_solve": init_captures,
           "captures_after_step": captures, "late_captures": late,
           "captures_total": CapturedCall.captures - c0,
           "dense_J_bytes": STRUCT_BATCH * n_g * n_x * 4,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    print("generic " + json.dumps(out), flush=True)
    check(launches["psd_solve"] > 0, "K1 never launched on the generic path")
    check(sum(by_systems.values()) == launches["psd_solve"],
          f"K1's launches by width {by_systems} do not sum to "
          f"{launches['psd_solve']}")
    check(launches["psd_solve_multi"] == 0 and launches["fused_inner"] == 0,
          f"the generic path launched {launches}")
    check(out["nan_lanes"] == 0, f"{out['nan_lanes']} non-finite lanes")
    check(out["mean_progress_frac"] > 0.0, "no progress toward the goals")
    check(not late, f"CUDA graphs captured after steps {late}")
    check(out["k1_variant"] == "block", f"K1 at {STRUCT_BATCH} x {n_x} "
          f"takes {out['k1_variant']}")

    # the cut-budget check: the card's float32 and float64 cold solves of
    # the reference's inputs against its float64 CPU solve
    want = ref_arrays["planned"]
    err_self = np.abs(ref_arrays["planned_moved"] - want).max(1)
    lines = {}
    for dtype in (torch.float32, torch.float64):
        cut = T.BatchedP2PRunner(problem, dtype=dtype, device=device,
                                 alm_options=T.ALMOptions(
                                     **STRUCT_CHECK_BUDGET))
        xc = torch.as_tensor(ref_arrays["x0"], dtype=dtype, device=device)
        pc = torch.as_tensor(ref_arrays["p0"], dtype=dtype, device=device)
        zero_launch_counts()
        stc = cut.init_solver_state(xc, pc)
        got = planned_state(cut, stc.x, pc).double().cpu().numpy()
        err = np.abs(got - want).max(1)
        lines[str(dtype).split(".")[-1]] = {
            "max_err_m": float(err.max()), "p50_err_m": float(np.median(err)),
            "feas_max": float(stc.feas.max()), "launches": launch_counts()}
    check_out = {"lanes": STRUCT_CHECK_LANES, "budget": STRUCT_CHECK_BUDGET,
                 "start_noise": STRUCT_CHECK_NOISE, **lines,
                 "cpu_solve_s": ref["solve_s"],
                 "cpu_feas_max": float(ref_arrays["feas"].max()),
                 "cpu_f64_perturbed": {"relative": F64_PERTURB,
                                       "max_err_m": float(err_self.max()),
                                       "p50_err_m": float(
                                           np.median(err_self))}}
    print("generic_check " + json.dumps(check_out), flush=True)
    for tag, line in lines.items():
        check(line["max_err_m"] < PARITY_GATE_M,
              f"generic {tag} card vs CPU planned states differ by "
              f"{line['max_err_m']} m")
        check(line["launches"]["psd_solve"] > 0,
              f"generic {tag} check: K1 never launched")
    return out


def dense_phase(T, device, main):
    """Phase 20 (b): the bench scene's float32 runner, built again from
    the cache, forced onto ``quadratic`` (no compaction) and then
    ``compact`` (no arrow); CA_STEPS steps each at the bench settings
    from phase 7's cold solve (its multipliers put back into the
    transcription's row order for ``quadratic``), counted and timed.
    Every lane's planned states within 2 cm of phase 10's compact-arrow
    states at every step, or within DENSE_SPREAD_FACTOR x the lane's own
    move in compact-arrow's rollout from a rounding-sized move of the cold
    solve (see DENSE_SPREAD_DRAWS).  K1 at the 151-row block variant, no K2
    or K3.  B = BATCH when the dense J (B x n_g x n_x x 4 bytes) fits in
    half the card's memory, else the largest power of two that does."""
    import torch
    from omg_tools_torch.ops import psd_kernels as pk
    runner, _, _, _, _, p0, state, setup_s, hit = setup_phase(T, device)
    check(hit, "phase 20 (b): the bench runner did not come from the cache")
    st, ca_states = main["st"], main["ca_states"]
    n_x, n_g = runner.n_x, runner.tr.n_g
    total = torch.cuda.get_device_properties(device).total_memory
    B = BATCH
    while B > 1 and B * n_g * n_x * 4 > total / 2:
        B //= 2
    cut = {"dense_J_bytes": B * n_g * n_x * 4, "half_card_bytes": total / 2,
           "batch": B, "cut_from": BATCH if B < BATCH else None}
    st = type(st)(*[a[:B] for a in st])
    p0, state, ca_states = p0[:B], state[:B], ca_states[:B]
    # each lane's own move under rounding-sized moves of the cold solve
    runner.fused_plan = None
    check(runner.structure == "compact-arrow",
          f"structure {runner.structure} without a fused plan")
    roll = runner.rollout_fn(CA_STEPS, **ROLLOUT)
    gen = torch.Generator(device).manual_seed(0)
    spread = torch.zeros(B, dtype=torch.float64, device=device)
    for _ in range(DENSE_SPREAD_DRAWS):
        x = st.x * (1 + F32_PERTURB * torch.randn(
            st.x.shape, generator=gen, device=device, dtype=st.x.dtype))
        _, moved = roll(st._replace(x=x), p0, state, runner.consts())
        spread = torch.maximum(spread, (moved.double() - ca_states.double())
                               .abs().amax((1, 2)))
    compact = runner.compact
    perm = torch.as_tensor(compact.row_perm, device=device)
    out = {"setup_s": setup_s, "cache_hit": hit, "n_x": n_x, "n_g": n_g,
           "spread_draws": DENSE_SPREAD_DRAWS,
           "spread_relative": F32_PERTURB,
           "spread_max_m": float(spread.max()),
           "spread_p99_m": float(torch.quantile(spread, 0.99)), **cut}
    print("dense_setup " + json.dumps(out), flush=True)
    for structure in DENSE_STRUCTURES:
        if structure == "quadratic":
            runner.compact = None
            lam = torch.empty_like(st.lam)
            lam[:, perm] = st.lam
            st_s = st._replace(lam=lam)
        else:
            runner.compact = compact
            compact.arrow = None
            st_s = st
        runner.solver = runner.make_solver(runner._alm_options)
        check(runner.structure == structure,
              f"forced {structure}, got {runner.structure}")
        consts = runner.consts()
        roll = runner.rollout_fn(CA_STEPS, **ROLLOUT)
        zero_launch_counts()
        carry, states = roll(st_s, p0, state, consts)
        torch.cuda.synchronize()
        launches = launch_counts()
        by_systems = k1_launches_by_systems()
        carry, states, run_s, _, step_ms = timed_rollouts(
            roll, st_s, p0, state, consts, timed_runs=1)
        lane_err = (states.double() - ca_states.double()).abs().amax(2)
        lane_max = lane_err.amax(1)
        over = lane_max > 0.01
        unexplained = (lane_max >= PARITY_GATE_M) & (
            lane_max > DENSE_SPREAD_FACTOR * spread)
        out[structure] = {
            "structure": runner.structure, "rollout_s": run_s,
            "step_ms": step_ms,
            "p50_step_latency_ms": float(np.median(step_ms)),
            "max_err_m_by_step": lane_err.amax(0).cpu().tolist(),
            "p99_err_m_by_step": torch.quantile(
                lane_err, 0.99, dim=0).cpu().tolist(),
            "lanes_over_1cm": {"err_m": lane_max[over].cpu().tolist(),
                               "own_spread_m": spread[over].cpu().tolist()},
            "feas_p99": float(np.percentile(
                carry[0].feas.double().cpu().numpy(), 99)),
            "launches": launches, "k1_launches_by_systems": by_systems,
            "k1_variant": pk.variant(n_x, 1, torch.float32)}
        print(f"dense_{structure} " + json.dumps(out[structure]), flush=True)
        check(bool(torch.isfinite(states).all()),
              f"{structure}: non-finite states")
        check(not bool(unexplained.any()),
              f"{structure}: lanes {lane_max[unexplained].tolist()} m "
              "from compact-arrow's, beyond their own spread")
        check(launches["psd_solve"] > 0
              and launches["psd_solve_multi"] == 0
              and launches["fused_inner"] == 0,
              f"{structure} launched {launches}")
        check(out[structure]["k1_variant"] == "block",
              f"K1 at {n_x} rows takes {out[structure]['k1_variant']}")
    return out


def export_phase(T, device, workdir):
    """Phase 20 (c): ExportP2P of the bench scene from a float64 runner on
    the card and from the same runner on the CPU; the two directories must
    be identical byte for byte.  Then, where the machine has g++ and make,
    the harness built and run (``make``, ``./test .``: PASSED)."""
    import filecmp
    import torch
    problem = build_problem(T)
    cpu = T.BatchedP2PRunner(problem, dtype=torch.float64, device="cpu")
    card = cpu.to(device)
    dirs = {}
    t0 = time.time()
    for tag, runner in (("card", card), ("cpu", cpu)):
        dirs[tag] = T.ExportP2P(problem, {"directory": os.path.join(
            workdir, "export_" + tag)}).run(runner)
    export_s = time.time() - t0
    names = sorted(os.path.relpath(os.path.join(d, f), dirs["cpu"])
                   for d, _, files in os.walk(dirs["cpu"]) for f in files)
    other = sorted(os.path.relpath(os.path.join(d, f), dirs["card"])
                   for d, _, files in os.walk(dirs["card"]) for f in files)
    _, mismatch, errors = filecmp.cmpfiles(dirs["cpu"], dirs["card"], names,
                                           shallow=False)
    tools = {t: shutil.which(t) for t in ("g++", "make")}
    out = {"files": len(names), "same_names": names == other,
           "mismatch": mismatch, "errors": errors, "export_s": export_s,
           "found": tools}
    if all(tools.values()):
        subprocess.run(["make"], cwd=dirs["card"], check=True,
                       capture_output=True, timeout=300)
        res = subprocess.run(["./test", "."], cwd=dirs["card"],
                             capture_output=True, text=True, timeout=300)
        out["harness"] = {"returncode": res.returncode,
                          "passed": "PASSED" in res.stdout,
                          "tail": res.stdout.strip().splitlines()[-2:]}
    else:
        out["harness"] = ("g++ or make missing on the card's machine: the "
                          "build and run is left to the CPU tests "
                          "(tests/test_torch_export.py)")
    print("export " + json.dumps(out), flush=True)
    check(out["same_names"] and not mismatch and not errors,
          f"card and CPU exports differ: {mismatch} {errors}")
    if all(tools.values()):
        check(out["harness"]["returncode"] == 0 and out["harness"]["passed"],
              f"the exported harness failed: {out['harness']}")
    return out


def structures_phase(T, device, reference, main, workdir):
    """Phase 20: (a) ``generic_phase``, (b) ``dense_phase``, (c)
    ``export_phase``, within STRUCT_PHASE_BUDGET_S (the exact Dubins'
    cold setup runs in the reference's process and is printed apart).
    Returns (a)'s and (b)'s lines."""
    os.environ["OMG_CACHE_DIR"] = main["cache_root"]
    t0 = time.time()
    generic = generic_phase(T, device, reference)
    dense = dense_phase(T, device, main)
    export_phase(T, device, workdir)
    seconds = time.time() - t0
    # the wait for the reference's process is its cold setup and CPU
    # solves still running (with ``--structures-only`` it starts with the
    # phase); the budget holds the phase's own work
    own_s = seconds - generic["reference_waited_s"]
    print("structures_phase " + json.dumps({
        "seconds": seconds, "seconds_without_reference_wait": own_s,
        "budget_s": STRUCT_PHASE_BUDGET_S,
        "setup_cold_s": generic["setup_cold_s"]}), flush=True)
    check(own_s <= STRUCT_PHASE_BUDGET_S,
          f"phase 20 took {own_s} s > {STRUCT_PHASE_BUDGET_S} s")
    return generic, dense


def structures_records(device, generic, dense):
    """Phase 15's records of K1 at phase 20's shapes (float32), each with
    the launches at its own number of systems in the runs that take it:
    (a)'s rollout and (b)'s quadratic and compact rollouts at the bench
    settings."""
    by_systems = {"generic": [generic["k1_launches_by_systems"]],
                  "quadratic_compact": [dense[s]["k1_launches_by_systems"]
                                        for s in DENSE_STRUCTURES]}
    records = []
    for tag, (N, n, r) in K1_STRUCT_SHAPES:
        line = kernel_phase_f64(K1_STRUCT_NAME, "psd_solve", N, n, r,
                                device, timed=True, shape=tag,
                                dtype="float32")
        check(line["variant"] == "block",
              f"K1 {tag}: {N} x {n} takes {line['variant']}, not block")
        counts = by_systems[tag.removesuffix("_rescue")]
        records.append(("psd_solve", {
            "name": f"{K1_STRUCT_NAME}, {tag}", "route": "cuda",
            "source": SOURCE, "replaces": KERNELS[0][2],
            "launches": sum(c.get(str(N), 0) for c in counts),
            "max_abs_err": line["max_abs_err"], "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": line["library_ms"],
            "call_ms": line["call_ms"], "variant": line["variant"],
            "shape": [N, n, r], "dtype": "float32"}))
    return records


def moving_obstacle_states(B, seed=0):
    """(pos, vel, acc) of bench.py's three obstacles for B scenarios:
    both rectangles fixed at their bench positions, the 0.4 m circle from
    its bench position at a speed uniform in 0-OBSTACLE_SPEED_MAX m/s in a
    uniform direction (numpy seed 0)."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(0.0, OBSTACLE_SPEED_MAX, B)
    heading = rng.uniform(0.0, 2 * np.pi, B)
    zero = np.zeros((B, 2))
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading)], 1)
    return [(np.tile(pos, (B, 1)), v, zero)
            for pos, v in (([-2.1, -0.5], zero), ([1.7, -0.5], zero),
                           ([1.5, 0.5], vel))]


def obstacle_phase(T, device, cache_root):
    """Phase 16 (b) and (c): the B = 4096 float32 rollouts (20 steps; the
    obstraj scene's OBSTRAJ_STEPS) at the
    bench settings (a) of bench.py's scene with the circle moving at a
    per-scenario velocity (``make_batch(obstacle_states=)``; the fused
    structure: K3, not K1 or K2) and (b) of the obstraj example's scene
    (a spline-trajectory circle; the structure K3's limits allow), one
    counted and one timed run each, and the cross-check of phase 11 on
    CONFIG_CROSS_LANES lanes.  Returns the structures' launches."""
    import torch
    os.environ["OMG_CACHE_DIR"] = cache_root
    out = {}
    runner, consts, starts, goals, *_, setup_s, hit = setup_phase(T, device)
    states = moving_obstacle_states(starts.shape[0])
    x0, p0, state = runner.make_batch(starts, goals, states)
    st, launches, _ = main_path_phase(
        runner, consts, starts, goals, x0, p0, state, setup_s,
        timed_runs=1, config="p2p_holonomic_moving_circle", feas_gate=False)
    out["moving_circle"] = launches
    cross_check_phase(T, runner, st, starts, goals, p0,
                      lanes=CONFIG_CROSS_LANES, obstacle_states=states)
    t0 = time.time()
    runner = T.BatchedP2PRunner(
        build_problem(T, "obstraj"), dtype=torch.float32, device=device,
        alm_options=T.ALMOptions(inner_iter=INNER_ITER, rho_init=10.0))
    x0, p0, state = runner.make_batch(starts, goals)
    consts = runner.consts()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print("setup_obstraj " + json.dumps({
        "setup_s": setup_s, "structure": runner.structure,
        "structure_reason": runner.structure_reason, "n_x": runner.n_x,
        "n_p": runner.n_p}), flush=True)
    st, launches, _ = main_path_phase(
        runner, consts, starts, goals, x0, p0, state, setup_s,
        n_steps=OBSTRAJ_STEPS, timed_runs=1, config="obstraj",
        feas_gate=False)
    out["obstraj"] = launches
    cross_check_phase(T, runner, st, starts, goals, p0, config="obstraj",
                      lanes=CONFIG_CROSS_LANES)
    return out


def k3_work(plan, B, n_inner, n_cands, phase=0):
    """(flops, bytes) that K3's function needs for B lanes, n_inner
    iterations and one phase of this plan.  The products with the plan's
    tables (C1, A, TA, Q, P: this run's data) count at the tables'
    non-zeros; Q x and Q dx once per quad family; the
    Gauss-Newton products at the non-zeros of J's rows and, being
    symmetric, at their lower triangle.  The assembled tail blocks, panels
    and head are factored and solved as dense triangles (their own
    sparsity is not credited), every row counts as active, and the line
    search's merit terms count per row and candidate.  Bytes: the lane
    state read and written once and one phase of tables (with lb, ub) read
    once."""
    h = plan.head[1]
    once = np.count_nonzero(plan.C1[phase])        # c = c0 + C1 pv
    per_it = 0.0
    for f in plan.fams:
        m_f = f.row_stop - f.row_start
        n_f = sum(z for _, z in f.runs)
        pat = plan.uA[f.iA][phase] != 0            # J's non-zeros
        if f.iTA >= 0:
            TA = plan.uTA[f.iTA][phase]
            once += np.count_nonzero(TA)           # A = A0 + TA pq
            pat = pat | (TA != 0).any(-1)
        if f.iQ >= 0:
            Q = plan.uQ[f.iQ].reshape(m_f, n_f, n_f) != 0
            pat = pat | Q.any(-1)
            # Q x, Q dx; J = A + 2 Q x, x'Q dx and dx'Q dx per entry
            per_it += 2 * Q.sum() + 3 * pat.sum()
        per_it += 3 * pat.sum()                    # g, J'y, J dx
        if f.iP >= 0:                              # H = P d, lower triangle
            P = plan.uP[f.iP][phase].reshape(n_f, n_f, m_f) != 0
            per_it += np.tril(P.transpose(2, 0, 1)).sum()
        else:                                      # H = J' diag(d) J
            k = pat.sum(1)
            per_it += (k * (k + 1) // 2 + k).sum()
    for (_, sz) in plan.blocks:
        # Cholesky, L^-1 [C' | r_b], Schur Y'Y (lower) + Y'r_b,
        # back-substitution
        per_it += sz ** 3 / 6 + sz * sz / 2 * (h + 1) \
            + sz * (h * (h + 1) / 2 + h) + sz * h + sz * sz / 2
    per_it += h ** 3 / 6 + h * h                   # head factor and solves
    flops = 2.0 * B * (float(once) + n_inner * float(per_it)) \
        + 6.0 * B * n_inner * plan.m * (n_cands + 1)
    lane = 2 * plan.n_x + 2 * plan.m + plan.n_v + 2
    nbytes = 4 * (B * lane + plan.phase_len + 2 * plan.m)
    return flops, nbytes


def _merit(x, gv, a, lb, ub, gf):
    """The inner loop's merit in float64 at (x, g(x) = gv): gf'x plus the
    penalty of the multipliers and rho of ``a`` (the constant f0 left out)."""
    import torch
    rho = a["rho"].double()
    rr = gv.double() + a["lam"].double() / rho[:, None]
    viol = rr - torch.clamp(rr, lb.double(), ub.double())
    return x.double() @ gf + 0.5 * rho * (viol * viol).sum(-1)


def k3_kernel_phase(runner, consts, x0, p0, shapes=K3_SHAPES,
                    name=K3_NAME, start_noise=0.0, well_quantile=None):
    """Phase 6: K3 against its plain version at the main and rescue shapes
    on the main path's cold-solve inputs; returns the kernels-line record
    (main shape).  Three checks per shape:

    - well-conditioned (ridge K3_WELL_RIDGE of the largest diagonal, the
      bench's other options): the kernel against the plain float32
      version, its step x - x0 within K3_TOL_DX of the largest step, g
      within K3_TOL_GV of the largest |g|, the gradient norm within
      K3_TOL_STAT of each lane's;
    - the bench options, whose ridge (1e-6) leaves directions that float32
      cannot resolve, so that float32 runs leave the float64 trajectory:
      the merit the kernel reaches, at p99 over lanes, within
      K3_MERIT_GATE of the float64 run's decrease from the start;
    - the same runs: p99 over lanes of max |x - x_f64|, the kernel's within
      10x the plain float32 version's (floor 1e-6 max |x|), and the kernel
      finite wherever the plain float32 version is.

    ``start_noise``: the checks start from x0 plus that much seeded
    normal noise (Dubins: make_batch's start puts rows exactly on their
    bounds, where float32 cannot resolve which rows are active; the
    kernel against the plain version and the plain float32 version
    against float64 at that start are printed beside, ungated).
    ``well_quantile``: the first check gates that quantile over lanes of
    the step and gradient-norm errors, not their max, and holds the
    kernel's g to g at the kernel's own x, taken in float64 by the plain
    version, at every lane (Dubins: on a few lanes in a thousand an
    activity switch during the iterations is a tie within float32
    rounding, so that the plain float32 version leaves the float64 one,
    in its step and even more in g, as far as the kernel leaves it)."""
    import torch
    from omg_tools_torch.ops import fused_alm as fa
    plan = runner.fused_plan
    opt = runner.solver.options
    well = opt._replace(gn_delta_rel=K3_WELL_RIDGE)
    dev = x0.device
    lb, ub = runner.solver.scale_bounds(runner.lb, runner.ub, torch.float32,
                                        dev)
    pv_all = p0[:, torch.as_tensor(plan.pcols, device=dev)].contiguous()
    fs = fa.FusedPlan.slice_phase(consts.FS, 0)
    fs64 = dict(fs, tables=fs["tables"].double())
    gf = plan.tables(fs64["tables"])["gf"]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # the compressed tables the kernel reads (one phase) and its lane layout
    layout = {"desc_words": int(fs["desc_host"].size),
              "values_per_phase": plan.values_len, "j_positions": plan.n_j,
              "arrow_floats": plan.arrow_len,
              "lane_bytes": 4 * plan.lane_floats(), "sms": n_sm}
    degenerate = {}
    if start_noise:
        rng = np.random.default_rng(5)
        x_given = x0
        x0 = x0 + start_noise * torch.as_tensor(
            rng.standard_normal(tuple(x0.shape)), dtype=x0.dtype,
            device=dev)
    rec, timers = None, {}
    for tag, B, n_inner in shapes:
        B = min(B, x0.shape[0])
        lanes = fa.lanes_per_block(B, n_sm, plan.smem_bytes)
        smem = plan.smem_bytes(lanes)
        check(fa.kernel_smem_bytes(fs["desc_host"], lanes) == smem,
              f"{name} {tag}: the CUDA side lays out "
              f"{fa.kernel_smem_bytes(fs['desc_host'], lanes)} shared bytes "
              f"for {lanes} lanes, FusedPlan {smem}")
        a = {"x": x0[:B].contiguous(), "pv": pv_all[:B].contiguous(),
             "lam": torch.zeros((B, plan.m), device=dev),
             "rho": torch.full((B,), opt.rho_init, device=dev),
             "lb": lb, "ub": ub}
        a64 = {k: v.double() for k, v in a.items()}

        def run(fn, o, n=n_inner, a=a, fs=fs):
            return fn(plan, fs, a["x"], a["lam"], a["rho"], a["pv"], a["lb"],
                      a["ub"], o, n)

        def kern(run=run):      # bound now: timed after the loop
            return run(fa.fused_inner, opt)

        def plain():
            return run(fa.fused_inner_plain, opt)

        def pct(e, q):
            return float(torch.quantile(e.double(), q))

        # well-conditioned: the kernel against the plain float32 version
        kw, pw = run(fa.fused_inner, well), run(fa.fused_inner_plain, well)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in kw + pw),
              f"{name} {tag}: non-finite output, well-conditioned")
        # per lane, over the largest step and |g|, and each lane's own
        # gradient norm; gated at their max over lanes, or at the
        # ``well_quantile`` quantile
        per_lane = {
            "step": (kw[0] - pw[0]).abs().amax(-1)
            / (pw[0] - a["x"]).abs().max(),
            "g": (kw[1] - pw[1]).abs().amax(-1) / pw[1].abs().max(),
            "stat": (kw[2] - pw[2]).abs() / pw[2].abs()}
        e_dx, e_gv, e_stat = (
            float(e.max()) if well_quantile is None
            else pct(e, well_quantile) for e in per_lane.values())
        if well_quantile is not None:
            # g: the kernel's against g at the kernel's own x in float64,
            # at every lane
            g_own = run(fa.fused_inner_plain,
                        opt._replace(ls_candidates=(0.0,)), n=1,
                        a={k: v.double() for k, v in
                           dict(a, x=kw[0]).items()}, fs=fs64)[1]
            e_gv = float((kw[1].double() - g_own).abs().max()
                         / g_own.abs().max())
        well_line = {"step": e_dx, "g": e_gv, "stat": e_stat,
                     "quantile": well_quantile,
                     "max": {k: float(e.max()) for k, e in per_lane.items()},
                     "max_abs_err_x": float((kw[0] - pw[0]).abs().max())}
        if start_noise:
            def rel(u, v, x):
                return {"step": float((u[0].double() - v[0].double()).abs()
                                      .max() / (v[0].double() - x.double())
                                      .abs().max()),
                        "g": float((u[1].double() - v[1].double()).abs()
                                   .max() / v[1].double().abs().max())}
            xg = x_given[:B].contiguous()
            kg = run(fa.fused_inner, well, a=dict(a, x=xg))
            pg = run(fa.fused_inner_plain, well, a=dict(a, x=xg))
            p64g = run(fa.fused_inner_plain, well,
                       a={k: v.double() for k, v in dict(a, x=xg).items()},
                       fs=fs64)
            degenerate[tag] = {"kernel_vs_plain_f32": rel(kg, pg, xg),
                               "plain_f32_vs_f64": rel(pg, p64g, xg)}
        check(e_dx <= K3_TOL_DX and e_gv <= K3_TOL_GV
              and e_stat <= K3_TOL_STAT,
              f"{name} {tag}: kernel vs plain float32, well-conditioned, "
              f"{well_line} exceeds ({K3_TOL_DX}, {K3_TOL_GV}, "
              f"{K3_TOL_STAT})")

        # the bench options: merit and x against a float64 run
        got, p32 = kern(), plain()
        p64 = run(fa.fused_inner_plain, opt, a=a64, fs=fs64)
        g_in = run(fa.fused_inner_plain, opt._replace(ls_candidates=(0.0,)),
                   n=1, a=a64, fs=fs64)[1]
        torch.cuda.synchronize()
        ref = p64[0]
        finite = torch.isfinite(p32[0]).all(-1)
        check(bool(torch.isfinite(got[0][finite]).all()),
              f"{name} {tag}: non-finite where the plain version is finite")
        m64 = _merit(ref, p64[1], a64, lb, ub, gf)
        decrease = _merit(a64["x"], g_in, a64, lb, ub, gf) - m64

        def merit_err(out):
            m = _merit(out[0], out[1], a64, lb, ub, gf)
            return ((m - m64).abs() / decrease.abs())[finite]
        mer_k, mer_p = merit_err(got), merit_err(p32)
        check(pct(mer_k, 0.99) <= K3_MERIT_GATE,
              f"{name} {tag}: p99 merit error {pct(mer_k, 0.99)} of the "
              f"float64 decrease > {K3_MERIT_GATE}")
        err_k = (got[0].double() - ref).abs().amax(-1)[finite]
        err_p = (p32[0].double() - ref).abs().amax(-1)[finite]
        floor = K3_GATE_FLOOR * float(ref.abs().max())
        gate = K3_GATE_FACTOR * max(pct(err_p, 0.99), floor)
        check(pct(err_k, 0.99) <= gate,
              f"{name} {tag}: p99 error vs float64 {pct(err_k, 0.99)} > "
              f"{gate}")

        timers[tag] = kern
        call_ms = time_ms(kern, reps=5, warmup=0)
        # where a block's time goes: the clock cycles of each phase of an
        # iteration, summed over blocks (one more launch, whose outputs
        # must equal the unprofiled launch's bit for bit)
        clocks = torch.zeros(len(fa.PHASES), dtype=torch.int64, device=dev)
        prof = fa.fused_inner(plan, fs, a["x"], a["lam"], a["rho"], a["pv"],
                              a["lb"], a["ub"], opt, n_inner, clocks=clocks)
        check(all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                  for u, v in zip(prof, got)),
              f"{name} {tag}: the clock profile changed the outputs")
        cyc = clocks.double().cpu().numpy()
        phases = {"cycles_per_block_iteration":
                  float(cyc.sum()) / (-(-B // lanes) * n_inner),
                  "share": {name: float(c / cyc.sum())
                            for name, c in zip(fa.PHASES, cyc)}}
        plain_ms = time_ms(plain, reps=3, warmup=1)
        flops, nbytes = k3_work(plan, B, n_inner, len(opt.ls_candidates))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        line = {"name": name, "shape": tag, "B": B, "n_inner": n_inner,
                "lanes_per_block": lanes, "blocks": -(-B // lanes),
                "phases": phases,
                "smem_bytes_per_block": smem, "layout": layout,
                "start_noise": start_noise,
                "at_make_batch_start": degenerate.get(tag),
                "finite_lanes": int(finite.sum()),
                "well_conditioned_vs_plain_f32": well_line,
                "merit_err_of_f64_decrease": {
                    "kernel_p50": pct(mer_k, 0.5),
                    "kernel_p99": pct(mer_k, 0.99),
                    "kernel_max": float(mer_k.max()),
                    "plain_f32_p99": pct(mer_p, 0.99),
                    "plain_f32_max": float(mer_p.max())},
                "kernel_vs_f64": {"p50": pct(err_k, 0.5),
                                  "p99": pct(err_k, 0.99),
                                  "max": float(err_k.max())},
                "plain_f32_vs_f64": {"p50": pct(err_p, 0.5),
                                     "p99": pct(err_p, 0.99),
                                     "max": float(err_p.max())},
                "gate": gate,
                "call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}
        print("kernel_check " + json.dumps(line), flush=True)
        if tag == "main":
            rec = {"name": name, "route": "cuda", "source": K3_SOURCE,
                   "replaces": K3_REPLACES, "launches": None,
                   "max_abs_err": well_line["max_abs_err_x"], "ms": None,
                   "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": line["bound_ms"],
                   "bound_by": line["bound_by"], "library_ms": None,
                   "shape": [B, n_inner], "lanes_per_block": lanes,
                   "smem_bytes_per_block": smem}
    return ("fused_inner", rec), timers


def k3_time_phase(rec, timers):
    """K3's device time at each shape of ``k3_kernel_phase`` (taken at the
    end, as K1's and K2's); the main shape's goes to the record."""
    for tag, kern in timers.items():
        ms, _ = device_ms(kern, K3_KERNEL, reps=10, warmup=2)
        print("kernel_time " + json.dumps({"name": rec["name"], "shape": tag,
                                           "ms": ms}), flush=True)
        if tag == "main":
            rec["ms"] = ms


def config_kernels(config, plan, B, rescue):
    """K1 and K2 at the compact-arrow shapes of ``config``'s plan, in the
    form of ``KERNELS``: the head solve (B x h, r = 1) and the tail blocks,
    padded to the largest (B k x b_max, r = h + 1), at B and at the
    rescue's lanes."""
    h, k = plan.head[1], len(plan.blocks)
    b = max(sz for _, sz in plan.blocks)
    return (
        (f"{KERNELS[0][0]}, {config}", "psd_solve", KERNELS[0][2],
         (("main", (B, h, 1)), ("rescue", (rescue, h, 1)))),
        (f"{KERNELS[1][0]}, {config}", "psd_solve_multi", KERNELS[1][2],
         (("main", (B * k, b, h + 1)), ("rescue", (rescue * k, b, h + 1)))))


def without_curvature(fn):
    """``fn()`` with the plain K3's line search blind to the d'Q d term of
    its candidates: a mutant that the curvature check must catch."""
    import torch
    from omg_tools_torch.ops import fused_alm as fa
    line_search = fa._line_search

    def blind(opt, gv, Jd, qd, *args):
        return line_search(opt, gv, Jd, torch.zeros_like(qd), *args)
    fa._line_search = blind
    try:
        return fn()
    finally:
        fa._line_search = line_search


def k3_curvature_errors(runner, consts, x0, p0, kernel):
    """The curvature check's numbers: from the state after K3_CURV_WARM
    plain float32 iterations of the cold solve's inputs (phase 0, zero
    multipliers, rho_init, the bench options), K3_CURV_INNER more
    iterations by ``kernel`` (a function with fused_inner's arguments),
    by the plain float32 version, by the plain float64 version and by the
    plain version blind to d'Q d (``without_curvature``).  At the bench
    plan's cold-solve state no quadratic row is active, so that d'Q d
    never decides a step there; on this state it decides some lanes'.
    Per lane: the kernel's and the mutant's max |x - x_plain| over the
    largest plain step; ``resolved``: the lanes whose plain float32 step is
    within K3_CURV_RESOLVED (of the largest step) of the float64 one, the
    lanes on which float32 can be compared at all."""
    import torch
    from omg_tools_torch.ops import fused_alm as fa
    plan, opt = runner.fused_plan, runner.solver.options
    dev, B = x0.device, x0.shape[0]
    lb, ub = runner.solver.scale_bounds(runner.lb, runner.ub, x0.dtype, dev)
    fs = fa.FusedPlan.slice_phase(consts.FS, 0)
    a = {"lam": torch.zeros((B, plan.m), dtype=x0.dtype, device=dev),
         "rho": torch.full((B,), opt.rho_init, dtype=x0.dtype, device=dev),
         "pv": p0[:, torch.as_tensor(plan.pcols, device=dev)].contiguous(),
         "lb": lb, "ub": ub}

    def run(fn, x, a=a, fs=fs, n=K3_CURV_INNER):
        return fn(plan, fs, x, a["lam"], a["rho"], a["pv"], a["lb"],
                  a["ub"], opt, n)
    xw = run(fa.fused_inner_plain, x0.contiguous(), n=K3_CURV_WARM)[0]
    xw = xw.contiguous()
    got, plain = run(kernel, xw), run(fa.fused_inner_plain, xw)
    blind = without_curvature(lambda: run(fa.fused_inner_plain, xw))
    a64 = {k: v.double() for k, v in a.items()}
    fs64 = dict(fs, tables=fs["tables"].double())
    p64 = run(fa.fused_inner_plain, xw.double(), a=a64, fs=fs64)
    scale = float((plain[0] - xw).abs().max())

    def lane_err(out):
        return ((out[0].double() - plain[0].double()).abs().amax(-1)
                / scale).cpu()
    resolved = ((plain[0].double() - p64[0]).abs().amax(-1)
                <= K3_CURV_RESOLVED * float((p64[0] - xw.double()).abs()
                                            .max())).cpu()
    return {"kernel": lane_err(got), "blind": lane_err(blind),
            "resolved": resolved, "finite": bool(torch.isfinite(got[0]).all())}


def k3_curvature_check(runner, consts, x0, p0, name):
    """Phase 13's curvature check, on the lanes float32 resolves: the
    mutant blind to d'Q d must leave the plain version's step by more than
    K3_TOL_DX on some lanes, and the kernel on at most K3_CURV_RATIO as
    many.  (Not on none: where a candidate's Armijo test is a tie within
    float32 rounding, the kernel's order of summation may pick the other
    step; at 4,096 lanes of the quadrotor plan that happened on 6 lanes,
    against the mutant's 78, NVIDIA H100 80GB HBM3, 700.00 W.)"""
    from omg_tools_torch.ops import fused_alm as fa
    e = k3_curvature_errors(runner, consts, x0, p0, fa.fused_inner)
    r = e["resolved"]
    line = {"name": name, "lanes": int(r.numel()), "resolved": int(r.sum()),
            "warm": K3_CURV_WARM, "inner": K3_CURV_INNER, "tol": K3_TOL_DX,
            "kernel_max": float(e["kernel"][r].max()),
            "blind_max": float(e["blind"][r].max()),
            "blind_lanes_over_tol": int((e["blind"][r] > K3_TOL_DX).sum()),
            "kernel_lanes_over_tol": int((e["kernel"][r] > K3_TOL_DX).sum())}
    print("k3_curvature " + json.dumps(line), flush=True)
    check(e["finite"], f"{name}: non-finite output, curvature check")
    check(line["blind_lanes_over_tol"] > 0,
          f"{name}: the curvature check does not see d'Q d: {line}")
    check(line["kernel_lanes_over_tol"]
          <= K3_CURV_RATIO * line["blind_lanes_over_tol"],
          f"{name}: kernel vs plain on the curvature check: {line}")
    return line


def config_phases(T, device, config, cache_root, B=BATCH):
    """Phase 13 for one of ``CONFIGS``, on an empty host-tensor cache of
    its own: setup, K3 checks, the main path, the compact-arrow path and
    the cross-check.  Returns the kernels-line entries (K3 at the plan's
    main shape; K1 and K2 at its compact-arrow shapes, their device times
    taken in phase 15) and K3's timers."""
    import torch
    c = CONFIGS[config]
    os.environ["OMG_CACHE_DIR"] = tempfile.mkdtemp(prefix=config + "_",
                                                   dir=cache_root)
    runner, consts, starts, goals, x0, p0, state, setup_s, hit = \
        setup_phase(T, device, B=B, config=config)
    check(not hit, f"{config}: the build found its host tensors in the "
          "cache")
    roll = c["rollout"]
    rescue = roll["rescue_lanes"]
    shapes = (("main", B, roll["budgets"][0][1]),
              ("rescue", rescue, INNER_ITER))
    name = f"{K3_NAME}, {config}"
    k3_entry, timers = k3_kernel_phase(
        runner, consts, x0, p0, shapes, name, c.get("k3_start_noise", 0.0),
        c.get("k3_well_quantile"))
    k3_curvature_check(runner, consts, x0, p0, name)
    st, launches, _ = main_path_phase(
        runner, consts, starts, goals, x0, p0, state, setup_s,
        timed_runs=1, rollout=roll, config=config)
    k3_entry[1]["launches"] = launches["fused_inner"]
    plan = runner.fused_plan
    ca, _ = compact_arrow_phase(runner, st, p0, state, rollout=roll,
                                config=config)
    cross_check_phase(T, runner, st, starts, goals, p0, config=config,
                      lanes=CONFIG_CROSS_LANES)
    chol = config_kernels(config, plan, B, rescue)
    torch.cuda.synchronize()
    return k3_entry, timers, chol, ca


def config_records(device, chol, ca):
    """Phase 14 for one configuration's K1/K2 shapes: the device times
    (the checks run again on the same inputs), with the launches of its
    compact-arrow phase."""
    records = kernel_phase(device, kernels=chol)
    for entry, rec in records:
        rec["launches"] = ca[entry]
    return records


def timed_rollouts(roll, st, p0, state, consts, timed_runs):
    """Median wall time of ``timed_runs`` rollouts and the step times
    between CUDA events recorded at every step boundary."""
    import torch
    times, step_ms = [], []
    for _ in range(timed_runs):
        events = [torch.cuda.Event(enable_timing=True)]
        t1 = time.time()
        events[0].record()
        carry, states = roll(st, p0, state, consts,
                             on_step=lambda k: events.append(
                                 _recorded_event()))
        torch.cuda.synchronize()
        times.append(time.time() - t1)
        step_ms.extend(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return carry, states, float(np.median(times)), times, step_ms


def main_path_phase(runner, consts, starts, goals, x0, p0, state, setup_s,
                    n_steps=N_STEPS, timed_runs=3, rollout=None,
                    config="p2p_holonomic", feas_gate=None):
    """The B-lane batched rollout on the runner's structure at
    ``rollout``'s settings (the holonomic bench's by default); the launch
    counters are zeroed before its first run and read after: on the fused
    structure K3 must have run, K1 and K2 not; on ``compact-arrow`` (phase
    16's obstraj scene) K1 and K2, not K3.  The holonomic and quadrotor
    runs are gated on feasibility (feas_p99 < 1e-3, no diverged lane);
    Dubins' and phase 16's (``feas_gate=False``) on finite values."""
    import torch
    B = x0.shape[0]
    rollout = ROLLOUT if rollout is None else rollout
    if feas_gate is None:
        feas_gate = CONFIGS.get(config, {}).get("feas_gate", True)
    roll = runner.rollout_fn(n_steps, **rollout)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    st = runner.init_solver_state(x0, p0, consts)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    init_launches = launch_counts()
    # the main path's counted run: the first rollout
    zero_launch_counts()
    t1 = time.time()
    carry, states = roll(st, p0, state, consts)
    torch.cuda.synchronize()
    first_s = time.time() - t1
    launches = launch_counts()
    carry, states, run_s, times, step_ms = timed_rollouts(
        roll, st, p0, state, consts, timed_runs)
    states_np = states.double().cpu().numpy()
    feas = carry[0].feas.double().cpu().numpy()
    feas_raw = carry[0].feas_raw.double().cpu().numpy()
    d0 = np.linalg.norm(starts - goals, axis=1)
    d1 = np.linalg.norm(states_np[:, -1] - goals, axis=1)
    scaled = rollout.get("recover_metric", "raw") == "scaled"
    out = {
        "config": config, "structure": runner.structure, "batch": B,
        "n_steps": n_steps, "rollout": {k: v for k, v in rollout.items()},
        "setup_s": setup_s, "cold_solve_s": init_s,
        "first_rollout_s": first_s,
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
        # bench.py:465-467: the scaled metric's lanes above recover_tol,
        # the raw metric's above 1e-2
        "diverged_lanes": int(np.sum(
            feas > rollout["recover_tol"] if scaled else feas_raw > 1e-2)),
        "nan_lanes": int(np.sum(~np.isfinite(feas_raw)
                                | ~np.isfinite(states_np).all((1, 2)))),
        "mean_progress_frac": float(np.mean((d0 - d1) / d0)),
        "n_iter_p50": float(np.median(carry[0].n_iter.cpu().numpy())),
        "init_launches": init_launches, "rollout_launches": launches,
        # from the cold solve on: the main path's own peak
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print("main_path " + json.dumps(out), flush=True)
    check(bool(np.isfinite(states_np).all()), "non-finite states")
    check(out["nan_lanes"] == 0, f"{out['nan_lanes']} non-finite lanes")
    if feas_gate:
        check(out["feas_p99"] < FEAS_P99_GATE,
              f"feas_p99 {out['feas_p99']} >= {FEAS_P99_GATE}")
        check(out["diverged_lanes"] == 0,
              f"{out['diverged_lanes']} diverged lanes")
    check(out["mean_progress_frac"] > 0.0, "no progress toward the goals")
    fused = runner.structure == "compact-arrow-fused"
    check((launches["fused_inner"] > 0) == fused,
          f"{runner.structure}: K3 launched {launches['fused_inner']} times")
    for name in ("psd_solve", "psd_solve_multi"):
        check((launches[name] == 0) == fused,
              f"{runner.structure}: {name} launched {launches[name]} times")
    return st, launches, out


def compact_arrow_phase(runner, st, p0, state, n_steps=CA_STEPS,
                        rollout=None, config="p2p_holonomic"):
    """Phase 10: the compact-arrow path (K1 + K2) on the same runner and
    batch, with the fused plan taken off, warm-started from the fused cold
    solve; returns its launch counts (the K1/K2 records') and the states
    of its timed run (phase 20 (b) holds the dense structures to them)."""
    import torch
    runner.fused_plan = None
    check(runner.structure == "compact-arrow",
          f"structure {runner.structure} without a fused plan")
    consts = runner.consts()
    roll = runner.rollout_fn(n_steps, **(ROLLOUT if rollout is None
                                          else rollout))
    zero_launch_counts()
    t0 = time.time()
    carry, states = roll(st, p0, state, consts)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = launch_counts()
    carry, states, run_s, times, step_ms = timed_rollouts(
        roll, st, p0, state, consts, timed_runs=1)
    feas = carry[0].feas.double().cpu().numpy()
    out = {"config": config, "structure": runner.structure,
           "batch": int(st.x.shape[0]),
           "n_steps": n_steps, "first_rollout_s": first_s,
           "rollout_s": run_s, "step_ms": step_ms,
           "p50_step_latency_ms": float(np.median(step_ms)),
           "max_step_latency_ms": float(np.max(step_ms)),
           "feas_p99": float(np.percentile(feas, 99)),
           "launches": launches}
    print("compact_arrow " + json.dumps(out), flush=True)
    check(bool(torch.isfinite(states).all()), "non-finite states")
    check(launches["fused_inner"] == 0,
          "K3 launched on the compact-arrow path")
    for name in ("psd_solve", "psd_solve_multi"):
        check(launches[name] > 0,
              f"{name} never launched on the compact-arrow path")
    return launches, states


def profile_phase(runner, st, p0, state, path):
    """One traced MPC step (k = 0, with its rescue) of ``runner``'s current
    path under torch.profiler: the device's kernel time against the same
    step's untraced wall time, the kernels launched, the device time of
    K1, K2 and K3 by kernel name, and the host time of each span."""
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
    ours = {"K1": [0.0, 0], "K2": [0.0, 0], "K3": [0.0, 0]}
    for e in events:
        span = e.key.startswith(("alm.", "rollout."))
        if e.device_type == DeviceType.CUDA and not span:
            kernel_us += e.self_device_time_total
            kernels += e.count
            # the K1/K2 instances are told apart by r = 1 (", true>")
            tag = ("K3" if K3_KERNEL in e.key else
                   None if CHOL_KERNEL not in e.key else
                   "K1" if ", true>" in e.key else "K2")
            if tag:
                ours[tag][0] += e.self_device_time_total / 1e3
                ours[tag][1] += e.count
            continue
        if span and e.device_type == DeviceType.CPU:
            spans[e.key] = {"count": e.count,
                            "host_ms": e.cpu_time_total / 1e3,
                            "device_ms": e.device_time_total / 1e3}
    top = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("alm.", "rollout."))),
                 key=lambda e: -e.self_device_time_total)[:8]
    out = {"path": path, "step": 0, "untraced_step_ms": untraced_ms,
           "traced_step_ms": traced_ms, "device_kernel_ms": kernel_us / 1e3,
           "device_busy_share": kernel_us / 1e3 / untraced_ms,
           "kernels_launched": kernels,
           "port_kernels": {k: {"device_ms": v[0], "launches": v[1]}
                            for k, v in ours.items()},
           "spans": spans,
           "top_kernels": [{"name": e.key[:100], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top],
           "analysis_s": time.time() - t0}
    print("profile " + json.dumps(out), flush=True)
    check(kernel_us > 0, "the traced step shows no device time")
    return out


def cross_check_phase(T, runner, st, starts, goals, p0,
                      config="p2p_holonomic", lanes=CROSS_LANES,
                      obstacle_states=None):
    """The cold solve of the first CROSS_LANES scenarios by the port on the
    CPU in float64 against (a) the card's float32 fused solve and (b) the
    same float64 runner moved to the card, whose compact-arrow solve runs
    K1 and K2 in float64 (launches counted from 0): the one-period-ahead
    planned state, each within bench.py's 2 cm parity bound.  Beside them,
    the CPU solve's own sensitivity to rounding: the same solve from x0
    perturbed by F64_PERTURB (relative).  The cold solve is not converged
    and its Newton systems are nearly singular, so that sensitivity is
    millimetres, not roundoff: no tighter bound holds for a second
    implementation that sums in another order.  ``obstacle_states``: the
    scenarios' obstacle states (``make_batch``), cut to the lanes."""
    import torch
    t0 = time.time()
    cpu_runner = T.BatchedP2PRunner(
        build_problem(T, config), dtype=torch.float64, device="cpu",
        alm_options=T.ALMOptions(inner_iter=INNER_ITER, rho_init=10.0))
    if obstacle_states is not None:
        obstacle_states = [tuple(a[:lanes] for a in s)
                           for s in obstacle_states]
    x0, p0c, _ = cpu_runner.make_batch(starts[:lanes], goals[:lanes],
                                       obstacle_states)
    st_cpu = cpu_runner.init_solver_state(x0, p0c)
    want = planned_state(cpu_runner, st_cpu.x, p0c).numpy()

    def err_m(x, runner_, p_):
        got = planned_state(runner_, x, p_).double().cpu().numpy()
        return np.max(np.abs(got - want), axis=1)

    err = err_m(st.x[:lanes], runner, p0[:lanes])
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(x0.shape, generator=gen, dtype=x0.dtype)
    st_self = cpu_runner.init_solver_state(x0 * (1 + F64_PERTURB * noise),
                                           p0c)
    err_self = err_m(st_self.x, cpu_runner, p0c)
    # the float64 runner on the card shares the CPU runner's host work
    card64 = cpu_runner.to(runner.device)
    xc, pc, _ = card64.make_batch(starts[:lanes], goals[:lanes],
                                  obstacle_states)
    zero_launch_counts()
    st64 = card64.init_solver_state(xc, pc)
    torch.cuda.synchronize()
    launches64 = launch_counts()
    err64 = err_m(st64.x, card64, pc)

    def stats(e):
        return {"max_err_m": float(e.max()),
                "p50_err_m": float(np.median(e)),
                "p90_err_m": float(np.percentile(e, 90))}
    out = {"config": config, "lanes": lanes,
           "obstacle_states": obstacle_states is not None, **stats(err),
           "cpu_feas_max": float(st_cpu.feas.max()),
           "card_f64": {"structure": card64.structure,
                        "dtype": str(st64.x.dtype), **stats(err64),
                        "feas_max": float(st64.feas.max()),
                        "launches": launches64},
           "cpu_f64_perturbed": {"relative": F64_PERTURB, **stats(err_self),
                                 "feas_max": float(st_self.feas.max())},
           "seconds": time.time() - t0}
    print("cross_check " + json.dumps(out), flush=True)
    check(out["max_err_m"] < PARITY_GATE_M,
          f"card vs CPU planned states differ by {out['max_err_m']} m")
    check(card64.structure == "compact-arrow" and st64.x.is_cuda
          and st64.x.dtype == torch.float64,
          f"the float64 card runner ran {card64.structure} on "
          f"{st64.x.device} in {st64.x.dtype}")
    check(launches64["psd_solve"] > 0 and launches64["psd_solve_multi"] > 0
          and launches64["fused_inner"] == 0,
          f"float64 card cold solve launched {launches64}")
    check(bool(np.isfinite(err64).all()) and float(err64.max()) < PARITY_GATE_M,
          f"float64 card vs CPU planned states differ by {err64.max()} m")


def main():
    if sys.argv[1:2] == ["--parity-reference"]:
        parity_reference(sys.argv[2])
        return
    if sys.argv[1:2] == ["--structures-reference"]:
        structures_reference(sys.argv[2])
        return
    started = time.time()
    # an empty host-tensor cache of the run's own: the first build and the
    # parity reference are computed here, never loaded
    cache_root = tempfile.mkdtemp(prefix="omg_cache_")
    os.environ["OMG_CACHE_DIR"] = cache_root
    try:
        with contextlib.ExitStack() as stack:
            run(cache_root, stack, started)
    finally:
        shutil.rmtree(cache_root, ignore_errors=True)


def structures_only(T, device, structures_ref, cache_root, started):
    """``--structures-only``: phases 4, 10 (on the fused runner's cold
    solve, no rollout of phase 7) and 20, then the device times of phase
    20's K1 shapes and the kernels line; no final line."""
    import torch
    runner, consts, starts, goals, x0, p0, state, setup_s, hit = \
        setup_phase(T, device)
    check(not hit, "the first build found its host tensors in the cache")
    st = runner.init_solver_state(x0, p0, consts)
    _, ca_states = compact_arrow_phase(runner, st, p0, state)
    generic, dense = structures_phase(
        T, device, structures_ref,
        {"st": st, "ca_states": ca_states, "cache_root": cache_root},
        cache_root)
    records = structures_records(device, generic, dense)
    torch.cuda.synchronize()
    print_elapsed(started)
    print(json.dumps({"kernels": [rec for _, rec in records]}), flush=True)


def mesh_only(T, device, started):
    """``--mesh-only``: phase 21 on phase 14's scene built here, then the
    device times of K1 at its two shapes and the kernels line; no final
    line."""
    import torch
    formation = build_formation(T, device)
    mesh = mesh_phase(T, device, formation)
    name, entry, replaces, _ = KERNELS[0]
    rec = dict(kernel_phase(device, kernels=(
        (name, entry, replaces, (("formation", K1_FLEET_SHAPE),)),))[0][1],
        launches=mesh["k1_by_systems"].get(str(FLEET_N), 0))
    records = [("psd_solve_fleet", rec)] + mesh_records(device, mesh)
    torch.cuda.synchronize()
    print_elapsed(started)
    print(json.dumps({"kernels": [r for _, r in records]}), flush=True)


def print_elapsed(started):
    """The script's wall time so far (the build included)."""
    print("elapsed " + json.dumps({"seconds": time.time() - started}),
          flush=True)


def run(cache_root, stack, started):
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
            for entry in ptxas_report(log.read_text()):
                print(f"ptxas[{name}] " + json.dumps(entry), flush=True)

    device = torch.device("cuda")
    if "--kernels-only" in sys.argv[1:]:
        kernel_phase(device)
        k1_shapes_phase(device, timed=True)
        return
    kernel_phase(device, timed=False)
    k1_shapes_phase(device, timed=False)
    for flag, phase in (("--scenes-only", scene_phase),
                        ("--vast-only", lambda T, device, _: vast_phase(
                            T, device)),
                        ("--gcode-only", lambda T, device, _: gcode_phase(
                            T, device)),
                        ("--distributed-only", None)):
        if flag in sys.argv[1:]:
            records = dist_records(device, distributed_phase(T, device)) \
                if phase is None else \
                loop_records(device, phase(T, device, cache_root))
            k1_shapes_phase(device, timed=True)
            print_elapsed(started)
            print(json.dumps({"kernels": [rec for _, rec in records]}),
                  flush=True)
            return
    if "--structures-only" in sys.argv[1:]:
        structures_only(T, device, stack.enter_context(
            StructuresReference(cache_root)), cache_root, started)
        return
    if "--mesh-only" in sys.argv[1:]:
        mesh_only(T, device, started)
        return
    runner, consts, starts, goals, x0, p0, state, setup_s, hit = \
        setup_phase(T, device)
    check(not hit, "the first build found its host tensors in the cache")
    # phase 8's reference, beside everything up to its gate
    reference = stack.enter_context(ParityReference(runner, x0, p0,
                                                    cache_root))
    cache_phase(T, device, consts, setup_s)
    k3_entry, k3_timers = k3_kernel_phase(runner, consts, x0, p0)
    st, launches, main_out = main_path_phase(runner, consts, starts, goals,
                                             x0, p0, state, setup_s)
    # phase 20's CPU side and the exact Dubins' cold setup, after the main
    # path's timed rollouts and beside everything up to phase 20
    structures_ref = stack.enter_context(StructuresReference(cache_root))
    profile_phase(runner, st, p0, state, "compact-arrow-fused")
    ca_launches, ca_states = compact_arrow_phase(runner, st, p0, state)
    launches.update({k: v for k, v in ca_launches.items()
                     if k != "fused_inner"})
    profile_phase(runner, st, p0, state, "compact-arrow")
    # phase 12's example copy beside the CPU solves of phase 11 (no time
    # is taken there)
    examples = start_examples("p2p_holonomic.py")
    try:
        cross_check_phase(T, runner, st, starts, goals, p0)
    finally:
        finish_examples(examples)
    k1_f64_launches, k1_f64_per_update = closed_loop_phase(device)
    # phase 13: the other bench configurations
    done = [config_phases(T, device, c, cache_root) for c in CONFIGS]
    # phase 14: bench.py's formation_holonomic
    launches["psd_solve_fleet"], k1_per_iteration, _, k1_fleet_f64, \
        formation = formation_phase(T, device)
    # phase 16: the free-time and rotating-obstacle closed loops, the
    # moving and spline-trajectory obstacles batched
    loops = scene_phase(T, device, cache_root)
    # phase 17: the vast-environment closed loops
    loops.update(vast_phase(T, device))
    # phase 18: G-code machining and the central formation
    loops.update(gcode_phase(T, device))
    # phase 19: rendezvous, dual decomposition, generic ADMM and the IPM
    dist = distributed_phase(T, device)
    # phase 20: the runner's generic, quadratic and compact structures and
    # the export
    generic, dense = structures_phase(
        T, device, structures_ref,
        {"st": st, "ca_states": ca_states, "cache_root": cache_root},
        cache_root)
    # phase 21: the fleet mesh path and the multi-host layer, one rank
    mesh = mesh_phase(T, device, formation)
    # phase 8's gate, its reference computed meanwhile
    parity_phase(T, device, reference, x0, p0, main_out["feas_p99"])
    # phase 15: device times, after every timed run
    records = kernel_phase(device) + [k3_entry]
    k1_shapes_phase(device, timed=True)
    k3_time_phase(k3_entry[1], k3_timers)
    for entry, rec in records:
        rec["launches"] = launches[entry]
        if entry == "psd_solve_fleet":
            rec["launches_per_admm_iteration"] = k1_per_iteration
            rec["launches_mesh_path"] = mesh["k1_by_systems"].get(
                str(FLEET_N), 0)
    records.append(("psd_solve", k1_f64_record(device, k1_f64_launches,
                                               k1_f64_per_update)))
    records.append(("psd_solve", k1_f64_record(
        device, k1_fleet_f64, None, name=K1_FLEET_NAME + " float64",
        shape=K1_FLEET_SHAPE, tag="formation")))
    records += loop_records(device, loops)
    records += dist_records(device, dist)
    records += structures_records(device, generic, dense)
    records += mesh_records(device, mesh)
    for c_k3, c_timers, chol, ca in done:
        k3_time_phase(c_k3[1], c_timers)
        records += config_records(device, chol, ca) + [c_k3]
    print_elapsed(started)
    print(json.dumps({"kernels": [rec for _, rec in records]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
