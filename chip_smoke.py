#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, in order; any failure raises and the script exits non-zero:

0. device: a CUDA card is required; prints ``nvidia-smi``'s name and power
   limit of the card.
1. build: compiles every hand-written kernel of the main paths from the
   checkout's sources with ``nvcc`` (one ``nvcc`` per source, all started
   together: the compaction, ``collide_pairs``, the mesh kernels,
   ``pgs_solve``, ``lcp_pivot``) and prints the build time; then ``launch_floor_ms``,
   what an
   empty kernel reads under the timer of every kernel time below.
2. ``compact_rows_t`` against its plain version on the card, at the bench
   path's shapes: B=8192 worlds, D=10, M=384, k=64, mask densities 0,
   0.15, 0.5 and 1 (overflow), both selector dtypes, held exactly equal.
   Times the kernel and its plain version with CUDA events, and reckons
   its two floors from the timed mask: ``bound_ms`` (4 bytes per kept
   value) and ``sector_floor_ms`` (32 bytes per payload row and group of 8
   columns that holds a kept one, which is what device memory serves).
3. the card's bench step against the port's CPU step: the bench world in 4
   worlds, settled 40 substeps on the CPU, then 8 substeps on each device;
   pos/quat/linvel/angvel at atol 1e-4, tick and overflow exact.
4. the bench main path at full width: the bench world (60 dynamic bodies in
   64 slots) in 8192 worlds through ``make_batched_step_fn(substeps=96)``,
   one warm-up launch and 3 timed ones (384 substeps, inside the 600
   audited for this capacity signature); zero overflow, finite state,
   tick 384; prints body-steps/s. Kernel launch counts are set to 0 just
   before this phase and read just after. Then one more substep is run
   with ``compact_rows_t`` wrapped to catch the mask and payload that the
   settled main path hands it; the kernel is held to its plain version
   and timed on them, with both floors for that mask. The same is done
   after phases 6, 9 and 10 (there also for ``sphere_mesh_d2_tiles``), so
   that each kernel is held to its plain version on every path's own
   tensors: the compaction at k=128 on the trimesh path and at k=80 on
   the rollout.
5. the card's mesh step against the port's CPU step: 4 worlds of the
   trimesh scene below, settled 96 substeps on the CPU, then 8 substeps on
   each device; and 4 worlds of a sphere and a box on the twin-ridge mesh
   (``box_tri_candidates`` on the card), settled 44 substeps, so that the
   box lands during the compared ones. Both at atol 1e-4, tick and
   overflow exact.
6. the trimesh main path at full width: ``benchmarks/teapot_bench.py``'s
   workload (the mesh in slot 0, 15 spheres of radius 0.25 from
   ``RandStream(3)``) on a stand-in for the teapot of the same padded size
   (9,216 triangles), 1,024 worlds, one warm-up launch of 96 substeps and 3
   timed launches of 48; then ``sphere_mesh_contacts``, the entry point of
   the per-triangle kernel, as one query of world 0's 15 spheres and as
   one query of all 1,024 x 15 settled spheres, whose first 15 answers
   must be the small query's. Zero overflow, finite state, tick 240;
   prints body-steps/s, ms/substep and peak memory. Launch counts are set
   to 0 just before this phase and read just after:
   ``sphere_mesh_d2_tiles`` and ``compact_rows_t`` once per substep,
   ``sphere_mesh_d2`` once per query.
7. the mesh kernels against their plain versions on the card at rtol 1e-5,
   atol 1e-6 (the kernels fuse multiply-adds and take their reciprocals
   once per triangle, so they round otherwise than the plain versions; the
   measured errors are printed): the tile kernel on all of the settled
   main path's own probes and on random probes; the per-triangle kernel on
   queries of 1 (the (3,) form), 15, 64, 77, 4,000 and all 15,360 of the
   main path's sphere centres against the 9,216-triangle mesh, one launch
   each, a NaN centre giving a NaN row. The 8 nearest tiles of every
   main-path probe, which is all that ``mesh_narrowphase`` takes from the
   tile kernel, must be the plain version's as a set. Times each kernel and
   its plain version with CUDA events; the per-triangle kernel at 1, 15
   and 15,360 centres, each with the bound of the whole query.
8. the card's rollout against the port's CPU rollout: 4 worlds of the
   rollout scene, settled 40 substeps on the CPU, then 4 control steps of
   ``PhysicsEnv`` with seeded actions and 16 lidar rays on each device;
   pos/quat/linvel/angvel, observations and lidar at atol 1e-4, tick and
   overflow exact.
9. the rollout main path at full width: ``benchmarks/rl_rollout_bench.py``'s
   workload at its defaults (``rollout_config(64)``, the bench world, 8192
   worlds, actor slots 4 and 5 observed alone, 16 horizontal lidar rays, 2
   substeps a control step, horizon 16, actions 0.5 x standard normal from
   a seed): one warm-up ``rollout`` and 2 timed ones, 96 substeps. Zero
   overflow, finite state and observations, tick 96, lidar in [0, 1] with
   hits and misses; prints env-steps/s, body-steps/s, ms per control step
   and peak memory. Launch counts set to 0 before and read after:
   ``compact_rows_t`` once per substep.
10. ``PhysicsEnv`` with ``trimesh=``: 64 settled worlds of phase 6 for 2
    control steps with seeded actions on two spheres; finite, overflow 0,
    the tile kernel and the compaction once per substep.
11. every narrowphase pipeline, card against CPU: ``mini_stack_world`` in 4
    worlds, settled 48 substeps on the CPU, then 8 substeps on each device
    (atol 1e-4, tick and overflow exact) through the classic pipeline
    (``EngineConfig()``), the classic pipeline with exact box clipping, the
    row-major typed path, sweep-and-prune, the dense pipeline and the
    throughput policy with capsules and planes; and a PLANE body under
    boxes, spheres and capsules on the component-major path at K=8. The
    dense pipeline's peak memory is printed beside the estimate that
    ``make_batched_step_fn`` refuses batches by.
12. the capsule-stack path at full width: BASELINE config 2 through the
    classic pipeline as ``tests/test_physics.py:222-238`` runs it
    (``EngineConfig(max_bodies=68, max_pair_candidates=192,
    max_contacts=192)``, defaults otherwise: JACOBI 20 sweeps, K=8,
    capsules and planes), ``capsule_stack_world(num_bodies=64, seed=7)``:
    one world settled 480 substeps on the card (the bodies fall 20-50 m),
    replicated into 8192 worlds, one warm-up launch of 24 substeps and 2
    timed launches of 48; zero overflow, finite state, no body under the
    floor; prints body-steps/s, ms/substep and peak memory. Of the hand
    kernels the path launches ``collide_pairs`` alone, once a timed
    substep (counted, and required). On the settled batch's broadphase
    candidates ``collide_pairs`` is held to its plain version bit for bit
    on every valid slot, in float32 and, the features cast, in float64
    with the exact clip; its time, the plain version's and its byte bound
    (``utils/bounds.collide_bound``) are printed.
13. the mini-stack path at full width: ``benchmarks/
    tpu_default_conformance.py``'s engine and scene
    (``EngineConfig.throughput(max_bodies=16, max_pair_candidates=128,
    max_contacts=256)``: 9 buckets, 2,432 payload rows, bf16 selectors) on
    ``mini_stack_world`` in 8192 worlds, one warm-up launch of 96 substeps
    and 3 timed ones; zero overflow, finite state, ``compact_rows_t`` once
    per substep; then the compaction kernel held exactly to its plain
    version on this path's own mask (k=256), with its floors.
14. the hand kernels at their newer shapes, each held to its plain
    version: the compaction at k = 2,048 and k = M = 4,096 (B=1,024, M=4,096,
    past the index lists that hold 1,536 columns), both selector dtypes,
    exactly; in float64 at the bench shapes with no, float32 and bf16
    selector rounding, exactly; the tile kernel and the per-triangle kernel
    in float64 on 49,152 and 15,360 random probes over the 9,216-triangle
    mesh at rtol 1e-12, atol 1e-13. Each float64 instance is timed beside its
    float32 one, its bound at the data sheet's FP64 rate (34 TFLOP/s).
15. the conformance step, card against CPU: the referee's configuration
    (``tests/_traj_engine.py:30-39``: PGS, exact box clip, K=8, float64) on
    ``mini_stack_world`` and on ``ridge_mesh_scene`` (the tile kernel's
    float64 instance on the card), and the typed path in float64 (the
    compaction's float64 instance): 4 kicked worlds settled on the CPU (the
    stack 48 substeps, the ridge 64, while its bodies land), then 8
    substeps on each device, atol 1e-9, tick and overflow exact. In
    float32, from the settled stack: the warm step
    (``ops/warmstart.make_warm_step_fn``, JACOBI and PGS; impulses and keys
    too) and ``step_with_diagnostics``' counters. The card's PGS steps
    launch ``pgs_solve`` once a substep (16 in float64, 9 in float32,
    counted).
16. the conformance path at width, graphed: the referee's configuration
    on the settled stack's first world in 1,024 worlds, one warm-up launch
    of 4 substeps and 2 timed launches of 8; zero overflow, finite state;
    prints body-steps/s, ms/substep, the last live row and, under
    ``torch.profiler``, the kernels and kernel time of one substep, with
    the device's idle share of the untraced substep (the trace slows the
    host, so the traced substep's wall time would count that as idle).
    ``pgs_solve`` once a substep and no other hand kernel (counted); its
    arguments are caught on an eager run of one more substep, which the
    graphed run equals bitwise. Then the settled ridge mesh's first world
    in 1,024 worlds for 16 substeps and one ``sphere_mesh_contacts`` query
    of every world's sphere: the float64 tile kernel and ``pgs_solve``
    once per substep, the float64 per-triangle kernel once, the mesh
    kernels held to their plain versions on that path's own tensors.
17. the device probes: each probe kernel against its plain version at a
    few trips (``probe_vpu`` bit for bit; ``probe_mxu``, one cluster of 16
    blocks, at A = 1, B = 1/16 bit for bit after 1, 2, 3, 7 and 64
    products and on random inputs at rtol 1e-5; ``probe_matmuls`` at 1, 2
    and 3 trips on random and on the TPU probe's inputs, its acc within 4
    float32 spacings and its checksum of all 384 columns at rtol 1e-5, a
    product 1% off in its first 64 columns refused by that check), the
    cluster's size and ``cudaOccupancyMaxActiveClusters``, then the probe
    path ``utils/device_probe.run(quick=True)``, launch counts set to 0
    before and read after: the memory pass at 64 MB and 1 GB, the bf16
    ``bmm``, the three kernels at the TPU probes' first trip counts, each
    beside its library chain (``library_ms``), the shape menu; prints the
    measured GB/s and FP32 TFLOP/s beside the data sheet's.
18. the bench's A/B levers (``solver_cm``, ``solver_matmul_dtype=
    "bfloat16"``, both) on ``bench_config(64)``: card against CPU on the
    bench scene (4 worlds settled 40 substeps on the CPU, 8 substeps on
    each device, atol 1e-4), then 24 substeps of phase 4's settled
    8192-world batch under the default and under each lever, body-steps/s
    side by side, ``compact_rows_t`` once per substep on each path; prints
    how bf16 products are taken on the card.
19. DANTZIG in float64 (``tests/_traj_engine.py``'s ``make_cfg("dantzig")``:
    the direct LCP solve, exact box clip, K=8, 96 contacts, R = 288 rows),
    graphed: card against CPU from phase 15's settled mini stack (atol
    1e-9, tick and overflow exact); world 0 of it in 1,024 worlds
    (dantzig-1024), a warm-up launch of 2 substeps and a timed one of 4,
    ``lcp_pivot_solve`` once a solve (counted), with ms a substep, the
    pivot rounds of every world read from the kernel's (B,) output of the
    timed launch's solves after the run, the solve of one more substep
    under ``torch.cuda.set_sync_debug_mode("error")`` (0 host reads), the
    peak memory, and one substep's launches and kernel time under
    ``torch.profiler``; then phase 15's settled ridge mesh in 1,024 worlds
    for 4 substeps under DANTZIG, the float64 tile kernel and the pivot
    kernel once a substep. The pivot kernel's arguments of one more
    substep of each are caught on an eager run, which the graphed run
    equals bitwise.
19b. ``lcp_pivot_solve`` against its plain version (``ops/lcp.py:
    _pivot_solve``) on the card: dantzig-1024's own (A, b, masks, μ), the
    same under μ = 0.4 (boxed rows), the ridge path's, the capsule pile's
    (one world settled 60 substeps, graphed, in 1,024 worlds: ~42 valid
    rows, past the float64 stage), 16 synthetic worlds of 96 contacts
    (``testing/lcp_systems``), all 288 rows valid in half of them (the
    large tier's blocked elimination), a world at each tier boundary
    (``lcp_kernel.boundary_counts``; every row active in the first round:
    the world of the large tier's shared rows + 1 takes the blocked
    elimination, alone, and the one of its shared rows − 1 does not), and
    one world of every row valid past the R whose panel fits shared memory
    (600 rows in float64, 1,149 in float32); float64: λ within 1e-10 of
    max |λ| and every world's rounds equal; float32: A·λ within 1e-5 of
    its largest; every world in the tier of its valid count. The kernel,
    the plain version, the bound and the chain floor
    (``utils/bounds.lcp_pivot_bound`` at the last solve's active rows)
    timed on each but the μ = 0.4 case, the 1,024-world cases' first 132
    worlds alone too (one an SM); the launch's shape, its launches a
    solve, the worlds each tier took, each tier kernel's registers, spills
    and static shared memory (the staged tier's let 8 blocks share an
    SM).
20. the hinge chain (``hinge_chain_scene``: a motorized, limited hinge and
    a ball joint): card against CPU under the referee's PGS and DANTZIG in
    float64 (atol 1e-9) and under ``core.config.hinge_chain_config`` (the
    throughput policy, capacities 2x the JAX package's peaks) in float32
    (atol 1e-4), 4 kicked worlds settled 40 substeps on the CPU (PGS and
    DANTZIG launch ``pgs_solve`` once a card substep: in the sweeps, and
    as DANTZIG's joint passes alone; counted); then 8,192 worlds under that
    JACOBI configuration (48 + 96 substeps, the compaction kernel once a
    substep) and 1,024 worlds under PGS in float64 (2 + 4 substeps,
    ``pgs_solve`` once a substep, its arguments caught on one more), both
    graphed, each with body-steps/s, ms a substep and the kernels of one
    substep.
20b. ``pgs_solve`` against its plain version at full width, on the
    tensors phases 16 and 20 caught: conformance-1024's (μ = ∞ as on the
    path, cold and warm; μ = 0.4; a μ per row, a third ∞; no friction;
    its rows scattered over each world's buffer; every row live, more
    than the kernel stages), the ridge path's, the hinge chain's joint
    rows in the sweeps and its joint passes alone (DANTZIG's entry, ω =
    1), conformance-1024's rows in worlds of ``max_slots`` + 1 slots
    (velocities in device memory), each in float64 (atol 1e-12) and
    float32 (atol 1e-5) after one 20-sweep solve; the wrapper on those
    worlds timed beside worlds of ``max_slots`` slots (velocities in
    shared memory); the kernel alone on the path's unpacked tensors, the
    wrapper and the plain loop timed on the path's own inputs, beside the
    bound (``utils/bounds.pgs_bound``: bytes and operations, and the chain
    floor of the longest world); the launch's W and S against every
    path's largest live-row count, the kernel's registers and spills.
21. the game server (``net/``): the body API card against CPU on 4
    worlds, every field bitwise; ``SimCore`` at the reference's 512 slots
    under the CLI's configuration (``EngineConfig(max_bodies=512,
    max_pair_candidates=2048, max_contacts=4096)``: classic, JACOBI 20) on
    ``grass_plane_world``: 248 bodies of the M-key distribution
    (``net.client.m_key_body``), 4 at each tick boundary over ticks 0-61, two
    capsule players, one walking 60 ticks, to tick 480; overflow 0, the
    intent log saved and replayed on the card to an equal
    ``state_digest``, the state at tick 400 stepped 8 ticks on each device
    (atol 1e-4), ms a tick over ticks 400-480, ticks/s against the 120 Hz
    of ``PHYSICS_DT`` and the launches of one tick under
    ``torch.profiler`` (no hand kernel: the classic path compacts with
    the plain ``compact_rows``). The same intents under
    ``EngineConfig.throughput`` at 512 slots (f32 selectors) live to tick
    480, ms a tick over ticks 400-480 on the landed arena, the first 240
    ticks replayed to the live run's digest at tick 240,
    ``compact_rows_t`` once a tick (counted as the ``server_throughput``
    path) and held to its plain version on the tensors of tick 481. A
    ``GameServer`` on the native transport with two clients over loopback
    UDP for 5 s (32 M-key spawns, 8 thrown spheres): both mirror every
    body; ticks per wall second and ms a broadcast (``body_states`` +
    encoding). Then the CLI's server (``--device cuda``) and, once it
    prints "Server started", a ``client --spawn 3`` for 8 s in
    subprocesses: the client mirrors 7 bodies, and the server, ended with
    SIGINT once the client is done, returns 0.
22. the world axis over a mesh (``parallel/mesh.py``): ``tests/
    test_mesh.py``'s batch (``stack_world`` of 10 bodies, seed 3, in 16
    worlds raised 0.013 m a world index; ``EngineConfig(16, 64, 128)``, 3
    substeps) stepped unsharded on the card, on ``make_mesh()`` and on a
    mesh of ``[cuda:0, cuda:0]`` under both step functions' names, every
    field bitwise; on a mesh of ``["cpu", "cuda:0"]`` each shard stays on
    its device and the result is within 1e-4 of the card's. Then
    ``utils/multichip_scaling.run`` at mesh sizes 1 and 2 (two shards of
    the one card: the card's machine has one), body-steps/s a shard and ms
    an ES train step, beside ``make_batched_step_fn`` on the same work
    (with one substep's launches under ``torch.profiler``);
    ``compact_rows_t`` counted as the ``sharded`` path and held to its
    plain version on that path's own tensors (one substep of two shards of
    64 worlds stepped 64 substeps).
23. the ES trainer (``examples/rl_training.py``): one train step on the
    card against the CPU from the same noise (pop 12, horizon 8; rtol
    1e-4, atol 1e-5); the learning check of ``tests/test_rl_training.py``
    (pop 12, horizon 25, 6 iterations: the mean reward rises by more than
    0.15 and ends above -3.3); pop 4,096 (8,192 worlds), horizon 25, one
    warm-up step and 2 timed: ms a train step and env-steps/s, then the
    launches and kernel time of one more under ``torch.profiler``.
24. BASELINE's bar on the card: the referee's configuration steps one
    world of ``sphere_drop`` (72 steps: it lands at about step 63),
    ``mini_stack`` (60) and ``hinge_chain`` (40) on the card, and the
    port's float64 referee (``testing/referee.py``) the same initial
    states on the host: max relative position error <= 1e-5, max
    quaternion error <= 1e-3; both printed with each side's seconds.
25. the examples: ``articulated`` for 8 ticks and ``rl_rollout`` at 256
    worlds and 60 steps on the card, their lines checked; the minimal
    server and client in subprocesses started together (the client
    receives id 0 and a roster of 1).
26. the measurement tools of ``utils/``, each at a small size, its
    numbers on a line of its own with the card's name and power limit, and
    its hand-kernel launches counted as a path of its own
    (``tool_<name>``): ``capacity_audit`` at 64 slots under both policies,
    seeds 42 and 7 for 96 substeps (2 chunks of 50): overflow 0 and each
    signature a key of ``benchmarks/audited_capacities.json``, the peaks
    beside the TPU registry's, ``compact_rows_t`` launched;
    ``tpu_default_conformance`` for 200 steps: its five numbers finite, and
    the card's trajectory against the port's CPU over the same steps;
    ``profile_step`` on 2,048 worlds x 8 substeps of the bench: its top 15
    rows, at least 90% of the device time mapped to a ``file:line`` of the
    port, ``compact_rows`` a row with a source; ``solver_iter`` at 512
    worlds (samples of 5 solves); ``teapot_bench --standin`` at 64 worlds,
    ``sphere_mesh_d2_tiles`` launched; ``rl_rollout_bench`` at 512 worlds,
    one timed rollout, ``compact_rows_t`` launched; ``phase_timings`` on the
    bench batch (8192 worlds settled 48 substeps). On each of the four
    ``tool_*`` paths the kernel's wrapper is caught during the tool's run,
    and once the counts are read the last tensors the tool handed it are
    held to its plain version (as on every earlier path's own data) and
    timed; the kernels line carries them as ``on_tool_<name>_data``.
27. the bench module (``rl_ode_physics_tpu_torch.bench``) in-process, as
    ``python3 -m rl_ode_physics_tpu_torch.bench`` runs it, at 1,024
    worlds and 16 substeps a launch (3 warm-up launches and 1 timed): its
    one stdout line a JSON object of exactly ``bench.py``'s four keys with
    a value above 0, its ``# parity:`` line on stderr, each line's final
    batch finite with overflow 0 and tick 64; ``compact_rows_t`` counted as
    the ``bench_module`` path and held to its plain version on the last
    tensors the bench handed it; ``BENCH_BODIES=512`` refused as
    unaudited. Then ``utils/roofline`` on the headline configuration at
    1,024 worlds with S=8, ``utils/sap_cost_analysis`` at 512 slots, chunk
    4, over 2 substeps, each a path of its own (``tool_roofline``,
    ``tool_sap_cost_analysis``) with ``compact_rows_t`` held to its plain
    version on the last tensors the tool handed it, and
    ``utils/orientation_probe``'s nine probes with k1=8 and k2=64, each
    printed with the card's name and power limit; the kernels line carries
    the three records as ``on_<path>_data``.
28. graphs (``utils/graphs.py``): every path's step function graphed
    (none eager); conformance-1024, its ridge-mesh half and the hinge
    chain under PGS, dantzig-1024 and its ridge mesh (float64, 1,024
    worlds), 4 substeps graphed against eager, bitwise, ms a substep in
    turns and each route's ``route_profile`` of one substep; then each
    JACOBI
    entry point at full width, graphed against its eager loop from the
    same state, bitwise: the bench (``bench_config(64)``, phase 4's
    settled 8192 worlds, 96 substeps) at unroll 1, 4 and 96, each
    capture's seconds, graph nodes and peak memory, then host and device
    ms a substep in turns; server-512 under both policies, phase 21's
    graphed sessions against the same intents run eagerly to tick 240,
    equal digests there, ticks/s; one rollout of phase 9's path; one ES
    train step at pop 4,096 from the same noise; two shards of the card
    against the unsharded graphed step, with whether they overlap. For the
    bench, a server tick, the ES step and the two shards, each route's
    ``utils/profiling.route_profile``: host launches a call, device ms,
    and the busy and idle shares of one traced call.
29. prints one JSON line of every kernel the run launched (each float64
    instance as a sub-entry of its kernel, with its own launches;
    ``pgs_solve``'s and ``lcp_pivot_solve``'s records are of their float64
    paths, their float32 instances the sub-entry ``f32``), then the last
    line ``{"ok": true, "device": {...}}``.

Every path runs graphed by default (``utils/graphs.py``), and the launch
counts are per replay (a capture records what the wrappers counted, each
replay adds it). A kernel's hold on a path's own tensors (phases 4, 6, 9,
10, 13, 16, 19, 20, 21, 22, 26, 27) catches the wrapper during an eager
run of the same work (``disable_graphs``), because a captured
call's tensors hold no computed values; where that work returns tensors
it runs once more graphed and must equal the eager run bitwise, and a
tool's eager run must call the kernel as often as its graphed run counted
launches. Each phase's seconds are printed as it ends.

The bench configuration is ``core.config.bench_config(64)``: the values
``bench.bench_config(64)`` resolves to at its defaults, with the contact
compaction run by the kernel. The trimesh configuration is
``EngineConfig.throughput(max_bodies=16, max_pair_candidates=64,
max_contacts=128, enable_planes=False, enable_capsules=False,
pallas_compaction=True)``, three probes per body. The rollout configuration
is ``core.config.rollout_config(64)``: what ``rl_rollout_bench.py`` builds,
the bench's buckets with 256 pair candidates and 80 contact rows.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from rl_ode_physics_tpu_torch.models.workloads import (  # noqa: E402
    CAPSULE_BODIES, CAPSULE_SETTLE, MESH_SPHERES, ROLLOUT_ACTORS,
    ROLLOUT_RAYS, ROLLOUT_SUBSTEPS, capsule_config, mesh_config, mesh_world,
    mini_config, rollout_env, seeded_actions, standin_mesh)
from rl_ode_physics_tpu_torch.utils.bounds import (  # noqa: E402
    FP32_OPS_PER_S, FP64_OPS_PER_S, HBM_BYTES_PER_S, collide_bound,
    compaction_floors, d2_bound, tiles_bound)

WORLDS = 8192
BODIES = 60
SUBSTEPS_PER_LAUNCH = 96
TIMED_LAUNCHES = 3

# the trimesh path: teapot_bench.py's workload at 16x its worlds
MESH_WORLDS = 1024
MESH_WARMUP_SUBSTEPS = 96
MESH_SUBSTEPS_PER_LAUNCH = 48
MESH_TIMED_LAUNCHES = 3
# the rollout path: rl_rollout_bench.py's defaults
ROLLOUT_HORIZON = 16
ROLLOUT_TIMED = 2
# the capsule-stack path: BASELINE config 2 through the classic pipeline
CAPSULE_WORLDS = 8192
CAPSULE_WARMUP = 24
CAPSULE_SUBSTEPS_PER_LAUNCH = 48
CAPSULE_TIMED_LAUNCHES = 2
# the mini-stack path: benchmarks/tpu_default_conformance.py's engine/scene
MINI_WORLDS = 8192
MINI_SUBSTEPS_PER_LAUNCH = 96
MINI_TIMED_LAUNCHES = 3
# the pipelines compared card against CPU on mini_stack_world
STACK = dict(max_bodies=12, max_pair_candidates=64, max_contacts=128)
# the conformance path: tests/_traj_engine.py's make_cfg("pgs") capacities
CONF_CAPS = dict(max_bodies=16, max_pair_candidates=128, max_contacts=256)
CONF_WORLDS = 1024
CONF_WARMUP = 4
CONF_SUBSTEPS_PER_LAUNCH = 8
CONF_TIMED_LAUNCHES = 2
CONF_SETTLE = 48             # CPU substeps before a card-vs-CPU comparison
RIDGE_SETTLE = 64            # the ridge scene's bodies land at 50-70
CONF_ATOL = 1e-9             # float64 card against float64 CPU
# pgs_solve against its plain version on the card after one 20-sweep
# solve: the kernel rounds as the plain version does on the CPU, the plain
# version's card kernels may fuse a multiply-add otherwise
PGS_ATOL_F64 = 1e-12
PGS_ATOL_F32 = 1e-5
RIDGE_SUBSTEPS = 16
# the bench's A/B levers at full width, from phase 4's settled batch
LEVERS = {"solver_cm": dict(solver_cm=True),
          "bf16": dict(solver_matmul_dtype="bfloat16"),
          "solver_cm_bf16": dict(solver_cm=True,
                                 solver_matmul_dtype="bfloat16")}
LEVER_SUBSTEPS = 24
# DANTZIG in float64 at 1,024 worlds: the mini stack, then the ridge mesh
DANTZIG_WARMUP = 2
DANTZIG_SUBSTEPS = 4
DANTZIG_RIDGE_SUBSTEPS = 4
# lcp_pivot against its plain version: float64 λ within 1e-10 of max |λ|
# with the same rounds a world (each sums in its own order); float32 held
# as ROADMAP's float32 trap holds DANTZIG, on the velocity change in
# constraint space, A·λ, within 1e-5 of its largest; the synthetic worlds
LCP_F64_RTOL = 1e-10
LCP_F32_RTOL = 1e-5
LCP_SYNTH_SEED, LCP_SYNTH_WORLDS = 11, 16
# the capsule pile's settling substeps on the card (14 contacts, 42 valid
# rows a world, past the float64 stage, from substep 40 on)
LCP_PILE_SETTLE = 60
# the hinge chain: CPU settling, the throughput path's 144 substeps (the
# horizon its capacities were sized over), PGS float64 at 1,024 worlds
HINGE_SETTLE = 40
HINGE_WARMUP = 48
HINGE_SUBSTEPS = 96
HINGE_PGS_SUBSTEPS = 4
# the game server: the CLI's configuration at the reference's MAX_BODIES
# (inc/body.h:6), 248 M-key bodies, 4 a tick over ticks 0-61 (252 bodies
# overflow nothing in it; 508 do, ROADMAP C6), 2 capsule players
SERVER_CAPS = dict(max_bodies=512, max_pair_candidates=2048,
                   max_contacts=4096)
SERVER_SPAWNS_PER_TICK = 4
SERVER_SPAWN_TICKS = 62
SERVER_WALK_TICKS = 60
SERVER_TICKS = 480           # the bodies dropped from y <= 50 have landed
SERVER_TIMED_FROM = 400      # ms a tick over ticks 400-480
SERVER_THROUGHPUT_REPLAYED = 240   # the throughput session's replayed ticks
# phase 28's eager sessions: to tick 240 (digests against the live runs'
# there), ms a tick over ticks 160-240
SERVER_EAGER_TICKS = 240
SERVER_EAGER_TIMED_FROM = 160
PHYSICS_HZ = 120             # net/server.PHYSICS_DT
SESSION_SECONDS = 5.0
SESSION_SPAWNS = 32
SESSION_THROWS = 8
CLI_SERVER_SECONDS = 8       # the client's window
CLI_SERVER_WINDOW = 180      # the server's: ended by SIGINT once it is done
# the mesh: tests/test_mesh.py's batch, and multichip_scaling.py's rows at
# mesh sizes 1 and 2 (two shards of the one card)
MESH_CAPS = dict(max_bodies=16, max_pair_candidates=64, max_contacts=128)
MESH_BATCH_WORLDS = 16
MESH_BATCH_SUBSTEPS = 3
SCALING_DEVICES = ("cuda:0", "cuda:0")
# the ES trainer: card against CPU, the learning check, the full width
ES_CHECK_POP, ES_CHECK_HORIZON = 12, 8
ES_LEARN_POP, ES_LEARN_HORIZON, ES_LEARN_ITERS = 12, 25, 6
ES_FULL_POP, ES_FULL_HORIZON, ES_FULL_TIMED = 4096, 25, 2
# the card's float64 engine against the port's referee: (scene, steps);
# the sphere lands at about step 63
REFEREE_RUNS = (("sphere_drop", 72), ("mini_stack", 60), ("hinge_chain", 40))
REFEREE_POS_TOL = 1e-5       # BASELINE's relative trajectory error bar
REFEREE_QUAT_TOL = 1e-3
# the examples: articulated's ticks, rl_rollout's worlds and steps, the
# minimal client's seconds
EXAMPLE_TICKS = 8
EXAMPLE_ROLLOUT = (256, 60)
MINIMAL_CLIENT_SECONDS = 8
# the measurement tools (phase 26): capacity_audit's seeds and substeps,
# tpu_default_conformance's steps, profile_step's (worlds, substeps) and
# table rows, solver_iter's, teapot_bench's and rl_rollout_bench's worlds,
# phase_timings' settling substeps; the audit's second seed (7) was cut
# to pay for phase 19b's capsule pile and tier boundaries
TOOL_AUDIT_SEEDS = (42,)
TOOL_AUDIT_SUBSTEPS = 96
TOOL_CONFORMANCE_STEPS = 200
TOOL_PROFILE = (2048, 8)
TOOL_PROFILE_ROWS = 15
TOOL_SOLVER_WORLDS = 512
TOOL_SOLVER_SOLVES = 5
TOOL_TEAPOT_WORLDS = 64
TOOL_ROLLOUT_WORLDS = 512
TOOL_TIMINGS_SETTLE = 48
# the bench module and its analyses (phase 27): the bench's environment,
# roofline's worlds and S, the SAP census's chunk and substeps, the
# orientation probe's two chain lengths
BENCH_MODULE_ENV = dict(BENCH_WORLDS="1024", BENCH_SUBSTEPS="16",
                        BENCH_STEPS="1")
ROOFLINE_WORLDS, ROOFLINE_SUBSTEPS = 1024, 8
SAP_CHUNK, SAP_SUBSTEPS = 4, 2
ORIENTATION_TRIPS = (8, 64)
# the compaction at k past the index list: worlds of M = 4,096 columns
WIDE_K_WORLDS = 1024
# the probe kernels: trips of the short checks, names in the kernels line
PROBE_CHECK_TRIPS = (1, 2, 3)
# probe_mxu's products checked bit for bit: both buffers, many barriers
PROBE_MXU_CHECK_STEPS = (1, 2, 3, 7, 64)
# the PyTorch call a step of each probe's library chain (utils/device_probe)
LIBRARY_CALLS = dict(
    matmuls="torch.bmm(acc, S) a step, the product alone",
    vpu="torch.addcmul a step, the fused chain",
    mxu="torch.mm(acc, B*0.0625) a product")
PROBE_NAMES = ("probe_kernel_matmuls", "probe_kernel_vpu", "probe_mxu_peak")
# phase 28, graphed against eager: the bench's unrolls and timed turns
# (one, to pay for phase 20b), the other paths' turns, the substeps of the
# two shards
GRAPH_UNROLLS = (1, 4, SUBSTEPS_PER_LAUNCH)
GRAPH_BENCH_TURNS = 1
GRAPH_TURNS = 2
# the rollout's and the ES step's timed turns: one each, to pay for phase
# 19b and the DANTZIG cells
GRAPH_ROLLOUT_ES_TURNS = 1
GRAPH_PROFILED = 8
GRAPH_MESH_SUBSTEPS = 8
# the PGS and DANTZIG paths graphed against eager (float64, 1,024 worlds):
# substeps a call
GRAPH_PGS_SUBSTEPS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is false)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = card.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from rl_ode_physics_tpu_torch.ops import (
        collide_kernel, compaction_kernel, kernel_build, lcp_kernel,
        mesh_kernels, pgs_kernel)
    from rl_ode_physics_tpu_torch.utils.timing import launch_floor_ms
    import torch
    builds = [compaction_kernel.build, collide_kernel.build,
              mesh_kernels.build, pgs_kernel.build,
              lambda: lcp_kernel.build(torch.float32),
              lambda: lcp_kernel.build(torch.float64),
              lambda: kernel_build.build("launch_floor.cu")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        libs = [f.result() for f in [pool.submit(b) for b in builds]]
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s: {[p.name for p in libs]}")
    floor_ms = launch_floor_ms()
    log(f"launch_floor_ms={floor_ms:.5f} (an empty kernel under "
        f"utils/timing.cuda_ms)")
    return floor_ms


def compaction_equals_plain(mask, payload, k, sel, label):
    """Raise unless the kernel's four outputs equal the plain version's;
    return the kernel's outputs and the largest difference measured in
    ``rows_t``."""
    import torch
    from rl_ode_physics_tpu_torch.ops import compaction, compaction_kernel
    got = compaction_kernel.compact_rows_t(mask, payload, k, sel)
    ref = compaction.compact_rows_t(mask, payload, k, sel)
    torch.cuda.synchronize()
    for name, g, r in zip(("rows_t", "valid", "count", "overflow"), got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"compact_rows_t differs from its plain "
                                 f"version in {name} ({label})")
    return got, float((got[0] - ref[0]).abs().max())


def phase_kernels():
    """compact_rows_t against its plain version at the main path's shape."""
    import torch
    from rl_ode_physics_tpu_torch.ops import compaction, compaction_kernel
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    b, d, m, k = WORLDS, 10, 384, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = None
    max_err = 0.0
    for sel in (None, torch.bfloat16):
        for density in (0.0, 0.15, 0.5, 1.0):
            mask = torch.rand((b, m), generator=gen, device="cuda") < density
            payload = torch.randn((b, d, m), generator=gen, device="cuda")
            got, err = compaction_equals_plain(
                mask, payload, k, sel, f"density {density}, sel {sel}")
            max_err = max(max_err, err)
            if density == 1.0 and not bool((got[3] == m - k).all()):
                raise AssertionError("overflow case: wrong overflow count")
            if sel is torch.bfloat16 and density == 0.15:
                timed = (mask, payload, sel)
            log(f"compact_rows_t sel={sel} density={density}: exact "
                f"(kept {int(got[2].sum())} rows, overflow "
                f"{int(got[3].sum())})")

    mask, payload, sel = timed
    kernel_ms = cuda_ms(
        lambda: compaction_kernel.compact_rows_t(mask, payload, k, sel))
    plain_ms = cuda_ms(
        lambda: compaction.compact_rows_t(mask, payload, k, sel))
    floors = compaction_floors(mask, d, k)
    full_bytes = b * (m + 4 * d * m) + b * (4 * d * k + k + 8)
    log(f"compact_rows_t at B={b} D={d} M={m} k={k} (density 0.15, bf16): "
        f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
        f"bound_ms={floors['bound_ms']:.5f} sector_floor_ms="
        f"{floors['sector_floor_ms']:.5f} floor_64b_ms="
        f"{floors['floor_64b_ms']:.5f} (kept {floors['kept']}; reading "
        f"the whole payload: {full_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms) "
        f"launches_per_substep=1 library_ms=null")
    return dict(name="compact_rows_t", route="cuda",
                source="rl_ode_physics_tpu_torch/csrc/compact_rows.cu",
                replaces="rl_ode_physics_tpu/ops/compaction_pallas.py:75",
                launches=None, max_abs_err=max_err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=floors["bound_ms"],
                bound_by="bytes", library_ms=None,
                sector_floor_ms=floors["sector_floor_ms"])


def kicked(batch, seed):
    """The batch with every dynamic body's velocity kicked by 0.05 x
    standard normal, from numpy and a seed, so that the worlds differ."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    kick = torch.from_numpy(0.05 * rng.standard_normal(
        tuple(batch.linvel.shape))).to(batch.linvel)
    moving = (batch.dynamic & ~batch.is_kinematic)[..., None]
    return batch.replace(linvel=batch.linvel + torch.where(moving, kick, 0.0))


def settled_on_cpu(config, world, mesh, settle, kick_seed=None,
                   joints=None):
    """4 worlds of ``world`` (``kicked`` apart with ``kick_seed``, if
    given) settled ``settle`` substeps on the CPU. ``mesh``, ``joints``:
    the scene's static mesh and joint table on the CPU, or None."""
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)
    batch = replicate(world, 4, device="cpu")
    if kick_seed is not None:
        batch = kicked(batch, kick_seed)
    return make_batched_step_fn(config, substeps=settle, device="cpu",
                                trimesh=mesh, joints=joints)(batch)


def _card_matches_cpu(config, start, mesh, label, atol=1e-4, joints=None):
    """8 substeps on each device from ``start``, a batch settled on the
    CPU: pos/quat/linvel/angvel at ``atol``, tick and overflow exact; under
    bf16 solver products the velocities within one bf16 spacing of the
    field (2⁻⁸ of its largest |v|, if that is more): a float32 difference
    of one spacing can carry a value across a bf16 rounding boundary.
    ``mesh``, ``joints``: the scene's static mesh and joint table on the
    CPU, or None. Returns the card's peak memory over its 8 substeps, in
    GB."""
    import torch
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn

    cpu = make_batched_step_fn(config, substeps=8, device="cpu",
                               trimesh=mesh, joints=joints)(start)
    on_card = _to(start, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card = make_batched_step_fn(
        config, substeps=8, device="cuda",
        trimesh=None if mesh is None else mesh.to("cuda"),
        joints=None if joints is None else joints.to("cuda"))(on_card)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    worst = {}
    for name in ("pos", "quat", "linvel", "angvel"):
        want = getattr(cpu, name)
        diff = (getattr(card, name).cpu() - want).abs().max()
        tol = atol
        if (config.solver_matmul_dtype == "bfloat16"
                and name in ("linvel", "angvel")):
            tol = max(atol, 2.0 ** -8 * float(want.abs().max()))
        worst[name] = float(diff)
        if not diff <= tol:
            raise AssertionError(f"{label}: card step differs from the CPU "
                                 f"step in {name}: {float(diff)} > {tol}")
    for name in ("tick", "overflow"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"{label}: card step {name} differs from "
                                 f"the CPU's")
    log(f"{label}: card step vs CPU step ({start.num_worlds} worlds settled "
        f"{int(start.tick[0])} substeps on the CPU, + 8 substeps, atol "
        f"{atol}): max abs diff {worst}, tick {cpu.tick.tolist()}, overflow "
        f"{cpu.overflow.tolist()}")
    return peak_gb


def phase_card_vs_cpu(config):
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    world = bench_world(config, num_bodies=BODIES, device="cpu")
    _card_matches_cpu(config, settled_on_cpu(config, world, None, 40), None,
                      "bench scene")


def _to(state, device):
    import dataclasses
    return type(state)(**{f.name: getattr(state, f.name).to(device)
                          for f in dataclasses.fields(state)})


def phase_main_path(config, card):
    import torch
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.ops import compaction_kernel
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world = bench_world(config, num_bodies=BODIES, device="cuda")
    batch = replicate(world, WORLDS, device="cuda")
    step = make_batched_step_fn(config, substeps=SUBSTEPS_PER_LAUNCH,
                                device="cuda")
    torch.cuda.synchronize()
    compaction_kernel.compact_rows_t.launches = 0
    t0 = time.perf_counter()
    batch = step(batch)                                  # warm-up launch
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TIMED_LAUNCHES):
        batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = compaction_kernel.compact_rows_t.launches

    total_substeps = SUBSTEPS_PER_LAUNCH * (TIMED_LAUNCHES + 1)
    overflow = int(batch.overflow.sum())
    if overflow:
        raise AssertionError(f"contact capacity overflow: {overflow} rows")
    for name in ("pos", "quat", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(batch, name)).all()):
            raise AssertionError(f"non-finite {name}")
    if not bool((batch.tick == total_substeps).all()):
        raise AssertionError(f"tick {batch.tick.unique().tolist()} != "
                             f"{total_substeps}")
    dynamic = int((world.inv_mass > 0).sum())
    timed_substeps = SUBSTEPS_PER_LAUNCH * TIMED_LAUNCHES
    rate = WORLDS * dynamic * timed_substeps / secs
    log(f"main path: {WORLDS} worlds x {dynamic} dynamic bodies (of "
        f"{config.max_bodies} slots), {timed_substeps} substeps in "
        f"{secs:.3f} s ({secs / timed_substeps * 1e3:.3f} ms/substep; "
        f"warm-up launch {warm_s:.3f} s): {rate:.1f} body-steps/s on {card}; "
        f"overflow 0, tick {total_substeps}, compact_rows_t launches "
        f"{launches}")
    if launches != total_substeps:
        raise AssertionError(f"compact_rows_t launched {launches} times in "
                             f"{total_substeps} substeps")
    return {"compact_rows_t": launches}, batch


def caught_calls(module, name, drive):
    """Run ``drive()`` with the kernel wrapper ``module.<name>`` wrapped once
    more, so that the arguments of its calls are kept; return how many
    calls it got, the last one's arguments (a tuple of all the wrapper's
    parameters), or None, and what ``drive()`` returned."""
    import functools
    import inspect
    import torch
    wrapped = getattr(module, name)
    signature = inspect.signature(wrapped)
    caught = [0, None]

    @functools.wraps(wrapped)
    def catching(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        caught[0] += 1
        caught[1] = tuple(bound.arguments.values())
        return wrapped(*args, **kwargs)

    # a wrapper counts its launches on the module's name for it
    catching.launches = wrapped.launches
    setattr(module, name, catching)
    try:
        out = drive()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, wrapped)
        wrapped.launches = catching.launches
    return caught[0], caught[1], out


@contextlib.contextmanager
def last_batches(module):
    """``module.make_batched_step_fn`` wrapped so that each step function
    it makes keeps the batch it last returned: yields a list that gets one
    list a step function, holding that batch once it has run."""
    made, finals = module.make_batched_step_fn, []

    def making(*args, **kwargs):
        step, last = made(*args, **kwargs), []
        finals.append(last)

        def stepping(batch):
            last[:] = [step(batch)]
            return last[0]
        return stepping

    module.make_batched_step_fn = making
    try:
        yield finals
    finally:
        module.make_batched_step_fn = made


def _bitwise(got, want, what) -> int:
    """Raise unless two trees of tensors are equal bit for bit; return how
    many tensors they hold."""
    import torch
    from rl_ode_physics_tpu_torch.utils import graphs
    got_leaves, got_def = graphs.flatten(got)
    want_leaves, want_def = graphs.flatten(want)
    if got_def != want_def:
        raise AssertionError(f"{what}: the two runs return other structures")
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: tensor {i} differs")
    return len(got_leaves)


def _caught_last(module, name, drive, path, calls, graphed_check=True):
    """The last call's arguments of ``caught_calls`` with ``drive()`` run
    eagerly (``disable_graphs``), so that they hold what the launch read;
    raises unless the wrapper got ``calls`` calls (any number but 0 when
    None). With ``graphed_check`` and a ``drive()`` that returns tensors,
    ``drive()`` runs once more on its default route, the CUDA graphs, and
    must return the same bits: the kernel held on the eager launch is the
    kernel the graph replays."""
    from rl_ode_physics_tpu_torch.utils import graphs
    with graphs.disable_graphs():
        n, last, eager = caught_calls(module, name, drive)
    if not n or (calls is not None and n != calls):
        raise AssertionError(f"{path}: {calls} substeps called {name} {n} "
                             f"times")
    if graphed_check and eager is not None:
        count = _bitwise(drive(), eager, f"{path}: graphed against eager")
        log(f"{path}: the graphed run is bitwise the eager run the kernel "
            f"was held on ({count} tensors)")
    return n, last


def compaction_on_path_data(drive, path, calls, earlier="",
                            graphed_check=True):
    """``compact_rows_t`` on the mask and payload that a settled main path
    hands it: ``drive()`` runs the path on (``calls`` substeps; None: a
    tool's whole run) eagerly with the kernel's wrapper caught; the last
    call's tensors are then held to the plain version, exactly, and both
    are timed on them alone; the graphed run is shown bitwise the eager
    one (``_caught_last``). ``earlier``: an earlier record of that time,
    printed beside it."""
    from rl_ode_physics_tpu_torch.ops import compaction, compaction_kernel
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    n, (mask, payload, k, sel) = _caught_last(
        compaction_kernel, "compact_rows_t", drive, path, calls,
        graphed_check)
    b, d, m = payload.shape
    compaction_equals_plain(mask, payload, k, sel, f"the {path} path's data")
    kernel_ms = cuda_ms(
        lambda: compaction_kernel.compact_rows_t(mask, payload, k, sel))
    plain_ms = cuda_ms(
        lambda: compaction.compact_rows_t(mask, payload, k, sel))
    floors = compaction_floors(mask, d, k, payload.element_size())
    log(f"compact_rows_t on the {path} path's own data (B={b} D={d} "
        f"M={m} k={k}, {payload.dtype}, sel {sel}, mask density {floors['density']:.5f}, "
        f"kept {floors['kept']}): exact; kernel_ms={kernel_ms:.5f} "
        f"plain_ms={plain_ms:.5f} bound_ms={floors['bound_ms']:.5f} "
        f"sector_floor_ms={floors['sector_floor_ms']:.5f} floor_64b_ms="
        f"{floors['floor_64b_ms']:.5f}{earlier}")
    return dict(floors, ms=kernel_ms, plain_ms=plain_ms, max_abs_err=0.0,
                shape=[b, d, m, k], calls=n)


def d2_errors(got, ref, what):
    """Raise unless a mesh kernel's ``got`` matches its plain version's
    ``ref`` within the kernels' tolerance for their dtype (D2_RTOL, D2_ATOL
    in float32; D2_RTOL_F64, D2_ATOL_F64 in float64); return the largest
    absolute and relative error."""
    import torch
    from rl_ode_physics_tpu_torch.ops.mesh_kernels import tolerance
    rtol, atol = tolerance(got.dtype)
    err = (got - ref).abs()
    worst = float(err.max()), float((err / ref.abs().clamp_min(atol)).max())
    if not torch.allclose(got, ref, rtol=rtol, atol=atol, equal_nan=True):
        raise AssertionError(
            f"{what} differs from its plain version beyond rtol {rtol}, "
            f"atol {atol}: max abs err {worst[0]}, max rel err {worst[1]}")
    return worst


def tiles_on_path_data(drive, path, calls, graphed_check=True):
    """``sphere_mesh_d2_tiles`` on the probes that a settled path hands it,
    caught as in ``compaction_on_path_data``: held to the plain version at
    the kernels' tolerance for the probes' dtype, and both timed on them
    alone."""
    import torch
    from rl_ode_physics_tpu_torch.ops import mesh_kernels
    from rl_ode_physics_tpu_torch.ops import trimesh as tm
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    n, (probes, *tris) = _caught_last(
        mesh_kernels, "sphere_mesh_d2_tiles", drive, path, calls,
        graphed_check)
    p, t = probes.shape[0], tris[0].shape[1]
    got = mesh_kernels.sphere_mesh_d2_tiles(probes, *tris)
    ref = tm.sphere_mesh_d2_tiles_plain(probes, *tris)
    torch.cuda.synchronize()
    abs_err, rel_err = d2_errors(
        got, ref, f"sphere_mesh_d2_tiles on the {path} path's probes")
    kernel_ms = cuda_ms(
        lambda: mesh_kernels.sphere_mesh_d2_tiles(probes, *tris))
    plain_ms = cuda_ms(
        lambda: tm.sphere_mesh_d2_tiles_plain(probes, *tris), iters=3)
    bound = tiles_bound(p, t, probes.dtype)
    rtol, atol = mesh_kernels.tolerance(probes.dtype)
    log(f"sphere_mesh_d2_tiles on the {path} path's own probes (P={p} x "
        f"T={t}, {probes.dtype}): within rtol {rtol}, atol {atol} of the "
        f"plain version (max abs err {abs_err:.3e}, max rel err "
        f"{rel_err:.3e}); kernel_ms="
        f"{kernel_ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
        f"{bound['bound_ms']:.5f} (operations {bound['ops_ms']:.5f}, bytes "
        f"{bound['bytes_ms']:.5f})")
    return dict(ms=kernel_ms, plain_ms=plain_ms, max_abs_err=abs_err,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                shape=[p, t], calls=n)


def ridge_box_world(config, device):
    """A sphere and a box dropped into the twin-ridge valley
    (``scenes.ridge_mesh_geometry``). Returns (world, mesh)."""
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
    from rl_ode_physics_tpu_torch.models.scenes import ridge_mesh_geometry
    from rl_ode_physics_tpu_torch.ops.trimesh import build_trimesh

    b = WorldBuilder(config, 0)
    slot = b.add_body_map((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    b.body_type[slot] = int(BodyType.TRIMESH)
    b.add_body(BodyType.SPHERE, (-0.6, 1.6, 0.4), (0.3, 0.0, 0.0))
    b.add_body(BodyType.BOX, (0.0, 1.2, -0.5), (0.5, 0.5, 0.5))
    verts, tris = ridge_mesh_geometry()
    return b.finish(device), build_trimesh(verts, tris, slot=slot,
                                           pad_to_multiple=128, device=device)


def phase_mesh_card_vs_cpu(config, verts, tris):
    world, mesh = mesh_world(config, verts, tris, "cpu")
    _card_matches_cpu(
        config, settled_on_cpu(config, world, mesh, MESH_WARMUP_SUBSTEPS),
        mesh, f"trimesh scene ({mesh.num_tris} triangles)")
    # the box lands in the valley at about substep 50: the 8 compared
    # substeps hold its impact
    world, mesh = ridge_box_world(config, "cpu")
    _card_matches_cpu(config, settled_on_cpu(config, world, mesh, 44), mesh,
                      "sphere and box on the ridge")


def phase_mesh_main_path(config, verts, tris, card):
    import torch
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.ops import compaction_kernel, mesh_kernels
    from rl_ode_physics_tpu_torch.ops.trimesh import sphere_mesh_contacts
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world, mesh = mesh_world(config, verts, tris, "cuda")
    batch = replicate(world, MESH_WORLDS, device="cuda")
    warm = make_batched_step_fn(config, substeps=MESH_WARMUP_SUBSTEPS,
                                device="cuda", trimesh=mesh)
    step = make_batched_step_fn(config, substeps=MESH_SUBSTEPS_PER_LAUNCH,
                                device="cuda", trimesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (compaction_kernel.compact_rows_t,
                mesh_kernels.sphere_mesh_d2_tiles, mesh_kernels.sphere_mesh_d2)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    batch = warm(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED_LAUNCHES):
        batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the per-triangle kernel's entry point on the settled spheres: world
    # 0's as one query, then every world's as one query
    spheres = (world.body_type[0] == int(BodyType.SPHERE)).nonzero()[:, 0]
    centers = batch.pos[:, spheres].reshape(-1, 3).contiguous()
    contacts = sphere_mesh_contacts(centers[:MESH_SPHERES], 0.25, mesh, k=4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    every = sphere_mesh_contacts(centers, 0.25, mesh, k=4)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    query_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in counters}

    timed_substeps = MESH_SUBSTEPS_PER_LAUNCH * MESH_TIMED_LAUNCHES
    total_substeps = MESH_WARMUP_SUBSTEPS + timed_substeps
    overflow = int(batch.overflow.sum())
    if overflow:
        raise AssertionError(f"trimesh path: capacity overflow {overflow}")
    for name in ("pos", "quat", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(batch, name)).all()):
            raise AssertionError(f"trimesh path: non-finite {name}")
    if not bool((batch.tick == total_substeps).all()):
        raise AssertionError(f"trimesh path: tick "
                             f"{batch.tick.unique().tolist()} != "
                             f"{total_substeps}")
    low = float(batch.pos[:, spheres, 1].min())
    if low < float(verts[:, 1].min()) - 0.5:
        raise AssertionError(f"trimesh path: a sphere fell through the "
                             f"mesh (y={low})")
    for name, few, all_ in zip(("points", "normals", "depths", "valid"),
                               contacts, every):
        if not bool(torch.isfinite(all_).all()):
            raise AssertionError(f"sphere_mesh_contacts: non-finite {name}")
        if tuple(all_.shape[:2]) != (centers.shape[0], 4):
            raise AssertionError(f"sphere_mesh_contacts: {name} of shape "
                                 f"{tuple(all_.shape)}")
        if not torch.equal(few, all_[:MESH_SPHERES]):
            raise AssertionError(f"sphere_mesh_contacts: world 0's {name} "
                                 f"differ between the two queries")
    touching = int(contacts[3].any(1).sum())
    touching_all = int(every[3].any(1).sum())
    if not touching:
        raise AssertionError("sphere_mesh_contacts: no settled sphere of "
                             "world 0 touches the mesh")
    rate = MESH_WORLDS * MESH_SPHERES * timed_substeps / secs
    log(f"trimesh main path: {MESH_WORLDS} worlds x {MESH_SPHERES} spheres "
        f"(of {config.max_bodies} slots) on {mesh.num_tris} triangles, "
        f"{timed_substeps} substeps in {secs:.3f} s "
        f"({secs / timed_substeps * 1e3:.3f} ms/substep; warm-up launch of "
        f"{MESH_WARMUP_SUBSTEPS} substeps {warm_s:.3f} s): {rate:.1f} "
        f"body-steps/s on {card}; overflow 0, tick {total_substeps}, peak "
        f"memory {peak_gb:.3f} GB; sphere_mesh_contacts: {touching} of "
        f"{MESH_SPHERES} world-0 spheres touch the mesh in one query, "
        f"{touching_all} of {centers.shape[0]} in one query of every world "
        f"({query_s * 1e3:.3f} ms, peak memory {query_gb:.3f} GB); launches "
        f"{launches}")
    want = {"compact_rows_t": total_substeps,
            "sphere_mesh_d2_tiles": total_substeps,
            "sphere_mesh_d2": 2}
    if launches != want:
        raise AssertionError(f"trimesh path launches {launches}, expected "
                             f"{want}")
    return launches, batch, mesh, centers


def phase_mesh_kernels(batch, config, mesh, sphere_centers, floor_ms):
    """Both mesh kernels against their plain versions on the card."""
    import torch
    from rl_ode_physics_tpu_torch.ops import mesh_kernels
    from rl_ode_physics_tpu_torch.ops import trimesh as tm
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    tris = mesh.transposed()
    t = mesh.num_tris
    nt = t // tm.MESH_TILE
    probes = tm.mesh_probes(batch, config).reshape(-1, 3).contiguous()
    p = probes.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    real = mesh.v0[mesh.v0[:, 0] < 1e8]          # not the far padding
    lo, hi = real.amin(0) - 1.0, real.amax(0) + 1.0
    rand = lo + (hi - lo) * torch.rand((4096, 3), generator=gen,
                                       device="cuda")
    rtol, atol = mesh_kernels.D2_RTOL, mesh_kernels.D2_ATOL

    max_err = 0.0
    for name, sample in (("main-path probes", probes), ("random probes",
                                                        rand)):
        got = mesh_kernels.sphere_mesh_d2_tiles(sample.contiguous(), *tris)
        ref = tm.sphere_mesh_d2_tiles_plain(sample, *tris)
        torch.cuda.synchronize()
        abs_err, rel_err = d2_errors(got, ref,
                                     f"sphere_mesh_d2_tiles on {name}")
        max_err = max(max_err, abs_err)
        # what mesh_narrowphase takes from the kernel: the 8 nearest tiles
        near_got = tm._top_k_smallest(got, tm.CAND_TILES)
        near_ref = tm._top_k_smallest(ref, tm.CAND_TILES)
        same_set = (near_got.sort(-1).values
                    == near_ref.sort(-1).values).all(-1)
        reordered = same_set & (near_got != near_ref).any(-1)
        order_only = int(reordered.sum())
        other_set = int((~same_set).sum())
        where = ""
        if order_only and sample is probes:
            # probes run (world, slot, probe of the slot)
            per_slot = p // (batch.pos.shape[0] * config.max_bodies)
            slots = (reordered.nonzero()[:, 0] // per_slot
                     % config.max_bodies).unique().tolist()
            where = f" (all of them probes of slots {slots})"
        log(f"sphere_mesh_d2_tiles on {sample.shape[0]} {name} x {t} "
            f"triangles: within rtol {rtol}, atol {atol} of the plain "
            f"version (max abs err {abs_err:.3e}, max rel err "
            f"{rel_err:.3e}); the {tm.CAND_TILES} nearest tiles: "
            f"{other_set} probes with another set, {order_only} with the "
            f"same set in another order{where}")
        if other_set and name == "main-path probes":
            raise AssertionError(
                f"sphere_mesh_d2_tiles: {other_set} main-path probes get "
                f"another set of nearest tiles than from the plain version")
    kernel_ms = cuda_ms(lambda: mesh_kernels.sphere_mesh_d2_tiles(
        probes, *tris))
    plain_ms = cuda_ms(lambda: tm.sphere_mesh_d2_tiles_plain(probes, *tris),
                       iters=3)
    bound = tiles_bound(p, t)
    tiles = dict(name="sphere_mesh_d2_tiles", route="cuda",
                 source="rl_ode_physics_tpu_torch/csrc/sphere_mesh_d2.cu",
                 replaces="rl_ode_physics_tpu/ops/pallas_kernels.py:108",
                 launches=None, max_abs_err=max_err, ms=kernel_ms,
                 plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                 bound_by=bound["bound_by"], library_ms=None)
    log(f"sphere_mesh_d2_tiles at P={p} probes x T={t} triangles "
        f"({p * t} pairs): kernel_ms={kernel_ms:.5f} plain_ms="
        f"{plain_ms:.5f} bound_ms={bound['bound_ms']:.5f} (operations "
        f"{bound['ops_ms']:.5f}, bytes {bound['bytes_ms']:.5f}) "
        f"library_ms=null")

    # the per-triangle kernel: one launch per query, whatever its width
    max_err = max_rel = 0.0
    for count in (1, 15, 64, 77, 4000, sphere_centers.shape[0]):
        query = sphere_centers[:count].clone()
        if count > 1:
            query[count // 2, 1] = float("nan")
        else:
            query = query[0]                     # the (3,) form
        before = mesh_kernels.sphere_mesh_d2.launches
        got = mesh_kernels.sphere_mesh_d2(query, *tris)
        if mesh_kernels.sphere_mesh_d2.launches != before + 1:
            raise AssertionError(f"sphere_mesh_d2: a query of {count} "
                                 f"centres was not one launch")
        ref = tm.sphere_mesh_d2_plain(query, *tris)
        torch.cuda.synchronize()
        want = (nt, tm.MESH_TILE) if count == 1 else (count, nt,
                                                      tm.MESH_TILE)
        if tuple(got.shape) != want:
            raise AssertionError(f"sphere_mesh_d2: shape {tuple(got.shape)}")
        nan_rows = torch.isnan(got).reshape(count, -1)
        if count > 1 and not (bool(nan_rows[count // 2].all())
                              and int(nan_rows.any(1).sum()) == 1):
            raise AssertionError(f"sphere_mesh_d2, {count} centres: the NaN "
                                 f"centre's row is not the one NaN row")
        keep = ~nan_rows.any(1)
        abs_err, rel_err = d2_errors(
            got.reshape(count, -1)[keep], ref.reshape(count, -1)[keep],
            f"sphere_mesh_d2 on {count} centres")
        max_err, max_rel = max(max_err, abs_err), max(max_rel, rel_err)
        log(f"sphere_mesh_d2 on {count} centres x {t} triangles, one launch: "
            f"within rtol {rtol}, atol {atol} of the plain version (max abs "
            f"err {abs_err:.3e}, max rel err {rel_err:.3e})")

    queries = {}
    for count in (1, MESH_SPHERES, sphere_centers.shape[0]):
        query = sphere_centers[:count].contiguous()
        kernel_ms = cuda_ms(lambda: mesh_kernels.sphere_mesh_d2(query, *tris))
        plain_ms = cuda_ms(lambda: tm.sphere_mesh_d2_plain(query, *tris),
                           iters=3)
        bound = d2_bound(count, t)
        queries[f"C={count}"] = dict(
            ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"],
            judged_against=("bound" if bound["bound_ms"] >= floor_ms
                            else "launch floor"))
        log(f"sphere_mesh_d2, one query of C={count} centres x T={t} "
            f"triangles: kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
            f"bound_ms={bound['bound_ms']:.6f} (operations "
            f"{bound['ops_ms']:.6f}, bytes {bound['bytes_ms']:.6f}) "
            f"launch_floor_ms={floor_ms:.5f} library_ms=null")
    # the line's own numbers are the widest query's, where the work and not
    # the launch is what is timed
    wide = queries[f"C={sphere_centers.shape[0]}"]
    one = dict(name="sphere_mesh_d2", route="cuda",
               source="rl_ode_physics_tpu_torch/csrc/sphere_mesh_d2.cu",
               replaces="rl_ode_physics_tpu/ops/pallas_kernels.py:136",
               launches=None, max_abs_err=max_err, ms=wide["ms"],
               plain_ms=wide["plain_ms"], bound_ms=wide["bound_ms"],
               bound_by=wide["bound_by"], library_ms=None,
               launch_floor_ms=floor_ms, queries=queries)
    return [tiles, one]


def phase_rollout_card_vs_cpu(config):
    """4 worlds settled 40 substeps on the CPU, then 4 control steps of the
    env on each device under the same actions."""
    import torch
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn

    steps = 4
    envs = {d: rollout_env(config, 4, d) for d in ("cpu", "cuda")}
    start, _ = envs["cpu"].reset(seed=42)
    start = make_batched_step_fn(config, substeps=40, device="cpu")(start)
    actions = seeded_actions((steps, 4, len(ROLLOUT_ACTORS), 6), 1, "cpu")
    state = {"cpu": start, "cuda": _to(start, "cuda")}
    worst = {"obs": 0.0, "lidar": 0.0}
    for i in range(steps):
        seen = {}
        for d, env in envs.items():
            state[d], seen[d] = env.step(state[d], actions[i].to(d))
        for name, card, cpu in zip(("obs", "lidar"), seen["cuda"],
                                   seen["cpu"]):
            worst[name] = max(worst[name],
                              float((card.cpu() - cpu).abs().max()))
    torch.cuda.synchronize()
    for name in ("pos", "quat", "linvel", "angvel"):
        worst[name] = float((getattr(state["cuda"], name).cpu()
                             - getattr(state["cpu"], name)).abs().max())
    for name, diff in worst.items():
        if not diff <= 1e-4:
            raise AssertionError(f"rollout: the card's {name} differs from "
                                 f"the CPU's: {diff} > 1e-4")
    for name in ("tick", "overflow"):
        if not torch.equal(getattr(state["cuda"], name).cpu(),
                           getattr(state["cpu"], name)):
            raise AssertionError(f"rollout: the card's {name} differs from "
                                 f"the CPU's")
    log(f"rollout scene: card env vs CPU env (4 worlds, 40 settling substeps "
        f"+ {steps} control steps of {ROLLOUT_SUBSTEPS} substeps, "
        f"{ROLLOUT_RAYS} lidar rays): max abs diff {worst}, tick "
        f"{state['cpu'].tick.tolist()}, overflow "
        f"{state['cpu'].overflow.tolist()}")


def phase_rollout_main_path(config, card):
    import torch
    from rl_ode_physics_tpu_torch.ops import compaction_kernel

    env = rollout_env(config, WORLDS, "cuda")
    state, _ = env.reset(seed=42)
    actions = seeded_actions(
        (ROLLOUT_HORIZON, WORLDS, env.num_actors, 6), 0, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compaction_kernel.compact_rows_t.launches = 0
    t0 = time.perf_counter()
    state, _ = env.rollout(state, actions)               # warm-up rollout
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ROLLOUT_TIMED):
        state, (obs, lidar) = env.rollout(state, actions)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = compaction_kernel.compact_rows_t.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    control_steps = ROLLOUT_HORIZON * ROLLOUT_TIMED
    total_substeps = ROLLOUT_SUBSTEPS * ROLLOUT_HORIZON * (ROLLOUT_TIMED + 1)
    overflow = int(state.overflow.sum())
    if overflow:
        raise RuntimeError(
            f"contact capacity overflow in the rollout: {overflow} dropped "
            f"rows, at most {int(state.overflow.max())} in one world "
            f"({config.max_contacts} contact rows)")
    for name in ("pos", "quat", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"rollout: non-finite {name}")
    if tuple(obs.shape) != (ROLLOUT_HORIZON, WORLDS, env.num_obs_slots, 13):
        raise AssertionError(f"rollout: obs of shape {tuple(obs.shape)}")
    if tuple(lidar.shape) != (ROLLOUT_HORIZON, WORLDS, env.num_actors,
                              ROLLOUT_RAYS):
        raise AssertionError(f"rollout: lidar of shape {tuple(lidar.shape)}")
    if not bool(torch.isfinite(obs).all()):
        raise AssertionError("rollout: non-finite observations")
    if not bool(((lidar >= 0.0) & (lidar <= 1.0)).all()):
        raise AssertionError("rollout: lidar outside [0, 1]")
    hits = float((lidar < 1.0).float().mean())
    if not 0.0 < hits < 1.0:
        raise AssertionError(f"rollout: lidar hit share {hits}: expected "
                             f"hits and misses")
    if not bool((state.tick == total_substeps).all()):
        raise AssertionError(f"rollout: tick {state.tick.unique().tolist()} "
                             f"!= {total_substeps}")
    env_rate = WORLDS * control_steps / secs
    log(f"rollout main path: {WORLDS} worlds x {BODIES} dynamic bodies (of "
        f"{config.max_bodies} slots), {env.num_actors} actors, "
        f"{ROLLOUT_RAYS} lidar rays, {ROLLOUT_TIMED} rollouts of "
        f"{ROLLOUT_HORIZON} control steps x {ROLLOUT_SUBSTEPS} substeps in "
        f"{secs:.3f} s ({secs / control_steps * 1e3:.3f} ms/control step; "
        f"warm-up rollout {warm_s:.3f} s): {env_rate:.1f} env-steps/s, "
        f"{env_rate * ROLLOUT_SUBSTEPS * BODIES:.1f} body-steps/s on {card}; "
        f"overflow 0, tick {total_substeps}, lidar hit share {hits:.4f}, "
        f"peak memory {peak_gb:.3f} GB, compact_rows_t launches {launches}")
    if launches != total_substeps:
        raise AssertionError(f"compact_rows_t launched {launches} times in "
                             f"{total_substeps} substeps")
    return ({"compact_rows_t": launches},
            lambda: env.step(state, actions[0]))


def phase_env_on_mesh(config, verts, tris, batch, mesh):
    """``PhysicsEnv(trimesh=mesh)`` on 64 settled worlds of the trimesh
    main path: 2 control steps under seeded actions on two spheres."""
    import torch
    from rl_ode_physics_tpu_torch.models.env import PhysicsEnv
    from rl_ode_physics_tpu_torch.ops import compaction_kernel, mesh_kernels
    from rl_ode_physics_tpu_torch.parallel.batch import take_worlds

    worlds, steps = 64, 2
    env = PhysicsEnv(
        config, lambda cfg, seed: mesh_world(cfg, verts, tris, "cuda")[0],
        actor_slots=[1, 2], num_worlds=worlds, substeps=ROLLOUT_SUBSTEPS,
        trimesh=mesh, device="cuda")
    state = take_worlds(batch, 0, worlds)
    tick0 = int(state.tick[0])
    actions = seeded_actions((steps, worlds, env.num_actors, 6), 2, "cuda")
    counters = (compaction_kernel.compact_rows_t,
                mesh_kernels.sphere_mesh_d2_tiles)
    for fn in counters:
        fn.launches = 0
    for i in range(steps):
        state, obs = env.step(state, actions[i])
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    substeps = steps * ROLLOUT_SUBSTEPS
    if int(state.overflow.sum()):
        raise AssertionError(f"env on a mesh: capacity overflow "
                             f"{int(state.overflow.sum())}")
    if not (bool(torch.isfinite(obs).all())
            and bool(torch.isfinite(state.pos).all())):
        raise AssertionError("env on a mesh: non-finite state")
    if not bool((state.tick == tick0 + substeps).all()):
        raise AssertionError(f"env on a mesh: tick "
                             f"{state.tick.unique().tolist()}")
    if launches != dict.fromkeys(launches, substeps):
        raise AssertionError(f"env on a mesh: launches {launches} in "
                             f"{substeps} substeps")
    log(f"env on a mesh: {worlds} worlds x {steps} control steps of "
        f"{ROLLOUT_SUBSTEPS} substeps on {mesh.num_tris} triangles: obs "
        f"{tuple(obs.shape)} finite, overflow 0, launches {launches}")
    return launches, lambda: env.step(state, actions[0])


def pipeline_configs():
    """The step's narrowphase pipelines, at mini_stack_world's size."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    base = EngineConfig(**STACK)
    return {
        "classic (EngineConfig())": base,
        "classic, exact box clip": base.replace(exact_box_clip=True),
        "typed row-major (cm_narrowphase=False)": base.replace(
            typed_buckets=True, cm_narrowphase=False),
        "typed sweep-and-prune (sap_window=6)": base.replace(
            typed_buckets=True, sap_window=6, sap_broad=2),
        "dense pipeline": base.replace(dense_pipeline=True),
        "throughput policy with capsules and planes":
            EngineConfig.throughput(**STACK),
    }


def plane_world(config, device):
    """A kinematic PLANE body under boxes, spheres and capsules (the scene
    of ``tests/test_narrowphase_cm.py:144-156``)."""
    import numpy as np
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.models.builder import WorldBuilder

    b = WorldBuilder(config, 0)
    b.add_body(BodyType.PLANE, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
               kinematic=True)
    rng = np.random.default_rng(7)
    for i in range(8):
        kind = (BodyType.BOX, BodyType.SPHERE, BodyType.CAPSULE)[i % 3]
        size = ((0.4, 0.5, 0.6) if kind == BodyType.BOX
                else (0.3, 0.8, 0.0) if kind == BodyType.CAPSULE
                else (0.3, 0.0, 0.0))
        b.add_body(kind, (float(rng.uniform(-1, 1)), 0.1 + 0.3 * i,
                          float(rng.uniform(-1, 1))), size)
    return b.finish(device)


def phase_pipelines_card_vs_cpu():
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models.scenes import mini_stack_world
    from rl_ode_physics_tpu_torch.parallel.batch import dense_pipeline_bytes

    for label, config in pipeline_configs().items():
        peak_gb = _card_matches_cpu(
            config, settled_on_cpu(config, mini_stack_world(
                config, device="cpu"), None, 48), None,
            f"mini stack, {label}")
        if config.dense_pipeline:
            log(f"dense pipeline at 4 worlds x {config.max_bodies} slots, "
                f"K={config.max_contacts_per_pair}: peak {peak_gb:.6f} GB "
                f"on the card over its 8 substeps; the estimate the batch "
                f"step refuses by: "
                f"{dense_pipeline_bytes(config, 4) / 1e9:.6f} GB")
    config = EngineConfig(max_bodies=16, max_pair_candidates=64,
                          max_contacts=128, typed_buckets=True,
                          max_contacts_per_pair=8)
    _card_matches_cpu(config, settled_on_cpu(config, plane_world(
        config, "cpu"), None, 24), None, "plane scene, component-major K=8")


def _hand_kernels():
    from rl_ode_physics_tpu_torch.ops import (
        collide_kernel, compaction_kernel, lcp_kernel, mesh_kernels,
        pgs_kernel)
    return (compaction_kernel.compact_rows_t, collide_kernel.collide_pairs,
            mesh_kernels.sphere_mesh_d2_tiles, mesh_kernels.sphere_mesh_d2,
            pgs_kernel.pgs_solve, lcp_kernel.lcp_pivot_solve)


def _check_batch(batch, label, tick):
    import torch
    overflow = int(batch.overflow.sum())
    if overflow:
        raise AssertionError(f"{label}: capacity overflow {overflow}, at "
                             f"most {int(batch.overflow.max())} in a world")
    for name in ("pos", "quat", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(batch, name)).all()):
            raise AssertionError(f"{label}: non-finite {name}")
    if not bool((batch.tick == tick).all()):
        raise AssertionError(f"{label}: tick {batch.tick.unique().tolist()} "
                             f"!= {tick}")


def phase_capsule_main_path(config, card):
    import torch
    from rl_ode_physics_tpu_torch.models.scenes import capsule_stack_world
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world = capsule_stack_world(config, num_bodies=CAPSULE_BODIES, seed=7,
                                device="cuda")
    t0 = time.perf_counter()
    world = make_batched_step_fn(config, substeps=CAPSULE_SETTLE,
                                 device="cuda")(world)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    batch = replicate(world, CAPSULE_WORLDS, device="cuda")
    warm = make_batched_step_fn(config, substeps=CAPSULE_WARMUP,
                                device="cuda")
    step = make_batched_step_fn(config, substeps=CAPSULE_SUBSTEPS_PER_LAUNCH,
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch = warm(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for fn in _hand_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(CAPSULE_TIMED_LAUNCHES):
        batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in _hand_kernels()}

    timed_substeps = CAPSULE_SUBSTEPS_PER_LAUNCH * CAPSULE_TIMED_LAUNCHES
    total = CAPSULE_SETTLE + CAPSULE_WARMUP + timed_substeps
    _check_batch(batch, "capsule-stack path", total)
    moving = (world.inv_mass[0] > 0)
    ys = batch.pos[:, moving, 1]
    if not (float(ys.min()) > -2.0 and float(ys.max()) < 20.0):
        raise AssertionError(f"capsule-stack path: bodies between y="
                             f"{float(ys.min())} and {float(ys.max())}")
    want = dict.fromkeys(launches, 0)
    want["collide_pairs"] = timed_substeps
    if launches != want:
        raise AssertionError(f"capsule-stack path launches {launches}, "
                             f"expected {want}")
    dynamic = int(moving.sum())
    rate = CAPSULE_WORLDS * dynamic * timed_substeps / secs
    fastest = float(batch.linvel[:, moving].norm(dim=-1).max())
    k = config.max_contacts_per_pair
    log(f"capsule-stack path (classic pipeline, K={k}, "
        f"{config.solver_iterations} Jacobi sweeps): one world settled "
        f"{CAPSULE_SETTLE} substeps in {settle_s:.3f} s, then "
        f"{CAPSULE_WORLDS} worlds x {dynamic} dynamic bodies (of "
        f"{config.max_bodies} slots), {timed_substeps} substeps in "
        f"{secs:.3f} s ({secs / timed_substeps * 1e3:.3f} ms/substep; "
        f"warm-up launch of {CAPSULE_WARMUP} substeps {warm_s:.3f} s): "
        f"{rate:.1f} body-steps/s on {card}; overflow 0, tick {total}, "
        f"bodies between y={float(ys.min()):.3f} and {float(ys.max()):.3f}, "
        f"fastest {fastest:.3f} m/s, peak memory {peak_gb:.3f} GB; hand "
        f"kernel launches {launches} (collide_pairs once a substep)")
    if peak_gb > 40.0:
        raise AssertionError(f"capsule-stack path: peak {peak_gb:.1f} GB, "
                             f"step it in world chunks")
    return {"collide_pairs": launches["collide_pairs"]}, (
        collide_on_path_data(batch, config))


def collide_on_path_data(batch, config):
    """``collide_pairs`` against its plain version on ``batch``'s
    broadphase candidates: in the batch's float32 under ``config``, and
    with the features cast to float64 under ``config`` with the exact
    clip. Each is bitwise on every valid candidate slot, and zero and not
    valid on the others. Returns the kernel's entry: times, the byte bound
    and the float64 record under ``f64``."""
    import dataclasses
    import torch
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, collide_kernel, narrowphase)
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    cand = broadphase.broadphase(batch, config)
    feats = narrowphase._features(batch)
    b, n, _ = feats.shape
    cp = cand.ia.shape[1]
    k = config.max_contacts_per_pair
    live = int(cand.valid.sum())
    records = {}
    for dtype, cfg in ((torch.float32, config),
                       (torch.float64, dataclasses.replace(
                           config, exact_box_clip=True))):
        args = (feats.to(dtype), cand.ia, cand.ib, cand.valid, k, cfg)
        label = f"collide_pairs {str(dtype)[6:]}"
        before = collide_kernel.collide_pairs.launches
        got = collide_kernel.collide_pairs(*args)
        if collide_kernel.collide_pairs.launches != before + 1:
            raise AssertionError(f"{label}: the kernel did not launch")
        want = collide_kernel.collide_pairs_plain(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("points", "normals", "depths", "valid"),
                              got, want):
            if not torch.equal(g[cand.valid], w[cand.valid]):
                bad = int((g[cand.valid] != w[cand.valid]).sum())
                raise AssertionError(f"{label}: {name} differs from the "
                                     f"plain version on {bad} values")
            if g[~cand.valid].any():
                raise AssertionError(f"{label}: {name} not zero on an "
                                     f"invalid candidate slot")
        contacts = int(want[3].sum())
        del got, want
        kernel_ms = cuda_ms(lambda: collide_kernel.collide_pairs(*args))
        plain_ms = cuda_ms(lambda: collide_kernel.collide_pairs_plain(*args),
                           iters=2)
        bound = collide_bound(b, n, cp, k, dtype, live=live)
        records[dtype] = dict(
            name="collide_pairs", ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            hbm_bytes=bound["bytes"], l2_bytes=bound["l2_bytes"],
            library_ms=None, max_abs_err=0.0, shape=[b, n, cp, k],
            exact_clip=cfg.exact_box_clip, live_slots=live,
            contacts=contacts)
        log(f"{label} on the capsule-stack path's settled batch (B={b} "
            f"worlds, N={n}, CP={cp} candidate slots, k={k}, exact clip "
            f"{cfg.exact_box_clip}; {live} live slots, {contacts} contacts): "
            f"bitwise the plain version on every valid slot, zero on the "
            f"others; kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound['bound_ms']:.5f} (bytes: {bound['bytes']} "
            f"through device memory; the live slots' feature rows, "
            f"{bound['l2_bytes']} bytes, from L2) library_ms=null (no one "
            f"PyTorch call)")
        del args
        torch.cuda.empty_cache()
    entry = records[torch.float32]
    entry["f64"] = records[torch.float64]
    return entry


def phase_mini_main_path(config, card):
    import torch
    from rl_ode_physics_tpu_torch.models.scenes import mini_stack_world
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    world = mini_stack_world(config, device="cuda")
    batch = replicate(world, MINI_WORLDS, device="cuda")
    step = make_batched_step_fn(config, substeps=MINI_SUBSTEPS_PER_LAUNCH,
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _hand_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    batch = step(batch)                                  # warm-up launch
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(MINI_TIMED_LAUNCHES):
        batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in _hand_kernels()}

    timed_substeps = MINI_SUBSTEPS_PER_LAUNCH * MINI_TIMED_LAUNCHES
    total = timed_substeps + MINI_SUBSTEPS_PER_LAUNCH
    _check_batch(batch, "mini-stack path", total)
    dynamic = int((world.inv_mass > 0).sum())
    rate = MINI_WORLDS * dynamic * timed_substeps / secs
    rows = sum(config.bucket_capacity(*pair) * min(
        k, config.max_contacts_per_pair) for pair, k in (
        ((1, 1), 1), ((1, 2), 1), ((1, 3), 1), ((1, 4), 1), ((2, 2), 8),
        ((2, 3), 3), ((2, 4), 8), ((3, 3), 2), ((3, 4), 2)))
    log(f"mini-stack path (throughput policy, typed component-major, "
        f"{rows} payload rows): {MINI_WORLDS} worlds x {dynamic} dynamic "
        f"bodies (of {config.max_bodies} slots), {timed_substeps} substeps "
        f"in {secs:.3f} s ({secs / timed_substeps * 1e3:.3f} ms/substep; "
        f"warm-up launch {warm_s:.3f} s): {rate:.1f} body-steps/s on {card}; "
        f"overflow 0, tick {total}, peak memory {peak_gb:.3f} GB, hand "
        f"kernel launches {launches}")
    want = {"compact_rows_t": total, "collide_pairs": 0,
            "sphere_mesh_d2_tiles": 0, "sphere_mesh_d2": 0, "pgs_solve": 0,
            "lcp_pivot_solve": 0}
    if launches != want:
        raise AssertionError(f"mini-stack path launches {launches}, "
                             f"expected {want}")
    return {"compact_rows_t": total}, batch


def phase_kernels_new_shapes(mesh):
    """The hand kernels at their newer shapes: the compaction at
    k = 2,048 and k = M = 4,096 and with float64 payloads, both mesh kernels
    in float64; each against its plain version, and timed beside its float32
    instance."""
    import torch
    from rl_ode_physics_tpu_torch.ops import (
        compaction, compaction_kernel, mesh_kernels)
    from rl_ode_physics_tpu_torch.ops import trimesh as tm
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(14)
    b, d, m = WIDE_K_WORLDS, 10, 4096
    mask = torch.rand((b, m), generator=gen, device="cuda") < 0.5
    payload = torch.randn((b, d, m), generator=gen, device="cuda")
    for k in (2048, m):
        for sel in (None, torch.bfloat16):
            got, _ = compaction_equals_plain(mask, payload, k, sel,
                                             f"k={k}, sel {sel}")
            log(f"compact_rows_t at B={b} D={d} M={m} k={k} sel={sel}: exact "
                f"(kept {int(got[2].sum())} rows, overflow "
                f"{int(got[3].sum())})")
    k = 2048
    wide = compaction_floors(mask, d, k)
    wide.update(
        shape=[b, d, m, k],
        ms=cuda_ms(lambda: compaction_kernel.compact_rows_t(mask, payload, k)),
        plain_ms=cuda_ms(lambda: compaction.compact_rows_t(mask, payload, k)),
        max_abs_err=0.0)
    log(f"compact_rows_t at k={k} (an index list a chunk): kernel_ms="
        f"{wide['ms']:.5f} plain_ms={wide['plain_ms']:.5f} bound_ms="
        f"{wide['bound_ms']:.5f} sector_floor_ms={wide['sector_floor_ms']:.5f}")

    b, d, m, k = WORLDS, 10, 384, 64
    mask = torch.rand((b, m), generator=gen, device="cuda") < 0.15
    pay32 = torch.randn((b, d, m), generator=gen, device="cuda")
    pay64 = pay32.double() + 1e-12 * torch.randn(
        (b, d, m), generator=gen, device="cuda", dtype=torch.float64)
    for sel in (None, torch.float32, torch.bfloat16):
        compaction_equals_plain(mask, pay64, k, sel, f"float64, sel {sel}")
        log(f"compact_rows_t float64 at B={b} D={d} M={m} k={k} sel={sel}: "
            f"exact")
    f64 = compaction_floors(mask, d, k, 8)
    f64.update(
        shape=[b, d, m, k], max_abs_err=0.0,
        ms=cuda_ms(lambda: compaction_kernel.compact_rows_t(mask, pay64, k)),
        plain_ms=cuda_ms(lambda: compaction.compact_rows_t(mask, pay64, k)),
        f32_ms=cuda_ms(lambda: compaction_kernel.compact_rows_t(mask, pay32,
                                                                k)))
    log(f"compact_rows_t float64 at B={b} D={d} M={m} k={k} (density 0.15): "
        f"kernel_ms={f64['ms']:.5f} (float32 on the same mask "
        f"{f64['f32_ms']:.5f}) plain_ms={f64['plain_ms']:.5f} bound_ms="
        f"{f64['bound_ms']:.5f} sector_floor_ms={f64['sector_floor_ms']:.5f}")

    # both mesh kernels in float64 on the stand-in mesh, random probes
    tris32 = mesh.transposed()
    tris64 = [x.double().contiguous() for x in tris32]
    t = mesh.num_tris
    real = mesh.v0[mesh.v0[:, 0] < 1e8]
    lo, hi = real.amin(0) - 1.0, real.amax(0) + 1.0
    p = MESH_WORLDS * 16 * 3
    probes64 = (lo.double() + (hi - lo).double() * torch.rand(
        (p, 3), generator=gen, device="cuda", dtype=torch.float64))
    probes32 = probes64.float()
    mesh64 = {}
    for name, kernel, plain, bound, n in (
            ("sphere_mesh_d2_tiles", mesh_kernels.sphere_mesh_d2_tiles,
             tm.sphere_mesh_d2_tiles_plain, tiles_bound, p),
            ("sphere_mesh_d2", mesh_kernels.sphere_mesh_d2,
             tm.sphere_mesh_d2_plain, d2_bound, 15360)):
        q64, q32 = probes64[:n].contiguous(), probes32[:n].contiguous()
        got, ref = kernel(q64, *tris64), plain(q64, *tris64)
        torch.cuda.synchronize()
        abs_err, rel_err = d2_errors(got, ref, f"{name} in float64")
        entry = dict(
            shape=[n, t], max_abs_err=abs_err, max_rel_err=rel_err,
            ms=cuda_ms(lambda: kernel(q64, *tris64)),
            plain_ms=cuda_ms(lambda: plain(q64, *tris64), iters=3),
            f32_ms=cuda_ms(lambda: kernel(q32, *tris32)),
            **bound(n, t, torch.float64))
        entry["f32_bound_ms"] = bound(n, t)["bound_ms"]
        rtol, atol = mesh_kernels.tolerance(torch.float64)
        log(f"{name} float64 on {n} random probes x {t} triangles: within "
            f"rtol {rtol}, atol {atol} of the plain version (max abs err "
            f"{abs_err:.3e}, max rel err {rel_err:.3e}); kernel_ms="
            f"{entry['ms']:.5f} plain_ms={entry['plain_ms']:.5f} bound_ms="
            f"{entry['bound_ms']:.5f} (FP64 at {FP64_OPS_PER_S / 1e12:.0f} "
            f"TFLOP/s); float32 instance {entry['f32_ms']:.5f} ms against "
            f"its bound {entry['f32_bound_ms']:.5f} (FP32 at "
            f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s)")
        mesh64[name] = entry
    return dict(k2048=wide, f64=f64), mesh64


def referee_config(dtype="float64"):
    """``tests/_traj_engine.py:30-39``'s ``make_cfg("pgs")``, by value:
    PGS in buffer row order, exact box clipping, K=8, float64."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    return EngineConfig.conformance(**CONF_CAPS, dtype=dtype,
                                    matmul_precision="highest")


def _as_float32(state):
    """The state with its float64 fields in float32."""
    import dataclasses
    return type(state)(**{
        f.name: (v.float() if v.is_floating_point() else v)
        for f in dataclasses.fields(state)
        for v in [getattr(state, f.name)]})


def _same(label, card, cpu, atol):
    """Raise unless two dicts of tensors agree: integer and bool tensors
    exactly, floats within ``atol``; return the largest float difference."""
    import torch
    worst = 0.0
    for name, value in cpu.items():
        other = card[name].cpu()
        if value.is_floating_point():
            diff = float((other - value).abs().max())
            worst = max(worst, diff)
            if not diff <= atol:
                raise AssertionError(f"{label}: card {name} differs from the "
                                     f"CPU's by {diff} > {atol}")
        elif not torch.equal(other, value):
            raise AssertionError(f"{label}: card {name} differs from the "
                                 f"CPU's")
    return worst


def phase_conformance_card_vs_cpu():
    """The conformance step, card against CPU, from one mini-stack state
    settled on the CPU under the referee's configuration (4 kicked worlds)
    and one ridge-mesh state: in float64 the referee's step on both (the
    tile kernel's float64 instance on the card) and the typed path (the
    compaction's float64 instance); in float32 the warm step (JACOBI and
    PGS) and ``step_with_diagnostics``. Returns the float64 and float32
    paths' hand-kernel launches ({path: {kernel: launches}}: the typed
    path's compaction, the card's PGS steps' ``pgs_solve``) and the two
    settled states."""
    import dataclasses

    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    from rl_ode_physics_tpu_torch.core.world import step_with_diagnostics
    from rl_ode_physics_tpu_torch.models.scenes import (
        mini_stack_world, ridge_mesh_scene)
    from rl_ode_physics_tpu_torch.ops import (
        compaction_kernel, mesh_kernels, pgs_kernel, warmstart)

    pgs = pgs_kernel.pgs_solve
    start_pgs = pgs.launches
    config = referee_config()
    stack = settled_on_cpu(config, mini_stack_world(config, device="cpu"),
                           None, CONF_SETTLE, kick_seed=3)
    _card_matches_cpu(config, stack, None, "conformance float64, mini stack",
                      atol=CONF_ATOL)
    world, mesh = ridge_mesh_scene(config, device="cpu")
    ridge = settled_on_cpu(config, world, mesh, RIDGE_SETTLE, kick_seed=4)
    tiles = mesh_kernels.sphere_mesh_d2_tiles
    before = tiles.launches
    _card_matches_cpu(config, ridge, mesh, "conformance float64, ridge mesh",
                      atol=CONF_ATOL)
    if tiles.launches - before != 8:
        raise AssertionError("ridge mesh: the float64 tile kernel did not "
                             "run once per card substep")
    typed = EngineConfig(**CONF_CAPS, typed_buckets=True, dtype="float64")
    before = compaction_kernel.compact_rows_t.launches
    _card_matches_cpu(typed, stack, None,
                      "typed path float64 (float32 selectors)",
                      atol=CONF_ATOL)
    typed_f64 = compaction_kernel.compact_rows_t.launches - before
    if typed_f64 != 8:
        raise AssertionError(f"typed float64: compact_rows_t launched "
                             f"{typed_f64} times in 8 card substeps")
    pgs_f64 = pgs.launches - start_pgs
    if pgs_f64 != 16:
        raise AssertionError(f"conformance float64: pgs_solve launched "
                             f"{pgs_f64} times in 16 card substeps")

    stack32 = _as_float32(stack)
    before = pgs.launches
    for kind in ("JACOBI", "PGS"):
        cfg = EngineConfig(**CONF_CAPS, solver=SolverKind[kind])
        step = warmstart.make_warm_step_fn(cfg)
        cpu, card = stack32, _to(stack32, "cuda")
        caches = [warmstart.init_cache(cfg, 4, device=d)
                  for d in ("cpu", "cuda")]
        for _ in range(8):
            cpu, caches[0] = step(cpu, caches[0])
            card, caches[1] = step(card, caches[1])
        fields = ("pos", "quat", "linvel", "angvel", "tick", "overflow")
        worst = _same(f"warm step {kind}", {f: getattr(card, f)
                                            for f in fields},
                      {f: getattr(cpu, f) for f in fields}, 1e-4)
        lam = _same(f"warm cache {kind}", dataclasses.asdict(caches[1]),
                    dataclasses.asdict(caches[0]), 1e-4)
        log(f"warm step {kind} (float32), card vs CPU (4 worlds, 8 substeps "
            f"from the settled stack): max abs diff {worst:.3e}, impulses "
            f"{lam:.3e}, keys exact ({int((caches[0].key >= 0).sum())} live)")

    cfg = EngineConfig.conformance(**CONF_CAPS)
    _, want = step_with_diagnostics(stack32, cfg)
    _, got = step_with_diagnostics(_to(stack32, "cuda"), cfg)
    worst = _same("step_with_diagnostics", got, want, 1e-4)
    log(f"step_with_diagnostics (conformance policy, float32), card vs CPU: "
        f"counts exact, floats within {worst:.3e}: "
        f"{ {k: v.tolist() for k, v in want.items()} }")
    pgs_f32 = pgs.launches - before
    if pgs_f32 != 9:
        raise AssertionError(f"float32 PGS: pgs_solve launched {pgs_f32} "
                             f"times in 8 warm substeps and 1 diagnostics "
                             f"step on the card")
    log(f"pgs_solve launches on the card's conformance steps: {pgs_f64} "
        f"float64 (16 substeps), {pgs_f32} float32 (8 warm substeps, 1 "
        f"diagnostics step)")
    f64_paths = {"typed_f64_card_vs_cpu": {"compact_rows_t": typed_f64},
                 "conformance_card_vs_cpu": {"pgs_solve": pgs_f64}}
    return (f64_paths, {"conformance_f32_card_vs_cpu": {"pgs_solve": pgs_f32}},
            stack, (ridge, mesh))


def _launches_of(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` with the device's
    activity only (its kernels, without the host's operator tree), after
    one untraced call (where a graphed step captures): kernel launches,
    their summed device time and the traced wall time (longer than an
    untraced call's: the trace slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time for e in kernels) / 1e3
    return dict(launches=len(kernels), device_ms=device_ms, wall_ms=wall_ms)


def _pgs_args(args) -> dict:
    """The caught arguments of a ``pgs_solve`` call, by name."""
    import inspect
    from rl_ode_physics_tpu_torch.ops import pgs_kernel
    names = inspect.signature(pgs_kernel.pgs_solve).parameters
    return dict(zip(names, args))


def phase_conformance_path(card, stack, ridge):
    """The conformance configuration at width: the referee's float64 PGS
    step on the settled mini stack's first world in 1,024 worlds, graphed,
    the PGS kernel once a substep, its arguments caught on one more
    substep of the path; then the settled ridge mesh's, whose probes go
    through the tile kernel's float64 instance."""
    import torch
    from rl_ode_physics_tpu_torch.core.state import BodyType
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, mesh_kernels, narrowphase, pgs_kernel, solver)
    from rl_ode_physics_tpu_torch.ops import trimesh as tm
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate, take_worlds)
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    config = referee_config()
    batch = replicate(take_worlds(stack, 0, 1), CONF_WORLDS, device="cuda")
    warm = make_batched_step_fn(config, substeps=CONF_WARMUP, device="cuda")
    step = make_batched_step_fn(config, substeps=CONF_SUBSTEPS_PER_LAUNCH,
                                device="cuda")
    torch.cuda.synchronize()
    for fn in _hand_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    batch = warm(batch)                     # its capture included
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _capture_untimed(step, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CONF_TIMED_LAUNCHES):
        batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in _hand_kernels()}
    timed = CONF_SUBSTEPS_PER_LAUNCH * CONF_TIMED_LAUNCHES
    _check_batch(batch, "conformance path",
                 int(stack.tick[0]) + CONF_WARMUP + timed)
    want = {"compact_rows_t": 0, "collide_pairs": CONF_WARMUP + timed,
            "sphere_mesh_d2_tiles": 0, "sphere_mesh_d2": 0,
            "pgs_solve": CONF_WARMUP + timed, "lcp_pivot_solve": 0}
    if launches != want:
        raise AssertionError(f"conformance path launches {launches}, "
                             f"expected {want}")
    contacts = narrowphase.narrowphase(
        batch, broadphase.broadphase(batch, config), config)
    bound = solver.live_row_bound(contacts.valid)
    if not bound:
        raise AssertionError("conformance path: no live contact row")
    one = make_batched_step_fn(config, substeps=1, device="cuda")
    t0 = time.perf_counter()
    prof = _launches_of(lambda: one(batch))
    prof_s = time.perf_counter() - t0
    dynamic = int((stack.inv_mass[0] > 0).sum())
    rate = CONF_WORLDS * dynamic * timed / secs
    substep_ms = secs / timed * 1e3
    idle = max(0.0, 1.0 - prof["device_ms"] / substep_ms)
    log(f"conformance path (referee configuration: PGS "
        f"{config.solver_iterations} sweeps, exact box clip, K="
        f"{config.max_contacts_per_pair}, float64), graphed: {CONF_WORLDS} "
        f"worlds x {dynamic} dynamic bodies of the settled mini stack, "
        f"{timed} substeps in {secs:.3f} s ({substep_ms:.3f} ms/substep; "
        f"warm-up launch of {CONF_WARMUP} substeps with its capture "
        f"{warm_s:.3f} s): {rate:.1f} body-steps/s on {card}; overflow 0; "
        f"last live row {bound} of {config.max_contacts} rows (contacts "
        f"per world {int(contacts.count.min())}-"
        f"{int(contacts.count.max())}); one graphed substep under "
        f"torch.profiler ({prof_s:.1f} s with the trace): "
        f"{prof['launches']} kernels, {prof['device_ms']:.3f} ms of kernel "
        f"time, idle {idle:.3f} of the untraced {substep_ms:.3f} ms substep "
        f"(the traced substep took {prof['wall_ms']:.3f} ms); hand kernel "
        f"launches {launches}")
    del contacts
    # the kernel's arguments on the path's own tensors (phase 20b holds
    # the kernel to its plain version on them)
    _, caught = _caught_last(pgs_kernel, "pgs_solve", lambda: one(batch),
                             "conformance", 1)
    conf_args = _pgs_args(caught)

    state, mesh = ridge
    mesh = mesh.to("cuda")
    rbatch = replicate(take_worlds(state, 0, 1), CONF_WORLDS, device="cuda")
    rstep = make_batched_step_fn(config, substeps=RIDGE_SUBSTEPS,
                                 device="cuda", trimesh=mesh)
    for fn in _hand_kernels():
        fn.launches = 0
    _capture_untimed(rstep, rbatch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rbatch = rstep(rbatch)
    torch.cuda.synchronize()
    rsecs = time.perf_counter() - t0
    sphere = int((state.body_type[0] == int(BodyType.SPHERE)).nonzero()[0])
    centres = rbatch.pos[:, sphere].contiguous()
    query = tm.sphere_mesh_contacts(centres, 0.3, mesh, k=4)
    torch.cuda.synchronize()
    rlaunches = {fn.__name__: fn.launches for fn in _hand_kernels()}
    _check_batch(rbatch, "ridge-mesh conformance path",
                 int(state.tick[0]) + RIDGE_SUBSTEPS)
    want = {"compact_rows_t": 0, "collide_pairs": RIDGE_SUBSTEPS,
            "sphere_mesh_d2_tiles": RIDGE_SUBSTEPS, "sphere_mesh_d2": 1,
            "pgs_solve": RIDGE_SUBSTEPS, "lcp_pivot_solve": 0}
    if rlaunches != want:
        raise AssertionError(f"ridge-mesh conformance path launches "
                             f"{rlaunches}, expected {want}")
    if not all(bool(torch.isfinite(x).all()) for x in query):
        raise AssertionError("ridge mesh: non-finite sphere_mesh_contacts")
    log(f"ridge-mesh conformance path (float64), graphed: {CONF_WORLDS} "
        f"worlds of the settled ridge scene, {RIDGE_SUBSTEPS} substeps in "
        f"{rsecs:.3f} s ({rsecs / RIDGE_SUBSTEPS * 1e3:.3f} ms/substep); "
        f"sphere_mesh_contacts on the {CONF_WORLDS} spheres, one query: "
        f"{int(query[3].any(1).sum())} touch the mesh; launches {rlaunches}")
    tiles64 = tiles_on_path_data(
        lambda: make_batched_step_fn(config, substeps=1, device="cuda",
                                     trimesh=mesh)(rbatch),
        "ridge-mesh conformance", 1)
    # the ridge path's PGS arguments: phase 20b holds the kernel on them
    _, rcaught = _caught_last(
        pgs_kernel, "pgs_solve",
        lambda: make_batched_step_fn(config, substeps=1, device="cuda",
                                     trimesh=mesh)(rbatch),
        "ridge-mesh conformance", 1, graphed_check=False)
    conf_args = dict(conformance=conf_args, ridge=_pgs_args(rcaught))
    tris = mesh.transposed()
    got = mesh_kernels.sphere_mesh_d2(centres, *tris)
    ref = tm.sphere_mesh_d2_plain(centres, *tris)
    torch.cuda.synchronize()
    abs_err, rel_err = d2_errors(got, ref, "sphere_mesh_d2 on the ridge's "
                                 "spheres")
    bound = d2_bound(CONF_WORLDS, mesh.num_tris, torch.float64)
    d2_64 = dict(
        shape=[CONF_WORLDS, mesh.num_tris], max_abs_err=abs_err,
        max_rel_err=rel_err,
        ms=cuda_ms(lambda: mesh_kernels.sphere_mesh_d2(centres, *tris)),
        plain_ms=cuda_ms(lambda: tm.sphere_mesh_d2_plain(centres, *tris)),
        **bound)
    log(f"sphere_mesh_d2 float64 on the ridge path's {CONF_WORLDS} sphere "
        f"centres x {mesh.num_tris} triangles: max abs err {abs_err:.3e}, "
        f"max rel err {rel_err:.3e}; kernel_ms={d2_64['ms']:.5f} plain_ms="
        f"{d2_64['plain_ms']:.5f} bound_ms={d2_64['bound_ms']:.6f}")
    return ({"conformance": launches,
             "ridge_mesh_conformance": rlaunches},
            dict(tiles=tiles64, d2=d2_64), conf_args,
            dict(conformance=batch, ridge=(rbatch, mesh)))


def phase_device_probes(card):
    """The three probe kernels against their plain versions at a few trips,
    then the device-probe path (``utils/device_probe.run``) at the TPU
    probes' first trip counts."""
    import torch
    from rl_ode_physics_tpu_torch.ops import probe_kernels as pk
    from rl_ode_physics_tpu_torch.utils import device_probe as dp
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(17)
    vel = torch.randn((dp.MATMUL_WORLDS, pk.ROWS, pk.INNER), generator=gen,
                      device="cuda")
    s = torch.randn((dp.MATMUL_WORLDS, pk.INNER, pk.COLS), generator=gen,
                    device="cuda")
    matmuls_err = 0.0
    for label, (v, w) in (("random", (vel, s)),
                          ("the TPU probe's", dp.matmuls_inputs())):
        # the check must refuse a product 1% off in its first 64 columns
        off = w.clone()
        off[..., :pk.INNER] *= 1.01
        for trips in PROBE_CHECK_TRIPS:
            got = pk.probe_matmuls(v, w, trips)
            want = pk.probe_matmuls_plain(v, w, trips)
            errors = pk.matmuls_errors(v, got, want)
            off_errors = pk.matmuls_errors(
                v, pk.probe_matmuls(v, off, trips), want)
            err = float((got[0] - want[0]).abs().max())
            if not pk.matmuls_agree(errors) or pk.matmuls_agree(off_errors):
                raise AssertionError(
                    f"probe_matmuls on {label} inputs, {trips} trips: "
                    f"{errors}; with the first 64 columns 1% off "
                    f"{off_errors}")
            matmuls_err = max(matmuls_err, err)
            log(f"probe_matmuls on {label} inputs, {trips} trips: acc "
                f"within {errors['ulps']:.0f} float32 spacings of the plain "
                f"version (max abs err {err:.3e}, increment rel err "
                f"{errors['increment']:.3e}), checksum of all 384 columns "
                f"rel err {errors['checksum']:.3e}; with the first 64 "
                f"columns 1% off refused ({off_errors['ulps']:.0f} spacings, "
                f"increment rel err {off_errors['increment']:.3e}, checksum "
                f"rel err {off_errors['checksum']:.3e})")
    for n in (3 * pk.VPU_THREADS, 12 * pk.VPU_THREADS):
        x = 0.5 + 1.5 * torch.rand((n,), generator=gen, device="cuda")
        if not torch.equal(pk.probe_vpu(x, 8), pk.probe_vpu_plain(x, 8)):
            raise AssertionError(f"probe_vpu on {n} values differs from the "
                                 f"plain version")
        fused = float((pk.probe_vpu(x, 8, True)
                       - pk.probe_vpu_plain(x, 8, True)).abs().max())
        log(f"probe_vpu on {n} values, 8 trips: bitwise the plain version; "
            f"the fmaf chain {fused:.3e} from the plain addcmul chain "
            f"(another rounding: timed only)")
    cluster = pk.mxu_cluster_info()
    log(f"probe_mxu: a cluster of {cluster['cluster']} blocks; "
        f"cudaOccupancyMaxActiveClusters {cluster['max_active_clusters']}")
    a, b = dp.mxu_inputs()
    for steps in PROBE_MXU_CHECK_STEPS:
        if not torch.equal(pk.probe_mxu(a, b, steps),
                           pk.probe_mxu_plain(a, b, steps)):
            raise AssertionError(f"probe_mxu at A = 1, B = 1/16 differs from "
                                 f"the plain version after {steps} products")
    ra = torch.randn((pk.MXU_N, pk.MXU_N), generator=gen, device="cuda")
    rb = torch.randn((pk.MXU_N, pk.MXU_N), generator=gen, device="cuda") / 16
    got, ref = pk.probe_mxu(ra, rb, 3), pk.probe_mxu_plain(ra, rb, 3)
    mxu_err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=pk.MATMUL_RTOL,
                          atol=pk.MATMUL_RTOL * float(ref.abs().max())):
        raise AssertionError(f"probe_mxu on random inputs: max abs err "
                             f"{mxu_err}")
    log(f"probe_mxu: bitwise the plain version at A = 1, B = 1/16 after "
        f"{list(PROBE_MXU_CHECK_STEPS)} products; on random inputs within "
        f"rtol {pk.MATMUL_RTOL} (max abs err {mxu_err:.3e} of "
        f"{float(ref.abs().max()):.3e})")

    counters = (pk.probe_matmuls, pk.probe_vpu, pk.probe_mxu)
    for fn in counters:
        fn.launches = 0
    report = dp.run(quick=True)
    torch.cuda.synchronize()
    launches = dict(zip(PROBE_NAMES, (fn.launches for fn in counters)))
    m = report["measured"]
    rates = ", ".join(f"{h['gb_per_s']:.1f} GB/s over {h['mb']} MB"
                      for h in report["hbm"])
    log(f"device probes on {card}: memory {rates} (data sheet "
        f"{m['data_sheet_gb_per_s']:.0f}); FP32 "
        f"{m['fp32_tflop_per_s_per_sm']:.4f} TFLOP/s an SM on {m['sms']} "
        f"SMs, x132 = {m['fp32_tflop_per_s_x132']:.2f} TFLOP/s in the "
        f"product chain, "
        f"{m['fp32_fma_chain_tflop_per_s_one_sm']:.4f} x132 = "
        f"{m['fp32_fma_chain_tflop_per_s_x132']:.2f} TFLOP/s in the fused "
        f"multiply-add chain (data sheet "
        f"{m['data_sheet_fp32_tflop_per_s']:.0f}); launches {launches}")
    log(f"device probes: {json.dumps(report)}")

    matmuls = report["kernel_matmuls"][0]
    vpu = report["kernel_vpu"][0]
    mxu = report["mxu_peak"][0]
    v0, s0 = dp.matmuls_inputs()
    x0 = torch.ones(vpu["shape"], device="cuda").reshape(-1)
    plain = dict(
        matmuls=cuda_ms(lambda: pk.probe_matmuls_plain(
            v0, s0, matmuls["trips"]), iters=2),
        vpu=cuda_ms(lambda: pk.probe_vpu_plain(x0, vpu["trips"]), iters=2),
        mxu=cuda_ms(lambda: pk.probe_mxu_plain(a, b, mxu["steps"]), iters=2))
    source = "rl_ode_physics_tpu_torch/csrc/device_probe.cu"
    entries = []
    for name, line, rep, key, err in (
            ("probe_kernel_matmuls", 94, matmuls, "matmuls", matmuls_err),
            ("probe_kernel_vpu", 131, vpu, "vpu", 0.0),
            ("probe_mxu_peak", 157, mxu, "mxu", mxu_err)):
        entries.append(dict(
            name=name, route="cuda", source=source,
            replaces=f"benchmarks/device_probe.py:{line}", launches=None,
            max_abs_err=err, ms=rep["ms"], plain_ms=plain[key],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"], library=LIBRARY_CALLS[key],
            timed_at={k: rep[k] for k in ("trips", "steps", "shape")
                      if k in rep}))
        log(f"{name}: kernel_ms={rep['ms']:.5f} plain_ms={plain[key]:.5f} "
            f"bound_ms={rep['bound_ms']:.5f} (FP32 operations on the SMs it "
            f"runs on) library_ms={rep['library_ms']:.5f} "
            f"({LIBRARY_CALLS[key]})")
    return {"device_probe": launches}, entries, report["measured"]


def _capture_untimed(step, batch):
    """A graphed ``step`` captured by an untimed call on ``batch``, its
    launches taken back from the counts, so that a timed call is the
    replays'."""
    from rl_ode_physics_tpu_torch.utils import graphs
    if step.graphed:
        counters = graphs.kernel_counters()
        before = graphs.read_counts(counters)
        step(batch)
        graphs.set_counts(counters, before)


def _timed_run(step, batch, label, tick):
    """One launch of ``step`` on ``batch`` timed after the card is idle;
    raises unless the result holds (``_check_batch``). A graphed step is
    captured by an untimed call first (``_capture_untimed``). Returns
    (batch, seconds)."""
    import torch
    _capture_untimed(step, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _check_batch(batch, label, tick)
    return batch, secs


def bf16_products_on_card(config):
    """The card's route for the solver's bf16 products (``solver._mm``) at
    the bench's shapes over 8192 worlds, the gather (B, 2C, N)·(B, N, 8)
    and the scatter (B, N, 2C)·(B, 2C, 8), on seeded bf16 operands: held
    to the float32 product of the same operands at float32 roundoff (the
    inner length times float32's epsilon, of Σ|a·b| an entry), and shown
    to differ beyond that bound from a bf16 ``bmm``, whose result is
    rounded to bf16. Prints each product's ms and the upcast's."""
    import torch
    from rl_ode_physics_tpu_torch.ops import solver
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    gen = torch.Generator("cuda").manual_seed(18)
    c2, n = 2 * config.max_contacts, config.max_bodies
    route = solver.bf16_product_route("cuda")
    for name, (m, k) in (("gather", (c2, n)), ("scatter", (n, c2))):
        a = torch.randn((WORLDS, m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        b = torch.randn((WORLDS, k, 8), generator=gen, device="cuda").to(
            torch.bfloat16)
        got = solver._mm(a, b, torch.float32)
        ref = torch.bmm(a.float(), b.float())
        bound = k * torch.finfo(torch.float32).eps * torch.bmm(
            a.float().abs(), b.float().abs())
        err = (got - ref).abs()
        rounded_err = (torch.bmm(a, b).float() - ref).abs()
        if got.dtype != torch.float32 or not bool((err <= bound).all()):
            raise AssertionError(
                f"bf16 {name} product through {route!r}: dtype {got.dtype}, "
                f"max error {float(err.max()):.3e} beyond float32 roundoff")
        if not bool((rounded_err > bound).any()):
            raise AssertionError(f"bf16 {name} product: a bf16 bmm stays "
                                 f"within float32 roundoff; the check "
                                 f"cannot tell the routes apart")
        ms = cuda_ms(lambda: solver._mm(a, b, torch.float32))
        upcast_ms = cuda_ms(lambda: torch.bmm(a.float(), b.float()))
        log(f"bf16 {name} product {tuple(a.shape)}x{tuple(b.shape)} through "
            f"{route!r}: max abs err {float(err.max()):.3e} against the "
            f"float32 product (bound {float(bound.max()):.3e}), a bf16 bmm "
            f"{float(rounded_err.max()):.3e}; {ms:.5f} ms, the upcast "
            f"{upcast_ms:.5f} ms")
        del a, b, got, ref, bound, err, rounded_err


def phase_bench_levers(config, card, settled):
    """The bench's A/B levers (``solver_cm``, bf16 solver products, both):
    the card's bf16 product route at the bench's shapes, card against CPU
    on the bench scene, then at full width: 48 substeps of the settled
    8192-world batch of phase 4 under the default and under each lever,
    body-steps/s side by side, the compaction kernel counted."""
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.ops import compaction_kernel, solver
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn

    bf16_products_on_card(config)
    start = settled_on_cpu(config, bench_world(
        config, num_bodies=BODIES, device="cpu"), None, 40)
    for name, lever in LEVERS.items():
        _card_matches_cpu(config.replace(**lever), start, None,
                          f"bench scene, {name}")
    kernel = compaction_kernel.compact_rows_t
    dynamic = int((settled.inv_mass[0] > 0).sum())
    tick = int(settled.tick[0]) + LEVER_SUBSTEPS
    launches, rates = {}, {}
    for name, lever in (("default", {}),) + tuple(LEVERS.items()):
        step = make_batched_step_fn(config.replace(**lever),
                                    substeps=LEVER_SUBSTEPS, device="cuda")
        kernel.launches = 0
        _, secs = _timed_run(step, settled, f"bench {name}", tick)
        launches[f"bench_{name}"] = {"compact_rows_t": kernel.launches}
        if kernel.launches != LEVER_SUBSTEPS:
            raise AssertionError(f"bench {name}: compact_rows_t launched "
                                 f"{kernel.launches} times in "
                                 f"{LEVER_SUBSTEPS} substeps")
        rates[name] = WORLDS * dynamic * LEVER_SUBSTEPS / secs
        log(f"bench {name}: {WORLDS} worlds x {dynamic} dynamic bodies from "
            f"the settled batch, {LEVER_SUBSTEPS} substeps in {secs:.3f} s "
            f"({secs / LEVER_SUBSTEPS * 1e3:.3f} ms/substep): "
            f"{rates[name]:.1f} body-steps/s on {card}; overflow 0, "
            f"compact_rows_t launches {kernel.launches}")
    log(f"bench levers, body-steps/s in one call: "
        f"{ {k: round(v, 1) for k, v in rates.items()} }; bf16 products "
        f"through {solver.bf16_product_route('cuda')!r}")
    return launches


def referee_dantzig_config():
    """``tests/_traj_engine.py:30-39``'s ``make_cfg("dantzig")``, by value:
    the direct LCP solve, exact box clipping, K=8, float64, 96 rows."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    return EngineConfig(**dict(CONF_CAPS, max_contacts=96), dtype="float64",
                        solver=SolverKind.DANTZIG, exact_box_clip=True,
                        max_contacts_per_pair=8, matmul_precision="highest")


def _one_substep_profile(config, batch, mesh=None, joints=None):
    """Launches and kernel time of one substep under ``torch.profiler``."""
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    one = make_batched_step_fn(config, substeps=1, device="cuda",
                               trimesh=mesh, joints=joints)
    return _launches_of(lambda: one(batch))


def _keeping_rounds(drive):
    """``drive()`` with ``lcp_kernel.lcp_pivot_solve`` wrapped so that each
    call's outputs are kept: the rounds (B,) and the live normal rows
    (B, R) of every solve a graph captured, which its replays write anew.
    Returns (what ``drive()`` returned, [(rounds, live normals), ...])."""
    import functools
    from rl_ode_physics_tpu_torch.ops import lcp_kernel
    pivot, kept = lcp_kernel.lcp_pivot_solve, []

    @functools.wraps(pivot)
    def keeping(a_mat, b, valid, is_normal, *args, **kwargs):
        out = pivot(a_mat, b, valid, is_normal, *args, **kwargs)
        kept.append((out[1], valid & is_normal))
        return out

    # the wrapper counts its launches on the module's name for it
    keeping.launches = pivot.launches
    lcp_kernel.lcp_pivot_solve = keeping
    try:
        out = drive()
    finally:
        lcp_kernel.lcp_pivot_solve = pivot
        pivot.launches = keeping.launches
    return out, kept


def _no_host_read(solve):
    """``solve()`` under ``torch.cuda.set_sync_debug_mode("error")``: raises
    if any of its operations waits on the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = solve()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def phase_dantzig(card, stack, ridge):
    """DANTZIG in float64, graphed: card against CPU on the settled mini
    stack; dantzig-1024 (the referee's DANTZIG configuration on the settled
    stack's first world in 1,024 worlds: a warm-up launch of 2 substeps and
    a timed one of 4, each one graph) with ``lcp_pivot_solve`` once a
    solve, the per-world pivot rounds read from the kernel's (B,) output
    of the timed launch's solves after the run, the solve of one more
    substep under ``set_sync_debug_mode("error")`` (no host read), one
    substep's launches and kernel time and the peak memory; then the ridge
    mesh under it, the float64 tile kernel and the pivot kernel once a
    substep. The pivot kernel's arguments of one more substep of each are
    caught eagerly, for phase 19b. Returns ({path: launches}, those
    arguments, the two settled batches)."""
    import torch
    from rl_ode_physics_tpu_torch.ops import (
        broadphase, integrator, lcp, lcp_kernel, narrowphase)
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate, take_worlds)
    from rl_ode_physics_tpu_torch.utils import graphs

    config = referee_dantzig_config()
    _card_matches_cpu(config, stack, None, "DANTZIG float64, mini stack",
                      atol=CONF_ATOL)

    batch = replicate(take_worlds(stack, 0, 1), CONF_WORLDS, device="cuda")
    for fn in _hand_kernels():
        fn.launches = 0
    tick = int(stack.tick[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch, warm_s = _timed_run(
        make_batched_step_fn(config, substeps=DANTZIG_WARMUP, device="cuda"),
        batch, "DANTZIG path", tick + DANTZIG_WARMUP)
    step = make_batched_step_fn(config, substeps=DANTZIG_SUBSTEPS,
                                device="cuda")
    if not step.graphed:
        raise AssertionError(f"DANTZIG path eager: {step.eager_reason}")
    (batch, secs), kept = _keeping_rounds(lambda: _timed_run(
        step, batch, "DANTZIG path",
        tick + DANTZIG_WARMUP + DANTZIG_SUBSTEPS))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {fn.__name__: fn.launches for fn in _hand_kernels()}
    want = {"compact_rows_t": 0,
            "collide_pairs": DANTZIG_WARMUP + DANTZIG_SUBSTEPS,
            "sphere_mesh_d2_tiles": 0, "sphere_mesh_d2": 0, "pgs_solve": 0,
            "lcp_pivot_solve": DANTZIG_WARMUP + DANTZIG_SUBSTEPS}
    if launches != want:
        raise AssertionError(f"DANTZIG path launches {launches}, expected "
                             f"{want}")
    # the warm-up body call first, then the captured solves the replay ran
    kept = kept[-DANTZIG_SUBSTEPS:]
    rounds = torch.stack([r for r, _ in kept])
    contacts = torch.stack([live.sum(1) for _, live in kept])
    if int(rounds.min()) < 1 or int(rounds.max()) >= lcp.MAX_PIVOT_ROUNDS:
        raise AssertionError(f"DANTZIG path: pivot rounds "
                             f"{int(rounds.min())}-{int(rounds.max())}")
    spread = {int(k): int(v) for k, v in zip(*torch.unique(
        rounds, return_counts=True))}
    del kept
    # the solve of one more substep: no host read
    contacts_now = narrowphase.narrowphase(
        batch, broadphase.broadphase(batch, config), config)
    state = integrator.apply_external_forces(batch, config)
    solved = _no_host_read(
        lambda: lcp.solve_dantzig(state, contacts_now, config))
    if not bool(torch.isfinite(solved.linvel).all()):
        raise AssertionError("DANTZIG path: non-finite solve")
    del contacts_now, state, solved
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    with_eager = make_batched_step_fn(config, substeps=1, device="cuda")
    with graphs.disable_graphs():
        with_eager(batch)
    torch.cuda.synchronize()
    eager_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    prof = _one_substep_profile(config, batch)
    dynamic = int((stack.inv_mass[0] > 0).sum())
    substep_ms = secs / DANTZIG_SUBSTEPS * 1e3
    log(f"DANTZIG path (referee configuration, float64, "
        f"{3 * config.max_contacts} rows), graphed: {CONF_WORLDS} worlds x "
        f"{dynamic} dynamic bodies of the settled mini stack, "
        f"{DANTZIG_SUBSTEPS} substeps in {secs:.3f} s ({substep_ms:.3f} "
        f"ms/substep; warm-up launch of {DANTZIG_WARMUP} substeps with its "
        f"capture {warm_s:.3f} s): "
        f"{CONF_WORLDS * dynamic * DANTZIG_SUBSTEPS / secs:.1f} body-steps/s"
        f" on {card}; overflow 0; contacts per world "
        f"{int(contacts.min())}-{int(contacts.max())}; pivot rounds per "
        f"world of the timed substeps' solves (the kernel's output) "
        f"{int(rounds.min())}-{int(rounds.max())}, worlds by rounds "
        f"{spread}; host reads 0 (the substeps are one graph, and one "
        f"solve under set_sync_debug_mode('error') ran); peak memory "
        f"{peak_gb:.3f} GB with the graphs' capture, {eager_peak_gb:.3f} GB "
        f"above the batch for one eager substep; one graphed substep under "
        f"torch.profiler: {prof['launches']} launches, "
        f"{prof['device_ms']:.3f} ms of kernel time, idle "
        f"{max(0.0, 1.0 - prof['device_ms'] / substep_ms):.3f} of the "
        f"untraced substep; hand kernel launches {launches}")
    one = make_batched_step_fn(config, substeps=1, device="cuda")
    _, args = _caught_last(lcp_kernel, "lcp_pivot_solve",
                           lambda: one(batch), "DANTZIG path", 1)
    del contacts, rounds
    torch.cuda.empty_cache()

    state, mesh = ridge
    mesh = mesh.to("cuda")
    rbatch = replicate(take_worlds(state, 0, 1), CONF_WORLDS, device="cuda")
    for fn in _hand_kernels():
        fn.launches = 0
    rstep = make_batched_step_fn(config, substeps=DANTZIG_RIDGE_SUBSTEPS,
                                 device="cuda", trimesh=mesh)
    (rbatch, rsecs), rkept = _keeping_rounds(lambda: _timed_run(
        rstep, rbatch, "DANTZIG ridge mesh",
        int(state.tick[0]) + DANTZIG_RIDGE_SUBSTEPS))
    rlaunches = {fn.__name__: fn.launches for fn in _hand_kernels()}
    want = {"compact_rows_t": 0, "collide_pairs": DANTZIG_RIDGE_SUBSTEPS,
            "sphere_mesh_d2_tiles": DANTZIG_RIDGE_SUBSTEPS,
            "sphere_mesh_d2": 0, "pgs_solve": 0,
            "lcp_pivot_solve": DANTZIG_RIDGE_SUBSTEPS}
    if rlaunches != want:
        raise AssertionError(f"DANTZIG ridge mesh launches {rlaunches}, "
                             f"expected {want}")
    rrounds = torch.stack([r for r, _ in rkept[-DANTZIG_RIDGE_SUBSTEPS:]])
    rcontacts = torch.stack([live.sum(1) for _, live
                             in rkept[-DANTZIG_RIDGE_SUBSTEPS:]])
    del rkept
    rprof = _one_substep_profile(config, rbatch, mesh)
    rsub_ms = rsecs / DANTZIG_RIDGE_SUBSTEPS * 1e3
    log(f"DANTZIG ridge mesh (float64), graphed: {CONF_WORLDS} worlds of "
        f"the settled ridge scene, {DANTZIG_RIDGE_SUBSTEPS} substeps in "
        f"{rsecs:.3f} s ({rsub_ms:.3f} ms/substep) on {card}; overflow 0; "
        f"contacts per world {int(rcontacts.min())}-{int(rcontacts.max())};"
        f" pivot rounds per world {int(rrounds.min())}-"
        f"{int(rrounds.max())}; one graphed substep under torch.profiler: "
        f"{rprof['launches']} launches, {rprof['device_ms']:.3f} ms of "
        f"kernel time, idle "
        f"{max(0.0, 1.0 - rprof['device_ms'] / rsub_ms):.3f}; launches "
        f"{rlaunches} (the float64 tile kernel and the pivot kernel once a "
        f"substep)")
    rone = make_batched_step_fn(config, substeps=1, device="cuda",
                                trimesh=mesh)
    _, rargs = _caught_last(lcp_kernel, "lcp_pivot_solve",
                            lambda: rone(rbatch), "DANTZIG ridge mesh", 1)
    return ({"dantzig_mini_stack": launches, "dantzig_ridge_mesh": rlaunches},
            {"dantzig-1024": args, "ridge": rargs},
            {"dantzig": batch, "ridge": (rbatch, mesh)})


def _capsule_pile_args():
    """The pivot kernel's arguments on the capsule pile: ``capsule_pile_
    world`` under ``referee_dantzig_config()``, one world settled
    ``LCP_PILE_SETTLE`` substeps on the card (graphed), then replicated to
    ``CONF_WORLDS`` worlds; one more substep's arguments caught on an eager
    run, which the graphed run equals bitwise."""
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.ops import lcp_kernel
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)
    config = referee_dantzig_config()
    world = scenes.capsule_pile_world(config, device="cuda")
    settle = make_batched_step_fn(config, substeps=LCP_PILE_SETTLE,
                                  device="cuda")
    if not settle.graphed:
        raise AssertionError(f"capsule pile eager: {settle.eager_reason}")
    world = settle(world)
    if int(world.overflow.sum()) != 0:
        raise AssertionError("capsule pile: overflow while settling")
    batch = replicate(world, CONF_WORLDS, device="cuda")
    one = make_batched_step_fn(config, substeps=1, device="cuda")
    _, args = _caught_last(lcp_kernel, "lcp_pivot_solve", lambda: one(batch),
                           "capsule pile", 1)
    return args


def phase_lcp_kernel(card, dantzig_args):
    """``lcp_pivot_solve`` against its plain version, ``lcp._pivot_solve``,
    on the card: on dantzig-1024's own (A, b, masks, μ) of one substep,
    the same under μ = 0.4 (boxed rows), the ridge path's, the capsule
    pile's (``_capsule_pile_args``: ~42 valid rows a world, past the
    float64 stage), 16 synthetic worlds of 96 contacts
    (``testing/lcp_systems``) with all 288 rows valid in half of them and
    10 contacts in the others, and one synthetic world at each tier
    boundary of the dtype (``lcp_kernel.boundary_counts``; the worlds of
    the large tier's shared rows ± 1 also launched alone, to show that the
    + 1 world takes the blocked elimination and the − 1 world does not),
    and one world of every row valid past the R whose panel fits shared
    memory (``far``: 600 rows in float64, 1,149 in float32). Float64: λ
    within ``LCP_F64_RTOL`` of max |λ| and each world's rounds equal;
    float32: the velocity change in constraint space, A·λ, within
    ``LCP_F32_RTOL`` of its largest (ROADMAP's float32 trap); each world
    taken by the tier of its valid count (the kernel's counters). The
    kernel and the plain version timed on each but the μ = 0.4 case
    (where the plain version's rounds may run long), beside the bound and
    the chain floor (``utils/bounds.lcp_pivot_bound``); the launch's
    shape, its launches a solve and each tier kernel's registers and
    spills. Returns the kernels line's entry. Also the device memory that
    one dantzig-1024 solve takes above its inputs, of the kernel and of the
    plain version."""
    import numpy as np
    import torch
    from rl_ode_physics_tpu_torch.ops import lcp, lcp_kernel
    from rl_ode_physics_tpu_torch.testing.lcp_systems import (
        random_contact_lcp, tier_boundary_lcp)
    from rl_ode_physics_tpu_torch.utils.bounds import (
        lcp_active_rows, lcp_pivot_bound)
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    a_mat, b, valid, is_normal, friction, mu = dantzig_args["dantzig-1024"]
    ridge = dantzig_args["ridge"]
    pile = _capsule_pile_args()
    synth = random_contact_lcp(LCP_SYNTH_SEED, worlds=LCP_SYNTH_WORLDS,
                               contacts=96, bodies=128, live=1.0)
    synth[2][1::2] = np.tile(np.arange(96) < 10, 3)

    def on_card(system):
        return tuple(None if x is None else torch.from_numpy(x).to("cuda")
                     for x in system)

    cases = {"dantzig-1024": (a_mat, b, valid, is_normal, mu),
             "dantzig-1024, mu 0.4": (a_mat, b, valid, is_normal,
                                      torch.full_like(mu, 0.4)),
             "ridge": ridge[:4] + (ridge[5],),
             "capsule pile": pile[:4] + (pile[5],),
             "synthetic, 288 rows valid": on_card(synth)}
    timed = ("dantzig-1024", "ridge", "capsule pile",
             "synthetic, 288 rows valid", "tier boundaries",
             "past the shared panel")

    def held(system, f, label):
        a, bb, v, n, m = system
        a, bb = a.to(f).contiguous(), bb.to(f)
        m = None if m is None else m.to(f)
        before = lcp_kernel.lcp_pivot_solve.launches
        lam, rounds = lcp_kernel.lcp_pivot_solve(a, bb, v, n, friction, m)
        if lcp_kernel.lcp_pivot_solve.launches != before + 1:
            raise AssertionError(f"lcp_pivot_solve {label}: not one launch")
        # the tiers from a second launch's counters, which must give the
        # same bits
        again, _, counters = lcp_kernel.launch(a, bb, v, n, friction, m)
        if not torch.equal(again, lam):
            raise AssertionError(f"lcp_pivot_solve {label}: two launches "
                                 f"differ")
        counts = v.sum(1).tolist()
        tiers = lcp_kernel.tier_counts(len(counts), counters)
        want_tiers = {t: sum(lcp_kernel.tier_of(v.shape[1], c) == t
                             for c in counts) for t in lcp_kernel.TIERS}
        if {t: tiers[t] for t in lcp_kernel.TIERS} != want_tiers:
            raise AssertionError(f"lcp_pivot_solve {label} ({f}): tiers "
                                 f"{tiers}, by the valid counts {want_tiers}")
        want, want_rounds = lcp._pivot_solve(a, bb, v, n, friction, m)
        torch.cuda.synchronize()
        if not bool((lam[~v] == 0).all()):
            raise AssertionError(f"lcp_pivot_solve {label}: an invalid row "
                                 f"is not 0")
        scale = float(want.abs().max())
        if f == torch.float64:
            err = float((lam - want).abs().max())
            rel, tol = err / scale, LCP_F64_RTOL
            if not torch.equal(rounds, want_rounds):
                differ = int((rounds != want_rounds).sum())
                raise AssertionError(f"lcp_pivot_solve {label}: {differ} "
                                     f"worlds take other rounds than the "
                                     f"plain version")
        else:
            moved = torch.bmm(a, want[..., None])
            err = float(torch.bmm(a, (lam - want)[..., None]).abs().max())
            rel, tol = err / float(moved.abs().max()), LCP_F32_RTOL
        if not rel <= tol:
            raise AssertionError(f"lcp_pivot_solve {label} ({f}): "
                                 f"{rel:.3e} of the plain version's scale "
                                 f"> {tol}")
        return dict(max_abs_err=float((lam - want).abs().max()),
                    rel_err=rel, max_abs_lam=scale,
                    rounds=[int(rounds.min()), int(rounds.max())],
                    valid_rows=[min(counts), max(counts)], tiers=tiers,
                    shape=list(v.shape)), (a, bb, v, n, m), lam, rounds

    def blocked_alone(system, f, count, nm):
        # the world of ``count`` valid rows launched alone: whether its
        # solves took the blocked elimination (more than nm active rows)
        w = system[2].sum(1).tolist().index(count)
        one = [x[w:w + 1].contiguous() for x in system[:4]]
        _, _, counters = lcp_kernel.launch(one[0].to(f), one[1].to(f),
                                           *one[2:], friction)
        tiers = lcp_kernel.tier_counts(1, counters)
        if tiers["large"] != 1 or (tiers["blocked_solves"] > 0) != (
                count > nm):
            raise AssertionError(f"lcp_pivot_solve ({f}): the world of "
                                 f"{count} valid rows (shared rows {nm}) "
                                 f"took {tiers}")
        return tiers["blocked_solves"]

    out = {}
    for f in (torch.float64, torch.float32):
        name = "float64" if f == torch.float64 else "float32"
        bounds = lcp_kernel.boundary_counts(f, 288)
        cases["tier boundaries"] = on_card(tier_boundary_lcp(bounds))
        nm = lcp_kernel.launch_shape(f, 1, 288).shared_rows
        blocked = {c: blocked_alone(cases["tier boundaries"], f, c, nm)
                   for c in (nm - 1, nm + 1)}
        far_rows = 600 if f == torch.float64 else 1149
        if not lcp_kernel.launch_shape(f, 1, far_rows).far or \
                lcp_kernel.launch_shape(f, 1, far_rows - 3).far:
            raise AssertionError(f"lcp_pivot_solve ({f}): R = {far_rows} is "
                                 f"not the first R past the shared panel")
        cases["past the shared panel"] = on_card(
            tier_boundary_lcp([far_rows], contacts=far_rows // 3))
        records = {}
        for label, system in cases.items():
            rec, (a, bb, v, n, m), lam, rounds = held(system, f, label)
            if label == "past the shared panel" and \
                    not rec["tiers"]["blocked_solves"]:
                raise AssertionError(f"lcp_pivot_solve ({f}): R = "
                                     f"{far_rows} took no blocked solve")
            if label in timed:
                rec["ms"] = cuda_ms(lambda: lcp_kernel.lcp_pivot_solve(
                    a, bb, v, n, friction, m), iters=5)
                rec["plain_ms"] = cuda_ms(lambda: lcp._pivot_solve(
                    a, bb, v, n, friction, m), iters=2)
                bound = lcp_pivot_bound(
                    v, rounds, f, m is not None,
                    active=lcp_active_rows(lam, v, n, friction, m))
                rec.update({k: bound[k] for k in (
                    "bound_ms", "bound_by", "bytes_ms", "ops_ms",
                    "chain_ms")})
                if v.shape[0] >= 4 * lcp_kernel.SMS:
                    # one world an SM: a world's own latency
                    sub = [None if x is None else x[:lcp_kernel.SMS]
                           .contiguous() for x in (a, bb, v, n, m)]
                    rec["ms_one_world_an_sm"] = cuda_ms(
                        lambda: lcp_kernel.lcp_pivot_solve(
                            *sub[:4], friction, sub[4]), iters=5)
            records[label] = rec
            del a, bb, v, n, m, lam
        del cases["past the shared panel"]
        shape = lcp_kernel.launch_shape(f, valid.shape[0], valid.shape[1])
        res = lcp_kernel.resources(f)
        if 8 * (res["staged"]["static_shared"] + 1024) > \
                lcp_kernel.SM_SHARED:
            raise AssertionError(f"lcp_pivot_solve ({f}): the staged tier's "
                                 f"{res['staged']['static_shared']} bytes "
                                 f"do not let 8 blocks share an SM")
        path = records["dantzig-1024"]
        # device memory a solve takes above its inputs, kernel and plain
        a, bb = a_mat.to(f), b.to(f)
        m = mu.to(f)
        for key, solve in (("peak_mb", lcp_kernel.lcp_pivot_solve),
                           ("plain_peak_mb", lcp._pivot_solve)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            solve(a, bb, valid, is_normal, friction, m)
            torch.cuda.synchronize()
            path[key] = (torch.cuda.max_memory_allocated() - base) / 1e6
        del a, bb, m
        out[name] = dict(
            max_abs_err=max(r["max_abs_err"] for r in records.values()),
            ms=path["ms"], plain_ms=path["plain_ms"],
            bound_ms=path["bound_ms"], bound_by=path["bound_by"],
            bytes_ms=path["bytes_ms"], ops_ms=path["ops_ms"],
            chain_ms=path["chain_ms"], library_ms=None, cases=records,
            launch_shape=shape._asdict(), launches_a_solve=shape.launches,
            registers=res["staged"]["registers"],
            local_bytes=res["staged"]["local_bytes"], resources=res,
            blocked_solves_alone=blocked, peak_mb=path["peak_mb"],
            plain_peak_mb=path["plain_peak_mb"])
        for label, r in records.items():
            times = ("" if "ms" not in r else
                     f" kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.3f}"
                     f" bound_ms={r['bound_ms']:.6f} ({r['bound_by']}; bytes"
                     f" {r['bytes_ms']:.6f}, operations {r['ops_ms']:.6f})"
                     f" chain_ms={r['chain_ms']:.6f}"
                     + ("" if "ms_one_world_an_sm" not in r else
                        f"; the first {lcp_kernel.SMS} worlds alone (one an"
                        f" SM) {r['ms_one_world_an_sm']:.5f} ms"))
            held_on = ("λ, the same rounds a world" if f == torch.float64
                       else "A·λ")
            log(f"lcp_pivot_solve {name}, {label} (B={r['shape'][0]} "
                f"worlds, R={r['shape'][1]} rows, {r['valid_rows'][0]}-"
                f"{r['valid_rows'][1]} valid a world, rounds "
                f"{r['rounds'][0]}-{r['rounds'][1]}; worlds by tier "
                f"{r['tiers']}): {r['rel_err']:.3e} of the plain version's "
                f"scale ({held_on}), max abs err {r['max_abs_err']:.3e};"
                f"{times} on {card}")
        tiers = ", ".join(f"{t} {v['registers']} registers, "
                          f"{v['local_bytes']} local bytes and "
                          f"{v['static_shared']} static shared bytes"
                          for t, v in res.items())
        log(f"lcp_pivot_solve {name}: {shape.launches} launches a solve at "
            f"R={valid.shape[1]} (the counters' memset and the staged, "
            f"medium and large tiers' kernels); staged up to "
            f"{shape.staged_rows} valid rows, medium up to "
            f"{shape.medium_rows} ({shape.medium_blocks} blocks), large "
            f"{shape.large_blocks} blocks of {shape.large_bytes} bytes, "
            f"active blocks of up to {shape.shared_rows} rows in shared "
            f"memory, slots of {shape.slot_bytes} bytes for the blocked "
            f"elimination (past R = {far_rows - 3} the panel and vectors "
            f"in the slot); tier boundaries {bounds}, blocked solves of "
            f"the shared rows ± 1 worlds alone {blocked}; {tiers}; a "
            f"dantzig-1024 solve takes {path['peak_mb']:.1f} MB of device "
            f"memory above its inputs, the plain version "
            f"{path['plain_peak_mb']:.1f} MB; library_ms=null (no one "
            f"PyTorch call runs the pivot loop)")
    entry = dict(name="lcp_pivot_solve", route="cuda",
                 source="rl_ode_physics_tpu_torch/csrc/lcp_pivot.cu",
                 replaces="rl_ode_physics_tpu/ops/lcp.py:206",
                 launches=None, dtype="float64", **out["float64"])
    entry["f32"] = out["float32"]
    return entry


def phase_hinge_chain(card):
    """``hinge_chain_scene``, card against CPU under the referee's PGS and
    DANTZIG in float64 (their joint passes ``pgs_solve``, in the sweeps
    and alone) and under ``hinge_chain_config`` (throughput JACOBI) in
    float32; then 8,192 worlds under that JACOBI configuration and 1,024
    under PGS in float64, graphed, the PGS kernel's arguments caught on
    one more substep. Returns ({path: launches}, those arguments, the PGS
    batch and its joint table)."""
    import torch
    from rl_ode_physics_tpu_torch.core.config import (
        SolverKind, hinge_chain_config)
    from rl_ode_physics_tpu_torch.models.scenes import hinge_chain_scene
    from rl_ode_physics_tpu_torch.ops import joints as joint_ops
    from rl_ode_physics_tpu_torch.ops import lcp_kernel, pgs_kernel, solver
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)

    jacobi = hinge_chain_config()
    pgs, pivot = pgs_kernel.pgs_solve, lcp_kernel.lcp_pivot_solve
    paths = {}
    for label, config, atol in (
            ("PGS float64", referee_config(), CONF_ATOL),
            ("DANTZIG float64", referee_dantzig_config(), CONF_ATOL),
            ("throughput JACOBI float32", jacobi, 1e-4)):
        world, joints = hinge_chain_scene(config, device="cpu")
        start = settled_on_cpu(config, world, None, HINGE_SETTLE,
                               kick_seed=5, joints=joints)
        before = (pgs.launches, pivot.launches)
        _card_matches_cpu(config, start, None, f"hinge chain, {label}",
                          atol=atol, joints=joints)
        want = 0 if config.solver is SolverKind.JACOBI else 8
        want_pivot = 8 if config.solver is SolverKind.DANTZIG else 0
        got = (pgs.launches - before[0], pivot.launches - before[1])
        if got != (want, want_pivot):
            raise AssertionError(f"hinge chain, {label}: pgs_solve and "
                                 f"lcp_pivot_solve launched {got} times in "
                                 f"8 card substeps")
        if want:
            paths[f"hinge_chain_card_vs_cpu_{config.solver.name.lower()}"] = {
                "pgs_solve": want, "lcp_pivot_solve": want_pivot}

    caught = None
    for label, config, worlds, warm, timed in (
            ("hinge_chain_jacobi", jacobi, WORLDS, HINGE_WARMUP,
             HINGE_SUBSTEPS),
            ("hinge_chain_pgs_f64", referee_config(), CONF_WORLDS, 2,
             HINGE_PGS_SUBSTEPS)):
        world, joints = hinge_chain_scene(config, device="cuda")
        batch = kicked(replicate(world, worlds, device="cuda"), 6)
        for fn in _hand_kernels():
            fn.launches = 0
        batch, warm_s = _timed_run(
            make_batched_step_fn(config, substeps=warm, device="cuda",
                                 joints=joints), batch, label, warm)
        batch, secs = _timed_run(
            make_batched_step_fn(config, substeps=timed, device="cuda",
                                 joints=joints), batch, label, warm + timed)
        launches = {fn.__name__: fn.launches for fn in _hand_kernels()}
        is_pgs = config.solver is SolverKind.PGS
        want = {"compact_rows_t": (warm + timed
                                   if config.typed_buckets else 0),
                "collide_pairs": (0 if config.typed_buckets
                                  else warm + timed),
                "sphere_mesh_d2_tiles": 0, "sphere_mesh_d2": 0,
                "pgs_solve": warm + timed if is_pgs else 0,
                "lcp_pivot_solve": 0}
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected "
                                 f"{want}")
        prof = _one_substep_profile(config, batch, joints=joints)
        # one joint pass alone: the batched one under JACOBI; under PGS the
        # kernel's joint-only entry (all of a solve's passes, one launch)
        rows = joint_ops.joint_rows(batch, joints, config)
        vel = torch.cat([batch.linvel, batch.angvel], -1)
        if is_pgs:
            params = dict(solver.pgs_params(config), omega=1.0)
            joint_pass = _launches_of(lambda: pgs_kernel.pgs_solve(
                vel, None, None, rows, **params))
            what = (f"pgs_solve joint-only entry ({config.solver_iterations}"
                    f" passes)")
        else:
            vel8 = torch.cat([vel, torch.zeros_like(vel[..., :2])], -1)
            joint_pass = _launches_of(lambda: joint_ops.joint_iteration(
                vel8, rows, torch.zeros_like(rows["rhs"]),
                config.jacobi_omega, config.cfm / config.dt))
            what = (f"joint_iteration ({config.solver_iterations} a "
                    f"substep)")
        dynamic = int((world.inv_mass[0] > 0).sum())
        substep_ms = secs / timed * 1e3
        log(f"{label}, graphed: {worlds} worlds x {dynamic} dynamic bodies, "
            f"2 joints each, {timed} substeps in {secs:.3f} s "
            f"({substep_ms:.3f} ms/substep; warm-up {warm} substeps "
            f"{warm_s:.3f} s): {worlds * dynamic * timed / secs:.1f} "
            f"body-steps/s on {card}; overflow 0; one substep under "
            f"torch.profiler: {prof['launches']} kernels, "
            f"{prof['device_ms']:.3f} ms of kernel time; one {what}: "
            f"{joint_pass['launches']} kernels; hand kernel launches "
            f"{launches}")
        paths[label] = launches
        if is_pgs:
            one = make_batched_step_fn(config, substeps=1, device="cuda",
                                       joints=joints)
            _, args = _caught_last(pgs_kernel, "pgs_solve",
                                   lambda: one(batch), label, 1)
            caught = (_pgs_args(args), batch, joints)
        else:
            del batch
        torch.cuda.empty_cache()
    return paths, caught


def _scattered_rows(lam, rows, seed):
    """Each world's rows in a seeded random order of its own: the path's
    live rows scattered over the buffer."""
    import torch
    bsz, c = rows["valid"].shape
    gen = torch.Generator("cuda").manual_seed(seed)
    perm = torch.argsort(torch.rand((bsz, c), generator=gen, device="cuda"),
                         1)
    ar = torch.arange(bsz, device="cuda")[:, None]
    return lam[ar, perm], {k: None if v is None else v[ar, perm]
                           for k, v in rows.items()}


def _all_rows_live(lam, rows):
    """Every one of a world's C rows live: row c a copy of its live row
    c mod (its live count), in buffer order."""
    import torch
    valid = rows["valid"]
    bsz, c = valid.shape
    count = valid.sum(1, keepdim=True)
    if not bool((count > 0).all()):
        raise AssertionError("a world without a live row to repeat")
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    src = order.gather(1, torch.arange(c, device="cuda")[None] % count)
    ar = torch.arange(bsz, device="cuda")[:, None]
    out = {k: None if v is None else v[ar, src] for k, v in rows.items()}
    out["valid"] = torch.ones_like(valid)
    return lam[ar, src], out


def phase_pgs_kernel(card, conf_args, hinge_args):
    """``pgs_solve`` against its plain version at full width, on the
    tensors the conformance path (1,024 worlds, float64), its ridge half
    and the PGS hinge chain path handed it: each friction case (as on the
    path: μ = ∞; μ = 0.4; a μ per row, a third of them ∞; no friction at
    ω = 1), cold and warm (random impulses on the live rows), the path's
    rows scattered over each world's buffer, and every row live (each
    world's live rows repeated over its 256: more than ``staged_rows`` in
    both dtypes, so the rows past S are read from device memory); the
    ridge path's rows; the hinge chain's joint rows in the sweeps, and its
    joint passes alone (the joint-only entry, ω = 1); the path's rows in
    worlds of ``max_slots`` + 1 slots (velocities in device memory), timed
    beside the same in worlds of ``max_slots`` (in shared); in float64 within
    ``PGS_ATOL_F64`` and float32 within ``PGS_ATOL_F32``. The kernel alone
    (launches on the path's own unpacked tensors, prepared once), the
    wrapper and the plain loop timed on the path's own inputs in each
    dtype, beside the bound and the chain floor; the launch's shape (W, S,
    shared bytes), every path's largest live-row count against S, and the
    built kernel's registers and local (spilled) bytes. Returns the
    kernels line's entry."""
    import torch
    from rl_ode_physics_tpu_torch.ops import pgs_kernel, solver
    from rl_ode_physics_tpu_torch.utils.bounds import pgs_bound
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms

    keys = ("iterations", "omega", "cfm_term", "friction", "mu",
            "per_body_surface")
    conf, ridge = conf_args["conformance"], conf_args["ridge"]
    base = {k: conf[k] for k in keys}
    rows64 = conf["rows"]
    vel64, lam64 = conf["vel"], conf["lam"]
    valid = rows64["valid"]
    gen = torch.Generator("cuda").manual_seed(11)
    mu_row = 0.2 + 0.8 * torch.rand(valid.shape, generator=gen,
                                    device="cuda", dtype=torch.float64)
    mu_row = torch.where(torch.rand(valid.shape, generator=gen,
                                    device="cuda") < 1 / 3, torch.inf, mu_row)
    warm_lam = torch.where(valid[..., None], 0.02 * torch.rand(
        lam64.shape, generator=gen, device="cuda", dtype=torch.float64), 0.0)
    scattered = _scattered_rows(lam64, rows64, 12)
    all_live = _all_rows_live(lam64, rows64)
    # label → (parameters over the path's, impulses and rows)
    cases = {"path": ({}, (lam64, rows64)),
             "path_warm": ({}, (warm_lam, rows64)),
             "mu_finite": (dict(mu=0.4), (lam64, rows64)),
             "per_body_surface": (dict(per_body_surface=True),
                                  (lam64, dict(rows64, mu=mu_row))),
             "no_friction": (dict(friction=False, omega=1.0),
                             (lam64, rows64)),
             "scattered": ({}, scattered),
             "all_live": ({}, all_live)}
    hv, hrows, hjrows = (hinge_args["vel"], hinge_args["rows"],
                         hinge_args["joints_rows"])
    hbase = {k: hinge_args[k] for k in keys}
    n_slots, c_rows = vel64.shape[1], valid.shape[1]
    live_max = {"conformance": int(valid.sum(1).max()),
                "ridge_mesh_conformance": int(ridge["rows"]["valid"]
                                              .sum(1).max()),
                "hinge_chain_pgs_contacts": int(hrows["valid"].sum(1).max()),
                "hinge_chain_joints": int(hjrows["live"].sum(1).max()),
                "all_live_case": c_rows}

    def cast(x, f):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: cast(v, f) for k, v in x.items()}
        return x.to(f) if x.is_floating_point() else x

    def held(vel, lam, rows, jrows, params, f, label):
        vel, lam, rows, jrows = (cast(x, f) for x in (vel, lam, rows, jrows))
        before = pgs_kernel.pgs_solve.launches
        got = pgs_kernel.pgs_solve(vel, lam, rows, jrows, **params)
        if pgs_kernel.pgs_solve.launches != before + 1:
            raise AssertionError(f"pgs_solve {label}: not one launch")
        want = solver.pgs_sweeps_plain(vel, lam, rows, jrows, **params)
        torch.cuda.synchronize()
        errs = [float((got[0] - want[0]).abs().max())]
        if lam is not None:
            errs.append(float((got[1] - want[1]).abs().max()))
        tol = PGS_ATOL_F64 if f == torch.float64 else PGS_ATOL_F32
        if not all(e <= tol for e in errs):
            raise AssertionError(f"pgs_solve {label} ({f}): differs from "
                                 f"its plain version by {errs} > {tol}")
        moved = float((got[0] - vel).abs().max())
        if not moved > 0:
            raise AssertionError(f"pgs_solve {label}: the rows did nothing")
        return max(errs)

    out = {}
    for f in (torch.float64, torch.float32):
        name = "float64" if f == torch.float64 else "float32"
        errs = {}
        for label, (over, (lam, rows)) in cases.items():
            errs[label] = held(vel64, lam, rows, None, dict(base, **over), f,
                               label)
        errs["ridge_path"] = held(ridge["vel"], ridge["lam"], ridge["rows"],
                                  None, {k: ridge[k] for k in keys}, f,
                                  "ridge path")
        errs["hinge_chain_joints"] = held(hv, hinge_args["lam"], hrows,
                                          hjrows, hbase, f, "hinge chain")
        errs["joint_only"] = held(hv, None, None, hjrows,
                                  dict(hbase, omega=1.0), f, "joint-only")
        # C3: worlds past max_slots keep their velocities in device memory;
        # the same rows in worlds of max_slots slots keep them in shared
        wide = {n: _past_the_most_slots(vel64, rows64, n) for n in (
            pgs_kernel.max_slots(f), pgs_kernel.max_slots(f) + 1)}
        wvel, wrows = wide[pgs_kernel.max_slots(f) + 1]
        errs["past_max_slots"] = held(wvel, lam64, wrows, None, base, f,
                                      "past max_slots")
        slots_ms = {}
        for n, (wvel, wrows) in wide.items():
            wvel, wrows = cast(wvel, f), cast(wrows, f)
            wl = cast(lam64, f)
            slots_ms[n] = cuda_ms(lambda: pgs_kernel.pgs_solve(
                wvel, wl, wrows, **base))
        del wide
        # the kernel alone, the wrapper and the plain loop on the path's
        # own inputs
        vel, lam, rows = (cast(x, f) for x in (vel64, lam64, rows64))
        mode = pgs_kernel.friction_mode(base["friction"], base["mu"],
                                        base["per_body_surface"])
        run = dict(iterations=base["iterations"], omega=base["omega"],
                   cfm_term=base["cfm_term"], mode=mode, mu=base["mu"])
        prepared = pgs_kernel.prepare(vel, lam, rows, None, mode)
        kernel_ms = cuda_ms(lambda: pgs_kernel.launch(prepared, **run))
        wrapper_ms = cuda_ms(lambda: pgs_kernel.pgs_solve(vel, lam, rows,
                                                          **base))
        plain_ms = cuda_ms(lambda: solver.pgs_sweeps_plain(
            vel, lam, rows, **base), iters=2)
        hprepared = pgs_kernel.prepare(
            cast(hv, f), cast(hinge_args["lam"], f), cast(hrows, f),
            cast(hjrows, f), mode)
        hinge_ms = cuda_ms(lambda: pgs_kernel.launch(hprepared, **dict(
            run, omega=hbase["omega"])))
        bound = pgs_bound(valid, None, n_slots, base["iterations"], f,
                          base["friction"])
        shape = pgs_kernel.launch_shape(f, n_slots, c_rows)
        hshape = hprepared.shape
        res = pgs_kernel.resources(f)
        del prepared, hprepared
        rows_per_world = valid.sum(1)
        out[name] = dict(
            max_abs_err=max(errs.values()), errors=errs, ms=kernel_ms,
            wrapper_ms=wrapper_ms, plain_ms=plain_ms,
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
            bytes_ms=bound["bytes_ms"], ops_ms=bound["ops_ms"],
            chain_ms=bound["chain_ms"], library_ms=None,
            hinge_chain_ms=hinge_ms,
            shape=[vel.shape[0], n_slots, c_rows],
            live_rows=[int(rows_per_world.min()), int(rows_per_world.max())],
            worlds_per_block=shape.worlds, staged_rows=shape.staged,
            shared_bytes=shape.shared_bytes,
            hinge_launch=list(hshape), paths_live_rows_max=live_max,
            registers=res["registers"], local_bytes=res["local_bytes"],
            wrapper_ms_by_slots={str(n): t for n, t in slots_ms.items()})
        past = {k: v for k, v in live_max.items() if v > shape.staged}
        log(f"pgs_solve {name} at conformance-1024's own inputs (B="
            f"{vel.shape[0]} worlds, N={n_slots} slots, C={c_rows} rows, "
            f"{int(rows_per_world.min())}-{int(rows_per_world.max())} live "
            f"a world, {base['iterations']} sweeps): every case within "
            f"{PGS_ATOL_F64 if f == torch.float64 else PGS_ATOL_F32} of the "
            f"plain version, max abs err {errs}; kernel_ms={kernel_ms:.5f} "
            f"wrapper_ms={wrapper_ms:.5f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound['bound_ms']:.6f} ({bound['bound_by']}; bytes "
            f"{bound['bytes_ms']:.6f}, operations {bound['ops_ms']:.6f}) "
            f"chain_ms={bound['chain_ms']:.5f} (the longest world's chain "
            f"floor); the hinge chain's solve with its joint rows "
            f"{hinge_ms:.5f} ms; library_ms=null (no one PyTorch call runs "
            f"a sequential sweep); launch W={shape.worlds} worlds a block, "
            f"S={shape.staged} staged rows a world, {shape.shared_bytes} "
            f"shared bytes a block (hinge chain: W, S, S_j, bytes "
            f"{tuple(hshape)}); the paths' largest live-row counts "
            f"{live_max}, past S: {past or 'none but the cases built so'}; "
            f"{res['registers']} registers a thread, {res['local_bytes']} "
            f"local bytes (spills); the wrapper on the path's rows in worlds "
            f"of N slots, velocities in shared memory up to max_slots and "
            f"in device memory past it: "
            f"{ {n: round(t, 5) for n, t in slots_ms.items()} } ms on "
            f"{card}")
    entry = dict(name="pgs_solve", route="cuda",
                 source="rl_ode_physics_tpu_torch/csrc/pgs_solve.cu",
                 replaces="rl_ode_physics_tpu/ops/solver.py:285",
                 launches=None, dtype="float64", **out["float64"])
    entry["f32"] = out["float32"]
    return entry


def _past_the_most_slots(vel, rows, n):
    """Worlds of ``n`` slots holding ``vel``'s bodies in their last slots,
    the rows' bodies moved with them."""
    import torch
    m = vel.shape[1]
    wide = torch.zeros((vel.shape[0], n, 6), dtype=vel.dtype,
                       device=vel.device)
    wide[:, n - m:] = vel
    return wide, dict(rows, a=rows["a"] + (n - m), b=rows["b"] + (n - m))


def _server_session(sim, ticks, timed_from, at_ticks=()):
    """Drive ``sim`` to ``ticks``: two capsule players join at tick 0,
    SERVER_SPAWNS_PER_TICK bodies of the M-key distribution (``m_key_body``
    from ``RandStream(0)``) spawn at each tick boundary of the first
    SERVER_SPAWN_TICKS, player 0 walks for SERVER_WALK_TICKS. Ticks from
    ``timed_from`` on are timed one by one, the card idle before and after
    each; each (tick, fn) of ``at_ticks`` calls fn(sim) before that
    tick's intents. Returns the timed ticks' ms."""
    import torch
    from rl_ode_physics_tpu_torch.net.client import m_key_body
    from rl_ode_physics_tpu_torch.utils.prng import RandStream
    rng = RandStream(0)
    for pid in (0, 1):
        if sim.player_join(pid) < 0:
            raise AssertionError("server session: a player was not seated")
    tick_ms = []
    while sim.tick < ticks:
        t = sim.tick
        for tick, fn in at_ticks:
            if t == tick:
                fn(sim)
        if t < SERVER_SPAWN_TICKS:
            for _ in range(SERVER_SPAWNS_PER_TICK):
                if sim.spawn_body(*m_key_body(rng)) < 0:
                    raise AssertionError("server session: a spawn was "
                                         "dropped")
        if t < SERVER_WALK_TICKS:
            sim.player_move(0, (0.05 * t, 2.0, -3.0 + 0.05 * t))
        if t >= timed_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.advance(1)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
        else:
            sim.advance(1)
    return tick_ms


def _tick_stats(tick_ms):
    import statistics
    mean = statistics.fmean(tick_ms)
    return dict(mean_ms=mean, min_ms=min(tick_ms), max_ms=max(tick_ms),
                stdev_ms=statistics.pstdev(tick_ms), ticks_per_s=1e3 / mean)


def body_api_sequence(device):
    """The body API on 4 worlds of the arena with 8 slots (4 free): every
    function, with and without ``auto_mass``, a slot per world as a (B,)
    tensor, and one more spawn than there are free slots. Returns the
    batch and the slots each spawn returned."""
    import torch
    from rl_ode_physics_tpu_torch.core import world as w
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models.scenes import grass_plane_world
    from rl_ode_physics_tpu_torch.parallel.batch import replicate

    cfg = EngineConfig(max_bodies=8, max_pair_candidates=32, max_contacts=64)
    b = replicate(grass_plane_world(cfg, device=device), 4, device=device)
    per_world = torch.tensor([4, 5, 6, 7], device=device)
    slots = []
    b, s = w.add_body(b, 1, (0.0, 1.0, 0.0), (0.3, 0.0, 0.0))
    slots.append(s)
    b, s = w.add_body(b, torch.tensor([1, 2, 3, 2], device=device),
                      (0.5, 2.0, -1.0), (0.3, 0.7, 0.9),
                      quat=(0.5, 0.5, -0.5, 0.5), linvel=(1.0, 0.0, -2.0),
                      angvel=(0.0, 3.0, 0.0), auto_mass=True, density=1.3)
    slots.append(s)
    b, s = w.add_body_map(b, (1.0, 0.5, 1.0), (0.1, -0.2, 0.3),
                          (2.0, 0.5, 1.0), color=(9, 8, 7, 255))
    slots.append(s)
    b, s = w.add_body(b, 2, (0.0, 3.0, 0.0), (0.4, 0.4, 0.4),
                      kinematic=True, auto_mass=True)
    slots.append(s)
    b, s = w.add_body(b, 1, (0.0, 4.0, 0.0), (0.2, 0.0, 0.0))   # full
    slots.append(s)
    b = w.release_body(b, per_world)
    b, s = w.add_body(b, 3, (0.0, 5.0, 0.0), (0.2, 0.6, 0.0),
                      auto_mass=True, density=0.7, color=(1, 2, 3, 4))
    slots.append(s)
    b = w.set_body_pose(b, per_world, pos=(1.0, 2.0, 3.0),
                        quat=(0.0, 1.0, 0.0, 0.0), linvel=(0.5, 0.5, 0.5),
                        angvel=(-1.0, 0.0, 1.0))
    b = w.set_body_surface(b, 5, friction=0.4, restitution=0.6)
    b = w.add_force(b, per_world, (1.0, -2.0, 3.0))
    b = w.add_force(b, 6, (0.25, 0.25, 0.25))
    b = w.add_torque(b, -1, (0.0, 0.0, 9.0))
    return b, torch.stack(slots)


def _cli_session() -> str:
    """``python -m rl_ode_physics_tpu_torch.net server --device cuda`` and,
    once it prints "Server started", a ``client --spawn 3 --duration
    CLI_SERVER_SECONDS``: the server's window (``CLI_SERVER_WINDOW``)
    covers the client's import of torch and its whole run, and the server
    is ended with SIGINT (its ``KeyboardInterrupt`` closes it, rc 0) once
    the client is done. Raises unless the server returned 0 and the client
    mirrored 7 bodies (4 arena boxes and its 3); returns their lines."""
    import signal
    import socket
    import threading
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cli = [sys.executable, "-m", "rl_ode_physics_tpu_torch.net"]
    server = subprocess.Popen(
        cli + ["server", "--device", "cuda", "--port", str(port),
               "--duration", str(CLI_SERVER_WINDOW)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, started = [], threading.Event()

    def read():
        for line in server.stdout:
            lines.append(line)
            if "Server started" in line:
                started.set()
        started.set()                       # the server ended

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    client, said = None, ""
    try:
        if started.wait(CLI_SERVER_WINDOW) and server.poll() is None:
            client = subprocess.Popen(
                cli + ["client", "--spawn", "3", "--port", str(port),
                       "--duration", str(CLI_SERVER_SECONDS)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            said, _ = client.communicate(timeout=120)
            server.send_signal(signal.SIGINT)
        server.wait(timeout=120)
        reader.join(timeout=30)
    finally:
        for proc in (client, server):
            if proc is not None:
                proc.kill()
                proc.wait()
    out = "".join(lines)
    first = next((x for x in lines if "Server started" in x), "")
    if (server.returncode != 0 or not first
            or "mirrored 7 bodies" not in said):
        raise AssertionError(
            f"CLI: server rc {server.returncode} {out}; client rc "
            f"{None if client is None else client.returncode} {said}")
    return f"{first.strip()} {said.strip()}"


def phase_game_server(card):
    """The game server (``net/``) on the card: the body API card against
    CPU; SimCore at 512 slots under the CLI's classic policy (480 ticks,
    replayed bitwise, card against CPU at tick 400) and under the
    throughput policy (480 ticks, the first 240 replayed bitwise, the
    compaction kernel once a tick); a loopback session of ``GameServer``
    on the native transport with two clients; the CLI in subprocesses."""
    import dataclasses
    import torch
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.net import native_transport, protocol
    from rl_ode_physics_tpu_torch.net import replay as replay_m
    from rl_ode_physics_tpu_torch.net.client import GameClient
    from rl_ode_physics_tpu_torch.net.server import GameServer, SimCore

    # 1. the body API, card against CPU, every field bitwise
    card_b, card_slots = body_api_sequence("cuda")
    cpu_b, cpu_slots = body_api_sequence("cpu")
    if not torch.equal(card_slots.cpu(), cpu_slots):
        raise AssertionError("body API: slots differ between card and CPU")
    for f in dataclasses.fields(cpu_b):
        if not torch.equal(getattr(card_b, f.name).cpu(),
                           getattr(cpu_b, f.name)):
            raise AssertionError(f"body API: {f.name} differs between card "
                                 f"and CPU")
    log(f"body API on 4 worlds of 8 slots: every field bitwise card against "
        f"CPU; slots per spawn {cpu_slots.tolist()}")

    # 2. SimCore at full width, the CLI's configuration
    config = EngineConfig(**SERVER_CAPS)
    intents = ROOT / "build" / "server_intents.jsonl"
    intents.parent.mkdir(parents=True, exist_ok=True)
    for fn in _hand_kernels():
        fn.launches = 0
    held = {}

    def card_against_cpu(sim):
        held["start"] = _to(sim.world, "cpu")

    sim = SimCore(config, seed=0, player_capsules=True, device="cuda")
    t0 = time.perf_counter()
    tick_ms = _server_session(sim, SERVER_TICKS, SERVER_TIMED_FROM, at_ticks=(
        (SERVER_EAGER_TICKS,
         lambda s: held.update(eager_cli=s.state_digest())),
        (SERVER_TIMED_FROM, card_against_cpu)))
    live_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in _hand_kernels()}
    cli_launches = {"collide_pairs": SERVER_TICKS}
    if launches != dict(dict.fromkeys(launches, 0), **cli_launches):
        raise AssertionError(f"server, CLI policy: hand kernel launches "
                             f"{launches}, expected {cli_launches} and no "
                             f"other")
    if sim.check_overflow():
        raise AssertionError(f"server, CLI policy: overflow "
                             f"{int(sim.world.overflow[0])}")
    _check_batch(sim.world, "server, CLI policy", SERVER_TICKS)
    digests = {"cli": sim.state_digest(), "cli_eager": held.pop("eager_cli")}
    bodies = int(sim.world.active.sum())
    prof = _launches_of(lambda: sim._step1(sim.world))
    replay_m.save_log(sim.intent_log, str(intents))
    t0 = time.perf_counter()
    again = replay_m.replay(replay_m.load_log(str(intents)), SERVER_TICKS,
                            config, seed=0, player_capsules=True,
                            device="cuda")
    replay_s = time.perf_counter() - t0
    if again.state_digest() != sim.state_digest():
        raise AssertionError("server, CLI policy: the replay's digest "
                             "differs from the live run's")
    _card_matches_cpu(config, held.pop("start"), None,
                      f"server, CLI policy, tick {SERVER_TIMED_FROM}")
    stats = _tick_stats(tick_ms)
    log(f"server, CLI policy ({SERVER_CAPS}, JACOBI "
        f"{config.solver_iterations}, classic): {bodies} active slots "
        f"({SERVER_SPAWNS_PER_TICK * SERVER_SPAWN_TICKS} M-key bodies, 2 "
        f"capsule players, 4 arena geoms), {SERVER_TICKS} ticks live in "
        f"{live_s:.2f} s, replayed from the saved intent log in "
        f"{replay_s:.2f} s: digests equal, overflow 0; ticks "
        f"{SERVER_TIMED_FROM}-{SERVER_TICKS}: {stats['mean_ms']:.3f} ms a "
        f"tick (min {stats['min_ms']:.3f}, max {stats['max_ms']:.3f}, "
        f"stdev {stats['stdev_ms']:.3f}), {stats['ticks_per_s']:.2f} ticks/s "
        f"against the {PHYSICS_HZ} Hz of PHYSICS_DT on {card}; one tick "
        f"under torch.profiler: {prof['launches']} launches, "
        f"{prof['device_ms']:.3f} ms of kernel time; hand kernel launches "
        f"{launches}")
    del sim, again
    torch.cuda.empty_cache()

    # 3. the same intents under the throughput policy: live to tick 480, so
    # that ticks 400-480 are timed on the landed arena as under the CLI's
    # policy; the first SERVER_THROUGHPUT_REPLAYED ticks replayed
    tconfig = EngineConfig.throughput(**SERVER_CAPS)
    for fn in _hand_kernels():
        fn.launches = 0
    sim = SimCore(tconfig, seed=0, player_capsules=True, device="cuda")
    tick_ms = _server_session(sim, SERVER_TICKS, SERVER_TIMED_FROM, at_ticks=(
        (SERVER_THROUGHPUT_REPLAYED,
         lambda s: held.update(digest=s.state_digest())),
        (SERVER_EAGER_TICKS,
         lambda s: held.update(eager_throughput=s.state_digest()))))
    t0 = time.perf_counter()
    again = replay_m.replay(sim.intent_log, SERVER_THROUGHPUT_REPLAYED,
                            tconfig, seed=0, player_capsules=True,
                            device="cuda")
    replay_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in _hand_kernels()}
    want = {"compact_rows_t": SERVER_TICKS + SERVER_THROUGHPUT_REPLAYED,
            "collide_pairs": 0, "sphere_mesh_d2_tiles": 0,
            "sphere_mesh_d2": 0, "pgs_solve": 0, "lcp_pivot_solve": 0}
    if launches != want:
        raise AssertionError(f"server, throughput policy: launches "
                             f"{launches}, expected {want}")
    if again.state_digest() != held["digest"]:
        raise AssertionError("server, throughput policy: the replay's "
                             "digest differs from the live run's at tick "
                             f"{SERVER_THROUGHPUT_REPLAYED}")
    if sim.check_overflow():
        raise AssertionError(f"server, throughput policy: overflow "
                             f"{int(sim.world.overflow[0])}")
    _check_batch(sim.world, "server, throughput policy", SERVER_TICKS)
    digests["throughput"] = sim.state_digest()
    digests["throughput_eager"] = held.pop("eager_throughput")
    prof = _launches_of(lambda: sim._step1(sim.world))
    stats_t = _tick_stats(tick_ms)
    log(f"server, throughput policy ({tconfig.selector_dtype} selectors): "
        f"{SERVER_TICKS} ticks live, the first {SERVER_THROUGHPUT_REPLAYED} "
        f"replayed in {replay_s:.2f} s: digests equal at tick "
        f"{SERVER_THROUGHPUT_REPLAYED}, overflow 0; ticks "
        f"{SERVER_TIMED_FROM}-{SERVER_TICKS}: {stats_t['mean_ms']:.3f} ms a "
        f"tick (min {stats_t['min_ms']:.3f}, max {stats_t['max_ms']:.3f}, "
        f"stdev {stats_t['stdev_ms']:.3f}), {stats_t['ticks_per_s']:.2f} "
        f"ticks/s on {card}; one tick under torch.profiler: "
        f"{prof['launches']} launches, {prof['device_ms']:.3f} ms of kernel "
        f"time; hand kernel launches {launches}")
    on_path = compaction_on_path_data(lambda: sim.advance(1),
                                      "server_throughput", 1)
    del sim, again
    torch.cuda.empty_cache()

    # 4. a live session over loopback UDP on the native transport
    server = GameServer(config, port=0, max_players=4, device="cuda")
    clients = []
    try:
        if not isinstance(server.host, native_transport.NativeHost):
            raise AssertionError("the native transport did not serve")
        server.sim.advance(1)
        clients = [GameClient(("127.0.0.1", server.host.port),
                              max_bodies=config.max_bodies, max_players=4,
                              seed=i) for i in range(2)]
        spawned = thrown = 0
        t_start = t_prev = time.monotonic()
        tick0 = server.sim.tick
        while time.monotonic() - t_start < SESSION_SECONDS:
            server.pump(0.002)
            now = time.monotonic()
            server.tick(now - t_prev)
            for c in clients:
                c.pump(0.001)
                c.update(now - t_prev)
            t_prev = now
            while clients[0].connected and spawned < SESSION_SPAWNS:
                clients[0].spawn_random()
                spawned += 1
            while clients[1].connected and thrown < SESSION_THROWS:
                clients[1].throw_sphere()
                thrown += 1
        wall_s = time.monotonic() - t_start
        ticks = server.sim.tick - tick0
        active = int(server.sim.world.active.sum())
        # the last spawns' snapshot: a broadcast, then 50 ms of pumping
        deadline = time.monotonic() + 5.0
        mirrored = []
        while time.monotonic() < deadline and mirrored != [active, active]:
            server.broadcast()
            for _ in range(10):
                server.pump(0.002)
                for c in clients:
                    c.pump(0.003)
            mirrored = [int((c.bodies["type"] != 0).sum()) for c in clients]
        if spawned != SESSION_SPAWNS or thrown != SESSION_THROWS:
            raise AssertionError(f"session: {spawned} spawns, {thrown} "
                                 f"throws sent")
        if active != 4 + SESSION_SPAWNS + SESSION_THROWS:
            raise AssertionError(f"session: {active} active slots")
        if mirrored != [active, active]:
            raise AssertionError(f"session: clients mirror {mirrored} of "
                                 f"{active} bodies")
        if any("dropped" in line for line in server.log):
            raise AssertionError(f"session: {server.log}")
        bcast = []
        for _ in range(60):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            protocol.encode_update_bodies(server.sim.body_states())
            bcast.append((time.perf_counter() - t0) * 1e3)
    finally:
        for c in clients:
            c.close()
        server.close()
    bcast_ms = sum(bcast) / len(bcast)
    log(f"session on the native transport: 2 clients, {spawned} M-key "
        f"spawns and {thrown} thrown spheres, {ticks} sim ticks in "
        f"{wall_s:.2f} s of wall time ({ticks / wall_s:.2f} ticks/s), both "
        f"clients mirror all {active} bodies, no spawn dropped; a "
        f"broadcast's body_states + encoding {bcast_ms:.3f} ms (min "
        f"{min(bcast):.3f}, max {max(bcast):.3f}, 60 calls)")

    # 5. the CLI's server and client in subprocesses
    log(f"CLI: {_cli_session()}")
    launches = {"server_cli": cli_launches, "server_throughput": want}
    return launches, on_path, dict(
        cli=stats, throughput=stats_t, session_ticks_per_s=ticks / wall_s,
        broadcast_ms=bcast_ms, digests=digests)


def mesh_batch(device):
    """``tests/test_mesh.py``'s batch: ``stack_world(10 bodies, seed 3)`` in
    16 worlds, each world's dynamic bodies raised by 0.013 m a world
    index."""
    import torch
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.models.scenes import stack_world
    from rl_ode_physics_tpu_torch.parallel.batch import replicate
    config = EngineConfig(**MESH_CAPS)
    w = stack_world(config, num_bodies=10, seed=3, device=device)
    b = replicate(w, MESH_BATCH_WORLDS, device=device)
    bump = torch.arange(MESH_BATCH_WORLDS, dtype=b.pos.dtype,
                        device=b.device) * 0.013
    lift = (bump[:, None] * (b.inv_mass > 0))[..., None]
    return config, b.replace(pos=b.pos + torch.nn.functional.pad(
        lift, (1, 1)))


def phase_mesh(card):
    """The world axis over a mesh (``parallel/mesh.py``): the mesh test's
    batch sharded three ways against the unsharded step, bitwise, and on a
    mesh of the CPU and the card within 1e-4; ``multichip_scaling`` at mesh
    sizes 1 and 2 (two shards on the one card), ``compact_rows_t`` counted
    as the ``sharded`` path; then the kernel held to its plain version on
    that path's own tensors."""
    import dataclasses
    import torch
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.ops import compaction_kernel
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)
    from rl_ode_physics_tpu_torch.parallel.mesh import (
        gather_batch, make_mesh, make_shard_map_step_fn,
        make_sharded_step_fn, shard_batch)
    from rl_ode_physics_tpu_torch.utils import multichip_scaling

    config, batch = mesh_batch("cuda")
    ref = make_batched_step_fn(config, substeps=MESH_BATCH_SUBSTEPS,
                               device="cuda")(batch)
    for label, devices, make in (
            ("make_mesh() (every card)", None, make_sharded_step_fn),
            ("[cuda:0, cuda:0]", ["cuda:0", "cuda:0"], make_sharded_step_fn),
            ("[cuda:0, cuda:0] (shard_map name)", ["cuda:0", "cuda:0"],
             make_shard_map_step_fn)):
        mesh = make_mesh(devices)
        out = make(config, mesh, substeps=MESH_BATCH_SUBSTEPS)(
            shard_batch(batch, mesh))
        got = gather_batch(out, "cuda")
        for f in dataclasses.fields(got):
            if not torch.equal(getattr(got, f.name), getattr(ref, f.name)):
                raise AssertionError(f"mesh {label}: {f.name} differs from "
                                     f"the unsharded step")
        log(f"mesh {label}: {len(out)} shard(s) of "
            f"{out[0].num_worlds} worlds, {MESH_BATCH_SUBSTEPS} substeps: "
            f"bitwise the unsharded step on the card")
    mesh = make_mesh(["cpu", "cuda:0"])
    out = make_sharded_step_fn(config, mesh, substeps=MESH_BATCH_SUBSTEPS)(
        shard_batch(batch, mesh))
    if [s.device.type for s in out] != ["cpu", "cuda"]:
        raise AssertionError("mesh [cpu, cuda:0]: a shard left its device")
    got = gather_batch(out, "cuda")
    moving = ("pos", "quat", "linvel", "angvel")
    worst = _same("mesh [cpu, cuda:0]",
                  {name: getattr(got, name) for name in moving},
                  {name: getattr(ref, name).cpu() for name in moving}, 1e-4)
    for f in dataclasses.fields(got):
        if f.name not in moving and not torch.equal(getattr(got, f.name),
                                                    getattr(ref, f.name)):
            raise AssertionError(f"mesh [cpu, cuda:0]: {f.name} differs from "
                                 f"the unsharded step")
    log(f"mesh [cpu, cuda:0]: each shard stepped on its own device, within "
        f"{worst:.3e} of the card's unsharded step (atol 1e-4)")

    compaction_kernel.compact_rows_t.launches = 0
    rows = multichip_scaling.run(list(SCALING_DEVICES))
    launches = compaction_kernel.compact_rows_t.launches
    want = sum((1 + multichip_scaling.REPS) * r["substeps"] * r["devices"]
               for r in rows["stepping"])
    if launches != want:
        raise AssertionError(f"sharded path: compact_rows_t launched "
                             f"{launches} times, {want} expected")
    for step_r, train_r in zip(rows["stepping"], rows["training"]):
        shards = step_r["devices"]
        note = (" (shards of ONE card, not cards)" if shards > 1 else "")
        log(f"multichip_scaling d={shards}{note}: "
            f"{step_r['bodysteps_per_sec_per_device']:.1f} body-steps/s a "
            f"shard ({step_r['substep_ms']:.3f} ms a substep), ES train step "
            f"{train_r['train_step_s'] * 1e3:.1f} ms "
            f"({train_r['per_device_slowdown_vs_1dev']:.2f}x d=1) on {card}")
    log(json.dumps(rows))

    # the d=1 row against make_batched_step_fn on the same work: what the
    # mesh's wrapping costs
    sconfig = multichip_scaling.scaling_config()
    world = bench_world(sconfig, num_bodies=60, device="cuda")
    row = rows["stepping"][0]
    worlds, substeps = row["worlds_per_device"], row["substeps"]
    plain = make_batched_step_fn(sconfig, substeps=substeps, device="cuda")
    batch = plain(replicate(world, worlds, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(multichip_scaling.REPS):
        batch = plain(batch)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / multichip_scaling.REPS
    rate = worlds * int((world.inv_mass > 0).sum()) * substeps / secs
    one = make_batched_step_fn(sconfig, substeps=1, device="cuda")
    traced = _launches_of(lambda: one(batch))
    log(f"make_batched_step_fn on the same {worlds} worlds x {substeps} "
        f"substeps: {rate:.1f} body-steps/s (the mesh of one card: "
        f"{row['bodysteps_per_sec_per_device']:.1f}, "
        f"{row['bodysteps_per_sec_per_device'] / rate:.3f}x); one substep "
        f"under torch.profiler: {traced['launches']} launches, "
        f"{traced['device_ms']:.3f} ms of kernel time (idle "
        f"{1 - traced['device_ms'] / (secs / substeps * 1e3):.1%} of the "
        f"untraced substep)")

    two = make_mesh(list(SCALING_DEVICES))
    shards = shard_batch(replicate(world, worlds * two.size, device="cuda"),
                         two)
    shards = make_sharded_step_fn(sconfig, two, substeps=64)(shards)
    on_path = compaction_on_path_data(
        lambda: make_sharded_step_fn(sconfig, two)(shards), "sharded",
        two.size)
    return {"compact_rows_t": launches}, on_path


def phase_es(card):
    """The ES trainer (``examples/rl_training.py``): one train step on the
    card against the CPU from the same noise; the learning check of
    ``tests/test_rl_training.py``; 8,192 worlds timed."""
    import torch
    from rl_ode_physics_tpu_torch.examples.rl_training import make_trainer

    pop, horizon = ES_CHECK_POP, ES_CHECK_HORIZON
    gen = torch.Generator().manual_seed(1)
    ew = torch.randn((pop, 6, 2), generator=gen) * 0.1
    eb = torch.randn((pop, 2), generator=gen) * 0.1
    results = {}
    for device in ("cpu", "cuda"):
        params, step = make_trainer(pop=pop, horizon=horizon, device=device)
        results[device] = step.step_with_noise(params, ew.to(device),
                                               eb.to(device))
    (cpu_p, cpu_r), (card_p, card_r) = results["cpu"], results["cuda"]
    worst = 0.0
    for want, got in zip(cpu_p + (cpu_r,), card_p + (card_r,)):
        got = got.cpu()
        worst = max(worst, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            raise AssertionError(f"ES step: card differs from the CPU by "
                                 f"{float((got - want).abs().max())}")
    log(f"ES train step (pop {pop}, horizon {horizon}), card against CPU from "
        f"the same noise: max abs diff {worst:.3e} (rtol 1e-4, atol 1e-5); "
        f"mean reward {float(card_r):.5f}")

    params, step = make_trainer(pop=ES_LEARN_POP, horizon=ES_LEARN_HORIZON,
                                device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rewards = []
    for _ in range(ES_LEARN_ITERS):
        params, mean_r = step(params, gen)
        rewards.append(float(mean_r))
    if not (rewards[-1] > rewards[0] + 0.15 and rewards[-1] > -3.3):
        raise AssertionError(f"ES learning check: rewards {rewards}")
    log(f"ES learning check (pop {ES_LEARN_POP}, horizon {ES_LEARN_HORIZON}):"
        f" mean rewards {[round(r, 3) for r in rewards]}")

    params, step = make_trainer(pop=ES_FULL_POP, horizon=ES_FULL_HORIZON,
                                device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params, mean_r = step(params, gen)                 # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ES_FULL_TIMED):
        params, mean_r = step(params, gen)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / ES_FULL_TIMED
    if not (torch.isfinite(mean_r) and all(torch.isfinite(p).all()
                                           for p in params)):
        raise AssertionError("ES at full width: non-finite result")
    worlds = 2 * ES_FULL_POP
    traced = _launches_of(lambda: step(params, gen))
    log(f"ES at full width: pop {ES_FULL_POP} ({worlds} worlds), horizon "
        f"{ES_FULL_HORIZON}, 2 substeps a control step: {secs * 1e3:.1f} ms "
        f"a train step (warm-up {warm_s:.2f} s), "
        f"{worlds * ES_FULL_HORIZON / secs:.1f} env-steps/s, mean reward "
        f"{float(mean_r):.4f} on {card}; one train step under "
        f"torch.profiler: {traced['launches']} launches, "
        f"{traced['device_ms']:.1f} ms of kernel time (idle "
        f"{1 - traced['device_ms'] / (secs * 1e3):.1%} of the untraced "
        f"step)")


def phase_referee(card):
    """BASELINE's bar on the card: the conformance configuration steps one
    world of each scene on the card, the port's float64 referee steps the
    same initial state on the host; max relative position error <= 1e-5,
    max quaternion error <= 1e-3."""
    from rl_ode_physics_tpu_torch.testing import conformance
    if conformance.conformance_config() != referee_config():
        raise AssertionError("conformance_config() is not the referee's "
                             "configuration")
    for scene, steps in REFEREE_RUNS:
        got = conformance.compare(scene, steps, device="cuda")
        if not (got["pos_err"] <= REFEREE_POS_TOL
                and got["quat_err"] <= REFEREE_QUAT_TOL):
            raise AssertionError(f"referee {scene}: {got}")
        log(f"referee {scene}, {steps} steps (B=1, float64, PGS): max rel "
            f"pos err {got['pos_err']:.3e} (bar {REFEREE_POS_TOL}), max abs "
            f"quat err {got['quat_err']:.3e}; card {got['engine_s']:.2f} s "
            f"({got['engine_s'] / steps * 1e3:.1f} ms a step), referee "
            f"{got['referee_s']:.2f} s on the host")


def _minimal_pair() -> str:
    """``examples.minimal_server`` and ``examples.minimal_client`` in
    subprocesses started together; raises unless the client received id 0
    and a roster of 1. Returns the client's lines."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mod = [sys.executable, "-m", "rl_ode_physics_tpu_torch.examples."]
    server = subprocess.Popen(
        mod[:2] + [mod[2] + "minimal_server", str(port)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    client = subprocess.Popen(
        mod[:2] + [mod[2] + "minimal_client", str(port),
                   str(MINIMAL_CLIENT_SECONDS)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        said, _ = client.communicate(timeout=120)
    finally:
        for proc in (client, server):
            proc.kill()
            proc.wait()
    if (client.returncode != 0 or "RECEIVED ID: 0" not in said
            or "roster size 1" not in said):
        raise AssertionError(f"minimal pair: client rc {client.returncode} "
                             f"{said}")
    return " / ".join(said.split("\n")).strip(" /")


def phase_examples(card):
    """The example programs: ``articulated`` and ``rl_rollout`` on the
    card, their printed lines checked; the minimal server and client."""
    import io
    from rl_ode_physics_tpu_torch.examples import articulated, rl_rollout

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        articulated.main(EXAMPLE_TICKS, "cuda")
    lines = out.getvalue().splitlines()
    if len(lines) != EXAMPLE_TICKS + 1 or not lines[-1].startswith(
            "DONE: arm swept"):
        raise AssertionError(f"articulated: {lines}")
    log(f"articulated {EXAMPLE_TICKS} ticks on the card: {lines[-2]} / "
        f"{lines[-1]}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rl_rollout.main(*EXAMPLE_ROLLOUT, "cuda")
    said = out.getvalue()
    if "env-steps/sec" not in said or "actor height spread" not in said:
        raise AssertionError(f"rl_rollout: {said}")
    log(f"rl_rollout {EXAMPLE_ROLLOUT[0]} worlds x {EXAMPLE_ROLLOUT[1]} "
        f"steps on {card}: " + " / ".join(said.strip().splitlines()))
    log(f"minimal server and client: {_minimal_pair()}")


def _tool_run(drive, kernel=None, path=None):
    """``drive()`` on its default route (CUDA graphs where the tool's steps
    take them) with every hand kernel's count set to 0 just before it;
    returns (its result, {kernel: launches}, seconds, on_path). With
    ``kernel`` (a name of ``_hand_kernels``), ``drive()`` then runs once
    more eagerly with that wrapper caught, and its last call's tensors are
    held to the plain version on the card (``compaction_on_path_data``,
    ``tiles_on_path_data``): ``on_path`` is that check's record, else
    None. Raises unless the eager run called the kernel as many times as
    the default run counted launches: replays count what their capture
    did."""
    import torch
    ran = {}

    def counted():
        for fn in _hand_kernels():
            fn.launches = 0
        t0 = time.perf_counter()
        ran["out"] = drive()
        torch.cuda.synchronize()
        ran["secs"] = time.perf_counter() - t0
        ran["counts"] = {fn.__name__: fn.launches for fn in _hand_kernels()
                         if fn.launches}

    if kernel is None:
        counted()
        return ran["out"], ran["counts"], ran["secs"], None
    counted()
    if not ran["counts"].get(kernel):
        raise AssertionError(f"{path}: {kernel} never launched: "
                             f"{ran['counts']}")
    check = {"compact_rows_t": compaction_on_path_data,
             "sphere_mesh_d2_tiles": tiles_on_path_data}[kernel]
    on_path = check(drive, path, ran["counts"][kernel], graphed_check=False)
    return ran["out"], ran["counts"], ran["secs"], on_path


def phase_tools(card):
    """The measurement tools of ``utils/`` on the card at small sizes, each
    with its hand-kernel launches counted as a path of its own
    (``tool_<name>``), and that kernel held to its plain version on the
    last tensors the tool's own run handed it. Returns ({path: launches},
    {path: the kernel's record on the path's data})."""
    import numpy as np
    import torch
    from rl_ode_physics_tpu_torch.core.config import bench_config
    from rl_ode_physics_tpu_torch.models.scenes import bench_world
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, replicate)
    from rl_ode_physics_tpu_torch.testing import conformance
    from rl_ode_physics_tpu_torch.utils import (
        capacity_audit, profile_step, rl_rollout_bench, solver_iter,
        teapot_bench, tpu_default_conformance)
    from rl_ode_physics_tpu_torch.utils.profiling import phase_timings

    by_path, on_path = {}, {}
    registry = capacity_audit.load_registry()
    path = "tool_capacity_audit"
    entries, counts, secs, on_path[path] = _tool_run(lambda: (
        capacity_audit.audit(64, TOOL_AUDIT_SUBSTEPS, TOOL_AUDIT_SEEDS,
                             "cuda")), "compact_rows_t", path)
    by_path[path] = counts
    for e in entries:
        if e["overflow"] or e["signature"] not in registry:
            raise AssertionError(f"capacity_audit {e['label']}: overflow "
                                 f"{e['overflow']}, signature "
                                 f"{e['signature']} in the registry: "
                                 f"{e['signature'] in registry}")
        log(f"capacity_audit 64 slots, {e['label']}, seeds "
            f"{list(TOOL_AUDIT_SEEDS)} x {TOOL_AUDIT_SUBSTEPS} substeps (whole "
            f"chunks of {capacity_audit.CHUNK}) on {card}: contacts "
            f"{e['peak_contacts']}/{e['max_contacts']}, pairs "
            f"{e['peak_pairs']} of caps {e['caps']}, overflow 0; "
            f"{capacity_audit.compare_line(e)}; {counts}, {secs:.1f} s")

    steps = TOOL_CONFORMANCE_STEPS
    r, _, secs, _ = _tool_run(lambda: (
        tpu_default_conformance.run(steps, "default", "cuda")))
    numbers = ("max_rel_pos_err", "late_height_err", "first_divergence_step",
               "sorted_heights_err", "late_motion")
    if not all(math.isfinite(r[k]) for k in numbers):
        raise AssertionError(f"tpu_default_conformance: {r}")
    cfg = tpu_default_conformance.throughput_config()
    pos_cpu, _, _ = conformance.engine_trajectory(
        conformance.build("mini_stack", cfg, "cpu")[0], cfg, steps)
    gap = float(np.abs(r["pos_e"] - pos_cpu).max())
    log(f"{tpu_default_conformance.line(r)} on {card}; card against the "
        f"port's CPU over the {steps} steps: max |dx| {gap:.3e}; card "
        f"{r['engine_s']:.2f} s, referee {r['referee_s']:.2f} s, "
        f"{secs:.1f} s")

    worlds, substeps = TOOL_PROFILE
    path = "tool_profile_step"
    p, counts, secs, on_path[path] = _tool_run(lambda: (
        profile_step.profile(worlds, substeps, "bench", "cuda")),
        "compact_rows_t", path)
    by_path[path] = counts
    log(profile_step.report(p, top=TOOL_PROFILE_ROWS))
    if p["mapped_share"] < 0.9:
        raise AssertionError(f"profile_step: {p['mapped_share']:.1%} of the "
                             f"device time mapped to the port's source")
    if not any("compact_rows" in row["op"] and row["source"] != "?"
               for row in p["rows"]):
        raise AssertionError("profile_step: no compact_rows row with a "
                             "source line")
    log(f"profile_step bench {worlds} worlds x {substeps} substeps on "
        f"{card}: {p['total_ms']:.3f} ms of device time a substep, "
        f"{p['mapped_share']:.1%} mapped; "
        f"{counts}, {secs:.1f} s")

    r, _, secs, _ = _tool_run(lambda: solver_iter.run(
        TOOL_SOLVER_WORLDS, "cuda", solves=TOOL_SOLVER_SOLVES))
    log(f"solver_iter on {card}: {json.dumps(r)}, {secs:.1f} s")

    verts, tris = teapot_bench.mesh_geometry(standin=True)
    path = "tool_teapot_bench"
    r, counts, secs, on_path[path] = _tool_run(lambda: teapot_bench.run(
        TOOL_TEAPOT_WORLDS, verts, tris, "cuda"), "sphere_mesh_d2_tiles",
        path)
    by_path[path] = counts
    log(f"teapot_bench --standin on {card}: {json.dumps(r)}; {counts}, "
        f"{secs:.1f} s")

    settings = rl_rollout_bench.settings(
        {"BENCH_WORLDS": str(TOOL_ROLLOUT_WORLDS), "BENCH_REPEATS": "1"})
    path = "tool_rl_rollout_bench"
    r, counts, secs, on_path[path] = _tool_run(lambda: (
        rl_rollout_bench.run(**settings, device="cuda")), "compact_rows_t",
        path)
    by_path[path] = counts
    log(f"rl_rollout_bench {TOOL_ROLLOUT_WORLDS} worlds on {card}: "
        f"{json.dumps(r)}; {counts}, {secs:.1f} s")

    config = bench_config(64)
    batch = replicate(bench_world(config, num_bodies=BODIES, device="cuda"),
                      WORLDS, device="cuda")
    batch = make_batched_step_fn(config, substeps=TOOL_TIMINGS_SETTLE)(batch)
    torch.cuda.synchronize()
    r, _, secs, _ = _tool_run(lambda: phase_timings(batch, config))
    if not all(math.isfinite(v) and v > 0 for v in r.values()):
        raise AssertionError(f"phase_timings: {r}")
    log(f"phase_timings, the bench batch ({WORLDS} worlds settled "
        f"{TOOL_TIMINGS_SETTLE} substeps) on {card}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in r.items())
        + f"; {secs:.1f} s")
    return by_path, on_path


@contextlib.contextmanager
def _bench_env(values: dict):
    """A context in which the ``BENCH_*`` variables are exactly
    ``values``."""
    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for key in saved:
        del os.environ[key]
    os.environ.update(values)
    try:
        yield
    finally:
        for key in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[key]
        os.environ.update(saved)


def phase_bench_module(card):
    """The bench module as its command runs it, then its three analyses,
    each small; the bench module, the roofline and the SAP analysis are
    each a path of their own, with ``compact_rows_t`` held to its plain
    version on the last tensors that path handed it. Returns ({path:
    launches}, {path: the kernel's record on the path's data})."""
    import io
    import torch
    from rl_ode_physics_tpu_torch import bench
    from rl_ode_physics_tpu_torch.parallel import batch as batch_module
    from rl_ode_physics_tpu_torch.utils import (
        bounds, orientation_probe, roofline, sap_cost_analysis)

    with _bench_env(dict(BENCH_MODULE_ENV, BENCH_BODIES="512")):
        try:
            bench.main([])
        except RuntimeError as err:
            if "UNAUDITED capacity configuration" not in str(err):
                raise
            log(f"bench BENCH_BODIES=512: refused ({str(err).splitlines()[0]})")
        else:
            raise AssertionError("bench ran 512 slots, which nothing signs")

    runs = []

    def drive():
        out, err = io.StringIO(), io.StringIO()
        runs.append((out, err))
        with _bench_env(BENCH_MODULE_ENV), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            return bench.main([])

    on_path = {}
    path = "bench_module"
    # each step function the bench makes keeps the last batch it returned
    with last_batches(batch_module) as finals:
        rc, counts, secs, on_path[path] = _tool_run(drive, "compact_rows_t",
                                                    path)
    out, err = runs[0]           # the graphed run's lines
    lines = out.getvalue().strip().splitlines()
    parity = [ln for ln in err.getvalue().splitlines()
              if ln.startswith("# parity: ")]
    if rc != 0 or len(lines) != 1 or len(parity) != 1:
        raise AssertionError(f"bench: rc {rc}, stdout {lines}, stderr "
                             f"{err.getvalue()}")
    headline = json.loads(lines[0])
    parity = json.loads(parity[0][len("# parity: "):])
    substeps = int(BENCH_MODULE_ENV["BENCH_SUBSTEPS"])
    ticks = (bench.WARMUP_LAUNCHES + int(BENCH_MODULE_ENV["BENCH_STEPS"])) \
        * substeps
    for line in (headline, parity):
        if (set(line) != {"metric", "value", "unit", "vs_baseline"}
                or not line["value"] > 0):
            raise AssertionError(f"bench line {line}")
    # two lines, each run graphed and then eagerly for the kernel's hold
    if len(finals) != 4:
        raise AssertionError(f"bench made {len(finals)} step functions")
    for line, (graphed,), (eager,) in zip(("headline", "parity"),
                                          finals[:2], finals[2:]):
        _bitwise(graphed, eager, f"bench module, {line} line: the graphed "
                 f"run against the eager one")
    log("bench module: each line's final batch, graphed "
        f"(BENCH_UNROLL={bench.settings()['unroll']}, donated), bitwise the "
        f"eager run's")
    for (batch,) in finals:
        if int(batch.overflow.sum()) or not bool(
                (batch.tick == ticks).all()) or not all(
                bool(torch.isfinite(getattr(batch, f)).all())
                for f in ("pos", "quat", "linvel", "angvel")):
            raise AssertionError("bench: overflow, tick or a non-finite "
                                 "state in a line's final batch")
    aux = [ln for ln in err.getvalue().splitlines() if ln.startswith("# aux")]
    log(f"bench module on {card}: {json.dumps(headline)}; parity "
        f"{json.dumps(parity)}; {aux[0] if aux else ''}; overflow 0, tick "
        f"{ticks} in both lines; {counts}, {secs:.1f} s")
    by_path = {path: counts}

    config = bench.bench_config(64)
    path = "tool_roofline"
    r, counts, secs, on_path[path] = _tool_run(lambda: (
        roofline.measure_config(
            "headline hb-8", config, 64, ROOFLINE_WORLDS, ROOFLINE_SUBSTEPS,
            bounds.HBM_BYTES_PER_S / 1e9, bounds.FP32_OPS_PER_S / 1e12,
            ROOFLINE_WORLDS, "cuda")), "compact_rows_t", path)
    numbers = [v for v in r.values() if isinstance(v, float)]
    if (not all(math.isfinite(v) for v in numbers)
            or r["bound"] not in ("bytes", "flops", "op-floor")
            or r["flops/substep/chunk"] < bench.solver_flops(config)
            * ROOFLINE_WORLDS or not r["t_measured_ms"] > 0):
        raise AssertionError(f"roofline: {r}")
    by_path[path] = counts
    log(f"roofline {ROOFLINE_WORLDS} worlds, S={ROOFLINE_SUBSTEPS} on "
        f"{card}: bound {r['bound']}, measured/model "
        f"{r['measured_over_model']:.3f}; {counts}, {secs:.1f} s")

    path = "tool_sap_cost_analysis"
    r, counts, secs, on_path[path] = _tool_run(lambda: (
        sap_cost_analysis.run(512, SAP_CHUNK, SAP_SUBSTEPS, device="cuda")),
        "compact_rows_t", path)
    if not all(r[label]["bytes/substep"] > 0 and r[label]["aten_ops"] > 0
               for label in ("dense", "sap")):
        raise AssertionError(f"sap_cost_analysis: {r}")
    by_path[path] = counts
    log(f"sap_cost_analysis 512 slots, chunk {SAP_CHUNK}, {SAP_SUBSTEPS} "
        f"substeps on {card}: overflow dense {r['dense']['overflow']}, sap "
        f"{r['sap']['overflow']}; {json.dumps(r['ratio'])}; {counts}, "
        f"{secs:.1f} s")

    k1, k2 = ORIENTATION_TRIPS
    t0 = time.perf_counter()
    r = orientation_probe.run(k1, k2)
    if len(r) != len(orientation_probe.PROBES) or not all(
            math.isfinite(p["ms_per_bmm"]) for p in r):
        raise AssertionError(f"orientation_probe: {r}")
    log(f"orientation_probe k1={k1}, k2={k2} on {card}: "
        f"{time.perf_counter() - t0:.1f} s")
    return by_path, on_path


def _routes_line(fn, label):
    """Print whether a step function replays graphs, and why not."""
    log(f"route {label}: graphed={fn.graphed}"
        + (f", eager: {fn.eager_reason}" if not fn.graphed else ""))
    return fn.graphed


def _route_table():
    """Every path's step function on the card: graphed, or eager with the
    host read that keeps it so."""
    from rl_ode_physics_tpu_torch.core.config import (
        bench_config, hinge_chain_config, rollout_config)
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.examples.rl_training import trainer_config
    from rl_ode_physics_tpu_torch.models.scenes import hinge_chain_scene
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    from rl_ode_physics_tpu_torch.utils import multichip_scaling

    rows = {
        "bench": (bench_config(64), None),
        "trimesh": (mesh_config(), None),
        "rollout": (rollout_config(64), None),
        "capsule_stack": (capsule_config(), None),
        "mini_stack": (mini_config(), None),
        "conformance (PGS float64)": (referee_config(), None),
        "dantzig (float64)": (referee_dantzig_config(), None),
        "server_cli": (EngineConfig(**SERVER_CAPS), None),
        "server_throughput": (EngineConfig.throughput(**SERVER_CAPS), None),
        "sharded": (multichip_scaling.scaling_config(), None),
        "es": (trainer_config(), None),
    }
    for label, config in (("hinge_chain_jacobi", hinge_chain_config()),
                          ("hinge_chain_pgs_f64", referee_config())):
        rows[label] = (config, hinge_chain_scene(config, device="cuda")[1])
    for name, lever in LEVERS.items():
        rows[f"bench_{name}"] = (bench_config(64).replace(**lever), None)
    graphed = {label: _routes_line(make_batched_step_fn(
        config, device="cuda", joints=joints), label)
        for label, (config, joints) in rows.items()}
    eager = sorted(k for k, v in graphed.items() if not v)
    if eager:
        raise AssertionError(f"eager step functions: {eager}")


def _graphed_bench(config, settled, card):
    """The bench path at full width from the settled batch: 96 substeps
    eagerly and graphed at unroll 1, 4 and 96, each route's first call
    (the capture) with its seconds and peak memory, every graphed result
    bitwise the eager one; then the host and device ms a substep, the
    idle share and the launches, in turns."""
    import torch
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    from rl_ode_physics_tpu_torch.utils import graphs, profiling

    n = SUBSTEPS_PER_LAUNCH
    routes = {"eager": make_batched_step_fn(config, n, device="cuda")}
    for unroll in GRAPH_UNROLLS:
        routes[f"unroll {unroll}"] = make_batched_step_fn(
            config, n, True, 0, unroll, device="cuda")

    def eager_call(fn):
        with graphs.disable_graphs():
            return fn(settled)

    def call(label):
        if label == "eager":
            return eager_call(routes[label])
        return routes[label](settled)

    def unroll_of(label):
        return 1 if label == "eager" else int(label.split()[1])

    want = None
    first = {}
    for label in routes:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = call(label)
        torch.cuda.synchronize()
        first[label] = dict(
            first_call_s=time.perf_counter() - t0,
            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        if label == "eager":
            want = out
            continue
        _bitwise(out, want, f"bench graphed at {label}")
        (stats,) = routes[label].graphs.stats()
        first[label].update(capture_s=stats["capture_s"],
                            nodes=stats["nodes"])
        log(f"bench graphed at {label}: {n} substeps bitwise the eager "
            f"loop; {first[label]}")
    log(f"bench eager: first call {first['eager']}")
    del want, out
    timed = {label: [] for label in routes}
    order = list(routes)
    for turn in range(GRAPH_BENCH_TURNS):
        for label in (order if turn % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(label)
            torch.cuda.synchronize()
            timed[label].append((time.perf_counter() - t0) * 1e3 / n)
    # the trace of a 96-substep eager call holds 332k launches: profile
    # calls of GRAPH_PROFILED substeps, graphed at unroll 1, 4 and all
    m = GRAPH_PROFILED
    short = {"eager": make_batched_step_fn(config, m, device="cuda")}
    for unroll in GRAPH_UNROLLS:
        short[f"unroll {unroll}"] = make_batched_step_fn(
            config, m, True, 0, min(unroll, m), device="cuda")
    result = {}
    for label, fn in short.items():
        if label == "eager":
            prof = profiling.route_profile(lambda: eager_call(fn), m)
        else:
            prof = profiling.route_profile(lambda: fn(settled), m)
        prof.update(host_ms_per_substep_in_turns=timed[label],
                    **first[label])
        result[label] = prof
        log(f"bench {label} on {card}: host ms a substep of {n}-substep "
            f"calls in turns {[round(t, 3) for t in timed[label]]}; one "
            f"call of {m} substeps (unroll {min(unroll_of(label), m)}) "
            f"profiled: {prof['host_launches_per_call']} host launches "
            f"({prof['graph_launches_per_call']} graph launches), "
            f"{prof['device_kernels_per_substep']:.1f} device kernels and "
            f"{prof['device_ms_per_substep']:.3f} device ms a substep, "
            f"{_shares(prof)}")
    return result


def _graphed_server(card, live):
    """The server-512 sessions of phase 21 (graphed, the default) against
    the same intents eagerly to SERVER_EAGER_TICKS: equal digests there
    under both policies, ticks/s (eager over ticks 160-240, graphed
    phase 21's 400-480), and the launches of one tick on each route."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig
    from rl_ode_physics_tpu_torch.net.server import SimCore
    from rl_ode_physics_tpu_torch.utils import graphs, profiling

    result = {}
    for policy, config in (
            ("cli", EngineConfig(**SERVER_CAPS)),
            ("throughput", EngineConfig.throughput(**SERVER_CAPS))):
        sim = SimCore(config, seed=0, player_capsules=True, device="cuda")
        with graphs.disable_graphs():
            tick_ms = _server_session(sim, SERVER_EAGER_TICKS,
                                      SERVER_EAGER_TIMED_FROM)
        if sim.state_digest() != live["digests"][f"{policy}_eager"]:
            raise AssertionError(f"server, {policy} policy: the graphed "
                                 f"run's digest differs from the eager "
                                 f"run's at tick {SERVER_EAGER_TICKS}")
        eager = _tick_stats(tick_ms)

        def tick_eager():
            with graphs.disable_graphs():
                return sim._step1(sim.world)

        prof = {"graphed": profiling.route_profile(
                    lambda: sim._step1(sim.world), 1),
                "eager": profiling.route_profile(tick_eager, 1)}
        result[policy] = dict(graphed_ticks_per_s=live[
            "cli" if policy == "cli" else "throughput"]["ticks_per_s"],
            eager_ticks_per_s=eager["ticks_per_s"], **prof)
        log(f"server-512, {policy} policy, {SERVER_EAGER_TICKS} ticks with "
            f"their intents: the graphed run's digest equals the eager "
            f"run's; graphed {result[policy]['graphed_ticks_per_s']:.2f} "
            f"ticks/s (ticks {SERVER_TIMED_FROM}-{SERVER_TICKS}), eager "
            f"{eager['ticks_per_s']:.2f} (ticks {SERVER_EAGER_TIMED_FROM}-"
            f"{SERVER_EAGER_TICKS}) on {card}; host launches a tick: "
            f"graphed {prof['graphed']['host_launches_per_call']} "
            f"({prof['graphed']['graph_launches_per_call']} graph launch, "
            f"the rest the copies in and out of a step not donated), eager "
            f"{prof['eager']['host_launches_per_call']}; graphed "
            f"{prof['graphed']['device_ms_per_substep']:.3f} device ms a "
            f"tick, {_shares(prof['graphed'])}; eager "
            f"{prof['eager']['device_ms_per_substep']:.3f} device ms a tick, "
            f"{_shares(prof['eager'])}")
        del sim
    return result


def _shares(prof: dict) -> str:
    """The busy and idle shares of a ``route_profile``, both of its traced
    call, beside that call's and an untraced call's ms."""
    return (f"busy {prof['busy_share']:.3f}, idle {prof['idle_share']:.3f} "
            f"of the traced call's {prof['traced_ms_per_substep']:.3f} ms "
            f"(untraced {prof['host_ms_per_substep']:.3f} ms)"
            + (" [kernels over the traced wall: a trace artefact]"
               if prof["device_over_wall"] else ""))


def _route_profiles(prof: dict, unit: str) -> str:
    """The graphed and eager ``route_profile`` of one call, on one line."""
    return "; ".join(
        f"{route}: {p['host_launches_per_call']} host launches "
        f"({p['graph_launches_per_call']} graph launches), "
        f"{p['device_kernels_per_substep']:.0f} device kernels and "
        f"{p['device_ms_per_substep']:.3f} device ms a {unit}, {_shares(p)}"
        for route, p in prof.items())


def _in_turns(calls: dict, turns: int) -> dict:
    """ms a call of each of ``calls`` (label: fn), in turns after one
    untimed call of each (where a graphed one captures), each ended by a
    synchronize."""
    import torch
    for fn in calls.values():
        fn()
    out = {label: [] for label in calls}
    order = list(calls)
    for turn in range(turns):
        for label in (order if turn % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[label]()
            torch.cuda.synchronize()
            out[label].append((time.perf_counter() - t0) * 1e3)
    return out


def _graphed_pgs(card, pgs_paths, dantzig_paths):
    """conformance-1024, its ridge-mesh half and hinge-chain PGS, and
    dantzig-1024 and its ridge mesh (float64, 1,024 worlds) from their
    settled batches: ``GRAPH_PGS_SUBSTEPS`` substeps graphed against the
    eager loop, bitwise; ms a substep of each route in turns; each route's
    ``route_profile`` of a one-substep call (host launches a call, device
    ms, busy and idle shares)."""
    import torch
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    from rl_ode_physics_tpu_torch.utils import graphs, profiling

    pgs, dantzig = referee_config(), referee_dantzig_config()
    rbatch, mesh = pgs_paths["ridge"]
    hbatch, joints = pgs_paths["hinge"]
    dbatch, dmesh = dantzig_paths["ridge"]
    cells = {"conformance-1024": (pgs, pgs_paths["conformance"], {}),
             "ridge-mesh conformance-1024": (pgs, rbatch,
                                             dict(trimesh=mesh)),
             "hinge-chain PGS float64": (pgs, hbatch, dict(joints=joints)),
             "dantzig-1024": (dantzig, dantzig_paths["dantzig"], {}),
             "ridge-mesh dantzig-1024": (dantzig, dbatch,
                                         dict(trimesh=dmesh))}
    out = {}
    n = GRAPH_PGS_SUBSTEPS
    for label, (config, batch, extra) in cells.items():
        fn = make_batched_step_fn(config, n, False, device="cuda", **extra)
        one = make_batched_step_fn(config, 1, False, device="cuda", **extra)
        if not (fn.graphed and one.graphed):
            raise AssertionError(f"{label}: not graphed: {fn.eager_reason}")

        def eager(f=fn):
            with graphs.disable_graphs():
                return f(batch)

        count = _bitwise(fn(batch), eager(), f"{label}: graphed against eager")
        ms = _in_turns({"graphed": lambda: fn(batch), "eager": eager},
                       GRAPH_TURNS)

        def eager_one():
            with graphs.disable_graphs():
                return one(batch)

        prof = {"graphed": profiling.route_profile(lambda: one(batch), 1),
                "eager": profiling.route_profile(eager_one, 1)}
        out[label] = dict({f"{k}_ms_per_substep": [t / n for t in v]
                           for k, v in ms.items()}, profiled=prof)
        log(f"{label}: {n} substeps graphed bitwise the eager loop "
            f"({count} tensors); ms a substep in turns: graphed "
            f"{[round(t / n, 3) for t in ms['graphed']]}, eager "
            f"{[round(t / n, 3) for t in ms['eager']]} on {card}; one "
            f"substep: {_route_profiles(prof, 'substep')}")
    return out


def phase_graphs(card, settled, server, pgs_paths, dantzig_paths):
    """Each JACOBI entry point at full width, graphed against its eager
    loop from the same state: the bench (unroll 1, 4, 96), server-512 under
    both policies, one rollout, one ES train step and two shards of the
    card; then the PGS paths (``_graphed_pgs``); every result bitwise.
    Prints every path's route."""
    import torch
    from rl_ode_physics_tpu_torch.core.config import (
        bench_config, rollout_config)
    from rl_ode_physics_tpu_torch.examples.rl_training import make_trainer
    from rl_ode_physics_tpu_torch.parallel.batch import (
        make_batched_step_fn, take_worlds)
    from rl_ode_physics_tpu_torch.parallel.mesh import (
        gather_batch, make_mesh, make_sharded_step_fn, shard_batch)
    from rl_ode_physics_tpu_torch.utils import graphs, profiling

    def eager(fn, *args):
        with graphs.disable_graphs():
            return fn(*args)

    _route_table()
    out = {"pgs": _graphed_pgs(card, pgs_paths, dantzig_paths)}
    torch.cuda.empty_cache()
    out["bench"] = _graphed_bench(bench_config(64), settled, card)
    torch.cuda.empty_cache()
    out["server"] = _graphed_server(card, server)
    torch.cuda.empty_cache()

    # one rollout of the rollout path from its reset state
    env = rollout_env(rollout_config(64), WORLDS, "cuda")
    state, _ = env.reset(seed=42)
    actions = seeded_actions(
        (ROLLOUT_HORIZON, WORLDS, env.num_actors, 6), 0, "cuda")
    got = env.rollout(state, actions)
    count = _bitwise(got, eager(env.rollout, state, actions),
                     "rollout: graphed against eager")
    del got
    ms = _in_turns({"graphed": lambda: env.rollout(state, actions),
                    "eager": lambda: eager(env.rollout, state, actions)},
                   GRAPH_ROLLOUT_ES_TURNS)
    out["rollout"] = {k: WORLDS * ROLLOUT_HORIZON / (min(v) / 1e3)
                      for k, v in ms.items()}
    log(f"rollout ({WORLDS} worlds, horizon {ROLLOUT_HORIZON}, lidar): the "
        f"graphed rollout bitwise the eager one ({count} tensors); "
        f"env-steps/s graphed {out['rollout']['graphed']:.1f}, eager "
        f"{out['rollout']['eager']:.1f} (ms a rollout in turns {ms}) on "
        f"{card}")
    del env, state, actions
    torch.cuda.empty_cache()

    # one ES train step at full width from the same noise
    params, trainer = make_trainer(pop=ES_FULL_POP, horizon=ES_FULL_HORIZON,
                                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    ew = torch.randn((ES_FULL_POP, 6, 2), generator=gen,
                     device="cuda") * 0.1
    eb = torch.randn((ES_FULL_POP, 2), generator=gen, device="cuda") * 0.1
    got = trainer.step_with_noise(params, ew, eb)
    _bitwise(got, eager(trainer.step_with_noise, params, ew, eb),
             "ES train step: graphed against eager")
    ms = _in_turns({
        "graphed": lambda: trainer.step_with_noise(params, ew, eb),
        "eager": lambda: eager(trainer.step_with_noise, params, ew, eb)},
        GRAPH_ROLLOUT_ES_TURNS)
    out["es"] = {k: min(v) for k, v in ms.items()}
    prof = {"graphed": profiling.route_profile(
                lambda: trainer.step_with_noise(params, ew, eb), 1),
            "eager": profiling.route_profile(
                lambda: eager(trainer.step_with_noise, params, ew, eb), 1)}
    out["es"]["profiled"] = prof
    log(f"ES train step (pop {ES_FULL_POP}, {2 * ES_FULL_POP} worlds, "
        f"horizon {ES_FULL_HORIZON}): graphed parameters and mean reward "
        f"bitwise the eager step's; ms a train step graphed "
        f"{out['es']['graphed']:.1f}, eager {out['es']['eager']:.1f} (in "
        f"turns {ms}) on {card}; {_route_profiles(prof, 'train step')}")
    del trainer
    torch.cuda.empty_cache()

    # two shards of the card against the unsharded graphed step
    config = bench_config(64)
    whole = make_batched_step_fn(config, GRAPH_MESH_SUBSTEPS, False,
                                 unroll=GRAPH_MESH_SUBSTEPS, device="cuda")
    half = make_batched_step_fn(config, GRAPH_MESH_SUBSTEPS, False,
                                unroll=GRAPH_MESH_SUBSTEPS, device="cuda")
    two = make_mesh(["cuda:0", "cuda:0"])
    sharded = make_sharded_step_fn(config, two, GRAPH_MESH_SUBSTEPS, False)
    shards = shard_batch(settled, two)
    ref = whole(settled)
    count = _bitwise(gather_batch(sharded(shards)), ref,
                     "two shards of the card against the unsharded step")
    first_half = take_worlds(settled, 0, WORLDS // 2)
    ms = _in_turns({"unsharded": lambda: whole(settled),
                    "two shards": lambda: sharded(shards),
                    "one shard alone": lambda: half(first_half)}, 2)
    best = {k: min(v) for k, v in ms.items()}
    prof = {"graphed": profiling.route_profile(lambda: sharded(shards), 1),
            "eager": profiling.route_profile(
                lambda: eager(sharded, shards), 1)}
    out["mesh"] = dict(best, profiled=prof)
    log(f"mesh of [cuda:0, cuda:0], graphed ({GRAPH_MESH_SUBSTEPS} substeps "
        f"a shard, one launch a shard): bitwise the unsharded graphed step "
        f"({count} tensors); ms a call: {best} (in turns {ms}); two shards "
        f"take {best['two shards'] / best['one shard alone']:.2f}x one "
        f"shard alone: they "
        f"{'overlap' if best['two shards'] < 1.8 * best['one shard alone'] else 'do not overlap'}"
        f" on the card's one stream, on {card}; two shards: "
        f"{_route_profiles(prof, 'call')}")
    return out


def main() -> int:
    start = time.perf_counter()
    card = phase_device()
    import torch
    from rl_ode_physics_tpu_torch.core.config import (
        bench_config, rollout_config)
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn

    mark = [start]

    def lap(phases: str) -> None:
        now = time.perf_counter()
        log(f"phase {phases}: {now - mark[0]:.1f} s")
        mark[0] = now

    config = bench_config(64)
    floor_ms = phase_build()
    lap("0-1 (device, build)")
    kernels = [phase_kernels()]
    compaction = kernels[0]
    lap("2")
    phase_card_vs_cpu(config)
    lap("3")
    bench_launches, batch = phase_main_path(config, card)
    by_path = {"bench": bench_launches}
    # each path's own tensors: one more substep (or control step) of the
    # settled path with the kernel's wrapper caught, after the counts are read
    compaction["on_main_path_data"] = compaction_on_path_data(
        lambda: make_batched_step_fn(config, substeps=1,
                                     device="cuda")(batch), "bench", 1,
        " (the earlier record on the bench mask: 0.02997 ms)")
    bench_settled = batch            # phase 18 starts its levers from it
    del batch
    lap("4")

    mcfg = mesh_config()
    verts, tris = standin_mesh()
    phase_mesh_card_vs_cpu(mcfg, verts, tris)
    lap("5")
    by_path["trimesh"], batch, mesh, centers = phase_mesh_main_path(
        mcfg, verts, tris, card)
    compaction["on_trimesh_path_data"] = compaction_on_path_data(
        lambda: make_batched_step_fn(mcfg, substeps=1, device="cuda",
                                     trimesh=mesh)(batch), "trimesh", 1)
    lap("6")
    tiles, per_triangle = phase_mesh_kernels(batch, mcfg, mesh, centers,
                                             floor_ms)
    kernels += [tiles, per_triangle]
    lap("7")

    rcfg = rollout_config(64)
    phase_rollout_card_vs_cpu(rcfg)
    lap("8")
    by_path["rollout"], control_step = phase_rollout_main_path(rcfg, card)
    compaction["on_rollout_path_data"] = compaction_on_path_data(
        control_step, "rollout", ROLLOUT_SUBSTEPS)
    lap("9")
    by_path["env_on_mesh"], control_step = phase_env_on_mesh(
        mcfg, verts, tris, batch, mesh)
    compaction["on_env_on_mesh_data"] = compaction_on_path_data(
        control_step, "env-on-a-mesh", ROLLOUT_SUBSTEPS)
    tiles["on_env_on_mesh_data"] = tiles_on_path_data(
        control_step, "env-on-a-mesh", ROLLOUT_SUBSTEPS)
    del batch, control_step
    lap("10")

    phase_pipelines_card_vs_cpu()
    lap("11")
    by_path["capsule_stack"], collide = phase_capsule_main_path(
        capsule_config(), card)
    torch.cuda.empty_cache()
    lap("12")
    ncfg = mini_config()
    by_path["mini_stack"], batch = phase_mini_main_path(ncfg, card)
    compaction["on_mini_stack_path_data"] = compaction_on_path_data(
        lambda: make_batched_step_fn(ncfg, substeps=1, device="cuda")(batch),
        "mini-stack", 1)
    del batch
    torch.cuda.empty_cache()
    lap("13")

    compaction_new, mesh64 = phase_kernels_new_shapes(mesh)
    compaction.update(compaction_new)
    lap("14")
    f64_paths, f32_pgs, stack, ridge = phase_conformance_card_vs_cpu()
    by_path.update(f32_pgs)
    lap("15")
    conformance, on_ridge, conf_args, pgs_paths = phase_conformance_path(
        card, stack, ridge)
    f64_paths.update(conformance)
    # the float64 instances: the same kernels, counted on their own paths
    for entry in kernels:
        f64 = entry["f64"] if "f64" in entry else mesh64[entry["name"]]
        entry["f64"] = f64
        counts = {path: got[entry["name"]] for path, got in f64_paths.items()
                  if got.get(entry["name"])}
        f64["launches"] = sum(counts.values())
        f64["launches_by_path"] = counts
    counts = {path: got["collide_pairs"] for path, got in f64_paths.items()
              if got.get("collide_pairs")}
    collide["f64"]["launches"] = sum(counts.values())
    collide["f64"]["launches_by_path"] = counts
    kernels.append(collide)
    tiles["f64"]["on_ridge_mesh_path_data"] = on_ridge["tiles"]
    per_triangle["f64"]["on_ridge_mesh_path_data"] = on_ridge["d2"]
    by_path.update(f64_paths)
    lap("16")
    probe_launches, probe_entries, _ = phase_device_probes(card)
    by_path.update(probe_launches)
    kernels += probe_entries
    lap("17")

    by_path.update(phase_bench_levers(config, card, bench_settled))
    lap("18")
    dantzig, dantzig_args, dantzig_paths = phase_dantzig(card, stack, ridge)
    by_path.update(dantzig)
    lap("19")
    kernels.append(phase_lcp_kernel(card, dantzig_args))
    del dantzig_args
    torch.cuda.empty_cache()
    lap("19b (lcp_pivot_solve)")
    hinge_paths, (hinge_args, hbatch, hjoints) = phase_hinge_chain(card)
    by_path.update(hinge_paths)
    pgs_paths["hinge"] = (hbatch, hjoints)
    del hbatch
    lap("20")
    pgs_entry = phase_pgs_kernel(card, conf_args, hinge_args)
    kernels.append(pgs_entry)
    del conf_args, hinge_args
    torch.cuda.empty_cache()
    lap("20b (pgs_solve)")
    server_launches, compaction["on_server_path_data"], server = (
        phase_game_server(card))
    by_path.update(server_launches)
    lap("21")
    by_path["sharded"], compaction["on_sharded_path_data"] = phase_mesh(card)
    lap("22 (mesh)")
    phase_es(card)
    lap("23 (ES)")
    phase_referee(card)
    lap("24 (referee)")
    phase_examples(card)
    lap("25 (examples)")
    tool_launches, on_tool_paths = phase_tools(card)
    by_path.update(tool_launches)
    for path, record in on_tool_paths.items():
        entry = compaction if path != "tool_teapot_bench" else tiles
        entry[f"on_{path}_data"] = record
    lap("26 (tools)")
    bench_module, on_bench_paths = phase_bench_module(card)
    by_path.update(bench_module)
    for path, record in on_bench_paths.items():
        compaction[f"on_{path}_data"] = record
    lap("27 (bench module)")
    phase_graphs(card, bench_settled, server, pgs_paths, dantzig_paths)
    del bench_settled, pgs_paths, dantzig_paths
    lap("28 (graphs)")
    # the float64 tile kernel on the DANTZIG ridge path
    f64_ridge = dantzig["dantzig_ridge_mesh"]["sphere_mesh_d2_tiles"]
    tiles["f64"]["launches"] += f64_ridge
    tiles["f64"]["launches_by_path"]["dantzig_ridge_mesh"] = f64_ridge

    for entry in kernels:
        counts = {path: got[entry["name"]] for path, got in by_path.items()
                  if got.get(entry["name"])}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
        if not entry["launches"]:
            raise AssertionError(f"{entry['name']} never launched on a "
                                 f"main path")
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(entry[key]):
                raise AssertionError(f"{entry['name']}: {key} not finite")
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
