"""Engine configuration: the JAX package's ``core/config.py``, copied.

The port keeps its own copy so that it never imports ``rl_ode_physics_tpu``
(importing even its config runs that package's ``__init__``, which pulls in
JAX). The fields, defaults, policy constructors and ``validate`` are the
JAX package's, field for field, so one set of keyword arguments builds the
same configuration on both sides. Comments that speak of XLA, the MXU or
Pallas describe the JAX reference; the port reads only the values.

``bench_config`` at the end is the port's copy of ``bench.bench_config`` at
its defaults (``bench.py`` imports JAX at module level, so the port cannot
reuse it).
"""

from __future__ import annotations

import dataclasses
import enum
import math


def jnp_dtype_is_bf16(name: str) -> bool:
    """dtype-string check without importing jax at module import time."""
    return str(name) in ("bfloat16", "bf16")


class SolverKind(enum.Enum):
    """Contact solver flavor.

    * ``PGS`` — sequential projected Gauss-Seidel (ODE QuickStep ordering):
      a ``lax.scan`` over contact rows. Matches ODE's convergence behavior
      most closely; per-world sequential, so best for conformance runs.
      PERFORMANCE WARNING: the row scan does per-row dynamic-index
      scatters inside the iteration loop — on TPU this is orders of
      magnitude slower than JACOBI (a conformance oracle, not a
      throughput path).
    * ``JACOBI`` — batched projected Jacobi with under-relaxation: every
      contact row updates in parallel from the previous iterate. The
      TPU-native throughput solver — one fused vector pass per iteration
      across the whole world batch.
    * ``DANTZIG`` — direct LCP (Lemke/Dantzig principal pivoting like ODE's
      ``dWorldStep``, the call the reference actually makes at
      ``src/main.c:213``). f64 conformance path, not a throughput solver.

    (A fourth kind, ``FUSED`` — a whole-substep Pallas megakernel — was
    built, bitwise-verified, and RETIRED in round 3: measured slower than
    the jnp JACOBI path it duplicated at every tried granularity, because
    XLA already keeps the chunked solver loop's working set VMEM-resident
    and the in-kernel per-world matmuls pay the same MXU B-operand-load
    floor. Full record in docs/BENCHMARKS.md.)
    """

    PGS = "pgs"
    JACOBI = "jacobi"
    DANTZIG = "dantzig"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters. Hashable → usable as a jit static arg."""

    # --- capacities (static shapes) -------------------------------------
    max_bodies: int = 512           # inc/body.h:6
    max_pair_candidates: int = 2048  # broadphase survivor capacity (pairs)
    max_contacts_per_pair: int = 8   # src/main.c:675 (dCollide MAX_CONTACTS)
    max_contacts: int = 2048         # solver row capacity per world

    # --- time stepping ---------------------------------------------------
    dt: float = 1.0 / 120.0         # src/main.c:208 (120 Hz fixed substep)
    gravity: tuple = (0.0, -9.8, 0.0)  # src/main.c:96

    # --- solver ----------------------------------------------------------
    solver: SolverKind = SolverKind.JACOBI
    solver_iterations: int = 20      # ODE QuickStep default
    sor_omega: float = 1.3           # ODE QuickStep default SOR relaxation
    jacobi_omega: float = 1.0        # Jacobi under-relaxation (mass-split scaled)
    # heavy-ball momentum on the projected Jacobi iterate (0 = plain Jacobi,
    # the ODE-parity default). Opt-in throughput knob: a beta in ~[0.3, 0.5]
    # reaches plain-Jacobi-at-20-iterations solution quality in fewer
    # sweeps (measured by benchmarks/solver_convergence.py).
    jacobi_beta: float = 0.0
    # unroll factor for the Jacobi iteration loop (1 = rolled fori_loop).
    # The production chunk regime is dispatch-floor-bound (~2.6 us/op at
    # chunk 128): unrolling removes the while-loop carry copies and lets
    # XLA fuse across iterations. Full unroll = solver_iterations.
    solver_loop_unroll: int = 1
    # per-body surface parameters: contact rows mix the two bodies'
    # WorldState.friction/restitution as min(mu) / max(bounce) instead of
    # using the global mu/bounce (beyond parity — ODE sets these per
    # contact in the NearCallback). JACOBI and PGS.
    per_body_surface: bool = False
    erp: float = 0.2                 # ODE default (never overridden by ref)
    cfm: float = 1e-5                # ODE dSINGLE default
    max_correcting_vel: float = 1e30  # ODE dWorldSetContactMaxCorrectingVel default (inf)

    # --- geometry capabilities (static: prune unused pair kernels) -------
    # The branch-free narrowphase evaluates every enabled pair kernel for
    # every candidate pair; disabling types a scene never uses shrinks the
    # compiled program (the reference scene is spheres+boxes only,
    # inc/body.h:14-18).
    enable_capsules: bool = True
    enable_planes: bool = True
    # exact ODE-style Sutherland-Hodgman box-box face clipping (conformance
    # path; slower on TPU — the default is the branch-free 8-candidate
    # manifold, see ops/narrowphase.py)
    exact_box_clip: bool = False
    # dense all-pairs pipeline (ops/dense.py): no compaction/selectors/
    # gathers — O(N²K) memory, the fast path for ≲128-body worlds; the
    # sparse compacted pipeline is the default and required for trimesh
    dense_pipeline: bool = False
    # typed-bucket narrowphase (ops/narrowphase.py:narrowphase_typed): one
    # compacted candidate list per pair type, each running only its own
    # kernel at its intrinsic manifold size. Throughput path for
    # JACOBI (contact rows grouped by bucket, not global pair order);
    # conformance runs keep the classic path. Default per-bucket candidate
    # capacity is max_pair_candidates; override per type pair via
    # bucket_caps = ((t1, t2, cap), ...).
    typed_buckets: bool = False
    bucket_caps: tuple = ()
    # trimesh phase-1 probes per body (ops/trimesh.py:mesh_narrowphase):
    # 3 = body center + the two long-axis extremities (boxes/capsules), so
    # a long body spanning separated mesh regions keeps candidate
    # triangles under BOTH ends; 1 = center-only (round-2 behavior,
    # cheaper — the phase-1 tile sweep cost scales with probe count).
    mesh_probes: int = 3
    # component-major typed-bucket narrowphase (ops/narrowphase_cm.py):
    # the same pipeline with pairs-in-lanes layout end to end — the
    # round-4 fix for the lane-padding machinery tax (67% of the substep,
    # docs/BENCHMARKS.md). Applies only when typed_buckets is on and every
    # enabled bucket has a CM kernel at its manifold size
    # (narrowphase_cm.supports_cm); otherwise the row-major path runs.
    # Same math, f32-roundoff-identical results, slot-major row order
    # within buckets. Off = always row-major (A/B lever).
    cm_narrowphase: bool = True
    # component-major JACOBI iteration loop: the solver's per-iteration
    # working set transposed to contacts-in-lanes — J/response planes
    # (8, 2C) instead of (2C, 8), lambda/d/target as (1, C) instead of
    # (C, 1), velocity carry (8, N). Gather is (8, N)·(N, 2C), scatter
    # (8, 2C)·(2C, N) — same MXU B-operand areas, but every elementwise
    # op in the loop runs on full 128-lane tiles instead of 8/128
    # (round-4 A/B lever; applies to contact-only solves — with joints,
    # warm starting, or lambda outputs the row-major loop runs).
    solver_cm: bool = False
    # windowed sweep-and-prune pair phase (round 4, the SURVEY §7 "is
    # all-pairs fine?" answer for the reference's MAX_BODIES=512 shape):
    # bodies sort by AABB x-min once per substep and each body only
    # tests the next ``sap_window`` bodies in sorted order, replacing
    # every O(N²) pair structure (eligibility masks, bucket-compaction
    # cumsums) with O(N·W). A pair whose x-intervals overlap beyond the
    # window is COUNTED LOUDLY into WorldState.overflow (conservative:
    # the count ignores the non-x filters), same policy as the contact
    # caps — size W to the measured occupancy. 0 = dense all-pairs (the
    # default; right for <=64 slots where N², at 64², is already small).
    # Requires the component-major typed-bucket path. Contact (a, b)
    # roles follow sorted-x order, not slot order — JACOBI-only like the
    # rest of the typed path; warm-start keys stay slot-based and only
    # miss on the rare substep where a pair swaps x-order.
    sap_window: int = 0
    # SAP broad-body capacity: the ``sap_broad`` bodies with the LARGEST
    # x-extent (the arena floor/walls — bodies that x-overlap everything
    # and would blow any window) are taken out of the sort and paired
    # DENSELY as extra mask columns (N×B) plus a B×B broad-broad block.
    # Bodies beyond this capacity stay in the window path, where an
    # oversized extent shows up in the loud window-miss counter.
    sap_broad: int = 8
    # contact-payload compaction via the VMEM one-hot Pallas kernel
    # (ops/compaction_pallas.py) on TPU backends — bitwise-identical to the
    # jnp selector-matmul path, minus the HBM round-trip of the (M, C)
    # one-hot. Off by default: isolated it is 1.4× faster, but end-to-end
    # the production chunk regime is op-dispatch-floor-bound and the kernel
    # boundary costs more than the HBM it saves (docs/BENCHMARKS.md).
    # Auto-falls back to the jnp path off-TPU.
    pallas_compaction: bool = False

    # --- contact surface (reference NearCallback, src/main.c:684-687) ----
    bounce: float = 0.2
    bounce_vel: float = 0.1
    mu: float = math.inf             # dInfinity friction
    friction: bool = True

    # --- numerics --------------------------------------------------------
    dtype: str = "float32"
    # dtype of the solver's contact<->body selector matmuls (the dominant
    # per-iteration cost). "bfloat16" halves bytes and doubles MXU rate; the
    # selector itself is exact (0/1) — only gathered velocities are rounded.
    solver_matmul_dtype: str = "float32"
    # dtype of the typed-bucket narrowphase/compaction selector matmuls
    # (pair-feature gathers and the contact payload compaction). The one-hot
    # selectors are exact in any dtype; "bfloat16" halves their HBM bytes.
    # On TPU at matmul_precision="default" this is numerically IDENTICAL to
    # float32 (the MXU rounds f32 operands to bf16 per pass anyway); on CPU
    # or at higher matmul precisions it rounds gathered features/contact
    # geometry to bf16 — keep "float32" for conformance runs. Integer
    # payload columns (body ids ≤ 256, manifold slots) stay exact in bf16;
    # contact keys are recomputed in int32 after compaction.
    selector_dtype: str = "float32"
    # XLA matmul precision for the whole step. TPU "default" runs f32
    # matmuls as bf16 MXU passes — the one-hot selection matmuls therefore
    # round gathered positions/velocities to bf16 (~3 decimal digits; all
    # conformance tests pass). "float32" (3-pass bf16x3) restores exact f32
    # at ~40% step cost — use for conformance-grade runs.
    matmul_precision: str = "default"

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # --- precision-policy profiles (docs/CONFORMANCE.md §2) ---------------
    # The documented policy has two modes; these constructors ARE the policy
    # (bench.py, __graft_entry__.py, the conformance tools and tests all
    # build from them, so "the shipped setting" has one definition):
    #
    # * RL/throughput mode (`EngineConfig.throughput()`): statistical
    #   trajectory realism at maximum speed — bf16 MXU passes, heavy-ball
    #   Jacobi at its measured convergence-parity budget, typed buckets,
    #   K=4 fold-merge manifolds.
    # * trajectory-fidelity mode (`EngineConfig.conformance()`): per-
    #   trajectory agreement with the f64 QuickStep referee — exact f32
    #   matmuls, PGS in ODE row order, exact Sutherland-Hodgman box
    #   clipping, K=8.
    #
    # One wrong default (running a fidelity-minded experiment at the TPU
    # default matmul precision) silently costs ~20x trajectory error
    # (docs/CONFORMANCE.md: 0.74 vs 3.6e-2 max rel err over 1k steps).

    @classmethod
    def throughput(cls, **overrides) -> "EngineConfig":
        """The SHIPPED throughput configuration (RL mode).

        Solver: heavy-ball Jacobi, 8 sweeps, omega=1.3, beta=0.9 — measured
        >= plain-Jacobi-at-20 convergence AND multi-seed trajectory-stable
        (benchmarks/solver_convergence.py, docs/BENCHMARKS.md; both gates
        required). Narrowphase: typed buckets, K=4 fold-merge manifolds.
        Numerics: TPU-default matmul precision (bf16 MXU passes), bf16
        one-hot selectors when ``max_bodies <= 256`` (numerically identical
        to f32 selectors at default precision — the MXU rounds f32 operands
        to bf16 per pass anyway; above 256 slots body ids stop being
        bf16-exact, so f32 selectors are chosen automatically).

        Capacities (max_bodies/max_contacts/bucket_caps) are scene-
        dependent and NOT part of the policy — size them to measured peaks
        (benchmarks/capacity_audit.py) and pass as overrides.
        """
        policy = dict(
            solver=SolverKind.JACOBI,
            solver_iterations=8,
            jacobi_omega=1.3,
            jacobi_beta=0.9,
            typed_buckets=True,
            max_contacts_per_pair=4,
            matmul_precision="default",
        )
        policy.update(overrides)
        if "selector_dtype" not in overrides:
            n = policy.get("max_bodies", cls.max_bodies)
            policy["selector_dtype"] = ("bfloat16" if n <= 256
                                        else "float32")
        return cls(**policy).validate()

    @classmethod
    def conformance(cls, **overrides) -> "EngineConfig":
        """Trajectory-fidelity configuration (referee-comparable).

        PGS in ODE QuickStep row order at ODE's default budget (20
        iterations, SOR 1.3), classic (non-bucketed) narrowphase so contact
        rows keep global pair order, exact Sutherland-Hodgman box-box
        clipping, K=8 manifolds, exact-f32 matmuls everywhere. For the full
        f64 referee bar, additionally pass ``dtype="float64"`` in a
        process with ``jax_enable_x64`` (see tests/_traj_engine.py).
        """
        policy = dict(
            solver=SolverKind.PGS,
            solver_iterations=20,
            sor_omega=1.3,
            typed_buckets=False,
            exact_box_clip=True,
            max_contacts_per_pair=8,
            selector_dtype="float32",
            solver_matmul_dtype="float32",
            matmul_precision="float32",
        )
        policy.update(overrides)
        return cls(**policy).validate()

    @property
    def is_fidelity_grade(self) -> bool:
        """True when matmuls are exact (no bf16 MXU rounding anywhere) —
        the precondition for quoting trajectory-fidelity numbers.
        Conformance-grade tools assert this unless they are intentionally
        measuring the default-precision (RL-mode) error."""
        return (self.matmul_precision in ("float32", "highest")
                and not jnp_dtype_is_bf16(self.selector_dtype)
                and not jnp_dtype_is_bf16(self.solver_matmul_dtype))

    def validate(self) -> "EngineConfig":
        """Reject unsupported feature compositions at CONFIG time.

        The full capability matrix is documented in docs/API.md; every
        unsupported cell errors here (when the step function is built), not
        as a mid-trace surprise. Returns self so call sites can chain.
        """
        errors = []
        if (jnp_dtype_is_bf16(self.selector_dtype)
                and self.max_bodies > 256):
            errors.append(
                "selector_dtype='bfloat16' requires max_bodies <= 256 "
                "(body slot ids ride the selector matmuls and must be "
                "bf16-exact).")
        key_space = self.max_bodies ** 2 * self.max_contacts_per_pair
        if key_space >= 2 ** 24:
            errors.append(
                f"contact-key space {key_space} (max_bodies="
                f"{self.max_bodies}, K={self.max_contacts_per_pair}) "
                f"exceeds the f32 exact-integer range 2^24; warm-start "
                f"keys packed through the f32 payload would silently "
                f"collide. Reduce max_bodies or max_contacts_per_pair.")
        if self.dense_pipeline and self.typed_buckets:
            errors.append(
                "dense_pipeline and typed_buckets are mutually exclusive "
                "narrowphase strategies.")
        if self.mesh_probes not in (1, 3):
            errors.append(
                f"mesh_probes={self.mesh_probes} is not supported: the "
                f"trimesh phase-1 probe stack is 1 (body center) or 3 "
                f"(center + the two long-axis extremities) — see "
                f"ops/trimesh.py mesh_narrowphase.")
        if self.sap_window:
            if not (self.typed_buckets and self.cm_narrowphase):
                errors.append(
                    "sap_window requires the component-major typed-bucket "
                    "narrowphase (typed_buckets=True, cm_narrowphase=True) "
                    "— the windowed pair phase is implemented there only.")
            if self.sap_window >= self.max_bodies:
                errors.append(
                    f"sap_window={self.sap_window} >= max_bodies="
                    f"{self.max_bodies}: the window covers all pairs; use "
                    f"the dense default (sap_window=0) instead.")
        if errors:
            raise ValueError(
                "unsupported EngineConfig composition:\n- "
                + "\n- ".join(errors))
        return self

    def bucket_capacity(self, t1: int, t2: int) -> int:
        """Candidate capacity of the (t1, t2) typed narrowphase bucket."""
        for (b1, b2, cap) in self.bucket_caps:
            if (b1, b2) == (t1, t2):
                return int(cap)
        return self.max_pair_candidates

    @property
    def num_pairs(self) -> int:
        """Upper-triangular all-pairs count for max_bodies."""
        n = self.max_bodies
        return n * (n - 1) // 2


# A small-world config handy for tests and the throughput benchmark
# (BASELINE.md workload: 8192 worlds × 64 bodies).
BENCH_CONFIG = EngineConfig(
    max_bodies=64,
    max_pair_candidates=512,
    max_contacts=512,
)


def bench_bucket_caps(num_bodies: int) -> tuple:
    """``bench._bucket_caps`` without its environment override: the
    typed-bucket pair capacities of the bench shapes."""
    if num_bodies <= 64:
        ss, sb, bb = 96, 96, 48
    elif num_bodies == 512:
        ss, sb, bb = 512, 768, 896
    else:
        ss = sb = 2 * num_bodies
        bb = num_bodies
    return ((1, 1, ss), (1, 2, sb), (2, 2, bb))


def bench_config(num_bodies: int = 64) -> EngineConfig:
    """The configuration ``bench.bench_config(num_bodies)`` resolves to with
    no environment overrides: the throughput policy (heavy-ball Jacobi, 8
    sweeps, omega 1.3, beta 0.9, typed buckets, K=4) with the bench's
    capacities, spheres and boxes only, and ``pallas_compaction=True``: the
    bench run with ``BENCH_PALLAS_COMPACT=1``, whose contact compaction runs
    through the kernel (the same numbers as the default path)."""
    return EngineConfig.throughput(
        solver=SolverKind.JACOBI,
        solver_iterations=8,
        jacobi_omega=1.3,
        jacobi_beta=0.9,
        solver_loop_unroll=1,
        friction=True,
        max_bodies=num_bodies,
        max_pair_candidates=4 * num_bodies,
        max_contacts=(64 if num_bodies == 64
                      else 768 if num_bodies == 512 else 2 * num_bodies),
        max_contacts_per_pair=4,
        enable_capsules=False,
        enable_planes=False,
        solver_matmul_dtype="float32",
        selector_dtype="bfloat16" if num_bodies <= 256 else "float32",
        typed_buckets=True,
        bucket_caps=bench_bucket_caps(num_bodies),
        pallas_compaction=True,
        cm_narrowphase=True,
        solver_cm=False,
        sap_window=0,
    )


def rollout_config(num_bodies: int = 64) -> EngineConfig:
    """The configuration ``benchmarks/rl_rollout_bench.py`` builds at its
    defaults (that script imports JAX, so the port keeps its own copy): the
    throughput policy with the bench's bucket capacities, spheres and boxes
    only, and 80 contact rows where the raw bench has 64, because the
    force-driven actors push the peak above the resting scene's; with
    ``pallas_compaction=True``, whose contact compaction runs through the
    kernel (the same numbers as the default path). Only ``num_bodies=64``
    has been run; another width copies that script's ``2 * num_bodies``
    contact rows, unmeasured."""
    return EngineConfig.throughput(
        max_bodies=num_bodies,
        max_pair_candidates=4 * num_bodies,
        max_contacts=80 if num_bodies == 64 else 2 * num_bodies,
        enable_capsules=False,
        enable_planes=False,
        bucket_caps=((1, 1, 96), (1, 2, 96), (2, 2, 48)),
        pallas_compaction=True,
    )
