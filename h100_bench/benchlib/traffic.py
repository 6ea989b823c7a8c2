"""The one generator of every traffic mix: seeded worlds and their resets.

A configuration's file names its scenes as data (static boxes, bodies, a
grid of boxes and spheres, a rain of boxes and spheres); a traffic file
picks one and says how many worlds, how they are drawn from ``--seed``,
how many substeps a call takes and when a world's episode restarts. The
worlds reach the program only through its public builder
(``models.builder.WorldBuilder``).

Resets: with ``episode_substeps`` E > 0, world i restarts at the start of
every call whose first substep t has ``(t - c*i) mod E == 0`` (c the
substeps a call), from pool world ``(i // k + 5 * (i % k) + 3 * episode)
mod P`` (k = E / c, P = ``pool_worlds``; the episode counts from 0 at the
run's first call), applied in place on the device with precomputed
indices and no host read.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

TYPES = {"sphere": 1, "box": 2, "capsule": 3}
# the fields a reset writes: the pose and the motion; a pool whose worlds
# differ in any other field takes no resets
RESET_FIELDS = ("pos", "quat", "linvel", "angvel")


def engine_config(cfg: dict):
    """The program's ``EngineConfig`` from a configuration file's
    ``engine`` fields."""
    from rl_ode_physics_tpu_torch.core.config import EngineConfig, SolverKind
    fields = dict(cfg["engine"])
    fields["solver"] = SolverKind(fields["solver"])
    fields["gravity"] = tuple(fields["gravity"])
    fields["bucket_caps"] = tuple(tuple(c) for c in fields["bucket_caps"])
    fields["mu"] = float(fields["mu"])
    return EngineConfig(**fields).validate()


def rng(seed: int, salt: int) -> np.random.Generator:
    """The run's stream for one purpose (``salt``), from ``--seed``."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), salt])


def grid_bodies(grid: dict) -> list:
    """The bench workload's grid: ``count`` bodies, boxes at even and
    spheres at odd places, on a cube of side ceil(count^(1/3)) at
    ``spacing``, rows from ``base_y`` up."""
    count = int(grid["count"])
    side = int(math.ceil(count ** (1.0 / 3.0)))
    out = []
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if len(out) >= count:
                    return out
                pos = [(ix - side / 2) * grid["spacing"],
                       grid["base_y"] + iy * grid["spacing"],
                       (iz - side / 2) * grid["spacing"]]
                if len(out) % 2 == 0:
                    b = grid["box_size"]
                    out.append({"type": "box", "pos": pos, "size": [b, b, b]})
                else:
                    out.append({"type": "sphere", "pos": pos,
                                "size": [grid["sphere_radius"], 0.0, 0.0]})
    return out


def rain_bodies(rain: dict, r: np.random.Generator, worlds: int) -> list:
    """``worlds`` lists of ``count`` bodies from the reference's spawn
    distribution: x, y, z uniform in the ``x``, ``y``, ``z`` ranges; a
    box (sides uniform in ``box_side``) or a sphere (radius uniform in
    ``sphere_radius``) with even odds."""
    n = int(rain["count"])
    pos = np.stack([r.uniform(*rain[k], size=(worlds, n))
                    for k in ("x", "y", "z")], -1)
    is_box = r.integers(0, 2, size=(worlds, n)) == 0
    sides = r.uniform(*rain["box_side"], size=(worlds, n, 3))
    radius = r.uniform(*rain["sphere_radius"], size=(worlds, n))
    return [[{"type": "box", "pos": pos[w, i], "size": sides[w, i]}
             if is_box[w, i] else
             {"type": "sphere", "pos": pos[w, i],
              "size": [radius[w, i], 0.0, 0.0]}
             for i in range(n)] for w in range(worlds)]


def _world(config, spec: dict, drawn: list):
    """One world of a scene through the program's builder, on the CPU:
    the static boxes, then ``drawn`` bodies, then the scene's own."""
    from rl_ode_physics_tpu_torch.models.builder import WorldBuilder
    b = WorldBuilder(config, 0)
    for box in spec.get("static_boxes", []):
        b.add_body_map(tuple(box["pos"]), tuple(box["euler"]),
                       tuple(box["size"]))
    for body in drawn + list(spec.get("bodies", [])):
        b.add_body(TYPES[body["type"]], tuple(body["pos"]),
                   tuple(body["size"]),
                   quat=None if "quat" not in body else tuple(body["quat"]),
                   kinematic=bool(body.get("kinematic", False)))
    return b.finish("cpu")


def pool(cfg: dict, traffic: dict, seed: int):
    """``pool_worlds`` worlds of the traffic's scene on the CPU, drawn from
    the seed: a ``grid`` scene's dynamic bodies each moved in x and z by
    up to ``jitter_xz`` (uniform), a ``rain`` scene's bodies drawn anew in
    every world."""
    import torch
    from rl_ode_physics_tpu_torch.parallel.batch import (
        concat_worlds, replicate)
    config = engine_config(cfg)
    spec = cfg["scenes"][traffic["scene"]]
    p = int(traffic["pool_worlds"])
    if "rain" in spec:
        drawn = rain_bodies(spec["rain"], rng(seed, 1), p)
        worlds = concat_worlds([_world(config, spec, d) for d in drawn])
    else:
        template = _world(config, spec, grid_bodies(spec["grid"]))
        worlds = replicate(template, p, reseed=False, device="cpu")
        dyn = np.flatnonzero((template.inv_mass[0] > 0).numpy())
        j = float(traffic.get("jitter_xz", 0.0))
        offsets = rng(seed, 1).uniform(-j, j, size=(p, len(dyn), 2))
        pos = worlds.pos.numpy()
        pos[:, dyn, 0] += offsets[..., 0].astype(pos.dtype)
        pos[:, dyn, 2] += offsets[..., 1].astype(pos.dtype)
    seeds = rng(seed, 2).integers(0, 2 ** 32, size=p)
    worlds.rng_state.copy_(torch.as_tensor(seeds))
    return worlds


def initial_batch(pool_worlds, traffic: dict, device):
    """World i of the batch starts as pool world i mod P, on ``device``."""
    import torch
    from rl_ode_physics_tpu_torch.core.state import WorldState
    b = int(traffic["worlds"])
    idx = torch.arange(b) % pool_worlds.num_worlds
    return WorldState(**{
        f.name: getattr(pool_worlds, f.name)[idx].contiguous().to(device)
        for f in dataclasses.fields(WorldState)})


class Resets:
    """The staggered episode resets of a traffic mix, on ``device``.

    ``apply(batch, call)`` writes, before call ``call`` (0 is the first
    call of the run, set-up included), the pool worlds due into the worlds
    whose episode restarts: a gather and a scatter a field, no host read.
    ``due(call)`` lists those worlds and their sources on the host."""

    def __init__(self, pool_worlds, traffic: dict, device):
        import torch
        self.episode = int(traffic.get("episode_substeps", 0))
        self.per_call = int(traffic["substeps_per_call"])
        self.worlds = int(traffic["worlds"])
        self.enabled = self.episode > 0
        if not self.enabled:
            return
        if self.episode % self.per_call:
            raise ValueError("episode_substeps must be a multiple of "
                             "substeps_per_call")
        self.k = self.episode // self.per_call          # calls an episode
        self.p = pool_worlds.num_worlds
        for f in dataclasses.fields(pool_worlds):
            v = getattr(pool_worlds, f.name)
            if (f.name not in RESET_FIELDS + ("rng_state",) and v.shape[0]
                    and not bool((v == v[:1]).all())):
                raise ValueError(f"the pool's worlds differ in {f.name}: a "
                                 f"reset writes {RESET_FIELDS} alone")
        phase = np.arange(self.worlds) % self.k
        self.phase = phase
        self.by_phase = [torch.as_tensor(np.flatnonzero(phase == r),
                                         device=device)
                         for r in range(self.k)]
        i = np.arange(self.worlds)
        self.base = i // self.k + 5 * (i % self.k)
        self.base_by_phase = [torch.as_tensor(self.base[phase == r],
                                              device=device)
                              for r in range(self.k)]
        self.pool = {name: getattr(pool_worlds, name).to(device)
                     for name in RESET_FIELDS}

    def due(self, call: int):
        """(worlds, pool sources) restarted before ``call``, on the host."""
        if not self.enabled:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        r = call % self.k
        worlds = np.flatnonzero(self.phase == r)
        return worlds, (self.base[worlds] + 3 * (call // self.k)) % self.p

    def apply(self, batch, call: int) -> None:
        import torch
        if not self.enabled:
            return
        r = call % self.k
        idx = self.by_phase[r]
        if idx.numel() == 0:
            return
        src = torch.remainder(self.base_by_phase[r]
                              + 3 * (call // self.k) % self.p, self.p)
        for name in RESET_FIELDS:
            getattr(batch, name).index_copy_(
                0, idx, self.pool[name].index_select(0, src))
