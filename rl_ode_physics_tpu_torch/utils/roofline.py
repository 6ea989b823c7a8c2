"""Roofline model of the bench substep on the card: where is the ceiling, per
configuration?

The port of ``benchmarks/roofline.py``, for both bench configurations (the
hb-8 headline and the plain-20 parity line), stating which resource binds:

* **Device-memory bytes**, counted from the operations that eager PyTorch
  runs (``count_substeps``), over the data-sheet rate of
  ``utils/bounds.py`` (3.35 TB/s). The JAX script read XLA's
  ``cost_analysis()`` of the compiled program instead; XLA's "bytes
  accessed" counts each instruction's operands and outputs, as this does
  each operation's.
* **Flops** of the matmul family (``torch.utils.flop_counter``'s
  registry: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, whatever their
  dtype), over the FP32 rate outside the tensor cores (67 TFLOP/s; TF32
  is off). Elementwise work is bytes-bound in eager mode, so its bytes
  carry it: the JSON says ``"flops_counted": "matmul-family"``, since
  XLA's flops counted elementwise work too.
* **Op floor**, measured: the same step at 8 worlds moves next to nothing,
  so its time a substep is what the program's structure costs whatever
  the batch (in the port: the host's launches).

Every time is a **two-depth slope** on the host's clock
(``utils/timing.wall_s``): the step is run at S and 2S substeps a call and
the time a substep is (t(2S) − t(S)) / S, which cancels what a call costs
once. The model, for a launch of ``chunks`` chunks stepped one after
another::

    t_substep >= floor_substep + max(bytes/BW, flops/peak)
    ceiling   = worlds × dynamic / (t_substep × chunks)

How operations are counted (``OpCount``): every dispatched ATen operation
that launches a kernel adds the bytes of its tensor operands (each read
once) and of its outputs (each written once). An in-place operation, or
one with ``out=``, reads and writes its tensor once each. Views
(``func.is_view``) and the ``empty`` family add nothing; ``zeros_like``
and its kin add only their output. The contact
compaction's kernel is called through ``ctypes``, which no dispatch mode
sees: during a count its wrapper adds ``bounds.compaction_bytes`` on its
own mask, and what its plain version runs on the CPU is not counted, so
the card and the CPU count alike. The count runs in a pass of its own,
never inside a timed window::

    python3 -m rl_ode_physics_tpu_torch.utils.roofline [--device cpu]
    BENCH_BW_GBS=..., BENCH_MXU_TFLOPS=...   # override the data sheet

``BENCH_BODIES`` (64), ``BENCH_WORLDS`` (8192), ``BENCH_CHUNK`` (0: the
whole batch, the port's bench default), ``BENCH_SUBSTEPS`` (96, S),
``BENCH_ONLY`` (``headline`` or ``parity``) and the configuration's
overrides of ``rl_ode_physics_tpu_torch.bench.bench_config``. Prints one
JSON object a configuration, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from rl_ode_physics_tpu_torch.utils import bounds, graphs

aten = torch.ops.aten
# operations that return storage without launching a kernel
NO_KERNEL = frozenset(
    (aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
     aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
     aten.resize_, aten._local_scalar_dense))
# factories shaped like an operand they do not read: their output only
WRITE_ONLY = frozenset(
    (aten.zeros_like, aten.ones_like, aten.full_like, aten.new_zeros,
     aten.new_ones, aten.new_full))
FLOOR_WORLDS = 8
COUNTED_SUBSTEPS = 2


def _tensor_bytes(tree) -> int:
    """The bytes of every tensor in a nest of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


class OpCount(TorchDispatchMode):
    """Counts what the operations run under it move and compute: ``bytes``,
    matmul-family ``flops``, ``ops``, a census of the operations that
    launch a kernel by name (the overload packet's, e.g. ``bmm``,
    ``copy_``), and ``op_bytes``, the bytes by that name. ``add`` books a
    kernel the mode cannot see; inside ``paused()`` nothing is counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0
        self.ops = collections.Counter()
        self.op_bytes = collections.Counter()
        self._paused = False

    @contextlib.contextmanager
    def paused(self):
        was, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = was

    def add(self, name: str, nbytes: int, flops: int = 0) -> None:
        self.ops[name] += 1
        self.op_bytes[name] += nbytes
        self.bytes += nbytes
        self.flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if self._paused or func.is_view or packet in NO_KERNEL:
            return out
        flops = 0
        formula = flop_registry.get(packet)
        if formula is not None:
            # the formulas take the tensor operands' shapes in order (a
            # dtype argument, as bmm's out_dtype overload has, is left out)
            flops = formula(*[a for a in args if isinstance(a, torch.Tensor)],
                            out_val=out)
        read = 0 if packet in WRITE_ONLY else _tensor_bytes((args, kwargs))
        self.add(packet.__name__, read + _tensor_bytes(out), flops)
        return out


@contextlib.contextmanager
def _compaction_booked(mode: OpCount):
    """``compaction_kernel.compact_rows_t`` wrapped so that each call is
    booked in ``mode`` as one kernel moving ``bounds.compaction_bytes``,
    whatever runs it (the kernel on the card, the plain version on the
    CPU)."""
    from rl_ode_physics_tpu_torch.ops import compaction_kernel as ck
    real = ck.compact_rows_t

    def booked(mask, payload_t, k, sel_dtype=None):
        with mode.paused():
            out = real(mask, payload_t, k, sel_dtype)
            nbytes = bounds.compaction_bytes(mask, payload_t.shape[1], k,
                                             payload_t.element_size())
        mode.add("compact_rows_t", nbytes)
        return out

    # the wrapper counts its launches on the module's name for it
    booked.launches = real.launches
    ck.compact_rows_t = booked
    try:
        yield
    finally:
        ck.compact_rows_t = real
        real.launches = booked.launches


def count_substeps(config, batch, substeps: int = COUNTED_SUBSTEPS) -> dict:
    """Run ``substeps`` substeps of ``config`` on ``batch`` under an
    ``OpCount``, the compaction kernel booked by its bytes: the totals over
    those substeps (``bytes``, ``flops``, and ``ops`` and ``op_bytes``,
    ``Counter``s by operation), their number and the ``state`` they end
    in."""
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    step = make_batched_step_fn(config, substeps=substeps,
                                device=batch.pos.device)
    mode = OpCount()
    # eager: a graph's replay runs no operation that the mode could see
    with graphs.disable_graphs(), _compaction_booked(mode), mode:
        state = step(batch)
    return dict(bytes=mode.bytes, flops=mode.flops, ops=mode.ops,
                op_bytes=mode.op_bytes,
                substeps=substeps, state=state)


def roofline_model(bytes_sub: float, flops_sub: float, t_sub: float,
                   floor_sub: float, *, worlds: int, chunk: int,
                   dynamic: int, bw_gbs: float, peak_tflops: float) -> dict:
    """``benchmarks/roofline.py``'s model on a chunk's bytes and flops a
    substep, the chunk's measured seconds a substep ``t_sub`` and the op
    floor's ``floor_sub``: the times in ms, which resource binds, the
    sustained rates and the ceilings in body-steps/s."""
    t_bytes = bytes_sub / (bw_gbs * 1e9)
    t_flops = flops_sub / (peak_tflops * 1e12)
    t_stream = max(t_bytes, t_flops)
    t_model = t_stream + floor_sub
    chunks = worlds // chunk
    return {
        "t_bytes_ms": t_bytes * 1e3,
        "t_flops_ms": t_flops * 1e3,
        "t_floor_ms": floor_sub * 1e3,
        "t_model_ms": t_model * 1e3,
        "t_measured_ms": t_sub * 1e3,
        "bound": ("bytes" if t_bytes > t_flops else "flops")
                 if t_stream > floor_sub else "op-floor",
        "hbm_gbs_sustained": bytes_sub / t_sub / 1e9,
        "mxu_tflops_sustained": flops_sub / t_sub / 1e12,
        "ceiling_body_steps_per_sec": worlds * dynamic / (t_model * chunks),
        "implied_at_measured": worlds * dynamic / (t_sub * chunks),
        "measured_over_model": t_sub / t_model,
    }


def _slope_per_substep(config, batch, substeps: int, reps: int = 3):
    """Seconds a substep by the two-depth slope (t(2S) − t(S)) / S, and
    t(S), each the least of ``reps`` calls from the same ``batch``."""
    from rl_ode_physics_tpu_torch.parallel.batch import make_batched_step_fn
    from rl_ode_physics_tpu_torch.utils.timing import wall_s
    device = batch.pos.device
    t = {}
    for s in (substeps, 2 * substeps):
        step = make_batched_step_fn(config, substeps=s, device=device)
        t[s] = wall_s(lambda: step(batch), reps, device)
    return (t[2 * substeps] - t[substeps]) / substeps, t[substeps]


def measure_config(label: str, config, num_bodies: int, chunk: int,
                   substeps: int, bw_gbs: float, peak_tflops: float,
                   worlds: int, device="cuda") -> dict:
    """Count and time one configuration at ``chunk`` worlds (and the op
    floor at 8); print and return the JSON object, with the card's name
    and power limit (``"cpu"`` on the CPU)."""
    from rl_ode_physics_tpu_torch.models import scenes
    from rl_ode_physics_tpu_torch.parallel.batch import replicate
    from rl_ode_physics_tpu_torch.utils.timing import card_label

    world = scenes.bench_world(config, num_bodies=num_bodies - 4,
                               device=device)
    batch = replicate(world, chunk, device=device)
    count = count_substeps(config, batch)
    n = count["substeps"]
    bytes_sub, flops_sub = count["bytes"] / n, count["flops"] / n
    ops_sub = sum(count["ops"].values()) / n
    del count

    t_sub, t_launch = _slope_per_substep(config, batch, substeps)
    floor_sub, _ = _slope_per_substep(
        config, replicate(world, FLOOR_WORLDS, device=device), substeps)
    out = {"config": label, "card": card_label(device), "chunk": chunk,
           "substeps": substeps,
           "bytes/substep/chunk": bytes_sub,
           "flops/substep/chunk": flops_sub,
           "ops/substep/chunk": ops_sub,
           "flops_counted": "matmul-family"}
    out.update(roofline_model(
        bytes_sub, flops_sub, t_sub, floor_sub, worlds=worlds, chunk=chunk,
        dynamic=int((world.inv_mass > 0).sum()), bw_gbs=bw_gbs,
        peak_tflops=peak_tflops))
    out["t_single_launch_ms"] = t_launch * 1e3
    print(json.dumps(out, indent=1), flush=True)
    return out


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch import bench
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the card)")
    args = ap.parse_args(argv)
    require_card("roofline", args.device)
    env = os.environ
    num_bodies = int(env.get("BENCH_BODIES", 64))
    worlds = int(env.get("BENCH_WORLDS", 8192))
    chunk = int(env.get("BENCH_CHUNK", 0)) or worlds
    substeps = int(env.get("BENCH_SUBSTEPS", 96))
    # the card's data sheet (utils/bounds.py), FP32 since TF32 is off
    bw = float(env.get("BENCH_BW_GBS", bounds.HBM_BYTES_PER_S / 1e9))
    peak = float(env.get("BENCH_MXU_TFLOPS", bounds.FP32_OPS_PER_S / 1e12))
    if worlds % chunk:
        raise ValueError(f"BENCH_WORLDS={worlds} is no multiple of "
                         f"BENCH_CHUNK={chunk}")

    only = env.get("BENCH_ONLY", "")
    for parity in (False, True):
        if only == "parity" and not parity:
            continue
        if only == "headline" and parity:
            continue
        cfg = bench.bench_config(num_bodies, parity=parity)
        measure_config("parity plain-20" if parity else "headline hb-8",
                       cfg, num_bodies, chunk, substeps, bw, peak, worlds,
                       args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
