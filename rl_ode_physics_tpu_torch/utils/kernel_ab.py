"""Two or more source files of one hand-written kernel, timed in turns on
one card.

Run on a machine with a CUDA card, from the root of the checkout::

    python3 -m rl_ode_physics_tpu_torch.utils.kernel_ab \\
        --mesh old=build/parent/sphere_mesh_d2.cu,-fmad=false --mesh new= \\
        --compact old=build/parent/compact_rows.cu --compact new= \\
        --probe old=build/parent/device_probe.cu --probe new= \\
        [--resources] [--sass DIR] [--rounds 2]

A variant is ``label=source[,nvcc flag...]``: a source file with the C
interface of the checkout's library (an older revision, or a copy with a
constant changed, written under the ignored ``build/``), with the flags
that source is built with; an empty source is the checkout's own ``csrc``
file. Two cards, and two calls on one card, differ by more than two
versions of a kernel do, so they are compared here, inside one process:
each variant is first held to the plain version at the main path's shape
(the mesh kernels at rtol 1e-5, atol 1e-6, the compaction exactly), then
all are timed with ``utils/timing.cuda_ms`` in the order given and back (a,
b, b, a), ``--rounds`` times. One JSON object is printed, with the card's
name and power limit.

``--resources`` adds what ``nvcc -Xptxas -v`` says of each variant
(registers, shared memory, spills); ``--sass DIR`` writes each variant's
``cuobjdump -sass`` listing to ``DIR/<kernel>_<label>.sass``.

Shapes: the tile kernel on 1,024 x 16 x 3 = 49,152 random probes within 1 m
above the 9,216-triangle mesh of ``models/workloads.py``; the per-triangle
kernel on queries of the first 1, 15, 64 and 15,360 of them (``query_ms``), one
launch a query, with ``launch_floor_ms``, an empty kernel under the same
timer, beside them (a ``--mesh`` variant whose flags hold the word
``one-centre`` is a source from before the centres had a batch axis, and a
query through it is one launch a centre); the compaction at B = 8,192 and
B = 1,024 worlds, D = 10, M = 384, k = 64, a random mask of density 0.15,
bf16 rounding; the device probes at the first trip counts of
``utils/device_probe`` (``probe_matmuls`` at 256 trips on the TPU probe's
inputs, ``probe_mxu`` at 4,096 products of A = 1, B = 1/16, ``probe_vpu``
at (8, 384) and 1,024 trips), each variant first held to the plain
versions: ``probe_matmuls`` by ``matmuls_agree`` at 1, 2 and 3 trips on
random and on the TPU probe's inputs (a product 1% off refused),
``probe_mxu`` bit for bit at A = 1, B = 1/16 after 1, 2, 3, 7 and 64
products and at rtol 1e-5 on random inputs, ``probe_vpu`` bit for bit.
With ``--sass``, a ``--probe`` variant also reports the FFMA instructions
of each kernel in its listing (``ffma``).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# sphere_mesh_d2 queries that are timed, in centres: one, a world's spheres,
# and every sphere of the trimesh main path (1,024 worlds x 15)
QUERY_CENTRES = (1, 15, 64, 15360)
# a --mesh variant marked with this word has the interface that
# csrc/sphere_mesh_d2.cu had before its centres got a batch axis
ONE_CENTRE = "one-centre"
ONE_CENTRE_FUNCTIONS = {
    "sphere_mesh_d2_tiles_launch":
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "sphere_mesh_d2_launch":
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]}


def _float32_launchers(functions: dict) -> dict:
    """A library's float32 launchers: the ones every revision of its source
    has (the float64 ones came later)."""
    return {name: argtypes for name, argtypes in functions.items()
            if not name.endswith("_f64")}


def _variant(spec: str, source: str):
    """``label=source[,flag...]`` → (label, absolute source path, flags)."""
    from rl_ode_physics_tpu_torch.ops import kernel_build
    label, _, rest = spec.partition("=")
    path, *flags = rest.split(",")
    src = (ROOT / path).resolve() if path else kernel_build.CSRC / source
    if not src.is_file():
        raise SystemExit(f"variant {label}: no source {src}")
    return label, src, tuple(flags)


def _build(src: Path, flags, label: str, kernel: str, args, report: dict):
    """Build the variant; note its resources and SASS where asked."""
    from rl_ode_physics_tpu_torch.ops import kernel_build
    lib = kernel_build.build(str(src), flags)
    if args.resources:
        report["ptxas"] = subprocess.run(
            [kernel_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", *flags, "-Xptxas", "-v", "-cubin", "-o",
             "/dev/null", str(src)],
            capture_output=True, text=True, check=True).stderr.strip()
    if args.sass:
        tool = Path(kernel_build.nvcc()).with_name("cuobjdump")
        out = Path(args.sass) / f"{kernel}_{label}.sass"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(subprocess.run(
            [str(tool), "-sass", str(lib)], capture_output=True, text=True,
            check=True).stdout)
    return lib


def _time_in_turns(calls: dict, rounds: int, iters: int) -> dict:
    """label → list of mean ms, one per visit; the labels are visited in
    order and back, ``rounds`` times."""
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms
    times = {label: [] for label in calls}
    for _ in range(rounds):
        for label in list(calls) + list(calls)[::-1]:
            times[label].append(cuda_ms(calls[label], iters))
    return times


def _raise_on(err: int, label: str) -> None:
    if err != 0:
        raise RuntimeError(f"{label}: kernel launch failed, CUDA error {err}")


def mesh_variants(specs, args) -> dict:
    import torch
    from rl_ode_physics_tpu_torch.models.workloads import standin_mesh
    from rl_ode_physics_tpu_torch.ops import kernel_build, mesh_kernels
    from rl_ode_physics_tpu_torch.ops import trimesh as tm
    from rl_ode_physics_tpu_torch.utils.timing import launch_floor_ms

    mesh = tm.build_trimesh(*standin_mesh(), device="cuda")
    tris = mesh.transposed()
    tri_ptrs = [x.data_ptr() for x in tris]
    t = mesh.num_tris
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = 1024 * 16 * 3
    lo = torch.tensor([-6.0, -0.3, -6.0], device="cuda")
    hi = torch.tensor([6.0, 1.3, 6.0], device="cuda")
    probes = lo + (hi - lo) * torch.rand((p, 3), generator=gen, device="cuda")
    ref = tm.sphere_mesh_d2_tiles_plain(probes, *tris)
    out = torch.empty((p, t // tm.MESH_TILE), device="cuda")
    centers = probes[:QUERY_CENTRES[-1]].contiguous()
    ref_rows = tm.sphere_mesh_d2_plain(centers, *tris)
    out_rows = torch.empty((centers.shape[0], t // tm.MESH_TILE,
                            tm.MESH_TILE), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rtol, atol = mesh_kernels.D2_RTOL, mesh_kernels.D2_ATOL
    result, tile_calls = {}, {}
    query_calls = {c: {} for c in QUERY_CENTRES}
    for label, src, flags in (_variant(s, "sphere_mesh_d2.cu") for s in specs):
        batched = ONE_CENTRE not in flags
        flags = tuple(f for f in flags if f != ONE_CENTRE)
        result[label] = {"source": str(src), "flags": list(flags),
                         "launches_per_query": "1" if batched else "C"}
        lib = kernel_build.load(
            _build(src, flags, label, "sphere_mesh_d2", args, result[label]),
            _float32_launchers(mesh_kernels.FUNCTIONS) if batched
            else ONE_CENTRE_FUNCTIONS)

        def tiles(lib=lib, label=label):
            _raise_on(lib.sphere_mesh_d2_tiles_launch(
                probes.data_ptr(), *tri_ptrs, out.data_ptr(), p, t, stream),
                label)

        def query(c, lib=lib, label=label, batched=batched):
            """The rows of the first ``c`` centres: one launch, or ``c``
            launches of a one-centre source."""
            if batched:
                _raise_on(lib.sphere_mesh_d2_batch_launch(
                    centers.data_ptr(), *tri_ptrs, out_rows.data_ptr(), c, t,
                    stream), label)
                return
            for i in range(c):
                _raise_on(lib.sphere_mesh_d2_launch(
                    centers.data_ptr() + 12 * i, *tri_ptrs,
                    out_rows.data_ptr() + 4 * t * i, t, stream), label)

        out.fill_(-1.0)
        out_rows.fill_(-1.0)
        tiles()
        query(centers.shape[0])
        torch.cuda.synchronize()
        for name, got, want in (
                ("tiles", out, ref),
                ("rows", out_rows, ref_rows)):
            err = (got - want).abs()
            if not torch.allclose(got, want, rtol=rtol, atol=atol):
                raise AssertionError(f"{label} ({name}): differs from the "
                                     f"plain version, max abs err "
                                     f"{float(err.max())}")
            result[label][f"{name}_max_abs_err"] = float(err.max())
        tile_calls[label] = tiles
        for c in QUERY_CENTRES:
            query_calls[c][label] = functools.partial(query, c)
    for label, ms in _time_in_turns(tile_calls, args.rounds, 20).items():
        result[label]["tiles_ms"] = ms
    for c, calls in query_calls.items():
        # many centres through a one-centre source are that many launches:
        # few runs of it
        for label, ms in _time_in_turns(calls, args.rounds,
                                        20 if c <= 64 else 3).items():
            result[label].setdefault("query_ms", {})[f"C={c}"] = ms
    floor = [launch_floor_ms() for _ in range(2)]
    return {"shape": {"P": p, "T": t, "query_centres": list(QUERY_CENTRES)},
            "launch_floor_ms": floor, "variants": result}


def compact_variants(specs, args) -> dict:
    import torch
    from rl_ode_physics_tpu_torch.ops import (
        compaction, compaction_kernel, kernel_build)

    d, m, k = 10, 384, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    mask = torch.rand((8192, m), generator=gen, device="cuda") < 0.15
    payload = torch.randn((8192, d, m), generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result, libs = {}, {}
    for label, src, flags in (_variant(s, "compact_rows.cu") for s in specs):
        result[label] = {"source": str(src), "flags": list(flags), "ms": {}}
        libs[label] = kernel_build.load(
            _build(src, flags, label, "compact_rows", args, result[label]),
            _float32_launchers(compaction_kernel.FUNCTIONS))
    for b in (8192, 1024):
        mk, pl = mask[:b].contiguous(), payload[:b].contiguous()
        ref = compaction.compact_rows_t(mk, pl, k, torch.bfloat16)
        outs = (torch.empty((b, d, k), device="cuda"),
                torch.empty((b, k), dtype=torch.bool, device="cuda"),
                torch.empty((b,), dtype=torch.int32, device="cuda"),
                torch.empty((b,), dtype=torch.int32, device="cuda"))
        calls = {}
        for label, lib in libs.items():
            def call(lib=lib, label=label):
                _raise_on(lib.compact_rows_launch(
                    mk.data_ptr(), pl.data_ptr(),
                    *(x.data_ptr() for x in outs), b, d, m, k, 1, stream),
                    label)

            outs[0].fill_(-1.0)
            call()
            torch.cuda.synchronize()
            for name, got, want in zip(("rows_t", "valid", "count",
                                        "overflow"), outs, ref):
                if not torch.equal(got, want):
                    raise AssertionError(f"{label}, B={b}: {name} differs "
                                         f"from the plain version")
            calls[label] = call
        for label, ms in _time_in_turns(calls, args.rounds, 50).items():
            result[label]["ms"][f"B={b}"] = ms
    return {"shape": {"D": d, "M": m, "k": k, "density": 0.15,
                      "round_bf16": True}, "variants": result}


def _ffma_counts(listing: str) -> dict:
    """Kernel name → FFMA instructions in a ``cuobjdump -sass`` listing."""
    counts, name = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "FFMA" in line:
            counts[name] += 1
    return counts


def probe_variants(specs, args) -> dict:
    import torch
    from rl_ode_physics_tpu_torch.ops import kernel_build
    from rl_ode_physics_tpu_torch.ops import probe_kernels as pk
    from rl_ode_physics_tpu_torch.utils import device_probe as dp

    gen = torch.Generator(device="cuda").manual_seed(11)
    w = dp.MATMUL_WORLDS
    inputs = {
        "random": (torch.randn((w, pk.ROWS, pk.INNER), generator=gen,
                               device="cuda"),
                   torch.randn((w, pk.INNER, pk.COLS), generator=gen,
                               device="cuda")),
        "tpu_probe": dp.matmuls_inputs()}
    a1, b16 = dp.mxu_inputs()
    ra = torch.randn((pk.MXU_N, pk.MXU_N), generator=gen, device="cuda")
    rb = torch.randn((pk.MXU_N, pk.MXU_N), generator=gen, device="cuda") / 16
    x = torch.ones(dp.VPU_SHAPES[0], device="cuda").reshape(-1)
    stream = torch.cuda.current_stream().cuda_stream
    trips, steps = dp.MATMULS_TRIPS[0], dp.MXU_STEPS[0]
    vpu_trips = dp.VPU_TRIPS[0]
    result = {}
    calls = {"matmuls": {}, "mxu": {}, "vpu": {}}
    for label, src, flags in (_variant(s, "device_probe.cu") for s in specs):
        result[label] = {"source": str(src), "flags": list(flags)}
        lib = kernel_build.load(
            _build(src, flags, label, "device_probe", args, result[label]),
            {name: argtypes for name, argtypes in pk.FUNCTIONS.items()
             if name.endswith("_launch")})
        if args.sass:
            result[label]["ffma"] = _ffma_counts(
                (Path(args.sass) / f"device_probe_{label}.sass").read_text())

        def matmuls(vel, s, n, lib=lib, label=label):
            out = torch.empty_like(vel)
            checksum = torch.empty((vel.shape[0],), dtype=torch.float64,
                                   device="cuda")
            _raise_on(lib.probe_matmuls_launch(
                vel.data_ptr(), s.data_ptr(), out.data_ptr(),
                checksum.data_ptr(), vel.shape[0], n, stream), label)
            return out, checksum

        def mxu(a, b, n, lib=lib, label=label):
            buf = torch.empty((2, pk.MXU_N, pk.MXU_N), device="cuda")
            _raise_on(lib.probe_mxu_launch(a.data_ptr(), b.data_ptr(),
                                           buf.data_ptr(), n, stream), label)
            return buf[(n - 1) % 2]

        def vpu(lib=lib, label=label, out=torch.empty_like(x)):
            _raise_on(lib.probe_vpu_launch(x.data_ptr(), out.data_ptr(),
                                           x.numel() // pk.VPU_THREADS,
                                           vpu_trips, 0, stream), label)
            return out

        errors = result[label]["matmuls_errors"] = {}
        for name, (vel, s) in inputs.items():
            for n in (1, 2, 3):
                want = pk.probe_matmuls_plain(vel, s, n)
                got = pk.matmuls_errors(vel, matmuls(vel, s, n), want)
                off = s.clone()
                off[..., :pk.INNER] *= 1.01
                refused = pk.matmuls_errors(vel, matmuls(vel, off, n), want)
                if not pk.matmuls_agree(got) or pk.matmuls_agree(refused):
                    raise AssertionError(f"{label}: probe_matmuls on {name} "
                                         f"inputs, {n} trips: {got}; 1% off "
                                         f"{refused}")
                errors[f"{name}_trips{n}"] = got
        for n in (1, 2, 3, 7, 64):
            if not torch.equal(mxu(a1, b16, n), pk.probe_mxu_plain(a1, b16,
                                                                   n)):
                raise AssertionError(f"{label}: probe_mxu at A = 1, B = 1/16 "
                                     f"differs after {n} products")
        got, ref = mxu(ra, rb, 3), pk.probe_mxu_plain(ra, rb, 3)
        if not torch.allclose(got, ref, rtol=pk.MATMUL_RTOL,
                              atol=pk.MATMUL_RTOL * float(ref.abs().max())):
            raise AssertionError(f"{label}: probe_mxu on random inputs, max "
                                 f"abs err {float((got - ref).abs().max())}")
        result[label]["mxu_max_abs_err"] = float((got - ref).abs().max())
        if not torch.equal(vpu(), pk.probe_vpu_plain(x, vpu_trips)):
            raise AssertionError(f"{label}: probe_vpu differs")
        calls["matmuls"][label] = functools.partial(
            matmuls, *inputs["tpu_probe"], trips)
        calls["mxu"][label] = functools.partial(mxu, a1, b16, steps)
        calls["vpu"][label] = vpu
    for kernel, iters in (("matmuls", 5), ("mxu", 2), ("vpu", 10)):
        for label, ms in _time_in_turns(calls[kernel], args.rounds,
                                        iters).items():
            result[label][f"{kernel}_ms"] = ms
    return {"shape": {"matmuls_trips": trips, "worlds": w,
                      "mxu_products": steps, "vpu_shape":
                      list(dp.VPU_SHAPES[0]), "vpu_trips": vpu_trips},
            "variants": result}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", action="append", default=[],
                    metavar="LABEL=SOURCE[,FLAG...]",
                    help="a source with csrc/sphere_mesh_d2.cu's interface")
    ap.add_argument("--compact", action="append", default=[],
                    metavar="LABEL=SOURCE[,FLAG...]",
                    help="a source with csrc/compact_rows.cu's interface")
    ap.add_argument("--probe", action="append", default=[],
                    metavar="LABEL=SOURCE[,FLAG...]",
                    help="a source with csrc/device_probe.cu's launchers")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--sass", default=None, metavar="DIR")
    args = ap.parse_args()

    from rl_ode_physics_tpu_torch.utils.timing import require_card
    report = {"card": require_card("kernel_ab")}
    if args.mesh:
        report["sphere_mesh_d2"] = mesh_variants(args.mesh, args)
    if args.compact:
        report["compact_rows_t"] = compact_variants(args.compact, args)
    if args.probe:
        report["device_probe"] = probe_variants(args.probe, args)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
