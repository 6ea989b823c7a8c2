"""Two or more source files of one hand-written kernel, timed in turns on
one card.

Run on a machine with a CUDA card, from the root of the checkout::

    python3 -m rl_ode_physics_tpu_torch.utils.kernel_ab \\
        --mesh old=build/parent/sphere_mesh_d2.cu,-fmad=false --mesh new= \\
        --compact old=build/parent/compact_rows.cu --compact new= \\
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
above the 9,216-triangle mesh of ``chip_smoke.py``, the one-probe kernel on
the first 64 of them, one launch each; the compaction at B = 8,192 and
B = 1,024 worlds, D = 10, M = 384, k = 64, a random mask of density 0.15,
bf16 rounding.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


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
    sys.path.insert(0, str(ROOT))
    from chip_smoke import standin_mesh
    from rl_ode_physics_tpu_torch.ops import kernel_build, mesh_kernels
    from rl_ode_physics_tpu_torch.ops import trimesh as tm

    mesh = tm.build_trimesh(*standin_mesh(), device="cuda")
    tris = mesh.transposed()
    tri_ptrs = [x.data_ptr() for x in tris]
    t = mesh.num_tris
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = 1024 * 16 * 3
    lo = torch.tensor([-6.0, -0.3, -6.0], device="cuda")
    hi = torch.tensor([6.0, 1.3, 6.0], device="cuda")
    probes = lo + (hi - lo) * torch.rand((p, 3), generator=gen, device="cuda")
    centers = probes[:64].contiguous()
    ref = tm.sphere_mesh_d2_tiles_plain(probes, *tris)
    ref_one = tm.sphere_mesh_d2_plain(centers[0], *tris)
    out = torch.empty((p, t // tm.MESH_TILE), device="cuda")
    out_one = torch.empty((t // tm.MESH_TILE, tm.MESH_TILE), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rtol, atol = mesh_kernels.D2_RTOL, mesh_kernels.D2_ATOL
    result, tile_calls, one_calls = {}, {}, {}
    for label, src, flags in (_variant(s, "sphere_mesh_d2.cu") for s in specs):
        result[label] = {"source": str(src), "flags": list(flags)}
        lib = kernel_build.load(
            _build(src, flags, label, "sphere_mesh_d2", args, result[label]),
            mesh_kernels.FUNCTIONS)

        def tiles(lib=lib, label=label):
            _raise_on(lib.sphere_mesh_d2_tiles_launch(
                probes.data_ptr(), *tri_ptrs, out.data_ptr(), p, t, stream),
                label)

        def each_center(lib=lib, label=label):
            for i in range(centers.shape[0]):
                _raise_on(lib.sphere_mesh_d2_launch(
                    centers.data_ptr() + 12 * i, *tri_ptrs,
                    out_one.data_ptr(), t, stream), label)

        out.fill_(-1.0)
        tiles()
        lib.sphere_mesh_d2_launch(centers.data_ptr(), *tri_ptrs,
                                  out_one.data_ptr(), t, stream)
        torch.cuda.synchronize()
        for name, got, want in (("tiles", out, ref), ("one", out_one,
                                                      ref_one)):
            err = (got - want).abs()
            if not torch.allclose(got, want, rtol=rtol, atol=atol):
                raise AssertionError(f"{label} ({name}): differs from the "
                                     f"plain version, max abs err "
                                     f"{float(err.max())}")
            result[label][f"{name}_max_abs_err"] = float(err.max())
        tile_calls[label], one_calls[label] = tiles, each_center
    for label, ms in _time_in_turns(tile_calls, args.rounds, 20).items():
        result[label]["tiles_ms"] = ms
    for label, ms in _time_in_turns(one_calls, args.rounds, 5).items():
        result[label]["one_probe_ms"] = [x / centers.shape[0] for x in ms]
    return {"shape": {"P": p, "T": t}, "variants": result}


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
            compaction_kernel.FUNCTIONS)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", action="append", default=[],
                    metavar="LABEL=SOURCE[,FLAG...]",
                    help="a source with csrc/sphere_mesh_d2.cu's interface")
    ap.add_argument("--compact", action="append", default=[],
                    metavar="LABEL=SOURCE[,FLAG...]",
                    help="a source with csrc/compact_rows.cu's interface")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--sass", default=None, metavar="DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()}
    if args.mesh:
        report["sphere_mesh_d2"] = mesh_variants(args.mesh, args)
    if args.compact:
        report["compact_rows_t"] = compact_variants(args.compact, args)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
