"""Device probes on the card: the rates that every bound in the records
divides by, measured.

    python -m rl_ode_physics_tpu_torch.utils.device_probe [--quick]

The port of ``benchmarks/device_probe.py``, every probe in its order:
``probe_hbm`` (at the probe's 64 MB, which device memory serves through the
50 MB L2 in part, and at 1 GB, which it cannot), ``probe_bmm``, the three
hand-written kernels of ``ops/probe_kernels`` (``probe_kernel_matmuls``,
``probe_kernel_vpu`` at (8, 384) and (32, 384), ``probe_mxu_peak``), and
``probe_shape_menu``. The plain probes are plain PyTorch, as the JAX ones
are plain jnp. The JAX script fitted a slope between two trip counts to
cancel the TPU host's round trip; here every probe is timed with
``utils/timing.cuda_ms`` at the JAX script's trip counts (``--quick``: the
first of each kernel's two only).

Each probe reports its time beside its bound: ``probe_hbm`` its bytes at
the H100 SXM data sheet's 3.35 TB/s; the kernels their FP32 operations at
67 TFLOP/s times the share of the card's 132 SMs they run on (the
multiply-then-add chain of ``probe_kernel_vpu`` at half that rate: the
data sheet's counts a fused multiply-add as two operations of one
instruction). Beside each kernel is its library chain, one PyTorch call a
step, timed in the same process with TF32 off (``library_ms``):
``torch.mm(acc, B·0.0625)`` for ``probe_mxu_peak`` (bit for bit its plain
version: scaling by 2⁻⁴ is exact), ``torch.bmm(acc, S)`` for
``probe_kernel_matmuls`` (the step's product alone, without the update and
the checksum: a floor for any chain of library calls) and ``torch.addcmul``
for the fused ``probe_kernel_vpu`` chain (its fused plain version). One
JSON object is printed, with the card's name and power limit and the
measured memory rate and FP32 rates beside those data-sheet figures: the
(256, 256) product chain's rate per SM on the 16 SMs of its cluster, and
one SM's fused multiply-add chain, each times 132. The entry point and the
timed probes need a CUDA card; the tests run one trip of each plain probe
(``hbm_trip``, ``bmm_trip``), the library chains and the kernels' plain
versions on the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import json

import torch

from rl_ode_physics_tpu_torch.ops import probe_kernels as pk
from rl_ode_physics_tpu_torch.utils.bounds import (
    FP32_OPS_PER_S, HBM_BYTES_PER_S)
from rl_ode_physics_tpu_torch.utils.timing import card_label

# H100 SXM data sheet: streaming multiprocessors (the rates are in
# utils/bounds.py)
SMS = 132

HBM_MB = (64, 1024)
BMM_SHAPE = (2048, 8, 64, 384)          # (batch, rows, K, lanes)
# (batch, rows, K, lanes, label): benchmarks/device_probe.py:197-206
SHAPE_MENU = (
    (2048, 8, 64, 384, "gather today C=192"),
    (2048, 8, 384, 64, "scatter today C=192"),
    (2048, 8, 64, 256, "gather C=128"),
    (2048, 8, 256, 64, "scatter C=128"),
    (1024, 16, 128, 384, "gather paired C=192"),
    (1024, 16, 128, 256, "gather paired C=128"),
    (1024, 8, 512, 128, "scatter paired C=128"),
)
MATMUL_WORLDS = 8
# the JAX script's two trip counts of each kernel probe
MATMULS_TRIPS = (256, 4096)
VPU_SHAPES = ((8, 384), (32, 384))
VPU_TRIPS = (1024, 16384)
MXU_STEPS = (4096, 65536)


def _cuda_ms(fn, iters):
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms
    return cuda_ms(fn, iters)


def _fp32_bound_ms(ops: float, sms: int) -> float:
    """The least time of ``ops`` FP32 operations on ``sms`` of the SMs."""
    return ops / (FP32_OPS_PER_S * sms / SMS) * 1e3


# ---------------------------------------------------------------------------
# the plain probes
# ---------------------------------------------------------------------------

def hbm_trip(x: torch.Tensor) -> torch.Tensor:
    """One trip of ``probe_hbm``'s chain, in place: ``x·1.0000001 + 1e-9``
    as two passes over ``x`` (XLA fused them into one), each reading and
    writing every float once."""
    return x.mul_(1.0000001).add_(1e-9)


def probe_hbm(mb: int, device="cuda", iters: int = 20) -> dict:
    x = torch.ones((mb * 1024 * 1024 // 4,), dtype=torch.float32,
                   device=device)
    ms = _cuda_ms(lambda: hbm_trip(x), iters)
    moved = 2 * 2 * x.numel() * 4                # two passes, read + write
    return dict(mb=mb, ms=ms, bytes=moved, gb_per_s=moved / ms / 1e6,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def bmm_trip(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One trip of ``probe_bmm``'s loop: (B, m, K)·(B, K, L) in bf16 with a
    float32 sum, the first K lanes (zero-padded where L < K) added back at
    1e-6. PyTorch's bf16 ``bmm`` rounds its float32 sum to bf16 once, where
    the JAX body keeps it in float32 and rounds it to bf16 in the next
    operation: the same values."""
    vh = torch.bmm(v, s)
    k = v.shape[-1]
    if vh.shape[-1] < k:
        vh = torch.nn.functional.pad(vh, (0, k - vh.shape[-1]))
    return v + vh[..., :k] * 1e-6


def _bmm_inputs(b, m, kk, lanes, device, menu):
    """``probe_bmm``'s operands (a 0/1 selector, every 7th entry set) or,
    for the shape menu, ones and 0.01."""
    v = torch.ones((b, m, kk), dtype=torch.bfloat16, device=device)
    if menu:
        s = torch.full((b, kk, lanes), 0.01, dtype=torch.bfloat16,
                       device=device)
    else:
        s = ((torch.arange(b * kk * lanes, device=device, dtype=torch.int64)
              .reshape(b, kk, lanes) % 7) == 0).to(torch.bfloat16)
    return v, s


def probe_bmm(shape=BMM_SHAPE, device="cuda", iters: int = 20,
              menu: bool = False) -> dict:
    b, m, kk, lanes = shape
    v, s = _bmm_inputs(b, m, kk, lanes, device, menu)
    trip_ms = _cuda_ms(lambda: bmm_trip(v, s), iters)
    bmm_ms = _cuda_ms(lambda: torch.bmm(v, s), iters)
    flops = 2 * b * m * kk * lanes
    return dict(shape=list(shape), trip_ms=trip_ms, bmm_ms=bmm_ms,
                tflop_per_s=flops / bmm_ms / 1e9,
                s_read_gb_per_s=s.numel() * 2 / bmm_ms / 1e6,
                ns_per_world=bmm_ms * 1e6 / b)


def probe_shape_menu(device="cuda", iters: int = 20) -> list:
    return [dict(probe_bmm((b, m, kk, lanes), device, iters, menu=True),
                 label=label)
            for b, m, kk, lanes, label in SHAPE_MENU]


# ---------------------------------------------------------------------------
# the hand-written kernels, with the TPU probes' inputs
# ---------------------------------------------------------------------------

def matmuls_inputs(device="cuda"):
    """``probe_kernel_matmuls``' inputs: vel of ones, S of 0.01."""
    return (torch.ones((MATMUL_WORLDS, pk.ROWS, pk.INNER), device=device),
            torch.full((MATMUL_WORLDS, pk.INNER, pk.COLS), 0.01,
                       device=device))


def _check_no_tf32() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the library chains are timed in full float32: "
                           "torch.backends.cuda.matmul.allow_tf32 is set")


def matmuls_library_products(vel: torch.Tensor, s: torch.Tensor,
                             trips: int) -> torch.Tensor:
    """``probe_kernel_matmuls``' library chain: one ``torch.bmm(acc, S)`` a
    step, ``trips`` × 16 of them, each the step's product alone (acc stays
    ``vel``; the update and the checksum are left out, so its time is a
    floor for any chain of library calls). Returns the last product."""
    vh = torch.empty((vel.shape[0], pk.ROWS, pk.COLS), dtype=vel.dtype,
                     device=vel.device)
    for _ in range(trips * pk.CHAIN):
        torch.bmm(vel, s, out=vh)
    return vh


def mxu_library_chain(a: torch.Tensor, b: torch.Tensor,
                      steps: int) -> torch.Tensor:
    """``probe_mxu_peak``'s chain as one ``torch.mm(acc, B·0.0625)`` a
    product: bit for bit ``(acc @ B) · 0.0625``, since scaling by 2⁻⁴ is
    exact."""
    b16 = b * 0.0625
    acc = a
    for _ in range(steps):
        acc = torch.mm(acc, b16)
    return acc


def probe_kernel_matmuls(trips: int, device="cuda", iters: int = 3) -> dict:
    _check_no_tf32()
    vel, s = matmuls_inputs(device)
    ms = _cuda_ms(lambda: pk.probe_matmuls(vel, s, trips), iters)
    library_ms = _cuda_ms(lambda: matmuls_library_products(vel, s, trips),
                          iters)
    steps = trips * pk.CHAIN
    ops = 2 * MATMUL_WORLDS * pk.ROWS * pk.INNER * pk.COLS * steps
    return dict(trips=trips, ms=ms, worlds=MATMUL_WORLDS,
                ns_per_dependent_product=ms * 1e6 / steps,
                bound_ms=_fp32_bound_ms(ops, MATMUL_WORLDS),
                bound_by="operations", library_ms=library_ms,
                tflop_per_s_per_sm=ops / MATMUL_WORLDS / ms / 1e9)


def probe_kernel_vpu(shape, trips: int, device="cuda", iters: int = 3,
                     fused: bool = False) -> dict:
    x = torch.ones(shape, device=device).reshape(-1)
    ms = _cuda_ms(lambda: pk.probe_vpu(x, trips, fused), iters)
    # the library chain: the fused plain version, one torch.addcmul a step
    library_ms = _cuda_ms(lambda: pk.probe_vpu_plain(x, trips, True), 2)
    steps = trips * pk.CHAIN
    ops = 2 * x.numel() * steps                  # a multiply and an add
    # the data sheet's rate counts a fused multiply-add as 2 operations in
    # one instruction; the unfused chain issues its multiply and its add
    # apart, so its ceiling is half that rate
    bound_ms = _fp32_bound_ms(ops, 1) * (1 if fused else 2)
    return dict(shape=list(shape), trips=trips, fused=fused, ms=ms,
                ns_per_op=ms * 1e6 / steps, bound_ms=bound_ms,
                bound_by="operations", library_ms=library_ms,
                tflop_per_s_per_sm=ops / ms / 1e9)


def mxu_inputs(device="cuda"):
    """``probe_mxu_peak``'s inputs: A of ones, B of 1/16, so that every
    product is exactly A again."""
    return (torch.ones((pk.MXU_N, pk.MXU_N), device=device),
            torch.full((pk.MXU_N, pk.MXU_N), 1.0 / 16.0, device=device))


def probe_mxu_peak(steps: int, device="cuda", iters: int = 2) -> dict:
    """The (256, 256) chain on the ``pk.MXU_CLUSTER`` SMs of its cluster:
    its bound on those SMs, its rate per SM and that rate × 132."""
    _check_no_tf32()
    a, b = mxu_inputs(device)
    ms = _cuda_ms(lambda: pk.probe_mxu(a, b, steps), iters)
    library_ms = _cuda_ms(lambda: mxu_library_chain(a, b, steps), iters)
    ops = 2 * pk.MXU_N ** 3 * steps
    sms = pk.MXU_CLUSTER
    per_sm = ops / sms / ms / 1e9
    return dict(steps=steps, ms=ms, ns_per_product=ms * 1e6 / steps,
                sms=sms, bound_ms=_fp32_bound_ms(ops, sms),
                bound_by="operations", library_ms=library_ms,
                tflop_per_s_per_sm=per_sm, tflop_per_s_x132=per_sm * SMS)


def measured(out: dict) -> dict:
    """The rates a report measured, beside the data sheet's: device memory
    (the best pass and the 1 GB one), the (256, 256) chain's FP32 rate per
    SM on the ``sms`` of its cluster and one SM's fused multiply-add chain,
    each also × 132."""
    mxu = out["mxu_peak"][-1]
    fma = max((r["tflop_per_s_per_sm"] for r in out["kernel_vpu"]
               if r["fused"]))
    return dict(
        memory_gb_per_s=max(h["gb_per_s"] for h in out["hbm"]),
        memory_gb_per_s_past_l2=out["hbm"][-1]["gb_per_s"],
        data_sheet_gb_per_s=HBM_BYTES_PER_S / 1e9,
        fp32_tflop_per_s_per_sm=mxu["tflop_per_s_per_sm"],
        sms=mxu["sms"],
        fp32_tflop_per_s_x132=mxu["tflop_per_s_x132"],
        fp32_fma_chain_tflop_per_s_one_sm=fma,
        fp32_fma_chain_tflop_per_s_x132=fma * SMS,
        data_sheet_fp32_tflop_per_s=FP32_OPS_PER_S / 1e12)


def run(quick: bool = False, device="cuda") -> dict:
    """Every probe, in the JAX script's order; ``quick``: the first of the
    two trip counts of each kernel probe only."""
    def counts(pair):
        return pair[:1] if quick else pair

    out = dict(hbm=[probe_hbm(mb, device) for mb in HBM_MB],
               bmm=probe_bmm(device=device),
               kernel_matmuls=[probe_kernel_matmuls(t, device)
                               for t in counts(MATMULS_TRIPS)],
               kernel_vpu=[probe_kernel_vpu(shape, t, device, fused=f)
                           for shape in VPU_SHAPES for t in counts(VPU_TRIPS)
                           for f in (False, True)],
               mxu_peak=[probe_mxu_peak(s, device)
                         for s in counts(MXU_STEPS)],
               shape_menu=probe_shape_menu(device),
               mxu_cluster=pk.mxu_cluster_info())
    out["measured"] = measured(out)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the first of the two trip counts of each kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("device_probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = dict(card=card_label(), device=torch.cuda.get_device_name(0))
    report.update(run(args.quick))
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
