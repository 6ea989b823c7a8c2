"""Solver iterations: the ``lcp_pivot`` kernels' share of their roofline,
in %: the least time the card could take for one elimination of each
world's valid block, over the traced kernels' device time.

The bound counts the dense contact LCP as posed, whatever the rounds or
the implementation: a world of V valid rows reads its V × V block of A in
float64 and its vectors (8·V² + 17·V bytes) and eliminates the block
once (⅔·V³ + 4·V² operations); the card's rates are 3.35 TB/s and 67
TFLOP/s (the H100 SXM's FP64 tensor-core peak, its highest FP64 rate).
ΣV, ΣV² and ΣV³ come from the program's counters (``lcp_valid_rows``,
``_sq``, ``_cube``) over ``world_substeps``, times the cell's worlds a
substep. Moves ``body_steps_per_s``."""

from _kernels import ms_per_substep
from _pivot import counters
from benchlib import manifest

BYTES_PER_S = 3.35e12
FLOPS = 67e12


def bound_ms(v1: float, v2: float, v3: float) -> float:
    """The roofline's ms for ΣV = ``v1``, ΣV² = ``v2``, ΣV³ = ``v3``."""
    nbytes = 8.0 * v2 + 17.0 * v1
    ops = 2.0 / 3.0 * v3 + 4.0 * v2
    return 1e3 * max(nbytes / BYTES_PER_S, ops / FLOPS)


def read(ctx):
    c = counters(ctx, "lcp_valid_rows", "lcp_valid_rows_sq",
                 "lcp_valid_rows_cube")
    ms = ms_per_substep(ctx, "lcp_pivot")
    if c is None or ms is None:
        return None
    worlds = int(manifest.traffic_of(
        manifest.cell(manifest.load(), ctx["cell"]))["worlds"])
    k = worlds / c["world_substeps"]
    bound = bound_ms(k * c["lcp_valid_rows"], k * c["lcp_valid_rows_sq"],
                     k * c["lcp_valid_rows_cube"])
    return 100.0 * bound / ms
