"""Probe: does the orientation of the solver's selector products change their
cost on the card?

The port of ``benchmarks/orientation_probe.py``: the same nine probes,
labels and shapes, each a chain of ``k`` dependent batched products
(B, m, kk)·(B, kk, l) in float32 with TF32 off (``torch.bmm``, where the
JAX script called ``lax.dot_general``). A trip of the chain is the JAX
loop body: the product, sliced (l ≥ kk) or zero-padded (l < kk) back to
(m, kk), added to the carry at 1e-6. The selector has every 7th entry
set, the carry starts at ones.

Each chain is captured once as a CUDA graph and replayed, so that its
time is the card's, as the JAX script's one compiled loop was: eagerly,
each trip's four small launches cost the host more than the card. The
time of a product is the slope between k1 = 64 and k2 = 1,024 trips,
(t(k2) − t(k1)) / (k2 − k1), each from ``utils/timing.cuda_ms``; printed
as ms a product and ns a world, with the card's name and power limit::

    python3 -m rl_ode_physics_tpu_torch.utils.orientation_probe \\
        [--k1 64] [--k2 1024] [--device cpu]

``--device cpu`` times the eager chain on the host's clock instead.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

B = 2048
# (section, label, batch, m, kk, l): orientation_probe.py:53-65
PROBES = (
    ("gather orientations (C=128 -> 2C=256 half-rows, N=64)",
     "today: vel x selT", B, 8, 64, 256),
    ("gather orientations (C=128 -> 2C=256 half-rows, N=64)",
     "flipped: sel x vel", B, 256, 64, 8),
    ("scatter orientations", "today: contribT x sel", B, 8, 256, 64),
    ("scatter orientations", "flipped: selT x contrib", B, 64, 256, 8),
    ("capacity scaling (today's orientation)", "gather C=64", B, 8, 64,
     128),
    ("capacity scaling (today's orientation)", "gather C=96", B, 8, 64,
     192),
    ("instance floor", "tiny (8,8)x(8,8)", B, 8, 8, 8),
    ("instance floor", "1-tile (8,64)x(64,128)", B, 8, 64, 128),
    ("lambda-space G matmul (2C=256)", "G: lam x G", B, 8, 256, 256),
)


def inputs(b: int, m: int, kk: int, l: int, device="cuda"):
    """The JAX probe's operands: the carry (b, m, kk) of ones and the
    selector (b, kk, l) with every 7th entry 1."""
    a = torch.ones((b, m, kk), dtype=torch.float32, device=device)
    s = ((torch.arange(b * kk * l, dtype=torch.int32, device=device)
          .reshape(b, kk, l) % 7) == 0).to(torch.float32)
    return a, s


def trip(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One trip of the JAX loop body (``orientation_probe.py:29-38``)."""
    vh = torch.bmm(v, s)
    kk, l = v.shape[-1], s.shape[-1]
    upd = vh[:, :, :kk] if l >= kk else torch.nn.functional.pad(
        vh, (0, kk - l))
    return v + upd * 1e-6


def chain(v: torch.Tensor, s: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        v = trip(v, s)
    return v


def _graph_ms(a, s, k: int, iters: int) -> float:
    """Device ms of a replay of the k-trip chain, captured as a graph."""
    from rl_ode_physics_tpu_torch.utils.timing import cuda_ms
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(a, s, 2)                   # cuBLAS's set-up outside capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(a, s, k)
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


def _chain_ms(a, s, k: int, iters: int) -> float:
    """ms of the k-trip chain: a graph's replay on the card, the eager
    chain's host-clock time on the CPU."""
    if a.is_cuda:
        return _graph_ms(a, s, k, iters)
    from rl_ode_physics_tpu_torch.utils.timing import wall_s
    return wall_s(lambda: chain(a, s, k), iters, a.device) * 1e3


def probe(label: str, b: int, m: int, kk: int, l: int, k1: int = 64,
          k2: int = 1024, iters: int = 10, device="cuda") -> dict:
    a, s = inputs(b, m, kk, l, device)
    t1, t2 = _chain_ms(a, s, k1, iters), _chain_ms(a, s, k2, iters)
    ms = (t2 - t1) / (k2 - k1)
    print(f"  {label:34s} ({b:4d},{m:3d},{kk:3d})x({kk:3d},{l:3d}) "
          f"float32  : {ms:7.4f} ms/bmm = {ms / b * 1e6:6.2f} ns/world "
          f"[t({k1})={t1:.3f} ms, t({k2})={t2:.3f} ms]", flush=True)
    return dict(label=label, shape=[b, m, kk, l], ms_per_bmm=ms,
                ns_per_world=ms / b * 1e6, t_k1_ms=t1, t_k2_ms=t2)


def run(k1: int = 64, k2: int = 1024, iters: int = 10,
        device="cuda") -> list:
    """Every probe, under its section's heading; a dict a probe."""
    out, section = [], None
    for head, label, b, m, kk, l in PROBES:
        if head != section:
            section = head
            print(f"== {head} ==", flush=True)
        out.append(probe(label, b, m, kk, l, k1, k2, iters, device))
    return out


def main(argv=None) -> int:
    from rl_ode_physics_tpu_torch.utils.timing import require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1", type=int, default=64)
    ap.add_argument("--k2", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the card; on the CPU the "
                         "eager chain on the host's clock)")
    args = ap.parse_args(argv)
    card = require_card("orientation_probe", args.device)
    print(f"card: {card} (float32, TF32 off)")
    results = run(args.k1, args.k2, device=args.device)
    print(json.dumps({"card": card, "k1": args.k1, "k2": args.k2,
                      "probes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
