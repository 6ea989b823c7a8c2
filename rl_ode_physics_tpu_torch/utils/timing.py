"""Device time of a short piece of work on the card, from CUDA events, and
what an empty kernel reads under the same timer."""

from __future__ import annotations

import time

# the H100 SXM's data-sheet device-memory rate, bytes/s: only to size the
# work queued before the timed runs
_HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` runs, after a
    warm-up, from CUDA events. The card is first given work that lasts
    longer than the host takes to enqueue all the runs, so that a short
    kernel's time is its own and not the host's time per call: between two
    events on an idle card, a kernel shorter than a call through its Python
    wrapper reads as the wrapper."""
    import torch
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    ballast = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    pass_ms = 2 * ballast.numel() * 4 / _HBM_BYTES_PER_S * 1e3
    passes = min(int(1.5 * host_ms * iters / pass_ms) + 1, 400)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(passes):
        ballast.add_(1.0)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    del ballast
    return start.elapsed_time(end) / iters


def launch_floor_ms(iters: int = 200) -> float:
    """What ``cuda_ms`` reads for an empty kernel (``csrc/launch_floor.cu``,
    one block of one thread, launched through ``ctypes`` like the
    hand-written kernels): the least any launch takes on this card under
    this timer. A kernel whose bound is shorter than this is judged against
    this."""
    import ctypes

    import torch

    from rl_ode_physics_tpu_torch.ops import kernel_build
    lib = kernel_build.load(kernel_build.build("launch_floor.cu"),
                            {"empty_launch": [ctypes.c_void_p]})
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.empty_launch(stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error "
                               f"{err}")

    return cuda_ms(launch, iters)
