"""Device time of a short piece of work on the card, from CUDA events, what
an empty kernel reads under the same timer, and the host-clock time of a
host-bound piece of work."""

from __future__ import annotations

import time

from rl_ode_physics_tpu_torch.utils.bounds import HBM_BYTES_PER_S


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
    # the data-sheet rate only sizes the work queued before the timed runs
    pass_ms = 2 * ballast.numel() * 4 / HBM_BYTES_PER_S * 1e3
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


def wall_s(fn, reps: int = 3, device="cuda") -> float:
    """The least host-clock seconds of ``fn()`` over ``reps`` runs after one
    warm-up run, each ended by ``torch.cuda.synchronize()`` on a CUDA
    ``device``: the host's time to enqueue the work included, as a
    host-bound path pays it. A difference of two depths of the same work
    cancels what a call costs once."""
    import torch
    dev = torch.device(device)

    def run():
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


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


def card_label(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, for a CUDA ``device``;
    ``"cpu"`` for the CPU, so that no number taken there is read as the
    card's."""
    import subprocess

    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[dev.index or 0]


def require_card(tool: str, device="cuda") -> str:
    """``card_label(device)``; exits with an error naming ``tool`` when
    ``device`` is a CUDA device and there is no card. Turns TF32 off, as
    every measurement of the port runs in float32."""
    import torch
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{tool} needs a CUDA card "
                             f"(torch.cuda.is_available() is false)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return card_label(device)
