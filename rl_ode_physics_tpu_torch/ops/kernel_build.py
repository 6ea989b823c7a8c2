"""Build a hand-written CUDA kernel library at first use.

Each kernel source in ``csrc/`` has a plain C interface. ``build`` compiles
it with ``nvcc`` for ``sm_90a`` into a shared library in ``build/kernels/``
at the root of the checkout, named by a hash of the source and the flags,
and ``load`` opens it with ``ctypes``. No PyTorch header is compiled, so a
build takes seconds. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the kernels are built with the "
                           "CUDA toolkit's nvcc")
    return str(path)


def build(source: str, flags=()) -> Path:
    """Compile ``csrc/<source>`` (once per source and flag version) and
    return the library's path."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", *flags, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(path: Path, functions: dict) -> ctypes.CDLL:
    """Open the library and declare ``functions``: name → argtypes. Every
    launcher returns the launch's ``cudaError_t`` as an int."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
