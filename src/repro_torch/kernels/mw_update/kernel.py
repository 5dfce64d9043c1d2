"""Build and bind the hand-written Hopper mw_update kernel.

The source is ``csrc/mw_update.cu``, compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C entry point and loaded
with ctypes (no PyTorch headers, so the build takes seconds).  The
library lands in ``build/repro_torch/`` at the repository root, named
by the source's content hash so an edited source always rebuilds.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mw_update.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the mw_update kernel is built "
                       "from source on a host with the CUDA toolkit")


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernel library if it is not built yet.  Returns its
    path and ptxas's resource report (empty when already built).
    Raises with the compiler's output when the build fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmw_update-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.mw_update_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(hits, correct, alive, new_hits, partials, wsum, stream) -> None:
    """Enqueue both passes on ``stream``; raises on a launch error.

    All tensors are contiguous CUDA tensors on one device: hits and
    new_hits int32 [R, m], correct and alive bool [R, m], partials
    float32 [R, ⌈m/BLOCK⌉], wsum float32 [R]."""
    R, m = hits.shape
    err = library().mw_update_launch(
        hits.data_ptr(), correct.data_ptr(), alive.data_ptr(),
        new_hits.data_ptr(), partials.data_ptr(), wsum.data_ptr(),
        R, m, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"mw_update kernel launch failed: CUDA error {err}")
