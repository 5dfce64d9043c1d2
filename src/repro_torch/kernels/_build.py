"""Build and load the port's hand-written CUDA kernels.

Each kernel's source, ``kernels/<name>/csrc/<name>.cu``, is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C entry
point and loaded with ctypes (no PyTorch headers, so a build takes
seconds).  Libraries land in ``build/repro_torch/`` at the repository
root, each named by its source's content hash, so an edited source
always rebuilds.  Nothing here runs at import: the CPU tests import
the kernel modules on hosts with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built "
                       "from source on a host with the CUDA toolkit")


def build_all(sources) -> list[tuple[pathlib.Path, str, float]]:
    """Compile every source not built yet, one nvcc each, all started
    together.  Returns (library, ptxas report, seconds) per source, in
    order (an empty report and 0 s for a library already built).
    Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{src.stem}-{digest}.so"
        if lib.exists():
            jobs.append((src, lib, None, None, 0.0))
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, proc, time.perf_counter()))
    out, failed = [], []
    for src, lib, tmp, proc, t0 in jobs:       # wait for every nvcc
        if proc is None:
            out.append((lib, "", 0.0))
            continue
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src.name}:\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, lib)
        out.append((lib, stderr, time.perf_counter() - t0))
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def load(source: pathlib.Path) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use)."""
    return ctypes.CDLL(str(build_all([source])[0][0]))


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
