"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/torch_kernels/lib<name>-<digest>.so`` under the repo
root, then loaded with ``ctypes``; ``csrc/<name>.cc`` (the host data plane,
no CUDA) is compiled the same way by ``g++`` (:func:`build_host`).
``<digest>`` hashes the source and the flags, so an edited source is rebuilt
and never mixed up with an old build.  Nothing here runs at import time:
tests import every module on machines without ``nvcc``.  A build failure
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in Built.log
)
HOST_CXX = "g++"
HOST_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # the compiler's output (nvcc: ptxas -v), kept beside the library as lib<name>-<digest>.log


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA kernels "
            "of bts_tpu_torch build on a machine with the CUDA toolkit"
        )
    return found


def build(name: str, defines: tuple = ()) -> Built:
    """Compile ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``, for a
    profiling build) unless this exact source is already built."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    stem = f"lib{name}{''.join('-' + d.lower() for d in defines)}"
    return _compile(CSRC / f"{name}.cu", stem, find_nvcc, flags, ())


def build_host(name: str, libs: tuple = ()) -> Built:
    """Compile ``csrc/<name>.cc`` with ``g++``, linked to ``libs`` (``-l``
    flags), unless this exact source is already built."""
    return _compile(CSRC / f"{name}.cc", f"lib{name}", lambda: HOST_CXX, HOST_CXX_FLAGS, libs)


def _compile(src: Path, stem: str, compiler, flags: tuple, libs: tuple) -> Built:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags + libs).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return Built(lib, 0.0, log_path.read_text() if log_path.exists() else "")
    cmd = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cmd, *flags, "-o", str(tmp), str(src), *libs], capture_output=True, text=True)
    except OSError as e:  # the compiler itself is missing or cannot run
        raise RuntimeError(f"{cmd} failed to build {src}: {e}") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd).name} failed to build {src} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all of it or none
    return Built(lib, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name).path))
