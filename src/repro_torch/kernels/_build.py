"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each kernel family keeps its sources in ``kernels/<name>/csrc/*.cu`` (plus
any ``*.cuh``) behind a plain ``extern "C"`` launcher, so the build is one
``nvcc`` call that links nothing of PyTorch and takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I kernels/include \
         -o build/kernels/lib<name>-<hash>.so ...

``kernels/include`` holds device code that several families share.  The
library's name carries a hash of the flags, the family's sources and the
shared headers, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``-Xptxas -v``
reports each kernel's registers, shared memory and spills; that report is
kept beside the library (``.log``).  A failed build raises with nvcc's
output: there is no other path to the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
INCLUDE_DIR = KERNELS_DIR / "include"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    lib: ctypes.CDLL
    path: Path
    seconds: float        # nvcc wall time; 0.0 when an earlier build was reused
    ptxas: str            # nvcc's -Xptxas -v report


_LOCK = threading.Lock()
_LOADED: dict[str, Built] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def sources(name: str) -> list[Path]:
    csrc = KERNELS_DIR / name / "csrc"
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources in {csrc}")
    return srcs


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    csrc = KERNELS_DIR / name / "csrc"
    for p in (sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
              + sorted(INCLUDE_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str) -> Built:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"lib{name}-{_digest(name)}"
    lib_path = BUILD_DIR / f"{stem}.so"
    log_path = BUILD_DIR / f"{stem}.log"
    seconds = 0.0
    if not lib_path.exists():
        tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               *(str(s) for s in sources(name))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        report = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the {name!r} kernels failed (nvcc exit "
                f"{proc.returncode}):\n$ {' '.join(cmd)}\n{report}")
        log_path.write_text(report)
        os.replace(tmp, lib_path)
    ptxas = log_path.read_text() if log_path.exists() else ""
    return Built(name, ctypes.CDLL(str(lib_path)), lib_path, seconds, ptxas)


def build(name: str) -> Built:
    """Build (or reuse) and load the kernels of ``kernels/<name>/csrc``."""
    with _LOCK:
        built = _LOADED.get(name)
    if built is None:
        built = _compile(name)
        with _LOCK:
            built = _LOADED.setdefault(name, built)
    return built


def load(name: str) -> ctypes.CDLL:
    return build(name).lib
