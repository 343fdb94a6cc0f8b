"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled by `nvcc`
for Hopper (`sm_90a`) into `build/kernels/<name>-<hash>.so` at the root of the
checkout; the hash covers the source, the shared `csrc/*.cuh` headers and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it is. Nothing is compiled when a
module is imported: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import socket
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DEFAULT_CUDA_HOME = "/usr/local/cuda"


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), _DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of anatomask_torch are built with "
            "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a source may include any of them
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a build of this exact source exists.
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as <library>.log."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # the ranks of every node that shares the checkout may build at once
    tmp = out.with_name(f"{out.name}.{socket.gethostname()}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{res.stdout}{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
