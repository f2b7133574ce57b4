"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``lib<name>.so``, bound with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The build runs on first use, one ``nvcc`` per
source, all started together, into ``build/repro_torch_kernels/<key>/``
at the root of the checkout, where ``<key>`` is a hash of the sources and
the flags: an edited source is rebuilt, an unchanged one is loaded as it
is.  Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    libs: dict            # source stem -> path of its shared library
    seconds: float        # wall time of this build (0 when reused)
    log: str              # nvcc's output (ptxas registers, spills, smem)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    path = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile every ``csrc/*.cu`` (or reuse the build for these sources)
    and return where the libraries are.  Raises on a compiler error."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_ROOT / _key()
    libs = {s.stem: out / f"lib{s.stem}.so" for s in sources}
    if all(p.exists() for p in libs.values()):
        return Build(libs, 0.0, (out / "nvcc.log").read_text())
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode:
            failed.append(src.name)
        else:
            os.replace(tmp, libs[src.stem])
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    (out / "nvcc.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    return Build(libs, seconds, log)


@functools.lru_cache(maxsize=None)
def bind(lib: str, fn: str, argtypes: tuple):
    """The C function ``fn`` of ``lib<lib>.so`` with its argument types
    declared (``c_void_p`` for every pointer and the stream) and an ``int``
    result: the ``cudaError_t`` of a launch, or the number a query returns."""
    f = getattr(ctypes.CDLL(str(build().libs[lib])), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f
