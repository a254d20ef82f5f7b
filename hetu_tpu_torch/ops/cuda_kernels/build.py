"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``hetu_tpu_torch/csrc/<name>.cu`` exposes a plain ``extern "C"``
launcher and compiles on its own, with no PyTorch headers, into
``hetu_tpu_torch/_build/lib<name>.so`` (seconds per source, where a build
against PyTorch's headers takes minutes).  A library is rebuilt when its
source, or any header ``csrc/*.cuh`` (which a source may include), is newer
than it.  A build or load error is raised, never swallowed:
a CUDA tensor has no other path to take.

Nothing here runs at import time; ``nvcc`` is needed only on the machine
with the card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # registers, shared memory and spills per kernel, kept in
              # the build log beside the library
              "-Xptxas", "-v")

_loaded: dict = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else the one on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "hetu_tpu_torch build from source on first use")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.log"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or than
    any header in ``csrc/``."""
    lib = library_path(name)
    if not lib.exists():
        return True
    inputs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(*names: str) -> list:
    """Compile every stale source among ``names`` (all ``nvcc`` processes
    started together) and return the library paths.  Raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    stale = [n for n in names if _stale(n)]
    if stale:
        compiler = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for n in stale:
            # build to a private name, then rename: a concurrent process
            # never loads a half-written library
            tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp"
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, tmp, p in procs:
            out, _ = p.communicate()
            log_path(n).write_text(out)
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{out}")
            else:
                os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
