"""ctypes binding of the parameter server's C++ core, built on first use
(counterpart of ``hetu_tpu/ps/binding.py``).

``csrc/hetu_ps.cpp`` at the repository root (the JAX package's own
source, unchanged) holds the in-process tier: tables with server-side
optimizers and the HET cache.  g++ compiles it alone, in a few seconds,
into ``hetu_tpu_torch/_build/libhetu_ps.so``, rebuilt when the source or
``csrc/hetu_ps_dtype.h`` is newer.  The remote tiers (the van, the
partitioned group, the scheduler) live in the other ``csrc/hetu_ps_*.cpp``
and come with the fleet slice; only what the in-process tier calls is
bound.  A failed build raises with g++'s output: a caller of the PS has no
other path to take.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG.parent / "csrc"
_SRC = _CSRC / "hetu_ps.cpp"
_HDRS = (_CSRC / "hetu_ps_dtype.h",)  # staleness only (not passed to g++)
_BUILD = _PKG / "_build"
_SO = _BUILD / "libhetu_ps.so"

_lock = threading.Lock()
_lib = None

_c = ctypes
_i64p, _f32p = _c.POINTER(_c.c_int64), _c.POINTER(_c.c_float)
_u64p, _u32p = _c.POINTER(_c.c_uint64), _c.POINTER(_c.c_uint32)
# name -> (argtypes, restype) of every function the in-process tier calls
_SIGNATURES = {
    "ps_table_create_ex": ([_c.c_int, _c.c_int64, _c.c_int64, _c.c_int,
                            _c.c_double, _c.c_double, _c.c_uint64,
                            _c.c_int], _c.c_int),
    "ps_table_set_optimizer": ([_c.c_int, _c.c_int, _c.c_float, _c.c_float,
                                _c.c_float, _c.c_float, _c.c_float],
                               _c.c_int),
    "ps_table_clear": ([_c.c_int], _c.c_int),
    "ps_dense_pull": ([_c.c_int, _f32p], _c.c_int),
    "ps_dense_push": ([_c.c_int, _f32p], _c.c_int),
    "ps_sparse_pull": ([_c.c_int, _i64p, _c.c_int64, _f32p, _u64p],
                       _c.c_int),
    "ps_sparse_push": ([_c.c_int, _i64p, _f32p, _c.c_int64], _c.c_int),
    "ps_sparse_set": ([_c.c_int, _i64p, _f32p, _c.c_int64], _c.c_int),
    "ps_sync_pull": ([_c.c_int, _i64p, _u64p, _c.c_int64, _c.c_uint64,
                      _u32p, _u64p, _f32p], _c.c_int64),
    "ps_table_slots_get": ([_c.c_int, _i64p, _c.c_int64, _f32p, _f32p,
                            _u64p], _c.c_int),
    "ps_table_slots_set": ([_c.c_int, _i64p, _c.c_int64, _f32p, _f32p,
                            _u64p], _c.c_int),
    "ps_table_save": ([_c.c_int, _c.c_char_p], _c.c_int),
    "ps_table_load": ([_c.c_int, _c.c_char_p], _c.c_int),
    "ps_cache_create": ([_c.c_int, _c.c_int, _c.c_int64, _c.c_int],
                        _c.c_int),
    "ps_cache_lookup": ([_c.c_int, _i64p, _c.c_int64, _c.c_uint64, _f32p],
                        _c.c_int64),
    "ps_cache_update": ([_c.c_int, _i64p, _f32p, _c.c_int64], _c.c_int),
    "ps_cache_flush": ([_c.c_int], _c.c_int),
    "ps_cache_size": ([_c.c_int], _c.c_int64),
}


def build() -> Path:
    """Compile ``csrc/hetu_ps.cpp`` if the library is missing or older
    than its source; return the library's path.  Builds to a private name
    and renames, so a concurrent process never loads a half-written file.
    Raises ``RuntimeError`` with g++'s output if the build fails."""
    newest = max(p.stat().st_mtime for p in (_SRC, *_HDRS))
    if _SO.exists() and _SO.stat().st_mtime >= newest:
        return _SO
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"libhetu_ps.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           str(_SRC), "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"hetu_ps: g++ not found ({e}); the parameter "
                           f"server's C++ core builds on first use") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"hetu_ps: g++ failed (exit {out.returncode}):\n"
                           f"{out.stderr}")
    os.replace(tmp, _SO)
    return _SO


def load() -> ctypes.CDLL:
    """The loaded library with its functions typed, built first if
    stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


class _Lazy:
    """``lib.<fn>`` loads (and if need be builds) the library on first
    use, never at import."""

    def __getattr__(self, name):
        return getattr(load(), name)


lib = _Lazy()
