"""ctypes binding of the parameter server's C++ core, its TCP van and its
remote tiers, built on first use (counterpart of
``hetu_tpu/ps/binding.py``).

Four sources at the repository root (the JAX package's own, unchanged;
the van through a wrapper, below):
``csrc/hetu_ps.cpp`` holds the in-process tier (tables with server-side
optimizers, the HET cache, SSP clocks, partial-reduce matchmaking, the
int8 row codec); ``csrc/hetu_ps_van.cpp`` the van (the
thread-per-connection TCP server and its client calls: remote tables,
the quantized gradient wire, the blob channel, the barrier, the
scheduler role and its heartbeats, the transport counters);
``csrc/hetu_ps_group.cpp`` the key-range-partitioned group over several
van servers; ``csrc/hetu_ps_rcache.cpp`` the HET cache over such a group.
The van compiles through ``hetu_tpu_torch/csrc/hetu_ps_van.cpp``, which
includes the root source with one repair (a departure): the server's
accept loop retries a failed ``accept()`` (an interrupted one, after a
SIGSTOP and SIGCONT, ended it for good).  g++ compiles the four together, in a few seconds, into
``hetu_tpu_torch/_build/libhetu_ps.so``.  The library is rebuilt when a
source or ``csrc/hetu_ps_dtype.h`` is newer, or when it was built from
another list of sources (the list is kept beside it in
``libhetu_ps.so.srcs``): a library built from fewer sources may be newer
than every source and lack their symbols.  Only what the port calls is
bound.  A failed build raises with g++'s output: a caller of the PS has
no other path to take.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG.parent / "csrc"
# the van through the port's wrapper of the root source (one repair: its
# accept loop survives a failed accept)
_SRCS = (_CSRC / "hetu_ps.cpp", _PKG / "csrc" / "hetu_ps_van.cpp",
         _CSRC / "hetu_ps_group.cpp", _CSRC / "hetu_ps_rcache.cpp")
# staleness only (not passed to g++)
_HDRS = (_CSRC / "hetu_ps_dtype.h", _CSRC / "hetu_ps_van.cpp")
_BUILD = _PKG / "_build"
_SO = _BUILD / "libhetu_ps.so"

_lock = threading.Lock()
_lib = None

_c = ctypes
_i64p, _f32p = _c.POINTER(_c.c_int64), _c.POINTER(_c.c_float)
_u64p, _u32p = _c.POINTER(_c.c_uint64), _c.POINTER(_c.c_uint32)
_i32p, _u8p = _c.POINTER(_c.c_int32), _c.POINTER(_c.c_uint8)
_i8p = _c.POINTER(_c.c_int8)
_int, _i64, _u64, _f32, _f64 = (_c.c_int, _c.c_int64, _c.c_uint64,
                                _c.c_float, _c.c_double)
# name -> (argtypes, restype) of every function the port calls
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
    # the TCP van (csrc/hetu_ps_van.cpp): server, connections, the blob
    # channel, the barrier and the transport counters
    "ps_van_start": ([_c.c_int], _c.c_int),
    "ps_van_stop": ([], None),
    "ps_van_connect": ([_c.c_char_p, _c.c_int], _c.c_int),
    "ps_van_close": ([_c.c_int], None),
    "ps_van_ping": ([_c.c_int], _c.c_int),
    "ps_van_blob_put": ([_c.c_int, _c.c_int64, _c.c_uint64, _c.c_void_p,
                         _c.c_int64, _c.c_int], _c.c_int),
    "ps_van_blob_get": ([_c.c_int, _c.c_int64, _c.c_uint64, _c.c_void_p,
                         _c.c_int64, _c.c_int, _i64p], _c.c_int64),
    "ps_van_blob_ack": ([_c.c_int, _c.c_int64, _c.c_uint64], _c.c_int),
    "ps_van_barrier": ([_c.c_int, _c.c_int64, _c.c_int, _c.c_int],
                       _c.c_int),
    "ps_van_stats": ([_c.c_int, _u64p, _u64p, _u64p], _c.c_int),
    "ps_van_stats_frames": ([_c.c_int], _c.c_int64),
    # the int8 row codec, SSP clocks and partial-reduce matchmaking of the
    # in-process tier
    "ps_q8_encode": ([_f32p, _i64, _i64, _i8p, _f32p], _int),
    "ps_q8_decode": ([_i8p, _f32p, _i64, _i64, _f32p], _int),
    "ps_ssp_init": ([_int, _int, _int], _int),
    "ps_ssp_clock_and_wait": ([_int, _int, _int], _int),
    "ps_ssp_get_clock": ([_int, _int], _i64),
    "ps_preduce_get_partner": ([_int, _int, _int, _int], _u64),
    # a remote table over one van connection (dtype'd rows, the quantized
    # gradient wire, request-id dedup, compare-and-set, slots)
    "ps_van_table_create_dt": ([_int, _int, _i64, _i64, _int, _f64, _f64,
                                _u64, _int], _int),
    "ps_van_set_optimizer": ([_int, _int, _int, _f32, _f32, _f32, _f32,
                              _f32], _int),
    "ps_van_sparse_pull_dt": ([_int, _int, _i64p, _i64, _f32p, _i64, _int],
                              _int),
    "ps_van_sparse_push_dt": ([_int, _int, _i64p, _f32p, _i64, _i64, _int],
                              _int),
    "ps_van_sparse_set_dt": ([_int, _int, _i64p, _f32p, _i64, _i64, _int],
                             _int),
    "ps_van_dense_pull": ([_int, _int, _f32p, _i64], _int),
    "ps_van_dense_push": ([_int, _int, _f32p, _i64], _int),
    "ps_van_dense_push_id": ([_int, _int, _f32p, _i64, _u64], _int),
    "ps_van_sparse_push_id": ([_int, _int, _i64p, _f32p, _i64, _i64, _u64],
                              _int),
    "ps_van_dense_push_w": ([_int, _int, _f32p, _i64, _i64, _int, _u64,
                             _f32p], _int),
    "ps_van_dense_pull_w": ([_int, _int, _f32p, _i64, _i64, _int], _int),
    "ps_van_sparse_push_w": ([_int, _int, _i64p, _f32p, _i64, _i64, _int,
                              _u64, _f32p], _int),
    "ps_van_row_cas": ([_int, _int, _i64, _int, _f32, _f32p, _i64, _f32p],
                       _int),
    "ps_van_table_clear": ([_int, _int], _int),
    "ps_van_table_slots_get": ([_int, _int, _i64p, _i64, _i64, _f32p,
                                _f32p, _u64p], _int),
    "ps_van_table_slots_set": ([_int, _int, _i64p, _i64, _i64, _f32p,
                                _f32p, _u64p], _int),
    "ps_van_table_save": ([_int, _int, _c.c_char_p], _int),
    "ps_van_table_load": ([_int, _int, _c.c_char_p], _int),
    # SSP and partial reduce over the wire
    "ps_van_ssp_init": ([_int, _int, _int, _int], _int),
    "ps_van_ssp_clock": ([_int, _int, _int, _int], _int),
    "ps_van_ssp_get": ([_int, _int, _int], _i64),
    "ps_van_preduce": ([_int, _int, _int, _int, _int], _u64),
    # the scheduler role: registration, its map, the servers' heartbeats
    "ps_van_sched_register": ([_int, _int, _int, _int], _int),
    "ps_van_sched_map": ([_int, _int, _i32p, _u8p, _i32p, _c.c_char_p],
                         _int),
    "ps_sched_beat_start": ([_c.c_char_p, _int, _int, _int, _int, _f64],
                            _int),
    "ps_sched_beat_rank": ([_int], _int),
    "ps_sched_beat_stop": ([_int], None),
    # the partitioned group (csrc/hetu_ps_group.cpp)
    "ps_group_create_dt": ([_c.c_char_p, _int, _i64, _i64, _int, _f64, _f64,
                            _u64, _f64, _int, _int], _int),
    "ps_group_create_sched_dt": ([_c.c_char_p, _int, _int, _int, _i64, _i64,
                                  _int, _f64, _f64, _u64, _f64, _int, _int],
                                 _int),
    "ps_group_set_optimizer": ([_int, _int, _f32, _f32, _f32, _f32, _f32],
                               _int),
    "ps_group_n": ([_int], _int),
    "ps_group_start": ([_int, _int], _i64),
    "ps_group_sparse_pull": ([_int, _i64p, _i64, _f32p], _int),
    "ps_group_sparse_push": ([_int, _i64p, _f32p, _i64], _int),
    "ps_group_sparse_set": ([_int, _i64p, _f32p, _i64], _int),
    "ps_group_dense_pull": ([_int, _f32p], _int),
    "ps_group_dense_push": ([_int, _f32p], _int),
    "ps_group_slots_get": ([_int, _i64p, _i64, _f32p, _f32p, _u64p], _int),
    "ps_group_slots_set": ([_int, _i64p, _f32p, _f32p, _u64p, _i64], _int),
    "ps_group_sync_pull": ([_int, _i64p, _u64p, _i64, _u64, _u32p, _u64p,
                            _f32p], _i64),
    "ps_group_save": ([_int, _c.c_char_p], _int),
    "ps_group_load": ([_int, _c.c_char_p], _int),
    "ps_group_alive_mask": ([_int], _u64),
    "ps_group_recovered": ([_int], _u64),
    "ps_group_close": ([_int], None),
    # the HET cache over a group (csrc/hetu_ps_rcache.cpp)
    "ps_rcache_create": ([_int, _i64, _int, _f32], _int),
    "ps_rcache_lookup": ([_int, _i64p, _i64, _u64, _f32p], _i64),
    "ps_rcache_update": ([_int, _i64p, _f32p, _i64], _int),
    "ps_rcache_flush": ([_int], _int),
    "ps_rcache_size": ([_int], _i64),
    "ps_rcache_close": ([_int], None),
}


def build() -> Path:
    """Compile the sources if the library is missing, older than a source
    or header, or built from another list of sources; return its path.
    Builds to private names and renames (the library first, then its
    list), so a concurrent process never loads a half-written file and a
    list on disk never vouches for an older library.  Raises
    ``RuntimeError`` with g++'s output if the build fails."""
    srcs = _SRCS
    key = "\n".join(s.name for s in srcs) + "\n"
    newest = max(p.stat().st_mtime for p in (*srcs, *_HDRS))
    stamp = _SO.with_name(_SO.name + ".srcs")
    if (_SO.exists() and _SO.stat().st_mtime >= newest and stamp.exists()
            and stamp.read_text() == key):
        return _SO
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD / f"libhetu_ps.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
           *map(str, srcs), "-o", str(tmp)]
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
    tmp_stamp = _BUILD / f"libhetu_ps.{os.getpid()}.srcs.tmp"
    tmp_stamp.write_text(key)
    os.replace(tmp_stamp, stamp)
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
