"""Rank processes: run one function in each of N ranks of a fresh
``torch.distributed`` group and collect what each returns.

The reference is a single SPMD program over a device mesh and needs no
such module; the port runs one process per rank, and this is how a test,
a script or ``chip_smoke.py`` starts them::

    from hetu_tpu_torch.parallel import ranks
    results = ranks.run(my_module.body, 2, backend="gloo", args=(cfg,))

``fn(rank, world, *args)`` runs in every rank after its group is up
(``init_process_group`` over a ``FileStore`` in a fresh temporary
directory); it must be importable by name (a module-level function), and
what it returns must pickle.  The processes are started with the
``spawn`` method, so a rank imports only ``fn``'s module and what that
imports.  A rank that raises makes :func:`run` raise with that rank's
traceback, after every process is gone.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence


def _rank_main(fn, rank: int, world: int, store: str, backend: str,
               threads: Optional[int], args, results) -> None:
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            out = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out = ("error", traceback.format_exc())
    results.put((rank, out))


def run(fn: Callable, world: int, *, backend: str = "gloo",
        args: Sequence[Any] = (), timeout_s: float = 600.0,
        threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` rank processes of one
    ``backend`` group and return their results in rank order.

    ``threads`` sets each rank's intra-op threads
    (``torch.set_num_threads``).  Raises
    ``RuntimeError`` with the first failing rank's traceback, or on
    ``timeout_s`` without every result; every rank process is stopped
    before this returns or raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="hetu_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, backend, threads,
                               tuple(args), results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    failure = None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world and failure is None:
            try:
                rank, (status, value) = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    # a rank that died without reporting (killed, or a
                    # crash below Python): give its report a moment
                    try:
                        rank, (status, value) = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no "
                                   f"result")
                        break
                elif time.monotonic() > deadline:
                    failure = (f"{world - len(out)} rank(s) gave no result "
                               f"within {timeout_s} s")
                    break
                else:
                    continue
            if status == "ok":
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]
