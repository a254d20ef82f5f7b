"""Process harness: spawn READY-handshaking subprocesses (counterpart of
``hetu_tpu/resilience/shardproc.py``).

The bootstrap the cross-process control plane shares: van servers and
serving-member processes (``hetu_tpu_torch.serve.crosshost``) come up
through here, so the handshake (spawn, wait for a READY line, fail
loudly with the process's output otherwise) and the spawn environment
(``launcher.spawn_local``: the repository on ``PYTHONPATH``) live in one
place.  The returned ``Popen`` handles are what
:class:`~hetu_tpu_torch.resilience.faults.FaultInjector`'s process
faults (``kill_shard``, ``member_kill``, ``member_suspend``) target.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]

_SERVER_SRC = """\
import os, sys, time
sys.path.insert(0, {repo!r})
# the van's own flight recorder: a SIGKILLed server's final spans survive
# on disk beside its peers' streams
from hetu_tpu_torch.telemetry import trace
trace.open_process_stream({trace_dir!r}, "van_p%d" % os.getpid())
from hetu_tpu_torch.ps import van
port = van.serve({port})
trace.instant("van.serve", {{"port": port, "pid": os.getpid()}},
              cat="van")
# the READY line says whether the van loaded jax or torch (neither)
print("READY", port, "jax=%d" % ("jax" in sys.modules),
      "torch=%d" % ("torch" in sys.modules), flush=True)
time.sleep({lifetime})
"""

# a van server that registers with a scheduler (the postoffice server
# role): the rejoin-at-a-new-address path
_REGISTERED_SERVER_SRC = """\
import os, sys, time
sys.path.insert(0, {repo!r})
from hetu_tpu_torch.telemetry import trace
trace.open_process_stream({trace_dir!r}, "van_p%d" % os.getpid())
from hetu_tpu_torch.ps import van
port, rank = van.serve_and_register("127.0.0.1", {sched_port},
                                    port={port}, rank_hint={rank_hint},
                                    beat_ms={beat_ms})
trace.instant("van.serve", {{"port": port, "rank": rank,
                             "pid": os.getpid()}}, cat="van")
print("READY", port, rank, flush=True)
time.sleep({lifetime})
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ready(workdir, tag: str, src: str, **fmt) -> subprocess.Popen:
    """Write ``src.format(repo=..., **fmt)`` as a script, spawn it, and
    block until it prints a READY line on stdout (its words after READY
    are kept as ``proc.ready``, e.g. the bound port).  The caller owns
    the returned ``Popen``."""
    script = Path(workdir) / f"{tag}.py"
    script.write_text(src.format(repo=str(_REPO), **fmt))
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line.startswith("READY"):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"{tag}: process failed to start: {line!r}")
    proc.ready = line.split()[1:]
    return proc


def spawn_module(workdir, tag: str, module: str, args, *,
                 extra_env: dict | None = None,
                 timeout_s: float = 120.0,
                 wait: bool = True) -> subprocess.Popen:
    """Spawn ``python -m module *args`` and wait for its READY line.

    Unlike :func:`spawn_ready`, stdout and stderr go to a log file in
    ``workdir`` (``<tag>.log``, its path kept as ``proc.log_path``) and
    READY is awaited by reading it: a long-lived member prints tracebacks
    and progress, and an unread stdout pipe would fill and wedge it.
    ``wait=False`` returns at once; :func:`wait_ready` then waits (several
    processes start side by side)."""
    from hetu_tpu_torch.launcher import spawn_local
    log_path = Path(workdir) / f"{tag}.log"
    with open(log_path, "w") as log:
        # the child inherits its own copy of the fd; holding the parent's
        # open would leak one fd a spawn (revive loops)
        proc = spawn_local([sys.executable, "-m", module,
                            *map(str, args)], extra_env=extra_env,
                           stdout=log, stderr=subprocess.STDOUT)
    proc.log_path = log_path
    proc.ready = False
    proc.started_at = time.monotonic()
    if wait:
        wait_ready(proc, tag, timeout_s)
    return proc


def wait_ready(proc: subprocess.Popen, tag: str,
               timeout_s: float = 120.0) -> subprocess.Popen:
    """Wait until a :func:`spawn_module` process has written READY to its
    log (``proc.ready_s``: the seconds from its spawn); raise with the
    log's tail if it exits first, kill it and raise after
    ``timeout_s``."""
    log_path = proc.log_path
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if "READY" in log_path.read_text(errors="replace"):
            proc.ready = True
            proc.ready_s = time.monotonic() - proc.started_at
            return proc
        if proc.poll() is not None:
            raise RuntimeError(
                f"{tag}: process exited rc={proc.returncode} before "
                f"READY:\n{log_path.read_text(errors='replace')[-2000:]}")
        time.sleep(0.02)
    proc.kill()
    proc.wait()
    raise TimeoutError(
        f"{tag}: no READY within {timeout_s}s:\n"
        f"{log_path.read_text(errors='replace')[-2000:]}")


def spawn_shard_server(workdir, port: int, tag: str = "s", *,
                       lifetime_s: int = 600) -> subprocess.Popen:
    """Start a van server subprocess on ``port``; blocks until READY (the
    server is accepting connections).  ``proc.ready`` holds ``[port,
    "jax=0", "torch=0"]``: the server loads neither."""
    return spawn_ready(workdir, f"shard_server_{tag}", _SERVER_SRC,
                       port=int(port), lifetime=int(lifetime_s),
                       trace_dir=str(workdir))


def spawn_registered_server(workdir, sched_port: int, tag: str = "r", *,
                            port: int = 0, rank_hint: int = -1,
                            beat_ms: int = 200,
                            lifetime_s: int = 600) -> subprocess.Popen:
    """Start a van server that registers with the scheduler at
    ``sched_port`` (a native beat thread keeps the registration live);
    ``proc.ready`` holds ``[bound_port, rank]``."""
    return spawn_ready(workdir, f"reg_server_{tag}",
                       _REGISTERED_SERVER_SRC, sched_port=int(sched_port),
                       port=int(port), rank_hint=int(rank_hint),
                       beat_ms=int(beat_ms), lifetime=int(lifetime_s),
                       trace_dir=str(workdir))
