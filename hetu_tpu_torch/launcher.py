"""Local process spawning (counterpart of ``hetu_tpu/launcher.py``'s
``local_env`` / ``spawn_local``).

The one primitive every cross-process harness of the port spawns through
(``resilience/shardproc.py`` -> serving members): the caller's
environment plus its extras, and ``PYTHONPATH`` set to this repository so
that ``python -m hetu_tpu_torch.*`` entry points resolve without an
install.

The reference's ``cpu_devices`` (XLA's forced host device count) has no
counterpart here: a port process picks its device from its own
arguments.  The cluster yaml and its ssh fan-out (``DistConfig``,
``launch``) wait for a later slice.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import List, Optional

_REPO = str(Path(__file__).resolve().parents[1])


def local_env(*, extra: Optional[dict] = None) -> dict:
    """Environment for a locally spawned process: the caller's env plus
    ``extra`` (values as strings)."""
    return {**os.environ, **{k: str(v) for k, v in (extra or {}).items()}}


def spawn_local(argv: List[str], *, extra_env: Optional[dict] = None,
                stdout=None, stderr=None) -> subprocess.Popen:
    """Spawn ``argv`` with :func:`local_env` and the repository first on
    ``PYTHONPATH``; the caller owns the returned ``Popen``."""
    env = local_env(extra=extra_env)
    path = env.get("PYTHONPATH", "")
    if _REPO not in path.split(os.pathsep):
        env["PYTHONPATH"] = _REPO + (os.pathsep + path if path else "")
    return subprocess.Popen(list(argv), env=env, stdout=stdout,
                            stderr=stderr)
