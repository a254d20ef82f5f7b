"""Span tracer: nestable spans, instant events, Chrome-trace/JSONL export
(counterpart of ``hetu_tpu/telemetry/trace.py``, copied whole: pure
Python).

What a live run can observe is the HOST-side phase structure — the
engine's ``serve.prefill`` / ``serve.decode`` spans (each ends after a
synchronising read, so it covers the device work), the scheduler's
``serve.step``, the van's client ``van.<op>`` spans, the pool's
``serve.migrate`` / ``serve.failover`` recovery spans — plus instant
events (fault injections, recompiles, sheds).  Events are recorded on
monotonic clocks (``time.perf_counter_ns``; wall-clock jumps must never
produce negative spans), thread-safely.

Two export shapes from one event list:

* :meth:`Tracer.chrome_trace` — the Chrome trace-event JSON Perfetto /
  chrome://tracing load directly (``ph``/``ts``/``dur``/``pid``/``tid``,
  ts in microseconds, sorted so ts is monotone within each track);
* an append-only JSONL stream (``jsonl_path=``, or one a process through
  :func:`open_process_stream`) — one event per line at record time, so a
  crashed run still has its trace up to the crash.

Disabled-path contract: module-level :func:`span` and :func:`instant`
check ONE module global; when tracing is off, ``span()`` returns a
preallocated singleton no-op context manager and ``instant()`` returns
immediately — no allocation, no lock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

# ---------------------------------------------------------------------------
# the disabled path: one global, one branch, zero allocation
# ---------------------------------------------------------------------------

_tracer: Optional["Tracer"] = None  # None = tracing disabled


class _NullSpan:
    """Singleton no-op span: ``with span(...)`` costs two no-op calls when
    tracing is disabled, and ``.set`` swallows attribute writes."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, key, value):
        return self


NULL_SPAN = _NullSpan()


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional["Tracer"]:
    return _tracer


def enable(jsonl_path=None, *, tracer: Optional["Tracer"] = None) -> "Tracer":
    """Install (and return) the process tracer.  ``jsonl_path`` streams
    every event as one JSON line at record time (append mode — a resumed
    run extends its predecessor's stream)."""
    global _tracer
    if _tracer is not None:
        _tracer.close()
    _tracer = tracer if tracer is not None else Tracer(jsonl_path=jsonl_path)
    return _tracer


def disable() -> Optional["Tracer"]:
    """Uninstall the process tracer; returns it (events stay readable —
    export after the run ends is the common pattern)."""
    global _tracer
    t = _tracer
    _tracer = None
    if t is not None:
        t.close()
    return t


def span(name: str, attrs: Optional[dict] = None, cat: str = "hetu"):
    """Context manager timing a phase.  Nesting works naturally — Perfetto
    stacks spans per (pid, tid) track by ts/dur containment."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, attrs, cat)


def instant(name: str, attrs: Optional[dict] = None, cat: str = "hetu") -> None:
    """A zero-duration marker (fault injected, recompile, retry)."""
    t = _tracer
    if t is None:
        return
    t.instant(name, attrs, cat)


def now_us() -> float:
    """Track-relative timestamp for retroactive spans (:func:`complete`);
    0.0 when tracing is disabled (complete() then no-ops anyway)."""
    t = _tracer
    if t is None:
        return 0.0
    return t._now_us()


def complete(name: str, start_us: float, attrs: Optional[dict] = None,
             cat: str = "hetu") -> None:
    """Record a span RETROACTIVELY from a ``now_us()`` taken earlier —
    for phases only worth recording once the outcome is known (a guard
    poll that actually repaired a shard, a retry envelope that actually
    retried)."""
    t = _tracer
    if t is None:
        return
    t.complete(name, start_us, attrs, cat)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

class _Span:
    __slots__ = ("_tracer", "name", "cat", "attrs", "_start")

    def __init__(self, tracer, name, attrs, cat):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, key, value):
        """Attach an attribute discovered mid-span (batch size, repaired
        count); shows up under ``args`` in Perfetto."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self):
        self._start = self._tracer._now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.set("error", exc_type.__name__)
        self._tracer.complete(self.name, self._start, self.attrs, self.cat)
        return False


class Tracer:
    """Thread-safe event recorder.  Events are Chrome-trace dicts from the
    moment they are recorded; ``seq`` (a lock-ordered sequence number) is
    an extra field Perfetto ignores but the determinism tests key on.

    **Clock anchors.**  Every tracer runs on its own ``perf_counter_ns``
    epoch, so two processes' streams are not directly comparable.  The
    tracer therefore records ``clock_sync`` metadata events — a
    (track-relative ts, wall-clock ns) pair — at construction and then
    every ``anchor_interval_s`` of recording, which is what lets
    :mod:`hetu_tpu_torch.telemetry.fleet` align N streams onto one wall-clock
    axis (re-anchoring bounds perf/wall drift over long runs)."""

    def __init__(self, *, jsonl_path=None, pid: Optional[int] = None,
                 process_name: str = "hetu_tpu_torch",
                 anchor_interval_s: float = 30.0,
                 max_events: Optional[int] = None):
        self._lock = threading.Lock()
        self.events: list = []
        # in-memory retention cap: when a JSONL stream is attached the
        # DISK is the durable record, and a long-lived process (a
        # serving member up for days) must not grow RSS one event dict
        # per span forever.  None = unbounded (the in-process analysis
        # pattern: record, then read .events).
        self._max_events = int(max_events) if max_events else None
        self.pid = int(pid) if pid is not None else os.getpid()
        self._t0 = time.perf_counter_ns()
        self._seq = 0
        self._jsonl = None
        self.jsonl_path = None
        self._anchor_interval_ns = max(int(anchor_interval_s * 1e9), 1)
        self._last_anchor_ns = 0  # forces an anchor on the first record
        if jsonl_path is not None:
            from pathlib import Path
            p = Path(jsonl_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(p, "a")
            self.jsonl_path = str(p)
        self._record({"ph": "M", "name": "process_name", "ts": 0.0,
                      "pid": self.pid, "tid": 0,
                      "args": {"name": process_name}})

    # ---- clocks ----
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1000.0

    def _anchor_locked(self, perf_ns: int) -> None:
        """Caller holds self._lock.  Append one clock_sync pair."""
        self._last_anchor_ns = perf_ns
        ev = {"ph": "M", "name": "clock_sync",
              "ts": (perf_ns - self._t0) / 1000.0,
              "pid": self.pid, "tid": 0, "seq": self._seq,
              "args": {"wall_ns": time.time_ns()}}
        self._seq += 1
        self.events.append(ev)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(ev) + "\n")

    # ---- recording ----
    def _record(self, ev: dict) -> None:
        with self._lock:
            perf_ns = time.perf_counter_ns()
            if perf_ns - self._last_anchor_ns >= self._anchor_interval_ns:
                self._anchor_locked(perf_ns)
            ev["seq"] = self._seq
            self._seq += 1
            self.events.append(ev)
            if self._max_events and len(self.events) > self._max_events:
                # drop the oldest tenth in one slice: amortized O(1)
                # per record, and the stream on disk keeps everything
                del self.events[:max(self._max_events // 10, 1)]
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(ev) + "\n")
                self._jsonl.flush()

    def span(self, name, attrs=None, cat="hetu") -> _Span:
        return _Span(self, name, attrs, cat)

    def instant(self, name, attrs=None, cat="hetu") -> None:
        self._record({"ph": "i", "name": name, "cat": cat,
                      "ts": self._now_us(), "pid": self.pid,
                      "tid": threading.get_ident(), "s": "t",
                      "args": dict(attrs) if attrs else {}})

    def complete(self, name, start_us, attrs=None, cat="hetu", *,
                 end_us: Optional[float] = None) -> None:
        """Record a span retroactively; ``end_us`` pins the end for a
        phase whose finish was stamped before this call (a request that
        resolved in another thread), else the span ends NOW."""
        end = self._now_us() if end_us is None else float(end_us)
        self._record({"ph": "X", "name": name, "cat": cat,
                      "ts": float(start_us),
                      "dur": max(end - float(start_us), 0.0),
                      "pid": self.pid, "tid": threading.get_ident(),
                      "args": dict(attrs) if attrs else {}})

    # ---- export ----
    def chrome_trace(self) -> dict:
        """Perfetto-loadable trace: events sorted so ``ts`` is monotone
        within each (pid, tid) track, parents before their children
        (same ts → longer dur first)."""
        with self._lock:
            evs = [dict(e) for e in self.events]
        evs.sort(key=lambda e: (e["pid"], e["tid"], e["ts"],
                                -e.get("dur", 0.0)))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write_chrome(self, path) -> str:
        from pathlib import Path
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.chrome_trace()))
        return str(p)

    def metric_dump(self, dump: dict, *, name: str = "hetu_metrics") -> None:
        """Record a full registry dump (:meth:`MetricsRegistry.dump`) as a
        metadata event — the stream doubles as a metrics black box, so a
        SIGKILLed process's last-written counters survive on disk next to
        its last spans."""
        self._record({"ph": "M", "name": name, "ts": self._now_us(),
                      "pid": self.pid, "tid": 0,
                      "args": {"metrics": dump}})

    def flush(self) -> None:
        """Push every buffered line to the OS.  ``_record`` already
        flushes per event, so this only matters for the SIGTERM/atexit
        hardening path — a no-op on a closed or memory-only tracer."""
        with self._lock:
            if self._jsonl is not None:
                try:
                    self._jsonl.flush()
                except ValueError:
                    pass  # closed underneath us (atexit ordering)

    def flush_from_signal(self) -> None:
        """Signal-handler-safe flush: NEVER blocks on the tracer lock.
        A handler runs on the main thread, and blocking-acquire while
        that same thread sits inside ``_record`` (which holds the lock
        across every write) would deadlock the process instead of
        letting it die.  Skipping under contention is sound — the
        holder's own per-record flush runs the moment it releases —
        and reentrant-io RuntimeErrors (flush interrupting the
        buffered writer mid-write) are swallowed for the same reason."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            if self._jsonl is not None:
                self._jsonl.flush()
        except (ValueError, RuntimeError):
            pass
        finally:
            self._lock.release()

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


def open_process_stream(stream_dir, name: str, *,
                        anchor_interval_s: float = 30.0
                        ) -> Optional["Tracer"]:
    """The flight-recorder entry point every spawned process calls at
    startup: install the process tracer with an append-only JSONL stream
    at ``<stream_dir>/<name>.trace.jsonl``.

    The stream is crash-durable by construction — every event is one
    flushed line, so a SIGKILL loses at most the torn final line (which
    :func:`load_jsonl` skips, never half-parses) — and this helper adds
    the cooperative-death hardening on top: the stream is flushed on
    atexit and on SIGTERM (chaining any previously installed handler,
    e.g. the training supervisor's preemption checkpoint; when SIGTERM
    was at its default disposition the default is re-raised so the
    process still dies).

    Disabled (returns None) when ``HETU_OBS_STREAM`` is "0"/"false" —
    the switch a telemetry-off run ships to the processes it spawns."""
    if os.environ.get("HETU_OBS_STREAM", "1").lower() in ("0", "false"):
        return None
    from pathlib import Path
    path = Path(stream_dir) / f"{name}.trace.jsonl"
    # bounded in-memory retention: the stream on disk is the record; a
    # member up for days must not hold every span dict in RAM
    t = Tracer(jsonl_path=path, process_name=name,
               anchor_interval_s=anchor_interval_s, max_events=100_000)
    enable(tracer=t)
    import atexit
    atexit.register(t.flush)
    try:
        import signal as _signal
        prev = _signal.getsignal(_signal.SIGTERM)

        def _flush_and_chain(signum, frame):
            try:
                t.flush_from_signal()
            except Exception:
                pass
            if callable(prev) and prev not in (_signal.SIG_DFL,
                                               _signal.SIG_IGN):
                prev(signum, frame)
            elif prev != _signal.SIG_IGN:
                # SIG_DFL — or None (a handler installed by non-Python
                # code, unrepresentable here): restore the default and
                # re-raise so SIGTERM still KILLS the process; only an
                # explicit SIG_IGN disposition is preserved as-is
                _signal.signal(signum, _signal.SIG_DFL)
                _signal.raise_signal(signum)

        _signal.signal(_signal.SIGTERM, _flush_and_chain)
    except (ValueError, OSError):
        pass  # not the main thread: atexit + per-line flush still hold
    return t


def load_jsonl(path) -> list:
    """Read a trace JSONL stream back into event dicts (blank lines and
    trailing partial lines from a crash are skipped, not fatal)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn final line from a crashed writer
            if isinstance(ev, dict):  # a torn line that still parses
                out.append(ev)        # (e.g. a truncated number) is not
    return out                        # an event — dropped, never mangled
