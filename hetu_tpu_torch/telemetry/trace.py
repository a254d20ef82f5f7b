"""Span tracer: nestable spans and instant events.

A copy of the part of ``hetu_tpu/telemetry/trace.py`` that serving and
the van use (pure Python): the engine records ``serve.prefill`` /
``serve.decode`` spans and ``serve.recompile`` instants, the scheduler
``serve.step`` spans and ``serve.shed`` / ``serve.preempt`` instants, the
van's client ``van.<op>`` spans (through :func:`now_us` and
:func:`complete`).  The per-process JSONL
streams, clock anchors and signal hardening wait for the fleet planes.

Events are recorded on a monotonic clock (``time.perf_counter_ns``),
thread-safely.  The spans are host-side: a span that must cover device
work ends after a synchronising read (the engine's token fetch).

Disabled-path contract: module-level :func:`span` and :func:`instant`
check ONE module global; when tracing is off, ``span()`` returns a
preallocated no-op context manager and ``instant()`` returns at once.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

_tracer: Optional["Tracer"] = None  # None = tracing disabled


class _NullSpan:
    """Singleton no-op span: ``.set`` swallows attribute writes."""

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


def enable(*, tracer: Optional["Tracer"] = None) -> "Tracer":
    """Install (and return) the process tracer."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def disable() -> Optional["Tracer"]:
    """Uninstall the process tracer and return it (its events stay
    readable)."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def span(name: str, attrs: Optional[dict] = None, cat: str = "hetu"):
    """Context manager timing a phase."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, attrs, cat)


def instant(name: str, attrs: Optional[dict] = None, cat: str = "hetu") -> None:
    """A zero-duration marker (recompile, shed, preempt)."""
    t = _tracer
    if t is None:
        return
    t.instant(name, attrs, cat)


def now_us() -> float:
    """The tracer's clock, for a span recorded afterwards by
    :func:`complete`; 0.0 when tracing is off (``complete`` then records
    nothing)."""
    t = _tracer
    if t is None:
        return 0.0
    return t._now_us()


def complete(name: str, start_us: float, attrs: Optional[dict] = None,
             cat: str = "hetu") -> None:
    """Record a span that started at ``start_us`` (from :func:`now_us`)
    and ends now: for a phase worth recording only once its outcome is
    known (a van call that did not fail)."""
    t = _tracer
    if t is None:
        return
    t.complete(name, start_us, attrs, cat)


class _Span:
    __slots__ = ("_tracer", "name", "cat", "attrs", "_start")

    def __init__(self, tracer, name, attrs, cat):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, key, value):
        """Attach an attribute discovered mid-span."""
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
    """Thread-safe event recorder; events are Chrome trace-event dicts."""

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list = []
        self.pid = os.getpid()
        self._t0 = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1000.0

    def _record(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def span(self, name, attrs=None, cat="hetu") -> _Span:
        return _Span(self, name, attrs, cat)

    def instant(self, name, attrs=None, cat="hetu") -> None:
        self._record({"ph": "i", "name": name, "cat": cat,
                      "ts": self._now_us(), "pid": self.pid,
                      "tid": threading.get_ident(), "s": "t",
                      "args": dict(attrs) if attrs else {}})

    def complete(self, name, start_us, attrs=None, cat="hetu") -> None:
        """Record a span that started at ``start_us`` and ends now."""
        end = self._now_us()
        self._record({"ph": "X", "name": name, "cat": cat,
                      "ts": float(start_us),
                      "dur": max(end - float(start_us), 0.0),
                      "pid": self.pid, "tid": threading.get_ident(),
                      "args": dict(attrs) if attrs else {}})
