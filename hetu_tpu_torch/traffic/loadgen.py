"""Seeded open-loop workload synthesis + replay (counterpart of
``hetu_tpu/traffic/loadgen.py``; numpy only, no torch).

Serving benchmarks that generate load closed-loop (issue, wait, issue)
measure the SERVER's pace, not the users': under overload a closed loop
self-throttles and the latency cliff disappears from the numbers.  This
module synthesizes an OPEN-LOOP arrival trace offline — every request
has a wall-clock arrival time fixed before the first one is sent — and
replays it against a pool at those times regardless of how the pool is
doing, which is the only way p99-under-overload means anything.

Synthesis is deterministic from the spec's seed (``np.random.
default_rng((seed, salt))`` streams, one salt per concern, the
reference's salts), and the trace serializes to CANONICAL JSON (sorted
keys, fixed separators, floats rounded to fixed precision), so the same
spec produces the same bytes on every run and in both packages.

Workload shape, per tenant:

* **diurnal rate curve** — a raised-cosine multiplier sweeping
  1 → ``peak_x`` → 1 over each period (:func:`diurnal_multiplier`);
* **bursty arrivals** — a two-state (calm/burst) modulated Poisson
  process, sampled by THINNING: arrivals drawn at the tenant's peak
  rate, each kept with probability rate(t)/peak — exact for an
  inhomogeneous Poisson process, and O(events);
* **Zipfian popularity** — prompts drawn from a finite catalog with
  rank-``r`` probability ∝ 1/r^s (CTR tenants reuse the ranks for their
  sparse keys);
* **deadlines** — per-tenant uniform [lo, hi], riding each event as
  ``deadline_s`` (the pool's ``timeout_s``, and the shed admission
  signal).

Replay (:func:`replay`) walks events in arrival order against an
injectable clock/sleep pair.  The submit callable comes from
:func:`llm_submitter` / :func:`ctr_submitter` (or anything with the same
``(event) -> handle`` shape).

Departure from the reference: :func:`prompt_catalog` gives the catalog
:func:`synthesize` draws from (a reference computes every event's stream
from it).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

import numpy as np

TRACE_VERSION = 1

# canonical-JSON float precision: microseconds for times, and more than
# enough for rates — fixed rounding is what makes the bytes stable
_ROUND = 6


@dataclass
class TenantSpec:
    """One tenant's traffic personality."""

    name: str
    # fraction of the trace's base_qps this tenant contributes at
    # multiplier 1 (shares need not sum to 1 — they are absolute
    # per-tenant rates, base_qps * share)
    share: float = 1.0
    # SLO class name (serve/scheduler.py slo_classes); None = best-effort
    slo: Optional[str] = None
    # per-request deadline drawn uniform from [lo, hi] seconds
    deadline_lo_s: float = 2.0
    deadline_hi_s: float = 6.0
    # two-state burst modulation: in the burst state the tenant's rate
    # multiplies by burst_x; state dwell times are exponential with
    # these means (burst_on_s=0 disables bursts)
    burst_x: float = 1.0
    burst_on_s: float = 0.0
    burst_off_s: float = 10.0
    # workload kind: "llm" (prompt + max_tokens) or "ctr" (dense+sparse)
    kind: str = "llm"
    max_tokens: int = 8


@dataclass
class TraceSpec:
    """Everything :func:`synthesize` needs — same spec, same bytes."""

    seed: int = 0
    duration_s: float = 10.0
    base_qps: float = 4.0
    tenants: list = field(default_factory=list)   # [TenantSpec]
    # diurnal curve: rate multiplier sweeps 1 -> peak_x -> 1 per period
    # (period defaults to the whole duration: one spike per trace)
    diurnal_peak_x: float = 1.0
    diurnal_period_s: Optional[float] = None
    # prompt/key catalog (Zipf popularity): n_prompts distinct prompts
    # of length [2, max_prompt_len] over [1, vocab); zipf_s is the
    # exponent (larger = more skew).  CTR tenants reuse the same ranks
    # for their sparse keys.
    vocab: int = 89
    n_prompts: int = 64
    max_prompt_len: int = 6
    zipf_s: float = 1.1
    # CTR payload geometry
    dense_dim: int = 8
    fields: int = 4
    key_space: int = 64


def diurnal_multiplier(t: float, *, peak_x: float,
                       period_s: float) -> float:
    """Raised-cosine rate multiplier: 1 at each period edge, ``peak_x``
    mid-period — the smooth single-peak "day" every diurnal knob in
    this module means."""
    if peak_x <= 1.0 or period_s <= 0:
        return 1.0
    phase = (t % period_s) / period_s
    return 1.0 + (peak_x - 1.0) * 0.5 * (1.0 - float(np.cos(
        2.0 * np.pi * phase)))


def _zipf_probs(n: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = 1.0 / ranks ** float(s)
    return p / p.sum()


def _burst_windows(rng, spec: TenantSpec, duration_s: float) -> list:
    """[(start, end)] burst intervals from the two-state dwell chain."""
    if spec.burst_x <= 1.0 or spec.burst_on_s <= 0:
        return []
    out, t, calm = [], 0.0, True
    while t < duration_s:
        dwell = float(rng.exponential(
            spec.burst_off_s if calm else spec.burst_on_s))
        if not calm:
            out.append((t, min(t + dwell, duration_s)))
        t += dwell
        calm = not calm
    return out


def _in_burst(t: float, windows: list) -> bool:
    return any(a <= t < b for a, b in windows)


def prompt_catalog(spec: TraceSpec) -> list:
    """The spec's prompt catalog, rank order: every LLM event's prompt is
    one of these.  The shared stream (salt 0xCA7A) makes hot ranks
    repeat across tenants, which is exactly the prefix-cache skew."""
    cat_rng = np.random.default_rng((int(spec.seed), 0xCA7A))
    catalog = []
    for _ in range(int(spec.n_prompts)):
        k = int(cat_rng.integers(2, max(int(spec.max_prompt_len), 3)))
        catalog.append([int(x) for x in
                        cat_rng.integers(1, int(spec.vocab), size=k)])
    return catalog


def synthesize(spec: TraceSpec) -> dict:
    """Spec → trace dict (``{"version", "spec", "events"}``), events in
    arrival order.  Deterministic: one seeded rng stream per (tenant,
    concern) salt, so adding a tenant never perturbs another's stream."""
    tenants = [t if isinstance(t, TenantSpec) else TenantSpec(**t)
               for t in spec.tenants] or [TenantSpec(name="default")]
    period = float(spec.diurnal_period_s or spec.duration_s)
    probs = _zipf_probs(spec.n_prompts, spec.zipf_s)
    catalog = prompt_catalog(spec)
    events = []
    for ti, ten in enumerate(tenants):
        arr_rng = np.random.default_rng((int(spec.seed), 0xA221, ti))
        pay_rng = np.random.default_rng((int(spec.seed), 0xF00D, ti))
        windows = _burst_windows(
            np.random.default_rng((int(spec.seed), 0xB125, ti)),
            ten, spec.duration_s)
        lam_base = float(spec.base_qps) * float(ten.share)
        lam_max = lam_base * max(float(spec.diurnal_peak_x), 1.0) \
            * max(float(ten.burst_x), 1.0)
        if lam_max <= 0:
            continue
        t = 0.0
        while True:
            # thinning: homogeneous arrivals at lam_max, kept with
            # probability rate(t)/lam_max — exact inhomogeneous Poisson
            t += float(arr_rng.exponential(1.0 / lam_max))
            if t >= spec.duration_s:
                break
            rate = lam_base * diurnal_multiplier(
                t, peak_x=float(spec.diurnal_peak_x), period_s=period)
            if _in_burst(t, windows):
                rate *= float(ten.burst_x)
            if float(arr_rng.random()) * lam_max > rate:
                continue
            deadline = float(pay_rng.uniform(ten.deadline_lo_s,
                                             ten.deadline_hi_s))
            ev = {"t": round(t, _ROUND), "tenant": ten.name,
                  "slo": ten.slo, "kind": ten.kind,
                  "deadline_s": round(deadline, _ROUND)}
            if ten.kind == "ctr":
                # sparse keys share the Zipf ranks (hot embedding rows)
                ranks = pay_rng.choice(len(probs), size=int(spec.fields),
                                       p=probs)
                ev["sparse"] = [int(r) % int(spec.key_space)
                                for r in ranks]
                ev["dense"] = [round(float(x), _ROUND) for x in
                               pay_rng.standard_normal(int(spec.dense_dim))]
            else:
                rank = int(pay_rng.choice(len(probs), p=probs))
                ev["prompt"] = list(catalog[rank])
                ev["max_tokens"] = int(ten.max_tokens)
            events.append(ev)
    events.sort(key=lambda e: (e["t"], e["tenant"]))
    return {"version": TRACE_VERSION,
            "spec": {**asdict(spec),
                     "tenants": [asdict(t) for t in tenants]},
            "events": events}


# ---------------------------------------------------------------------------
# canonical JSON (byte-stable save/load)
# ---------------------------------------------------------------------------

def dumps_trace(trace: dict) -> str:
    """Canonical serialization: sorted keys, no whitespace — the SAME
    trace object always produces the SAME bytes, so recorded traces
    diff cleanly and replay byte-identically."""
    return json.dumps(trace, sort_keys=True, separators=(",", ":"))


def save_trace(trace: dict, path) -> None:
    with open(path, "w") as f:
        f.write(dumps_trace(trace))


def load_trace(path) -> dict:
    with open(path) as f:
        trace = json.load(f)
    if int(trace.get("version", -1)) != TRACE_VERSION:
        raise ValueError(f"trace version {trace.get('version')!r}; "
                         f"this loadgen speaks {TRACE_VERSION}")
    return trace


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def llm_submitter(pool) -> Callable:
    """Event → non-blocking submit against an LLM pool
    (:class:`~hetu_tpu_torch.serve.crosshost.CrossProcessServingPool`
    or anything with its ``submit`` keyword surface).  Returns the
    pool's request handle."""
    def _submit(ev: dict):
        return pool.submit(ev["prompt"],
                           max_tokens=int(ev.get("max_tokens", 8)),
                           timeout_s=float(ev["deadline_s"]),
                           tenant=ev.get("tenant"), slo=ev.get("slo"))
    return _submit


def ctr_submitter(rpool) -> Callable:
    """Event → non-blocking submit against a
    :class:`~hetu_tpu_torch.serve.recsys.RecsysPool` (delegated
    ``submit(RecsysRequest)``); the handle's ``done`` event resolves
    like the LLM pool's."""
    def _submit(ev: dict):
        from hetu_tpu_torch.serve.recsys import RecsysRequest
        req = RecsysRequest(
            dense=np.asarray(ev["dense"], np.float32),
            sparse=np.asarray(ev["sparse"], np.int64),
            timeout_s=float(ev["deadline_s"]))
        rpool.submit(req)
        return req
    return _submit


def replay(trace: dict, submit: Callable, *,
           speed: float = 1.0,
           clock: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep,
           on_submit: Optional[Callable] = None) -> list:
    """Open-loop replay: issue every event at its recorded arrival time
    (scaled by ``speed``: 2.0 replays twice as fast) REGARDLESS of how
    the pool is keeping up — the property that makes overload visible.

    Pacing is absolute (each event sleeps until ``t0 + t/speed``), so
    a slow submit call delays later events' issue times but never
    compresses the schedule drift-free case.  Returns
    ``[(event, handle)]``; a submit that raises records ``(event,
    exc)`` and the replay continues — one rejected request must not
    silence the rest of the trace.  ``clock``/``sleep`` are injectable
    for deterministic tests."""
    speed = float(speed)
    if speed <= 0:
        raise ValueError("speed must be positive")
    out = []
    t0 = clock()
    for ev in trace["events"]:
        due = t0 + float(ev["t"]) / speed
        delay = due - clock()
        if delay > 0:
            sleep(delay)
        try:
            handle = submit(ev)
        except Exception as e:  # the trace outranks any one submit
            handle = e
        out.append((ev, handle))
        if on_submit is not None:
            on_submit(ev, handle)
    return out
