"""Link emulation on the van wire: gray network failures, injectable
(counterpart of ``hetu_tpu/ps/netem.py``; its draws, byte for byte: one
seed replays the same drops and delays in both packages).

Every fault the chaos plane could inject before this module was binary —
a process dies (SIGKILL), freezes (SIGSTOP), or a single op raises once
(``van_error``).  Real multi-host networks fail GRAY: 200ms-jitter
links, 1% loss, a bandwidth cliff, and partitions that are one-way (A
hears B, B never hears A).  This module makes those injectable at the
same client-op seam the fault injector uses (:func:`hetu_tpu_torch.ps.
van.set_netem_hook`, firing right after the fault hook), seeded and
byte-replayable, addressable per (src, dst) LINK and per DIRECTION, and
schedulable over time like :class:`~hetu_tpu_torch.resilience.faults.
FaultSchedule` events.

Model
-----
The emulator lives in ONE process and shapes that process's half of
every van conversation.  Each client wire op is classified by the
direction its payload flows:

* **egress** — this process writes (``*_push``/``*_set``/``blob_put``):
  the frame travels ``local -> peer``;
* **ingress** — this process reads (``*_pull``/``*_get``/
  ``blob_get``): the data travels ``peer -> local``;
* everything else (ping, barrier, stats) needs BOTH directions up.

A :class:`LinkPolicy` on ``(local, peer)`` therefore shapes only this
process's sends, and one on ``(peer, local)`` only its reads — which is
exactly what makes ASYMMETRIC partitions expressible: partitioning
``(member, van)`` drops the member's heartbeat writes (the controller
sees silence) while the member still hears the control row, the "B
never hears A" half-failure a lease machine must survive without
grieving a live process.

Emulated effects per frame (drawn from a per-link seeded rng, in op
order — same seed + same op sequence replays byte-for-byte):

* ``partition`` / ``drop_p`` — the op raises :class:`NetemDrop` (a
  ``ConnectionError``: retry layers treat it exactly like a real
  transport failure);
* ``latency_s`` + uniform ``jitter_s`` — the op sleeps first;
* ``rate_mbps`` — serialization delay ``bytes / rate`` for ops whose
  payload size is known up front (sends; deliveries learn their size
  too late to charge honestly, so reads get latency/loss only);
* ``dup_p`` — the frame is "sent twice": one extra serialization charge
  (the van's blob seqs are idempotent and table writes last-write-win,
  so a duplicate's only real cost IS the wire time);
* ``reorder_p``/``reorder_s`` — the frame is "delivered late": an extra
  delay (the van's single-connection ops are order-preserving per
  channel, so reordering surfaces as added tail latency).

``duration_s`` auto-expires a policy (a partition that HEALS without
needing a second command to cross the very link it cut).
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

EGRESS = "egress"
INGRESS = "ingress"
BOTH = "both"

_EGRESS_MARKERS = ("push", "set", "put")
_INGRESS_MARKERS = ("pull", "get")


def op_directions(op: str) -> tuple:
    """Which way the op's payload flows: ``("egress",)``,
    ``("ingress",)``, or both for control ops (ping/barrier) that need
    a round trip either way."""
    name = op.rsplit(".", 1)[-1]
    if any(m in name for m in _EGRESS_MARKERS):
        return (EGRESS,)
    if any(m in name for m in _INGRESS_MARKERS):
        return (INGRESS,)
    return (EGRESS, INGRESS)


class NetemDrop(ConnectionError):
    """An emulated link dropped (or a partition black-holed) the frame.

    Subclasses ``ConnectionError`` so every retry layer in the repo
    (``control_rpc``, the supervisor's transient retry, blob resends)
    classifies it transient — the whole point is exercising those paths
    against loss they cannot tell from the real thing."""


@dataclass
class LinkPolicy:
    """Shaping for one direction of one link.  All fields optional;
    the zero policy is a transparent wire."""

    latency_s: float = 0.0      # fixed one-way delay per frame
    jitter_s: float = 0.0       # + uniform[0, jitter_s)
    drop_p: float = 0.0         # P(frame lost) -> NetemDrop
    dup_p: float = 0.0          # P(frame sent twice): 2x serialization
    reorder_p: float = 0.0      # P(frame delivered late)
    reorder_s: float = 0.0      # the lateness of a reordered frame
    rate_mbps: Optional[float] = None   # serialization: bytes/rate
    partition: bool = False     # 100% loss (one-way when set on one
    # direction only — the asymmetric case)
    duration_s: Optional[float] = None  # auto-heal after this long

    def to_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items()
                if v not in (0.0, None, False)}

    @classmethod
    def from_dict(cls, d: dict) -> "LinkPolicy":
        return cls(**d)

    def delay_for(self, nbytes: int, rng: np.random.Generator) -> float:
        d = self.latency_s
        if self.jitter_s:
            d += float(rng.uniform(0.0, self.jitter_s))
        if self.rate_mbps and nbytes:
            ser = nbytes / (self.rate_mbps * 125_000.0)
            d += ser
            if self.dup_p and float(rng.random()) < self.dup_p:
                d += ser  # the duplicate's retransmit cost
        elif self.dup_p:
            rng.random()  # keep the draw order byte-stable either way
        if self.reorder_p and float(rng.random()) < self.reorder_p:
            d += self.reorder_s
        return d


def link_key(src: str, dst: str) -> str:
    return f"{src}->{dst}"


class NetEm:
    """Per-link network emulator for THIS process's van traffic.

    ``local`` names this process's endpoint, ``peer`` the default
    remote (there is usually exactly one van server per deployment).
    Policies are addressed per directed link::

        em = NetEm(local="m0", seed=7)
        em.set_link(LinkPolicy(latency_s=0.05, jitter_s=0.2,
                               drop_p=0.01))              # both ways
        em.set_link(LinkPolicy(partition=True, duration_s=1.5),
                    direction="egress")                   # one-way:
        # m0's writes black-hole (the controller stops hearing m0)
        # while m0 still reads control — and the partition heals
        # itself after 1.5s.
        em.install()

    Replay contract: decisions are drawn from one seeded rng per
    directed link, in op order — a run with the same seed, policies,
    and op sequence makes byte-identical drop/delay decisions
    (:class:`~hetu_tpu_torch.resilience.faults.FaultSchedule`'s contract,
    extended to the gray-failure plane).

    ``stats`` counts per-link ``{dropped, delayed, delay_s}``; the same
    counters land in ``telemetry.default_registry`` as
    ``netem.<src>-><dst>.dropped`` / ``.delayed`` / ``.delay_s`` so a
    chaos run's trace and metrics agree on what the emulated network
    did.
    """

    def __init__(self, local: str = "local", peer: str = "van", *,
                 seed: int = 0):
        self.local = str(local)
        self.peer = str(peer)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._policies: dict = {}     # link key -> LinkPolicy
        self._rngs: dict = {}         # link key -> np rng (seeded)
        self._timers: list = []
        self.stats: dict = {}
        self._installed = False
        self._prev_hook = None

    # ---- policy management ----
    def _rng_for(self, key: str) -> np.random.Generator:
        rng = self._rngs.get(key)
        if rng is None:
            rng = np.random.default_rng(
                (self.seed << 32) ^ zlib.crc32(key.encode()))
            self._rngs[key] = rng
        return rng

    def set_link(self, policy: LinkPolicy, *, direction: str = BOTH,
                 src: Optional[str] = None,
                 dst: Optional[str] = None) -> None:
        """Install ``policy`` on the (src, dst) link.  With the default
        endpoints, ``direction="egress"`` is ``local->peer`` (shapes
        this process's writes), ``"ingress"`` is ``peer->local``
        (shapes its reads), ``"both"`` installs on both directed
        links.  A policy with ``duration_s`` arms a timer that clears
        it — the self-healing partition."""
        src = self.local if src is None else str(src)
        dst = self.peer if dst is None else str(dst)
        keys = []
        if direction in (EGRESS, BOTH):
            keys.append(link_key(src, dst))
        if direction in (INGRESS, BOTH):
            keys.append(link_key(dst, src))
        if not keys:
            raise ValueError(f"unknown direction {direction!r}")
        with self._lock:
            for k in keys:
                self._policies[k] = policy
                self._rng_for(k)
        if policy.duration_s:
            t = threading.Timer(policy.duration_s, self._expire,
                                args=(keys, policy))
            t.daemon = True
            t.start()
            self._timers.append(t)

    def _expire(self, keys, policy) -> None:
        with self._lock:
            for k in keys:
                if self._policies.get(k) is policy:
                    del self._policies[k]

    def clear_link(self, *, direction: str = BOTH,
                   src: Optional[str] = None,
                   dst: Optional[str] = None) -> None:
        src = self.local if src is None else str(src)
        dst = self.peer if dst is None else str(dst)
        with self._lock:
            if direction in (EGRESS, BOTH):
                self._policies.pop(link_key(src, dst), None)
            if direction in (INGRESS, BOTH):
                self._policies.pop(link_key(dst, src), None)

    def clear(self) -> None:
        with self._lock:
            self._policies.clear()

    def policy_for(self, direction: str) -> Optional[LinkPolicy]:
        key = link_key(self.local, self.peer) if direction == EGRESS \
            else link_key(self.peer, self.local)
        with self._lock:
            return self._policies.get(key)

    def current_rate_mbps(self) -> Optional[float]:
        """The tightest bandwidth cap currently installed on the
        default link, either direction — the netem-visible rate the
        auto drain codec (:func:`hetu_tpu_torch.serve.migrate.pick_codec`)
        consults before falling back to op-span-derived measurement."""
        rates = [p.rate_mbps for p in (self.policy_for(EGRESS),
                                       self.policy_for(INGRESS))
                 if p is not None and p.rate_mbps]
        return min(rates) if rates else None

    # ---- the hook ----
    def _stat(self, key: str) -> dict:
        st = self.stats.get(key)
        if st is None:
            st = self.stats[key] = {"dropped": 0, "delayed": 0,
                                    "delay_s": 0.0}
        return st

    def hook(self, op: str, nbytes: int) -> None:
        prev = self._prev_hook
        if prev is not None:
            prev(op, nbytes)
        dirs = op_directions(op)
        delay = 0.0
        with self._lock:
            for d in dirs:
                key = link_key(self.local, self.peer) if d == EGRESS \
                    else link_key(self.peer, self.local)
                pol = self._policies.get(key)
                if pol is None:
                    continue
                rng = self._rng_for(key)
                st = self._stat(key)
                if pol.partition or (
                        pol.drop_p and float(rng.random()) < pol.drop_p):
                    st["dropped"] += 1
                    self._reg_inc(key, "dropped")
                    raise NetemDrop(
                        f"netem: link {key} "
                        f"{'partitioned' if pol.partition else 'dropped'} "
                        f"{op}")
                d_s = pol.delay_for(
                    nbytes if d == EGRESS else 0, rng)
                if d_s > 0:
                    st["delayed"] += 1
                    st["delay_s"] += d_s
                    delay += d_s
        if delay > 0:
            self._reg_inc("total", "delay_ms", int(delay * 1e3))
            time.sleep(delay)

    @staticmethod
    def _reg_inc(key: str, which: str, n: int = 1) -> None:
        from hetu_tpu_torch.telemetry import default_registry as reg
        reg.counter(f"netem.{key}.{which}").inc(n)

    # ---- lifecycle ----
    def install(self) -> "NetEm":
        from hetu_tpu_torch.ps import van
        if not self._installed:
            self._prev_hook = van.set_netem_hook(self.hook)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            from hetu_tpu_torch.ps import van
            van.set_netem_hook(self._prev_hook)
            self._prev_hook = None
            self._installed = False
        for t in self._timers:
            t.cancel()
        self._timers.clear()


# ---------------------------------------------------------------------------
# time-scheduled link events (the FaultSchedule of the gray plane)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, order=True)
class NetemEvent:
    """At ``t_s`` (seconds after :meth:`NetemSchedule.start`), install
    ``policy`` on the link — or clear it when ``policy`` is None."""

    t_s: float
    direction: str = BOTH
    policy: Optional[dict] = field(default=None, compare=False)


class NetemSchedule:
    """A time-ordered list of link events, JSON-serializable so it can
    ride a member/worker process's spawn config — the cross-process
    analog of handing a :class:`FaultSchedule` to the injector.

    ``start(em)`` arms daemon timers against an ABSOLUTE epoch
    (``t0_unix``, defaulting to now): two processes given the same
    schedule + epoch apply each event at the same wall moment, which is
    what lets the controller's fault instants and a member's applied
    policies line up in one timeline."""

    def __init__(self, events, *, t0_unix: Optional[float] = None):
        self.events = sorted(events)
        self.t0_unix = t0_unix

    def to_json(self) -> str:
        return json.dumps(
            {"t0_unix": self.t0_unix,
             "events": [[e.t_s, e.direction, e.policy]
                        for e in self.events]},
            separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "NetemSchedule":
        d = json.loads(s)
        return cls([NetemEvent(float(t), str(dr), p)
                    for t, dr, p in d["events"]],
                   t0_unix=d.get("t0_unix"))

    def start(self, em: NetEm) -> list:
        """Arm one daemon timer per event; returns the timers."""
        t0 = self.t0_unix if self.t0_unix is not None else time.time()
        timers = []
        for ev in self.events:

            def fire(ev=ev):
                if ev.policy is None:
                    em.clear_link(direction=ev.direction)
                else:
                    em.set_link(LinkPolicy.from_dict(ev.policy),
                                direction=ev.direction)

            delay = max(t0 + ev.t_s - time.time(), 0.0)
            t = threading.Timer(delay, fire)
            t.daemon = True
            t.start()
            timers.append(t)
        em._timers.extend(timers)
        return timers
