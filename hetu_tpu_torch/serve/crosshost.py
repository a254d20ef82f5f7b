"""Cross-process serving pool: members are real OS processes
(counterpart of ``hetu_tpu/serve/crosshost.py``).

The in-process :class:`~hetu_tpu_torch.serve.pool.ServingPool` proves the
HA machinery (health routing, live KV drain, fold re-prefill failover),
but its members share one Python process.  Here each member is a
SEPARATE process running a listener-less
:class:`~hetu_tpu_torch.serve.server.InferenceServer` (engine loop and
requeue machinery, ``own_van=False``) on its own device context, attached
to the controller's van, and the control plane crosses the wire:

* **membership** — members join and heartbeat through the van blackboard
  (:mod:`hetu_tpu_torch.ps.membership`); the controller's lease state
  machine (alive → suspect → lost) replaces in-process health polling.
  A SIGSTOPped member goes *suspect* (unroutable, state presumed intact)
  and CLEARS when its beats resume — never double-counted as a loss plus
  a rejoin;
* **requests** — the controller routes each accepted request to the
  least-loaded alive member over a per-process submit channel and
  resolves it from the member's completion events; member death
  (SIGKILL → lease expiry) re-routes every outstanding request to a
  survivor, which re-prefills from the original prompt — greedy decode
  regenerates exactly the tokens the dead member would have produced;
* **drain** — a planned preemption ships the member's live KV slots AND
  its in-flight request records to a peer process over the chunked-CRC
  migrate wire (:func:`hetu_tpu_torch.serve.migrate.export_payload` /
  :func:`~hetu_tpu_torch.serve.migrate.adopt_payload`), two-phase: the
  source holds its export until the target confirms adoption, so a
  failed transfer rolls back to a still-serving source.  The adopter
  continues mid-decode sequences token for token with zero re-prefill.

Channel topology on the ONE shared van: each member process gets a fresh
(submit, event) blob-channel pair allocated by the controller (never
reused across member incarnations), migration transfers draw ids from
their own base (disjoint from the in-process pool's
``MIGRATE_CHANNEL_BASE``), and the membership blackboard is a small f32
table.  Recovery spans mirror the in-process pool (``serve.migrate`` /
``serve.failover``) plus the retroactive ``serve.member_suspect`` for a
partition that healed.

**Controller death is just another fault kind.**  The controller holds a
lease of its own (the blackboard's controller row — incarnation fence +
beat), journals every piece of RAM-only state (rid→member ownership,
retry budgets, half-open drains, per-slot channel bases) to a
:class:`~hetu_tpu_torch.ps.membership.DeltaLedger` on the van, and keys
every command channel by its incarnation.  A new incarnation
(:meth:`CrossProcessServingPool.takeover`) claims the fence, reads
blackboard + ledger, re-adopts the still-serving member processes,
aborts half-open drains back to a serving source and resolves every
accepted request; a fenced zombie's writes are refused member-side.
This needs the van to outlive the controller: run it as its own process
(``resilience/shardproc.spawn_shard_server``) and build the pool with
``own_van=False``.

**Van death too.**  With ``van_spec`` (a
:class:`~hetu_tpu_torch.ps.replica.ReplicaSpec` dict naming a primary and
a backup van) the blackboard and the ledger dual-write synchronously to
both vans, every blob channel binds the replica's CURRENT primary, and a
SIGKILLed primary costs a promotion (one CAS on the survivor's epoch
row), a channel rebind on both sides and a re-send of every unresolved
submit (members dedup by rid); ``van_backup_factory`` then re-silvers a
fresh backup so the pair survives the next fault as well.

Departures from the reference:

* a member's weights are drawn from the spec's seed with numpy in the
  reference's initialisers (:func:`build_engine`), not by
  ``jax.random``: one spec gives the same weights in every process of
  the port, other weights than the reference's members serve;
* the member HOLD (``"hold_at"`` in the model spec, and the ``hold`` /
  ``release`` commands): a member's engine parks at the start of a
  decode round and reports it, so that a drain, a kill or a signal lands
  mid-decode at a chosen round instead of after a sleep; a drain or an
  adoption that waits for the held member's scheduler lock lets it go;
* members publish their flash-forward launch count, prefill count, peak
  device memory and whether ``jax`` is loaded in their metrics;
* the pool counts the submits it re-sends after a van failover
  (``van_rebind_resent``), and ``controller_main``'s READY line says
  whether the process loaded ``jax``;
* ``controller_main``'s ``autoscale`` drives
  :class:`~hetu_tpu_torch.traffic.autoscale.Autoscaler` as the
  reference's does; the pool journals its state (``journal_autoscaler``,
  ``'s'`` ledger records) and a takeover hands it to a successor loop
  (``autoscaler_state``).
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import sys
import signal as _signal
import threading
import time
import traceback
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from hetu_tpu_torch.ps import membership as _mb
from hetu_tpu_torch.serve import migrate as _migrate
from hetu_tpu_torch.serve.metrics import ServeMetrics
from hetu_tpu_torch.serve.pool import _MIG_SEQ
from hetu_tpu_torch.telemetry import trace

# controller-allocated control channels ('CHCT'); migration transfers get
# their own base ('MIG3'), disjoint from serve/pool.py's in-process base
# so a mixed deployment sharing one van cannot cross streams
CONTROL_CHANNEL_BASE = 0x43484354
CROSSHOST_MIGRATE_BASE = 0x4D494733

_xfer_ids = itertools.count(1)

# control channels are keyed by CONTROLLER incarnation: blob seqs are
# per-channel and a takeover cannot know the dead controller's
# positions, so each incarnation binds fresh channels — and a fenced
# zombie keeps writing to channels nobody reads
CTRL_CHAN_STRIDE = 1 << 20


def _fenced_chan(base: int, ctrl_inc: int) -> int:
    return int(base) + int(ctrl_inc) * CTRL_CHAN_STRIDE


def _dbg(msg: str) -> None:
    if os.environ.get("HETU_DEBUG_FLEET"):
        print(f"[member pid={os.getpid()} t={time.monotonic():.3f}] {msg}",
              file=sys.stderr, flush=True)


def _fleet_event(name: str, rec: dict) -> None:
    """Structured fleet forensics: one instant on the process span
    stream (``membership.event`` / ``route.park`` / ``route.send_fail``
    — the fleet doctor and ``fleet_report.py`` read these), with the
    old ``HETU_DEBUG_FLEET`` stderr dump kept as a FORMATTER over the
    same record — the env var now picks a sink, it no longer decides
    whether the evidence exists."""
    trace.instant(name, rec, cat="fleet")
    if os.environ.get("HETU_DEBUG_FLEET"):
        kv = " ".join(f"{k}={v}" for k, v in rec.items())
        print(f"[fleet] {time.monotonic():.2f} {name} {kv}",
              file=sys.stderr, flush=True)


def seeded_prompts(n: int, seed: int = 0, *, vocab: int = 89,
                   max_len: int = 6) -> list:
    """Deterministic prompt set shared by the controller harness, the
    chaos tests and ``chip_smoke.py`` — same (n, seed) → same
    prompts in every process, so token-exactness is checkable across a
    controller death without shipping the prompts anywhere."""
    rng = np.random.default_rng((int(seed), 0xC7A0))
    out = []
    for _ in range(int(n)):
        k = int(rng.integers(2, max(int(max_len), 3)))
        out.append([int(t) for t in rng.integers(1, int(vocab), size=k)])
    return out


@dataclass
class MemberSpec:
    """Everything a member process needs to build its engine and find
    the control plane — JSON-serialized into the spawn config so the
    member re-derives the SAME model weights (deterministic seeded
    init) the controller and its peers hold."""

    port: int
    slot: int
    n_slots: int
    submit_ch: int
    event_ch: int
    membership_table: int = _mb.SERVE_MEMBERSHIP_TABLE
    hb_ms: int = 100
    request_timeout_s: float = 60.0
    max_loop_errors: int = 2
    failover_grace_s: float = 5.0
    model: dict = field(default_factory=dict)
    # overload shedding in the member's scheduler (serve/scheduler.py):
    # deadline-doomed submits resolve 'shed' instantly instead of
    # queueing into collapse
    shed: bool = False
    shed_headroom: float = 1.0
    # per-tenant SLO classes forwarded into the member scheduler
    # (serve/scheduler.py): {name: {"priority": int, "weight": float,
    # "ttft_slo_s": float|None}} — empty keeps pure FIFO admission
    slo_classes: dict = field(default_factory=dict)
    # netem link emulation applied at process start: {"seed": int,
    # "links": [[direction, policy_dict], ...]} — the static half; the
    # dynamic half arrives over the wire as a "netem" command
    netem: dict = field(default_factory=dict)
    # the controller-ledger table id, recorded here so a TAKEOVER can
    # find every durable control-plane id from any member's spawn
    # config on disk; members themselves never read the ledger.  The
    # ROW COUNT is geometry, not just capacity: DeltaLedger derives
    # base/delta region boundaries from it, so a takeover reading with
    # a different rows value would misparse the delta region — it must
    # ride the spawn config like the id does
    ledger_table: int = 0
    ledger_rows: int = 2048
    # fleet observability: non-empty = the member opens a crash-durable
    # span/metric stream (<trace_dir>/member_sN_pPID.trace.jsonl) at
    # startup — the flight recorder a SIGKILL cannot erase.  scrape_s
    # is recorded so a controller TAKEOVER restores the pool's scrape
    # cadence, not the constructor default
    trace_dir: str = ""
    scrape_s: float = 1.0
    # replicated durable tier: a ReplicaSpec dict ({"endpoints":
    # [[h,p],[h,p]], "epoch_table": id, ...}) — non-empty means the
    # member's blackboard/channel wire runs over the primary+backup van
    # pair and re-resolves to the promoted endpoint on primary death.
    # Recorded in the spawn config like every other durable id, so a
    # controller takeover finds the SAME pair.
    van: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "MemberSpec":
        return cls(**json.loads(s))


DEFAULT_MODEL = {
    "vocab_size": 97, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
    "ffn_size": 128, "max_position": 64, "seed": 0,
    "num_slots": 4, "max_len": 48, "min_bucket": 8,
    # the port's keys: where the member runs, its compute type, its
    # attention path (flash: the CUDA kernel on the card, its plain
    # version on the CPU), and the decode round its engine first parks at
    # (None: no hold)
    "device": "cuda", "dtype": "float32", "attention_impl": "flash",
    "hold_at": None,
}

_DTYPES = {"float32": "float32", "bfloat16": "bfloat16", "f32": "float32",
           "bf16": "bfloat16"}


def gpt_params(cfg, seed: int) -> dict:
    """GPT parameters in the reference's layout and with its
    initialisers, drawn with numpy from ``seed``: normal(0.02)
    embeddings, Xavier-uniform attention and FFN weights (``[in, out]``,
    stacked ``[L, ...]``), zero biases, unit LayerNorm scales.  Same
    (config, seed) → the same arrays in every process."""
    g = np.random.default_rng(int(seed))
    h, f, n = cfg.hidden_size, cfg.ffn_size, cfg.num_layers

    def normal(*shape):
        return 0.02 * g.standard_normal(shape, dtype=np.float32)

    def xavier(*shape):  # (L, in, out)
        lim = np.float32(np.sqrt(6.0 / (shape[-2] + shape[-1])))
        return (g.random(shape, dtype=np.float32) * 2 - 1) * lim

    def z(*shape):
        return np.zeros(shape, np.float32)

    def o(*shape):
        return np.ones(shape, np.float32)

    return {
        "tok_emb": normal(cfg.vocab_size, h),
        "pos_emb": normal(cfg.max_position, h),
        "blocks": {
            "attn": {"qkv_weight": xavier(n, h, 3 * h),
                     "qkv_bias": z(n, 3 * h),
                     "out_weight": xavier(n, h, h), "out_bias": z(n, h)},
            "ln1": {"scale": o(n, h), "bias": z(n, h)},
            "ffn_in": {"weight": xavier(n, h, f), "bias": z(n, f)},
            "ffn_out": {"weight": xavier(n, f, h), "bias": z(n, h)},
            "ln2": {"scale": o(n, h), "bias": z(n, h)},
        },
        "ln_f_scale": o(h), "ln_f_bias": z(h),
    }


def build_engine(model_spec: dict, *, device=None):
    """Deterministic engine construction shared by member processes and
    in-test reference engines: same spec → same weights everywhere, the
    property that makes cross-process failover token-exact.  Returns
    ``(model, variables, engine)``: the port's model, the parameters in
    the reference's layout (``{"params": tree, "state": {}}``, numpy),
    and the engine on ``device`` (default: the spec's ``"device"``).

    ``{"engine": "paged"}`` in the spec builds a
    :class:`~hetu_tpu_torch.serve.engine.PagedServeEngine` (page size via
    ``"page_size"``, pool size via ``"num_pages"``) instead of the slot
    engine — same weights, same wire."""
    import torch

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTModel
    from hetu_tpu_torch.serve.engine import PagedServeEngine, ServeEngine
    spec = {**DEFAULT_MODEL, **(model_spec or {})}
    device = spec["device"] if device is None else device
    cfg = GPTConfig(
        vocab_size=int(spec["vocab_size"]),
        hidden_size=int(spec["hidden_size"]),
        num_layers=int(spec["num_layers"]),
        num_heads=int(spec["num_heads"]),
        ffn_size=int(spec["ffn_size"]),
        max_position=int(spec["max_position"]), dropout_rate=0.0,
        dtype=getattr(torch, _DTYPES[str(spec["dtype"])]),
        attention_impl=str(spec["attention_impl"]))
    tree = gpt_params(cfg, int(spec["seed"]))
    # built on the CPU and loaded from the host draw; the engine moves
    # its serving copy to the device
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(interop.params_from_jax(tree, cfg))
    variables = {"params": tree, "state": {}}
    if spec.get("engine") == "paged":
        num_pages = spec.get("num_pages")
        return model, variables, PagedServeEngine(
            model, num_slots=int(spec["num_slots"]),
            max_len=int(spec["max_len"]),
            page_size=int(spec.get("page_size", 8)),
            num_pages=None if num_pages is None else int(num_pages),
            min_bucket=int(spec["min_bucket"]), device=device)
    return model, variables, ServeEngine(
        model, num_slots=int(spec["num_slots"]),
        max_len=int(spec["max_len"]), min_bucket=int(spec["min_bucket"]),
        device=device)


class _MemberEngine:
    """The member's view of its engine: every verb passes through; it
    counts prefills (``prefills`` in the engine's metrics) and decode
    rounds, and implements the HOLD.

    Armed (:meth:`hold`, or the spec's ``hold_at``), the engine parks at
    the start of a decode round and reports it once (``on_hold``, with the
    hold's id).  A control call that waits for the scheduler lock
    (``waiting()``) lets the parked round go and takes the lock right
    after it (a submit, whose request the next round's step admits, a
    drain's export, an adoption); the hold parks again at the next round
    until :meth:`unhold` ends it, as the harness does once a drain or an
    adoption is done.  A new :meth:`hold` lets a parked round go and parks
    again ``after`` rounds on."""

    def __init__(self, inner, *, hold_at=None):
        self.inner = inner
        self.decodes = 0
        self.hold_at = None if hold_at is None else int(hold_at)
        self.hold_id = 0
        self.on_hold = None   # callable(round, id) set by the harness
        self.waiting = None   # callable() -> bool set by the harness
        self._reported = False
        self._closed = False
        if hasattr(inner, "begin_prefill"):
            # a paged engine (the scheduler tells the two apart by this
            # verb): its prefills start here
            def begin_prefill(*args, **kw):
                inner.metrics.inc("prefills")
                return inner.begin_prefill(*args, **kw)
            self.begin_prefill = begin_prefill

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def hold(self, after: int = 0, hold_id: int = 0) -> None:
        """Park ``after`` decode rounds from now (0: the next round, or
        the round parked now)."""
        self._reported = False
        self.hold_id = int(hold_id)
        self.hold_at = self.decodes + int(after)

    def unhold(self) -> None:
        """End the hold and let a parked round go."""
        self.hold_at = None

    def close(self) -> None:
        self._closed = True
        self.unhold()

    def prefill(self, slot, prompt):
        self.inner.metrics.inc("prefills")
        return self.inner.prefill(slot, prompt)

    def _parked(self) -> bool:
        return (self.hold_at is not None and not self._closed and
                self.decodes >= self.hold_at)

    def decode(self):
        while self._parked():
            if not self._reported:
                self._reported = True
                if self.on_hold is not None:
                    self.on_hold(self.decodes, self.hold_id)
            time.sleep(0.002)
            if self.waiting is not None and self.waiting():
                break
        out = self.inner.decode()
        self.decodes += 1
        return out


# ---------------------------------------------------------------------------
# member process
# ---------------------------------------------------------------------------

class MemberHarness:
    """The member-process half of the control plane.

    Wraps a listener-less :class:`InferenceServer` (its engine loop,
    crash requeue, and failover-grace machinery are reused unchanged)
    with three wire surfaces on the shared van: a command loop on the
    submit channel (submit / drain two-phase / adopt / shutdown — ONE
    reader thread, so a drain command is naturally ordered after every
    submit the controller sent before it), an outbound event queue
    (completions, drain acks) on the event channel, and a membership
    heartbeat carrying load + engine health."""

    def __init__(self, spec: MemberSpec):
        from hetu_tpu_torch.ps import van
        from hetu_tpu_torch.serve.scheduler import (
            ContinuousBatchingScheduler,
        )
        from hetu_tpu_torch.serve.server import InferenceServer
        self.spec = spec
        self._van = van
        # the replicated durable tier, when the spawn config names one:
        # every table/channel this member builds re-resolves to the
        # promoted endpoint on primary-van death (a VanFailover is a
        # retried transient at every call site)
        self.replica = None
        if spec.van:
            from hetu_tpu_torch.ps.replica import VanReplica
            self.replica = VanReplica.from_spec(spec.van)
        # the flight recorder FIRST: every span this process ever
        # records (engine prefill/decode, per-request lifecycle, drain
        # legs) streams to disk line-by-line, so a SIGKILL loses at most
        # one torn line (trace.load_jsonl skips it)
        if spec.trace_dir:
            trace.open_process_stream(
                spec.trace_dir, f"member_s{spec.slot}_p{os.getpid()}")
        model = {**DEFAULT_MODEL, **spec.model}
        self.device = str(model["device"])
        _, _, engine = build_engine(model)
        self.engine = _MemberEngine(engine, hold_at=model["hold_at"])
        self.scheduler = ContinuousBatchingScheduler(
            self.engine, shed=spec.shed, shed_headroom=spec.shed_headroom,
            slo_classes=spec.slo_classes)
        # the hold reports over the event channel, and a control call
        # waiting for the scheduler lock (a drain's export, an adoption)
        # lets a parked round go
        self.engine.on_hold = lambda r, i: self._emit(
            {"type": "held", "slot": int(spec.slot), "round": int(r),
             "id": int(i)})
        self.engine.waiting = lambda: self.scheduler.control_waiting > 0
        # the member's half of the gray-failure plane: one emulator per
        # process, installed up front (policies arrive via spec.netem
        # and/or "netem" commands; an empty emulator is a transparent
        # wire)
        from hetu_tpu_torch.ps.netem import LinkPolicy, NetEm
        self.netem = NetEm(local=f"m{spec.slot}", peer="van",
                           seed=int(spec.netem.get("seed", 0)))
        for direction, pol in spec.netem.get("links", ()):
            self.netem.set_link(LinkPolicy.from_dict(pol),
                                direction=direction)
        self.netem.install()
        self.server = InferenceServer(
            self.scheduler, port=spec.port, own_van=False, max_clients=0,
            request_timeout_s=spec.request_timeout_s,
            max_loop_errors=spec.max_loop_errors,
            failover_grace_s=spec.failover_grace_s)
        self.member = _mb.MembershipClient(
            "127.0.0.1", spec.port, table_id=spec.membership_table,
            slot=spec.slot, n_slots=spec.n_slots, replica=self.replica)
        self._stop = threading.Event()
        self._events: queue.Queue = queue.Queue()
        self._migrated: set = set()   # rids handed to a peer (no event)
        # rid dedup: after a van failover the controller RE-SENDS every
        # unresolved submit (it cannot know which landed before the
        # primary died), and a re-routed orphan (takeover) can pick this
        # member again; a rid this member already owns must not be
        # served twice.  Bounded like _done_log.
        self._seen_rids: OrderedDict = OrderedDict()
        self._pending_drain = None    # (xfer_id, pairs) awaiting commit
        # completion RECORDS, kept after emission: when a controller
        # dies, whatever sat unread in the old event channel's single
        # slot died with it — on rebind every record is re-announced
        # and the new controller dedups by rid
        self._done_log: list = []
        self._fenced_cmds = 0
        self._epoch_ack = 0
        # the controller's incarnation keys the command channels: wait
        # for the first control publish (the pool publishes BEFORE
        # spawning members, so this is immediate except under chaos)
        deadline = time.monotonic() + 30.0
        while True:
            try:
                self._epoch_ack = self.member.read_control()[0]
            except Exception:
                pass
            if self.member.ctrl_inc > 0:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "no controller incarnation on the control row")
            time.sleep(0.02)
        self._ctrl_gen = self.member.ctrl_inc
        self._van_gen = self.replica.incarnation if self.replica else 0
        # generations are (controller incarnation, van incarnation)
        # pairs: EITHER bump rebinds the command/event channels — a new
        # controller allocates fresh incarnation-keyed ids, a promoted
        # van has fresh (empty) channel state at the same ids
        self._in_gen = self._out_gen = (self._ctrl_gen, self._van_gen)
        self._in = self._chan(spec.submit_ch, self._ctrl_gen)
        self._out = self._chan(spec.event_ch, self._ctrl_gen)
        self.member.join(epoch_ack=float(self._epoch_ack))
        self._threads = [
            threading.Thread(target=self._beat_loop, daemon=True),
            threading.Thread(target=self._event_loop, daemon=True),
            threading.Thread(target=self._ctrl_watch_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ---- outbound ----
    def _emit(self, ev: dict) -> None:
        self._events.put(ev)

    def _chan(self, base: int, ctrl_inc: int):
        """A control/event blob channel at the CURRENT durable-tier
        endpoint, keyed by controller incarnation as always."""
        cid = _fenced_chan(base, ctrl_inc)
        if self.replica is not None:
            return self.replica.channel(cid)
        return self._van.BlobChannel("127.0.0.1", self.spec.port, cid)

    def _mig_chan(self, ch_id: int):
        if self.replica is not None:
            return self.replica.channel(ch_id)
        return self._van.BlobChannel("127.0.0.1", self.spec.port, ch_id)

    def _gen(self) -> tuple:
        return (self._ctrl_gen, self._van_gen)

    def _ctrl_watch_loop(self) -> None:
        """Track the controller lease: the read updates the client's
        fence (``ctrl_inc``) and silence clock; an incarnation bump is
        the rebind signal for the command/event loops, and the observed
        control EPOCH is acked through the heartbeat so deaf-member
        detection works on the serving plane too.  With a replicated
        durable tier the same read drives VAN failover: a failed pull
        runs the replica's promotion dance inside its retry loop, and
        the observed van incarnation joins the rebind generation."""
        period = max(self.spec.hb_ms, 10) / 1000.0
        while not self._stop.wait(period):
            try:
                e = self.member.read_control()[0]
            except Exception:
                e = None  # unreadable control row: nothing to react to
            if e is not None:
                self._epoch_ack = max(self._epoch_ack, e)
                if self.member.ctrl_inc > self._ctrl_gen:
                    self._ctrl_gen = self.member.ctrl_inc
            if self.replica is not None and \
                    self.replica.incarnation != self._van_gen:
                self._van_gen = self.replica.incarnation

    def _event_loop(self) -> None:
        seq = 1
        backlog: list = []
        while not self._stop.is_set():
            if self._out_gen != self._gen():
                # a new controller incarnation owns the fleet (or the
                # durable tier failed over to the promoted van): bind
                # the event channel there and RE-ANNOUNCE every
                # completion record — the dead controller may have
                # resolved none/some of them (the new one dedups by
                # rid), whatever sat unread in the old channel's single
                # slot is gone, and a promoted van starts with EMPTY
                # channel state at the same ids
                gen = self._gen()
                try:
                    self._out.close()
                except Exception:
                    pass
                try:
                    self._out = self._chan(self.spec.event_ch, gen[0])
                except ConnectionError:
                    # a transiently unreachable van, or mid-promotion:
                    # keep the thread alive, retry once the replica
                    # adopts the new primary
                    time.sleep(0.1)
                    continue
                self._out_gen = gen
                seq = 1
                backlog = list(self._done_log)
            from_backlog = bool(backlog)
            if from_backlog:
                ev = backlog[0]
            else:
                try:
                    ev = self._events.get(timeout=0.1)
                except queue.Empty:
                    continue
            payload = json.dumps(ev).encode()
            sent = False
            while not self._stop.is_set() and \
                    self._out_gen == self._gen():
                try:
                    # idempotent same-seq resend: a timeout retries the
                    # SAME slot until the controller drains it.
                    # ConnectionError covers a netem-partitioned egress
                    # (NetemDrop): a one-way-partitioned member must
                    # QUEUE its completions and flush them at heal, not
                    # lose its event thread to the partition
                    self._out.put(payload, seq, timeout_s=2.0)
                    seq += 1
                    sent = True
                    break
                except (TimeoutError, ConnectionError, RuntimeError):
                    time.sleep(0.05)
            if sent:
                if from_backlog:
                    backlog.pop(0)
            elif not from_backlog:
                # a rebind (or stop) interrupted a queue event mid-send:
                # requeue it — done events would ride the replay anyway,
                # but drain acks exist only here
                self._events.put(ev)

    def _beat_loop(self) -> None:
        period = max(self.spec.hb_ms, 10) / 1000.0
        last_err = 0.0
        while not self._stop.wait(period):
            try:
                self.member.heartbeat(
                    load=float(self.scheduler.load),
                    healthy=self.server.healthy,
                    epoch_ack=float(self._epoch_ack))
            except Exception as e:
                now = time.monotonic()
                if now - last_err > 1.0:
                    last_err = now
                    _dbg(f"slot={self.spec.slot} heartbeat failed: "
                         f"{type(e).__name__}: {e}")
                # a transiently unreachable van must not kill the beat
                # thread — silence IS the loss signal, so keep trying
                time.sleep(period)

    def _record_request_span(self, req, tenant) -> None:
        """One retroactive ``serve.request`` span per resolved rid: the
        member-side anchor of the cross-process causal chain (the fleet
        stitcher links controller ``serve.submit`` → this → controller
        ``serve.resolve`` by the shared rid) PLUS the in-process latency
        decomposition — queue wait (submit→slot), prefill (slot→first
        token), decode (first→last token) — measured where the clocks
        are local and exact.  Control-plane ids ride as args (``ci`` =
        controller incarnation, ``slot``) so a trace of a takeover run
        shows which incarnation owned each leg."""
        t = trace.get_tracer()
        if t is None or req.submitted_at is None:
            return
        # request stamps are time.monotonic(); anchor them to the
        # tracer's clock via a (now_monotonic, now_track) pair so no
        # cross-clock epoch assumption is needed
        now_m, now_us = time.monotonic(), t._now_us()

        def at(stamp):
            return max(now_us - max(now_m - stamp, 0.0) * 1e6, 0.0)

        attrs = {"rid": int(req.rid), "status": req.status or "ok",
                 "slot": int(self.spec.slot),
                 "ci": int(self._ctrl_gen), "tokens": len(req.tokens)}
        if tenant:
            attrs["tenant"] = tenant
        if req.admitted_at is not None:
            attrs["queue_s"] = round(req.admitted_at - req.submitted_at, 6)
            if req.first_token_at is not None:
                attrs["prefill_s"] = round(
                    req.first_token_at - req.admitted_at, 6)
        if req.ttft_s is not None:
            attrs["ttft_s"] = round(req.ttft_s, 6)
        end = req.finished_at if req.finished_at is not None else now_m
        if req.first_token_at is not None:
            attrs["decode_s"] = round(end - req.first_token_at, 6)
        t.complete("serve.request", at(req.submitted_at), attrs,
                   cat="serve", end_us=at(end))

    def _watch(self, req, tenant=None) -> None:
        """Report the request's terminal state to the controller once it
        resolves — unless it migrated away (the adopter reports it).
        The record survives in ``_done_log`` so a controller takeover
        can be re-announced to."""
        def run():
            req.done.wait()
            if req.status == "migrated" or req.rid in self._migrated:
                return
            try:
                self._record_request_span(req, tenant)
            except Exception:
                traceback.print_exc()  # telemetry must never block a
                # completion from reaching the controller
            ev = {"type": "done", "rid": int(req.rid),
                  "status": req.status or "ok",
                  "tokens": [int(t) for t in req.tokens],
                  "ttft_s": req.ttft_s}
            self._done_log.append(ev)
            if len(self._done_log) > 1024:
                del self._done_log[0]
            self._emit(ev)
        threading.Thread(target=run, daemon=True).start()

    # ---- command dispatch (single reader: ordering is the protocol) ----
    def run(self) -> None:
        seq = 1
        while not self._stop.is_set():
            if self._in_gen != self._gen():
                # DRAIN the dying incarnation's channel before
                # switching: the slot is one-deep, and the command
                # possibly still sitting in it (e.g. the submit the
                # dead controller journaled right before dying) belongs
                # to a request the NEW controller has adopted and is
                # waiting on — dropping it would strand that rid
                # forever.  These drained commands bypass the staleness
                # fence (they were written by the then-legitimate
                # controller; a zombie can only reach this window by
                # racing the one bounded drain, after which the old
                # channel is never read again).  When the VAN
                # incarnation changed, the old channel lives on a dead
                # (or fenced) van — nothing to drain, and the
                # controller re-sends every unresolved submit after its
                # own rebind, so skip straight to the new endpoint.
                van_changed = self._in_gen[1] != self._van_gen
                _dbg(f"slot={self.spec.slot} rebind {self._in_gen} -> "
                     f"{self._gen()}")
                drain_deadline = time.monotonic() + 5.0
                while not van_changed and not self._stop.is_set():
                    try:
                        # a generous get timeout: 0.2s would conflate
                        # "slot empty" with "slow wire" and drop a
                        # journaled submit under a netem-degraded link
                        raw = self._in.get(seq, timeout_s=1.0)
                    except TimeoutError:
                        break  # slot empty — the drain is complete
                    except (ConnectionError,
                            self._van.BlobTransportError):
                        # transient wire wobble (netem degrade, van
                        # hiccup, a stop past the get's deadline): must
                        # not truncate the ONE bounded drain — a
                        # journaled submit dropped here strands the rid
                        # its successor adopted
                        if time.monotonic() >= drain_deadline:
                            break
                        time.sleep(0.05)
                        continue
                    except RuntimeError:
                        break  # van gone under us
                    seq += 1
                    try:
                        if not self._dispatch(json.loads(raw),
                                              allow_stale=True):
                            self.close()
                            return
                    except Exception:
                        traceback.print_exc()
                gen = self._gen()
                try:
                    self._in.close()
                except Exception:
                    pass
                try:
                    self._in = self._chan(self.spec.submit_ch, gen[0])
                except ConnectionError:
                    # a transiently unreachable van, or the pair
                    # mid-promotion (a SECOND fault can land while this
                    # rebind is already in flight): _in_gen stays stale,
                    # so the loop re-enters this block and re-binds once
                    # the watch loop adopts the promoted incarnation — a
                    # member must outlive the window, not crash into a
                    # lease expiry
                    time.sleep(0.1)
                    continue
                self._in_gen = gen
                seq = 1
            try:
                raw = self._in.get(seq, timeout_s=0.25)
            except (TimeoutError, ConnectionError,
                    self._van.BlobTransportError):
                continue  # idle poll / netem-partitioned ingress / a
                # stop (SIGSTOP) that outlasted the get: the command
                # loop outlives a transiently unreachable wire
            except RuntimeError as e:
                if self.replica is not None:
                    # a dead PRIMARY van surfaces here as rc=-101 at
                    # the get deadline — with a replicated durable
                    # tier that is a survivable outage (the watch
                    # loop promotes/adopts and bumps the van
                    # generation, and this loop rebinds), NOT a
                    # shutdown signal
                    time.sleep(0.05)
                    continue
                # van gone under us: the log says so before the leave
                print(f"member {self.spec.slot} exits: command channel "
                      f"failed: {e!r}", file=sys.stderr, flush=True)
                break
            seq += 1
            try:
                msg = json.loads(raw)
                if not self._dispatch(msg):
                    print(f"member {self.spec.slot} exits: "
                          f"{msg.get('cmd')} command", file=sys.stderr,
                          flush=True)
                    break
            except Exception:
                traceback.print_exc()  # one bad command must not kill
                # the member — the controller's lease would misread a
                # parse error as a death
        self.close()

    def _dispatch(self, msg: dict, *, allow_stale: bool = False) -> bool:
        from hetu_tpu_torch.serve.scheduler import Request
        ci = msg.get("ci")
        if not allow_stale and ci is not None and \
                int(ci) < self.member.ctrl_inc:
            # a fenced (superseded-incarnation) controller's command:
            # refused — the member-side half of the zombie fence
            self._fenced_cmds += 1
            return True
        cmd = msg.get("cmd")
        if cmd == "submit":
            rid = int(msg["rid"])
            if rid in self._seen_rids:
                # duplicate delivery (a controller re-send after a van
                # failover, or an orphan re-route that picked this
                # member again): already owned — serving it twice would
                # waste slots, and the original's completion record
                # answers the controller either way
                return True
            self._seen_rids[rid] = True
            while len(self._seen_rids) > 4096:
                self._seen_rids.popitem(last=False)
            req = Request(prompt=[int(t) for t in msg["prompt"]],
                          max_tokens=int(msg.get("max_tokens", 16)),
                          eos_id=msg.get("eos_id"),
                          timeout_s=float(msg.get(
                              "timeout_s", self.spec.request_timeout_s)))
            req.rid = rid  # controller-global id: completion
            # events and cross-process drains correlate on it
            req.tenant = msg.get("tenant")  # rides the migration record
            # too, so an adopter keeps the attribution
            req.slo = msg.get("slo")  # SLO class name — the scheduler
            # maps it to (priority, weight) via its slo_classes
            self._watch(req, tenant=req.tenant)
            self.scheduler.submit(req)
        elif cmd == "recv_migration":
            self._recv_migration(int(msg["ch"]), int(msg["xfer"]),
                                 float(msg.get("timeout_s", 30.0)))
        elif cmd == "drain":
            self._drain(int(msg["ch"]), int(msg["xfer"]),
                        str(msg.get("codec", "none")),
                        float(msg.get("timeout_s", 30.0)))
        elif cmd == "drain_commit":
            self._drain_commit(int(msg["xfer"]), leave=bool(msg.get("exit")))
            if msg.get("exit"):
                return False
        elif cmd == "drain_abort":
            self._drain_abort(int(msg["xfer"]))
        elif cmd == "netem":
            self._apply_netem(msg)
        elif cmd == "replay":
            # the controller lost track of these rids (an event that
            # died in a dead van's single-slot channel, a listener
            # rebind race): re-emit any COMPLETED record it names —
            # in-progress rids simply have no record yet, and the
            # controller's first-wins dedup absorbs duplicates
            rids = {int(r) for r in msg.get("rids", ())}
            for ev in list(self._done_log):
                if int(ev.get("rid", -1)) in rids:
                    self._emit(ev)
        elif cmd == "metrics":
            self._emit_metrics()
        elif cmd == "hold":
            self.engine.hold(int(msg.get("after", 0)), int(msg.get("id", 0)))
        elif cmd == "release":
            self.engine.unhold()
        elif cmd == "shutdown":
            return False
        return True

    _DURABLE_TIER_METRICS = ("membership.", "van.replica.",
                             "van.resilver.", "ledger.", "standby.",
                             "ps.")

    def _publish_process_metrics(self) -> None:
        """The port's member-process evidence, into the scheduler's
        registry (so it rides every scrape, and a dead incarnation's
        counters are retired, not lost): the flash forward's launches
        (a counter set to the kernel wrapper's count), whether ``jax``
        is loaded, and the peak device memory."""
        from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
            flash_attention,
        )
        reg = self.scheduler.metrics.registry
        c = reg.counter("kernels.flash_fwd.launches",
                        help="flash forward launches in this process")
        c.inc(int(flash_attention.launches) - int(c.value))
        reg.gauge("member.jax_loaded").set(int("jax" in sys.modules))
        peak = 0.0
        if self.device.startswith("cuda"):
            import torch
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        reg.gauge("member.peak_gib").set(peak)

    def _emit_metrics(self) -> None:
        """Answer a fleet scrape: ship the FULL registry state (raw
        histogram buckets, not percentiles — the controller's merge is
        bucket-wise) over the event channel, and mirror it into the span
        stream as a black-box record so a later SIGKILL cannot erase
        the last scraped numbers.  Durable-tier health counters
        (stale control reads, replication lag/promotions) live in the
        process-default registry — folded into the same dump so
        ``fleet_metrics()`` and the Prometheus export cover them."""
        from hetu_tpu_torch.telemetry import default_registry
        self._publish_process_metrics()
        if self.replica is not None:
            self.replica.export_lag()  # refresh the lag gauge
        dump = {k: v for k, v in default_registry.dump().items()
                if k.startswith(self._DURABLE_TIER_METRICS)}
        dump.update(self.scheduler.metrics.registry.dump())
        t = trace.get_tracer()
        if t is not None:
            t.metric_dump(dump)
        self._emit({"type": "metrics", "slot": int(self.spec.slot),
                    "dump": dump})

    def _apply_netem(self, msg: dict) -> None:
        """Install (or clear) a link policy on this member's van wire.
        The policy usually carries ``duration_s`` so a PARTITION heals
        itself — a heal command could never cross the very link it is
        supposed to heal."""
        from hetu_tpu_torch.ps.netem import LinkPolicy
        direction = str(msg.get("direction", "both"))
        pol = msg.get("policy")
        if pol is None:
            self.netem.clear_link(direction=direction)
        else:
            self.netem.set_link(LinkPolicy.from_dict(pol),
                                direction=direction)

    # ---- migration (two-phase, source side holds until commit) ----
    def _drain(self, ch_id: int, xfer: int, codec: str,
               timeout_s: float) -> None:
        # the MEMBER-side half of the drain recovery, recorded in THIS
        # process's stream: a preemption fault injected controller-side
        # pairs with this span on the merged fleet trace (the xfer id is
        # the drain's control-plane correlation key).  A failed export
        # carries args.error, so the timeline never claims it as a
        # recovery that repaired anything.
        with trace.span("serve.migrate",
                        {"xfer": int(xfer), "member": int(self.spec.slot),
                         "ci": int(self._ctrl_gen)}, cat="serve") as sp:
            pairs = None
            try:
                try:
                    payload, pairs = _migrate.export_payload(
                        self.scheduler, codec=codec)
                finally:
                    self.engine.unhold()  # a drain ends a hold
                tx = self._mig_chan(ch_id)
                try:
                    _migrate.send_payload(tx, payload, timeout_s=timeout_s)
                finally:
                    tx.close()
            except Exception as e:
                traceback.print_exc()
                sp.set("error", type(e).__name__)
                if pairs is not None:
                    try:
                        self.scheduler.adopt_inflight(pairs)  # resume
                    except Exception:
                        traceback.print_exc()
                self._emit({"type": "drain_failed", "xfer": xfer,
                            "error": repr(e)})
                return
            sp.set("requests", len(pairs))
        self._pending_drain = (xfer, pairs)
        self._emit({"type": "drained", "xfer": xfer, "n": len(pairs)})

    def _drain_commit(self, xfer: int, *, leave: bool = True) -> None:
        from hetu_tpu_torch.serve.scheduler import finish_request
        if self._pending_drain is None or self._pending_drain[0] != xfer:
            return
        _, pairs = self._pending_drain
        self._pending_drain = None
        for req, _slot in pairs:
            # resolve locally as 'migrated' so the watcher stays silent —
            # the ADOPTER owns the client-visible completion now
            self._migrated.add(req.rid)
            finish_request(req, "migrated", None)
        _migrate.release_exported(self.scheduler, pairs)
        if leave:
            try:
                self.member.leave()  # planned exit: never grieved
            except Exception:
                pass

    def _drain_abort(self, xfer: int) -> None:
        if self._pending_drain is None or self._pending_drain[0] != xfer:
            return
        _, pairs = self._pending_drain
        self._pending_drain = None
        try:
            self.scheduler.adopt_inflight(pairs)  # back in service
        except Exception:
            traceback.print_exc()

    def _recv_migration(self, ch_id: int, xfer: int,
                        timeout_s: float) -> None:
        # ack FIRST: the controller must not start the source's send
        # before this member is committed to receiving
        self._emit({"type": "mig_ready", "xfer": xfer})
        with trace.span("serve.adopt",
                        {"xfer": int(xfer), "member": int(self.spec.slot),
                         "ci": int(self._ctrl_gen)}, cat="serve") as sp:
            try:
                rx = self._mig_chan(ch_id)
                try:
                    got = _migrate.recv_payload(rx, timeout_s=timeout_s)
                finally:
                    rx.close()
                try:
                    reqs, slot_map = _migrate.adopt_payload(self.scheduler,
                                                            got)
                finally:
                    self.engine.unhold()  # an adoption ends a hold
            except Exception as e:
                traceback.print_exc()
                sp.set("error", type(e).__name__)
                self._emit({"type": "adopt_failed", "xfer": xfer,
                            "error": repr(e)})
                return
            sp.set("requests", len(reqs))
        for req in reqs:
            self._seen_rids[req.rid] = True  # adopted = owned: a later
            # duplicate submit for the rid must not double-serve it
            self._watch(req, tenant=getattr(req, "tenant", None))
        self._emit({"type": "adopted", "xfer": xfer, "n": len(reqs),
                    "slots": len(slot_map),
                    # the records that moved without a slot (queued at
                    # the source; a payload lists the slotted ones first):
                    # the adopter prefills these
                    "queued": [int(r.rid) for r in reqs[len(slot_map):]]})

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self.engine.close()  # a parked round must not hold the close up
        t = trace.get_tracer()
        if t is not None:
            try:  # final black-box record + flush (clean exits; kills
                # rely on the per-line flush).  The engine loop still
                # steps until the server closes: the record is taken
                # between two steps, or a prefill counted at its start
                # would stand beside only some of its layers' launches
                with self.scheduler.between_steps(2.0):
                    self._publish_process_metrics()
                    t.metric_dump(self.scheduler.metrics.registry.dump())
                t.flush()
            except Exception:
                pass
        try:
            self.member.leave()
        except Exception:
            pass
        try:
            self.server.close(5.0)
        except Exception:
            traceback.print_exc()
        for ch in (self._in, self._out):
            try:
                ch.close()
            except Exception:
                pass
        self.member.close()
        self.netem.uninstall()


def member_main(config_path: str) -> int:
    """Entry point for a spawned member process: build the harness,
    announce READY (the spawner's handshake), serve until told to stop."""
    import faulthandler
    import signal as _signal
    faulthandler.register(_signal.SIGUSR1)  # live-stack dump to stderr
    spec = MemberSpec.from_json(open(config_path).read())
    harness = MemberHarness(spec)
    # the launch log says whether this process loaded jax (it must not)
    print("READY", spec.slot, f"jax={int('jax' in sys.modules)}",
          flush=True)
    harness.run()
    return 0


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

class PoolRequest:
    """Controller-side request record: the original message (the
    failover resubmission source), current route, and the waiter's
    completion event.  Response dict shape matches the in-process
    pool's ``generate``."""

    __slots__ = ("rid", "msg", "member", "retries", "tokens", "status",
                 "ttft_s", "done", "sent", "routed_at")

    def __init__(self, rid: int, msg: dict):
        self.rid = rid
        self.msg = msg
        self.member: Optional[int] = None
        self.retries = 0
        self.routed_at: Optional[float] = None  # monotonic; the
        # replay-nudge ages unresolved requests from here
        self.tokens: list = []
        self.status: Optional[str] = None
        self.ttft_s = None
        self.done = threading.Event()
        # True once the submit command LANDED on the member's channel:
        # the ledger journals an ownership only when it is real — a
        # concurrent journal snapshotting the optimistic assignment
        # mid-send would otherwise record a member that never heard of
        # the rid, and a takeover would wait on it forever
        self.sent = False


class CrossProcessServingPool:
    """Controller over N serving-member PROCESSES on one van.

    Construction starts the van, creates the membership blackboard,
    spawns ``n_members`` member processes (each builds the same seeded
    model), and waits for them to join.  ``generate``/``submit`` route
    over the wire; the poll thread runs the lease state machine and the
    failover/suspect handling; ``drain_member`` runs the two-phase
    cross-process KV migration.  ``procs`` holds the live ``Popen``
    handles — exactly what the chaos harness's ``member_kill`` /
    ``member_suspend`` faults target.
    """

    def __init__(self, n_members: int = 2, *, workdir, model: dict = None,
                 port: int = 0, own_van: bool = True,
                 hb_ms: int = 80, lease_s: float = 0.6,
                 suspect_grace_s: float = 0.5,
                 poll_s: float = 0.05,
                 request_timeout_s: float = 60.0,
                 max_retries: int = 3,
                 migrate_codec: str = "none",
                 membership_table: Optional[int] = None,
                 ledger_table: Optional[int] = None,
                 # DeltaLedger geometry: half the rows hold the base
                 # snapshot (state capacity ~= the old snapshot
                 # ledger's), half the append-only delta region
                 ledger_rows: int = 2048,
                 deaf_ack_s: Optional[float] = None,
                 metrics: Optional[ServeMetrics] = None,
                 member_env: Optional[dict] = None,
                 spawn_timeout_s: float = 120.0,
                 shed: bool = False, shed_headroom: float = 1.0,
                 slo_classes: Optional[dict] = None,
                 rtt_degraded_x: float = 5.0,
                 start_poll: bool = True,
                 telemetry_streams: bool = True,
                 scrape_s: float = 1.0,
                 van_spec: Optional[dict] = None,
                 van_backup_factory=None,
                 _takeover: bool = False):
        from hetu_tpu_torch.ps import van
        if n_members < 1:
            raise ValueError("a serving pool needs at least one member")
        migrate_codec = _migrate.check_codec(migrate_codec)
        self._van = van
        # replicated durable tier: `van_spec` (a ReplicaSpec dict)
        # names a primary+backup van pair — the blackboard and ledger
        # dual-write synchronously, channels re-resolve to the promoted
        # endpoint, and a primary-van SIGKILL costs a rebind, not the
        # fleet
        self._replica = None
        self._van_spec = dict(van_spec) if van_spec else {}
        self._van_gen = 0
        self._mb_van_seen = 0
        self._van_rebind_pending = False
        if self._van_spec:
            if own_van:
                raise ValueError(
                    "a replicated durable tier is external by "
                    "definition: pass own_van=False with van_spec")
            from hetu_tpu_torch.ps.replica import VanReplica
            # pair-membership rendezvous on the shared workdir: members
            # whose cached endpoint view goes fully dead (both slots
            # replaced while they were busy) re-read the pair from here
            # instead of livelocking against two dead ports
            self._van_spec.setdefault(
                "rendezvous", os.path.join(workdir, "van_pair.json"))
            self._replica = VanReplica.from_spec(
                self._van_spec, bootstrap=not _takeover)
            if _takeover:
                self._replica.refresh()  # unconditional: a stale
                # cached view must not adopt the dead primary
            port = self._replica.primary[1]
            self._van_gen = self._replica.incarnation
            self._mb_van_seen = self._replica.incarnation
            self._replica.register(self._on_van_failover)
            if van_backup_factory is not None:
                # continuous redundancy: a promotion auto-resilvers
                # onto a fresh van from this factory (replica -> (host,
                # port)), restoring the pair without an operator
                self._replica.spawn_backup = van_backup_factory
                self._replica.write_rendezvous()  # seed the snapshot
        self._own_van = own_van
        if own_van:
            self.port = van.serve(port)
        else:
            if not port:
                raise ValueError("own_van=False needs the running van's port")
            self.port = port
        self.workdir = workdir
        self.model = {**DEFAULT_MODEL, **(model or {})}
        self.n_members = int(n_members)
        self.hb_ms = int(hb_ms)
        self.request_timeout_s = float(request_timeout_s)
        self.max_retries = int(max_retries)
        self.migrate_codec = migrate_codec
        # fresh by default: the native table registry outlives van.stop(),
        # and two pools in one process must not share a blackboard
        self._membership_table = int(membership_table) \
            if membership_table is not None else _mb.fresh_table_id()
        self._ledger_table = int(ledger_table) \
            if ledger_table is not None else _mb.fresh_table_id()
        self._ledger_rows = int(ledger_rows)
        self._spawn_timeout_s = float(spawn_timeout_s)
        # extra environment of every member process, e.g.
        # {"OMP_NUM_THREADS": "1"} for CPU members sharing a host
        self._member_env = dict(member_env) if member_env else None
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._lock = threading.RLock()
        self._poll_lock = threading.Lock()
        self._journal_lock = threading.Lock()
        self._journal_dirty = False
        self._pending_deltas: list = []  # coalesced route/resolve
        # records, flushed by the poll loop in ONE append frame
        self._unrouted: dict = {}  # rid -> routing deadline (parked
        # while no member is routable — e.g. mid van-failover blind
        # window; journaled, so they must resolve, not error out)
        self._rid_seq = 0               # journaled: rid space survives
        self._ctrl_seq = 0              # a takeover (no reuse)
        self._requests: dict = {}       # rid -> PoolRequest
        # rid -> terminal status, bounded: the ledger's dedup record —
        # a member re-announcing an already-resolved completion after a
        # takeover must be recognized, not re-served
        self._resolved: OrderedDict = OrderedDict()
        self._ch_bases: dict = {}       # slot -> (submit_base, event_base)
        self._drain_journal: dict = {}  # xfer -> two-phase drain record
        self._member_pids: dict = {}    # takeover-adopted pids (no Popen)
        self._fenced = False
        self._inflight: dict = {}       # slot -> outstanding count
        self._draining: set = set()
        # slot -> submits being sent to it by _route now; a drain waits
        # for 0 before its drain command (see drain_member)
        self._routing: dict = {}
        self._routing_cv = threading.Condition(self._lock)
        # slots being revived: the fresh process joins the blackboard
        # before its control channel is bound here, and a submit sent
        # meanwhile would go down the dead incarnation's channel
        self._binding: set = set()
        self._quarantined: set = set()  # engine-dead / failed-over slots
        self._suspect_t0: dict = {}     # slot -> trace ts of suspicion
        # per-link health, measured from this controller's OWN control
        # sends (every submit/drain command is a timed blob put): the
        # routing penalty that keeps traffic off a member behind a
        # degraded link BEFORE its lease ever wobbles
        self._shed = bool(shed)
        self._shed_headroom = float(shed_headroom)
        # per-tenant SLO classes, forwarded verbatim into every member's
        # spawn config (and so into each member scheduler) — the pool
        # itself only needs them to stamp submits with a class name
        self._slo_classes = dict(slo_classes) if slo_classes else {}
        self._rtt_degraded_x = float(rtt_degraded_x)
        self._rtt: dict = {}            # slot -> EWMA send seconds
        self._degraded_t0: dict = {}    # slot -> trace ts of degrade
        self._xfers: dict = {}          # xfer id -> {"evt", "events"}
        # the member hold: slot -> the id of the last hold it reported
        # parked at (0: the spec's hold_at), the ids sent, and the
        # condition that wait_held blocks on
        self._held: dict = {}
        self._hold_ids: dict = {}
        self._held_cv = threading.Condition(threading.Lock())
        self._out: dict = {}            # slot -> (channel, lock, [seq])
        self._listeners: dict = {}      # slot -> (thread, stop)
        # fleet observability: members stream spans to workdir when
        # telemetry_streams, and the poll loop scrapes their registry
        # dumps every scrape_s (0 disables the cadence; scrape() still
        # works on demand).  The scrape round runs in a ONE-SHOT side
        # thread so a wedged member's control channel can never stall
        # the membership sweep that would declare it lost.
        self._telemetry_streams = bool(telemetry_streams)
        self._scrape_s = float(scrape_s)
        self._member_metrics: dict = {}  # slot -> last registry dump
        self._metrics_replies: dict = {}  # slot -> reply count
        self._scrape_pending: dict = {}  # slot -> unanswered ask time
        # counters/histograms of DEAD member incarnations, folded in at
        # revive time: without this, a replacement's first scrape reply
        # would overwrite the victim's last dump and the fleet's
        # request counters would go BACKWARD (a broken Prometheus
        # counter) while silently dropping the dead incarnation's work
        self._retired_metrics: dict = {}
        self._last_scrape = 0.0
        self._scrape_busy = threading.Event()
        # completion-replay nudge: a done event can die in a dead van's
        # single-slot channel (or a listener rebind race) — the member
        # keeps the record in its _done_log, so the controller
        # periodically asks owners to re-emit records for rids it still
        # sees unresolved.  First-wins dedup makes duplicates free.
        self._nudge_after_s = 3.0
        self._last_nudge = 0.0
        self._nudge_busy = threading.Event()
        self.procs: list = [None] * self.n_members
        self.adopted: dict = {}         # takeover: rid -> PoolRequest
        self.takeover_report: dict = {}
        # the autoscaler's journaled state ('s' ledger records, written
        # by journal_autoscaler): replayed and carried through
        # compaction, so a successor's loop resumes warm
        self._autoscaler_state: Optional[dict] = None
        # live health plane (started on demand by start_health_monitor)
        self.health_monitor = None
        self._stop = threading.Event()
        try:
            if _takeover:
                # adopt, don't create: the blackboard, ledger, and the
                # member PROCESSES all outlived the dead controller
                self._bb = _mb.attach_blackboard(
                    "127.0.0.1", self.port,
                    table_id=self._membership_table,
                    n_slots=self.n_members, replica=self._replica)
                self.svc = _mb.MembershipService(
                    self._bb, self.n_members, lease_s=lease_s,
                    suspect_grace_s=suspect_grace_s,
                    deaf_ack_s=deaf_ack_s)
                self._ledger = _mb.DeltaLedger(
                    "127.0.0.1", self.port, table_id=self._ledger_table,
                    rows=self._ledger_rows, create=False,
                    replica=self._replica)
                self._adopt()
            else:
                self._bb = _mb.create_blackboard(
                    "127.0.0.1", self.port,
                    table_id=self._membership_table,
                    n_slots=self.n_members, replica=self._replica)
                self.svc = _mb.MembershipService(
                    self._bb, self.n_members, lease_s=lease_s,
                    suspect_grace_s=suspect_grace_s,
                    deaf_ack_s=deaf_ack_s)
                self._ledger = _mb.DeltaLedger(
                    "127.0.0.1", self.port, table_id=self._ledger_table,
                    rows=self._ledger_rows, create=True,
                    replica=self._replica)
                # publish the control row BEFORE spawning: members key
                # their command channels on the incarnation it carries
                self.svc.publish_control(epoch=1, width=self.n_members,
                                         alive_mask=0)
                self._spawn(range(self.n_members))
                self._wait_joined(range(self.n_members))
                self._journal()
        except Exception:
            self.close()
            raise
        self._poll_thread = None
        if start_poll:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, args=(float(poll_s),), daemon=True)
            self._poll_thread.start()

    @classmethod
    def takeover(cls, *, workdir, port, lease_s: float = 0.6,
                 suspect_grace_s: float = 0.5, poll_s: float = 0.05,
                 request_timeout_s: float = 60.0, max_retries: int = 3,
                 deaf_ack_s: Optional[float] = None,
                 metrics: Optional[ServeMetrics] = None,
                 spawn_timeout_s: float = 120.0,
                 start_poll: bool = True) -> "CrossProcessServingPool":
        """Become the fleet's NEW controller after the old one died.

        Reads the dead controller's member spawn configs from
        ``workdir`` (the durable record of every control-plane id:
        blackboard, ledger, channel bases, model), attaches to the
        still-running van at ``port``, claims the controller row with a
        strictly higher incarnation, and adopts: members rebind their
        command channels to the new incarnation and re-announce their
        completion records, unresolved requests are restored from the
        ledger (orphans re-routed), and half-open drains are aborted
        back to a serving source — the whole hand-off under one
        ``ctrl.takeover`` span.  Adopted in-flight requests land in
        ``self.adopted``; :meth:`wait_adopted` blocks on them."""
        from pathlib import Path
        cfgs = sorted(Path(workdir).glob("member_*.json"),
                      key=lambda p: p.stat().st_mtime)
        if not cfgs:
            raise FileNotFoundError(
                f"no member spawn configs under {workdir} — nothing to "
                f"take over")
        spec = MemberSpec.from_json(cfgs[-1].read_text())
        return cls(spec.n_slots, workdir=workdir, model=spec.model,
                   port=port, own_van=False, hb_ms=spec.hb_ms,
                   lease_s=lease_s, suspect_grace_s=suspect_grace_s,
                   poll_s=poll_s, request_timeout_s=request_timeout_s,
                   max_retries=max_retries,
                   membership_table=spec.membership_table,
                   ledger_table=spec.ledger_table,
                   ledger_rows=spec.ledger_rows,
                   deaf_ack_s=deaf_ack_s, metrics=metrics,
                   spawn_timeout_s=spawn_timeout_s,
                   shed=spec.shed, shed_headroom=spec.shed_headroom,
                   telemetry_streams=bool(spec.trace_dir),
                   scrape_s=spec.scrape_s, van_spec=spec.van or None,
                   start_poll=start_poll, _takeover=True)

    def _adopt(self) -> None:
        got = self._ledger.read()
        state = self._replay_ledger(got) if got else {}
        with trace.span("ctrl.takeover", cat="ctrl") as sp:
            sp.set("plane", "serving")
            sp.set("incarnation", self.svc.ctrl_incarnation)
            ctrl = self.svc.read_control_row()
            # carry any injected slow-link fields forward (the serving
            # plane publishes rarely, but the rule is uniform: a
            # takeover must not silently heal an injection)
            self.svc.adopt_slow(ctrl["slow_slot"], ctrl["slow_ms"])
            # republish under the NEW incarnation: this is the rebind
            # signal every member's control watch is waiting for
            self.svc.publish_control(
                epoch=max(int(ctrl["epoch"]), 1), width=self.n_members,
                alive_mask=int(ctrl["alive_mask"]))
            with self._lock:
                self._rid_seq = int(state.get("rid", 0))
                self._ctrl_seq = int(state.get("cid", 0))
                for s, bases in (state.get("channels") or {}).items():
                    self._ch_bases[int(s)] = (int(bases[0]),
                                              int(bases[1]))
                for rid_s, rec in (state.get("requests") or {}).items():
                    req = PoolRequest(int(rid_s), dict(rec["msg"]))
                    req.member = rec.get("member")
                    req.sent = req.member is not None
                    if req.sent:  # nudge-eligible: the member's
                        # re-announce usually beats the nudge, but a
                        # lost event must not strand the adoption
                        req.routed_at = time.monotonic()
                    req.retries = int(rec.get("retries", 0))
                    self._requests[req.rid] = req
                    self.adopted[req.rid] = req
                for rid_s, st in (state.get("resolved") or {}).items():
                    self._resolved[int(rid_s)] = st
                self._drain_journal = {
                    str(k): dict(v)
                    for k, v in (state.get("drains") or {}).items()}
                self._autoscaler_state = \
                    dict(state["autoscaler"]) \
                    if state.get("autoscaler") else None
            # wire up every recorded member under the new incarnation
            inc = self.svc.ctrl_incarnation
            for slot, (sub, evb) in sorted(self._ch_bases.items()):
                ch = self._ctrl_chan(_fenced_chan(sub, inc))
                with self._lock:
                    old = self._out.get(slot)
                    self._out[slot] = (ch, threading.Lock(), [1])
                    self._inflight.setdefault(slot, 0)
                if old is not None:
                    try:
                        old[0].close()
                    except Exception:
                        pass
                self._start_listener(slot, evb)
            # learn who is still beating (members that died WITH the
            # controller surface as ordinary lease expiries below)
            self.svc.wait_present(self._spawn_timeout_s, poll=self.poll)
            # member pids off the blackboard: these processes are the
            # DEAD controller's children — the pid is the only handle
            # close()/revive have on them
            self._member_pids.update(self.svc.member_pids())
            # half-open drains: abort back to a still-serving source
            # (the drain's abort path — the source re-adopts its export;
            # a target that also adopted serves duplicates the rid
            # dedup absorbs, token-identically).  The abort must LAND
            # before the record may be dropped: the source parks its
            # exported requests in _pending_drain until told, and a
            # swallowed send failure would strand them forever.  The
            # send can fail transiently right after takeover (the
            # source rebinds its incarnation-keyed channel one watch
            # period after the bump), so failed aborts retry until the
            # source either hears us or loses its lease (dead source ⇒
            # _pending_drain died with it; its rids re-route as
            # orphans below).  Records that outlive the budget stay
            # journaled for the next incarnation rather than vanish.
            aborted = 0
            orphaned = 0  # source died WITH the drain: no abort to
            # deliver — the record drops and its rids re-route below
            pending = dict(self._drain_journal)
            abort_deadline = time.monotonic() + self._spawn_timeout_s
            while pending:
                for xid_s, d in list(pending.items()):
                    src = int(d.get("source", -1))
                    src_alive = 0 <= src < self.n_members and \
                        self.svc.state_of(src).state in ("alive",
                                                         "suspect")
                    sent = False
                    try:
                        self._send(src, {"cmd": "drain_abort",
                                         "xfer": int(xid_s)})
                        sent = True
                    except Exception:
                        traceback.print_exc()
                    if sent or not src_alive:
                        with self._lock:
                            self._draining.discard(src)
                            self._drain_journal.pop(xid_s, None)
                        del pending[xid_s]
                        if sent:
                            aborted += 1
                        else:
                            orphaned += 1
                if pending:
                    if time.monotonic() >= abort_deadline:
                        break
                    self.poll()
                    time.sleep(0.05)
            # rebuild routing state and re-home orphans: a request whose
            # member is gone re-prefills on a survivor (the ordinary
            # failover fold — greedy decode keeps it token-exact)
            with self._lock:
                for r in self._requests.values():
                    if r.member is not None:
                        self._inflight[r.member] = \
                            self._inflight.get(r.member, 0) + 1
                alive = set(self.svc.present_slots())
                orphans = [r for r in self._requests.values()
                           if r.member is None or r.member not in alive]
            for r in orphans:
                self._route(r, exclude=(
                    {r.member} if r.member is not None else set()))
            self.takeover_report = {
                "incarnation": self.svc.ctrl_incarnation,
                "adopted_requests": len(self.adopted),
                "resolved_known": len(self._resolved),
                # the ledger's pre-kill resolutions, by rid: the
                # supported loss-accounting surface (a rid is safe iff
                # adopted-and-resolved OR already here)
                "resolved": dict(self._resolved),
                "drains_aborted": aborted,
                "drains_orphaned": orphaned,
                "orphans_rerouted": len(orphans),
                "members_present": sorted(self.svc.present_slots()),
                "autoscaler_state": dict(self._autoscaler_state)
                if self._autoscaler_state else None,
            }
            sp.set("adopted_requests", len(self.adopted))
            sp.set("drains_aborted", aborted)
            sp.set("drains_orphaned", orphaned)
            sp.set("orphans_rerouted", len(orphans))
        self.metrics.inc("controller_takeovers")
        # the new incarnation opens on a FRESH base: one compaction
        # subsumes the predecessor's base + deltas (and proves the
        # mid-compaction takeover safe — a reader only ever sees one
        # atomic frame or the other)
        self._compact_ledger()

    def wait_adopted(self, timeout_s: float = 120.0) -> dict:
        """Block until every request adopted at takeover resolves;
        returns ``{rid: {"status", "tokens", "ttft_s"}}``.  A request
        that never resolves within the budget reads status
        'timeout'."""
        deadline = time.monotonic() + float(timeout_s)
        out = {}
        for rid, req in sorted(self.adopted.items()):
            if not req.done.wait(max(deadline - time.monotonic(), 0.01)):
                self._resolve(req, "timeout")
            out[rid] = {"status": req.status or "ok",
                        "tokens": list(req.tokens),
                        "ttft_s": req.ttft_s}
        return out

    @property
    def fenced(self) -> bool:
        """True once a newer controller incarnation superseded this one
        (every further control write is refused)."""
        return self._fenced

    # ---- spawning ----
    def _next_rid(self) -> int:
        with self._lock:
            self._rid_seq += 1
            return self._rid_seq

    def _spawn(self, slots) -> None:
        """Spawn a fresh member process for each of ``slots`` (new
        incarnation, new control channels): all are started before the
        first READY is awaited, so their start-ups (device context,
        weights) overlap."""
        from pathlib import Path

        from hetu_tpu_torch.resilience.shardproc import (
            spawn_module, wait_ready,
        )
        if self._replica is not None:
            # spawn configs must carry the CURRENT pair membership: a
            # member spawned after failovers + re-silvers would find
            # the original endpoints both dead and have no rendezvous
            self._van_spec = self._replica.current_spec()
        started = []
        try:
            for slot in slots:
                with self._lock:
                    cid = self._ctrl_seq
                    self._ctrl_seq += 1
                spec = MemberSpec(
                    port=self.port, slot=slot, n_slots=self.n_members,
                    submit_ch=CONTROL_CHANNEL_BASE + 2 * cid,
                    event_ch=CONTROL_CHANNEL_BASE + 2 * cid + 1,
                    membership_table=self._membership_table,
                    hb_ms=self.hb_ms,
                    request_timeout_s=self.request_timeout_s,
                    model=self.model, shed=self._shed,
                    shed_headroom=self._shed_headroom,
                    slo_classes=self._slo_classes,
                    ledger_table=self._ledger_table,
                    ledger_rows=self._ledger_rows,
                    trace_dir=str(self.workdir)
                    if self._telemetry_streams else "",
                    scrape_s=self._scrape_s, van=self._van_spec)
                tag = f"member_{slot}_{cid}"
                cfg = Path(self.workdir) / f"{tag}.json"
                cfg.write_text(spec.to_json())
                proc = spawn_module(self.workdir, tag,
                                    "hetu_tpu_torch.serve.crosshost",
                                    [str(cfg)], extra_env=self._member_env,
                                    timeout_s=self._spawn_timeout_s,
                                    wait=False)
                self.procs[slot] = proc
                started.append((slot, spec, tag, proc))
            for _, _, tag, proc in started:
                wait_ready(proc, tag, self._spawn_timeout_s)
        except Exception:
            for _, _, _, proc in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            raise
        for slot, spec, _, _ in started:
            self._bind_member(slot, spec)

    def _bind_member(self, slot: int, spec: MemberSpec) -> None:
        ch = self._ctrl_chan(
            _fenced_chan(spec.submit_ch, self.svc.ctrl_incarnation))
        with self._lock:
            old = self._out.get(slot)
            self._out[slot] = (ch, threading.Lock(), [1])
            self._inflight[slot] = 0
            self._ch_bases[slot] = (spec.submit_ch, spec.event_ch)
            self._member_pids.pop(slot, None)
            self._scrape_pending.pop(slot, None)  # fresh incarnation:
            # the old unanswered ask died with the old process
            self._held.pop(slot, None)
            self._hold_ids.pop(slot, None)
            # a fresh process's link has no history: the old one's RTT
            # (a dead member's timed-out sends) must not price it out
            self._rtt.pop(slot, None)
            self._degraded_t0.pop(slot, None)
            self._retire_member_metrics_locked(slot)
        if old is not None:  # a revived slot's previous control channel
            try:
                old[0].close()
            except Exception:
                pass
        self._start_listener(slot, spec.event_ch)
        # the fresh channel bases are JOURNALED state: a controller
        # death right after a revive must hand the successor the new
        # bases, not the dead slot's old ones (a takeover would
        # otherwise wire this member to channels nobody serves)
        try:
            self._append_ledger([
                {"c": [slot, spec.submit_ch, spec.event_ch]},
                {"q": [self._rid_seq, self._ctrl_seq]}])
        except Exception:
            traceback.print_exc()

    def _ctrl_chan(self, channel_id: int):
        """A control/event blob channel at the CURRENT durable-tier
        endpoint (the replica's primary when replicated)."""
        if self._replica is not None:
            return self._replica.channel(channel_id)
        return self._van.BlobChannel("127.0.0.1", self.port, channel_id)

    def _on_van_failover(self, replica) -> None:
        """Replica callback (runs on whichever thread hit the
        failover): flag only — the poll loop owns the rebind, so
        channel surgery never runs concurrently with itself."""
        self._van_rebind_pending = True

    def _van_rebind(self) -> None:
        """The durable tier failed over: rebind every member control/
        event channel to the promoted endpoint (same incarnation-keyed
        ids — the new van has fresh channel state, both sides reset to
        seq 1) and RE-SEND every unresolved submit (whatever sat in the
        dead van's single-slot channels died with it; members dedup by
        rid, so a duplicate is absorbed and a lost one re-delivered).
        The blackboard and ledger need no rebinding — their tables
        re-target inside :class:`~hetu_tpu_torch.ps.replica.
        ReplicatedPSTable`."""
        if self._replica is None:
            return
        from hetu_tpu_torch.ps.replica import retire_handle
        self._van_rebind_pending = False
        self._van_gen = self._replica.incarnation
        self.port = self._replica.primary[1]
        with trace.span("ctrl.van_rebind",
                        {"incarnation": int(self._van_gen)},
                        cat="ctrl") as sp:
            inc = self.svc.ctrl_incarnation
            with self._lock:
                bases = dict(self._ch_bases)
            rebind_failed = False
            _dbg(f"ctrl van rebind to incarnation {self._van_gen}")
            for slot, (sub, evb) in sorted(bases.items()):
                try:
                    ch = self._ctrl_chan(_fenced_chan(sub, inc))
                except Exception:
                    traceback.print_exc()
                    # this slot is still bound to the dead van: the
                    # pending flag was cleared at entry, so re-arm it
                    # below or the slot never rebinds (a SECOND fault
                    # mid-rebind would strand it forever)
                    rebind_failed = True
                    continue
                with self._lock:
                    old = self._out.get(slot)
                    self._out[slot] = (ch, threading.Lock(), [1])
                if old is not None:
                    # deferred close: a _send may be inside the old
                    # channel — closing now frees its fd for kernel
                    # reassignment mid-op
                    retire_handle(old[0])
                self._start_listener(slot, evb)
            if rebind_failed:
                self._van_rebind_pending = True
            with self._lock:
                pending = [r for r in self._requests.values()
                           if not r.done.is_set()]
            resent = 0
            for r in pending:
                if r.member is not None and r.sent:
                    try:
                        self._send(r.member, {"cmd": "submit",
                                              "rid": r.rid, **r.msg})
                        r.routed_at = time.monotonic()
                        resent += 1
                    except Exception:
                        # the member did not hear the re-send (its own
                        # rebind may be lagging): PARK the rid so the
                        # unrouted sweep re-routes it — a sent+owned
                        # request is otherwise in nobody's recovery
                        # scope (the lease never expires for a beating
                        # member, and the replay nudge only re-emits
                        # COMPLETED records)
                        _dbg(f"ctrl re-send of rid {r.rid} failed")
                        with self._lock:
                            r.sent = False
                            self._unrouted.setdefault(
                                r.rid, time.monotonic() + float(
                                    r.msg.get("timeout_s",
                                              self.request_timeout_s)))
                else:
                    self._route(r)
            sp.set("resent", resent)
        self.metrics.inc("van_rebinds")
        self.metrics.inc("van_rebind_resent", resent)

    def _start_listener(self, slot: int, event_ch: int) -> None:
        old = self._listeners.get(slot)
        if old is not None:
            old[1].set()
        stop = threading.Event()
        t = threading.Thread(
            target=self._event_loop,
            args=(slot, _fenced_chan(event_ch,
                                     self.svc.ctrl_incarnation), stop),
            daemon=True)
        self._listeners[slot] = (t, stop)
        t.start()

    # ---- the controller ledger (durable RAM, O(delta) per change) ----
    def _snapshot(self) -> dict:
        """The full recoverable state — everything a takeover cannot
        re-derive from lease rows or member-side records: rid→member
        ownership, retry budgets, original request messages, half-open
        drains, per-slot channel bases, id high-waters.  Written only
        at COMPACTION (amortized); the per-change path appends O(delta)
        records instead."""
        with self._lock:
            return {
                "rid": self._rid_seq, "cid": self._ctrl_seq,
                "channels": {str(s): list(b)
                             for s, b in self._ch_bases.items()},
                "requests": {str(r.rid): {
                    # an ownership mid-send is NOT journaled (member
                    # None = orphan = the takeover re-routes; if the
                    # send actually landed, the duplicate submit is
                    # absorbed by the rid dedup, token-identically)
                    "msg": r.msg,
                    "member": r.member if r.sent else None,
                    "retries": r.retries}
                    for r in self._requests.values()
                    if not r.done.is_set()},
                "resolved": {str(k): v
                             for k, v in self._resolved.items()},
                "drains": {str(k): dict(v)
                           for k, v in self._drain_journal.items()},
                "autoscaler": dict(self._autoscaler_state)
                if self._autoscaler_state else None,
            }

    # ---- warm autoscaler takeover (the control loop's durable RAM) ----
    def journal_autoscaler(self, state: dict, *,
                           sync: bool = True) -> None:
        """Journal the autoscaler's exported state (streaks, cooldown
        elapsed times, active set) into the ledger alongside accepts.
        ``sync=True`` for ACTION ticks (a lost scale action must not be
        repeated by a cold successor); hold ticks may coalesce — each
        record is a full upsert, so losing one costs staleness, never
        corruption."""
        with self._lock:
            self._autoscaler_state = dict(state)
        rec = {"s": dict(state)}
        if sync:
            self._append_ledger([rec])
        else:
            self._queue_delta(rec)

    def autoscaler_state(self) -> Optional[dict]:
        """The journaled autoscaler state (after a takeover: replayed
        from the ledger) — what a resumed control loop warms up from."""
        with self._lock:
            return dict(self._autoscaler_state) \
                if self._autoscaler_state else None

    def _append_ledger(self, records) -> None:
        """Synchronously journal delta records (accept / drain / spawn
        transitions — the load-bearing writes).  A full delta region
        triggers compaction: the CURRENT state (which already contains
        everything the records describe — state mutates before it
        journals) becomes the new base in one atomic frame, and the
        records are therefore covered without re-append.  The old
        snapshot ledger's refuse-accepts cliff is gone: sustained
        accepts cost O(record) bytes each, plus an amortized O(state)
        compaction."""
        with self._journal_lock:
            self._append_records_locked(list(records))

    def _append_records_locked(self, records) -> None:
        ci = self.svc.ctrl_incarnation
        try:
            try:
                self._ledger.append(records, ctrl_inc=ci)
            except _mb.LedgerCompactionNeeded:
                self._ledger.compact(self._snapshot(), ctrl_inc=ci)
        except _mb.ControllerFenced:
            self._fenced = True
            raise

    def _queue_delta(self, rec: dict) -> None:
        """Coalesced (route/resolve) records: flushed by the poll loop
        in one append frame.  Losing them with the controller is safe
        by the replay's own invariants — an unjournaled owner re-routes
        and the rid dedup absorbs the duplicate; a lost resolution is
        recovered from re-announced ``_done_log`` records — only the
        ACCEPT record is load-bearing for zero loss and stays
        synchronous."""
        with self._lock:
            self._pending_deltas.append(rec)
            self._journal_dirty = True

    def _journal(self) -> None:
        """Flush the coalesced delta queue (poll loop / close).  On
        failure the batch is re-queued AT THE FRONT so per-rid record
        order survives the retry."""
        with self._journal_lock:
            with self._lock:
                batch = self._pending_deltas
                self._pending_deltas = []
                self._journal_dirty = False
            if not batch:
                return
            try:
                self._append_records_locked(batch)
            except Exception:
                with self._lock:
                    self._pending_deltas = batch + self._pending_deltas
                    self._journal_dirty = True
                raise

    def _compact_ledger(self) -> None:
        """One amortized full-state write: at takeover (a fresh base
        under the new incarnation) and proactively from the poll loop
        before the delta region forces it mid-accept."""
        with self._journal_lock:
            with self._lock:
                batch = self._pending_deltas
                self._pending_deltas = []
                self._journal_dirty = False
            # the snapshot subsumes any queued deltas (state mutates
            # before journaling), so the batch just drops
            del batch
            try:
                self._ledger.compact(self._snapshot(),
                                     ctrl_inc=self.svc.ctrl_incarnation)
            except _mb.ControllerFenced:
                self._fenced = True
                raise

    @staticmethod
    def _replay_ledger(got: dict) -> dict:
        """Base snapshot + delta records → the snapshot-shaped state a
        takeover adopts.  Every record application is an idempotent
        upsert, so replay converges whatever the interleaving of
        coalesced flushes and compactions was."""
        state = got.get("state") or {}
        requests = dict(state.get("requests") or {})
        resolved = OrderedDict(state.get("resolved") or {})
        drains = dict(state.get("drains") or {})
        channels = dict(state.get("channels") or {})
        autoscaler = state.get("autoscaler") or None
        rid_seq = int(state.get("rid", 0))
        cid_seq = int(state.get("cid", 0))
        for d in got.get("deltas") or ():
            if "a" in d:
                rid, msg = d["a"]
                rid_seq = max(rid_seq, int(rid))
                requests[str(int(rid))] = {"msg": msg, "member": None,
                                           "retries": 0}
            elif "o" in d:
                rid, member, retries = d["o"]
                rec = requests.get(str(int(rid)))
                if rec is not None:
                    rec["member"] = member
                    rec["retries"] = int(retries)
            elif "r" in d:
                rid, status = d["r"]
                requests.pop(str(int(rid)), None)
                resolved[str(int(rid))] = status
            elif "d" in d:
                xid, rec = d["d"]
                if rec is None:
                    drains.pop(str(xid), None)
                else:
                    drains[str(xid)] = dict(rec)
            elif "c" in d:
                slot, sub, evb = d["c"]
                channels[str(int(slot))] = [int(sub), int(evb)]
            elif "q" in d:
                rid_seq = max(rid_seq, int(d["q"][0]))
                cid_seq = max(cid_seq, int(d["q"][1]))
            elif "s" in d:
                # autoscaler state: each record is a full upsert —
                # the LAST one wins, whatever compaction interleaving
                autoscaler = dict(d["s"])
        while len(resolved) > 1024:
            resolved.popitem(last=False)
        return {"rid": rid_seq, "cid": cid_seq, "channels": channels,
                "requests": requests, "resolved": resolved,
                "drains": drains, "autoscaler": autoscaler}

    def _wait_joined(self, slots, timeout_s: Optional[float] = None) -> None:
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self._spawn_timeout_s)
        want = set(int(s) for s in slots)
        while time.monotonic() < deadline:
            self.poll()
            if want <= set(self.svc.present_slots()):
                return
            time.sleep(0.05)
        raise TimeoutError(f"members {sorted(want)} did not join within "
                           f"the spawn window")

    # ---- wire helpers ----
    def _send(self, slot: int, msg: dict, *, timeout_s: float = 2.0,
              attempts: int = 2, observe_rtt: bool = True) -> None:
        """One ordered control send with bounded retry: same-seq blob
        resend is idempotent, so a transport wobble retries safely; a
        member that stays unreadable (suspended/dead) surfaces as the
        TimeoutError the router treats as 'pick someone else'.

        ``observe_rtt=False`` keeps a send out of the link-health EWMA:
        the fleet scrape uses a deliberately tiny timeout, and letting
        its routine timeout against a momentarily busy member read as
        evidence of a GRAY LINK would open the degrade window — whose
        active probe pings then stall every poll sweep for members
        that were never degraded at all."""
        if self._fenced:
            raise ConnectionError(
                "controller fenced: a newer incarnation owns the fleet")
        ent = self._out.get(slot)
        if ent is None:
            raise ConnectionError(f"member {slot} has no control channel")
        ch, lock, seq = ent
        # every command carries the incarnation: the member-side fence
        # rejects a stale controller's writes wherever they land
        payload = json.dumps(
            {**msg, "ci": self.svc.ctrl_incarnation}).encode()
        t0 = time.monotonic()
        try:
            with lock:
                _mb.control_rpc(
                    lambda: ch.put(payload, seq[0], timeout_s=timeout_s),
                    attempts=attempts, base_s=0.05,
                    op=f"send[{msg.get('cmd')}]", link=f"ctrl->m{slot}",
                    is_transient=lambda e: isinstance(
                        e, (TimeoutError, ConnectionError, RuntimeError)))
                seq[0] += 1
        finally:
            # every control send doubles as a link probe — failures
            # included (a send that burned its whole retry budget is the
            # strongest degradation signal there is)
            if observe_rtt:
                self._observe_rtt(slot, time.monotonic() - t0)

    def _observe_rtt(self, slot: int, rtt_s: float) -> None:
        prev = self._rtt.get(slot)
        ewma = rtt_s if prev is None else 0.7 * prev + 0.3 * rtt_s
        self._rtt[slot] = ewma
        base = self._rtt_floor()
        if base is None:
            return
        if ewma > self._rtt_degraded_x * base:
            if slot not in self._degraded_t0:
                # the degrade window opens: recorded retroactively as a
                # serve.link_degraded span when the link recovers — the
                # recovery event RECOVERY_FOR pairs with fault.netem_degrade
                self._degraded_t0[slot] = trace.now_us()
                self.metrics.inc("links_degraded")
        elif ewma < 2.0 * base:
            t0d = self._degraded_t0.pop(slot, None)
            if t0d is not None:
                trace.complete("serve.link_degraded", t0d,
                               {"member": int(slot),
                                "rtt_ms": round(ewma * 1e3, 3)},
                               cat="serve")
                self.metrics.inc("links_recovered")

    def _rtt_floor(self) -> Optional[float]:
        """The healthiest observed link (EWMA floor) — the baseline a
        degraded link is judged against.  None until measured.  Floored
        at 2ms: on loopback the true RTT is microseconds and any GIL
        hiccup would read as a 5x 'degradation' — a link must be
        MILLISECONDS worse than its peers before it is called gray."""
        if not self._rtt:
            return None
        return max(min(self._rtt.values()), 2e-3)

    def _rtt_penalty(self, slot: int) -> float:
        """Routing penalty in 'equivalent in-flight requests': each
        multiple of the baseline RTT costs like one extra outstanding
        request, capped so a wedged link ranks worst but stays finite
        (a suspect lease, not this penalty, takes it out entirely)."""
        rtt = self._rtt.get(slot)
        base = self._rtt_floor()
        if rtt is None or base is None:
            return 0.0
        return min(max(rtt / base - 1.0, 0.0), 16.0)

    def _event_loop(self, slot: int, event_ch: int,
                    stop: threading.Event) -> None:
        ch = None
        seq = 1
        try:
            while not (stop.is_set() or self._stop.is_set()):
                if ch is None:
                    # bound in-loop, retried: this listener is usually
                    # (re)started by a van-failover rebind, i.e. MID
                    # promotion — a bind that raises once must not kill
                    # the thread, or the member's completions strand in
                    # its event channel until the NEXT failover (which
                    # may never come) while its emitter spins on an
                    # undrained single-slot mailbox
                    try:
                        ch = self._ctrl_chan(event_ch)
                    except Exception:
                        if stop.wait(0.2):
                            break
                        continue
                try:
                    raw = ch.get(seq, timeout_s=0.25)
                except TimeoutError:
                    continue
                except ConnectionError:
                    # a failover raises instantly (VanFailover) until
                    # the rebind replaces this listener: pace the loop
                    time.sleep(0.05)
                    continue
                except RuntimeError:
                    if self._stop.is_set():
                        break
                    time.sleep(0.1)
                    continue
                seq += 1
                try:
                    ev = json.loads(raw)
                except (ValueError, TypeError):
                    continue
                try:
                    self._dispatch_event(slot, ev)
                except Exception:
                    traceback.print_exc()
        finally:
            if ch is not None:
                ch.close()

    def _dispatch_event(self, slot: int, ev: dict) -> None:
        kind = ev.get("type")
        if kind == "done":
            self._on_done(slot, ev)
            return
        if kind == "held":
            with self._held_cv:
                self._held[slot] = max(self._held.get(slot, -1),
                                       int(ev.get("id", 0)))
                self._held_cv.notify_all()
            return
        if kind == "metrics":
            with self._lock:
                self._member_metrics[slot] = ev.get("dump") or {}
                self._metrics_replies[slot] = \
                    self._metrics_replies.get(slot, 0) + 1
                self._scrape_pending.pop(slot, None)
            return
        xfer = self._xfers.get(int(ev.get("xfer", -1)))
        if xfer is not None:
            xfer["events"][kind] = ev
            xfer["evt"].set()

    # ---- fleet metric aggregation ----
    def _retire_member_metrics_locked(self, slot: int) -> None:
        """Caller holds ``self._lock``.  Fold the slot's last dump into
        the retired accumulator before a replacement incarnation's
        first reply overwrites it — counters and histograms only (sums
        stay monotone); a dead process's GAUGE is a stale level with
        nothing to aggregate into."""
        dump = self._member_metrics.pop(slot, None)
        if not dump:
            return
        from hetu_tpu_torch.telemetry.registry import MetricsRegistry
        reg = MetricsRegistry.from_dump(self._retired_metrics)
        reg.merge({k: v for k, v in dump.items()
                   if v.get("type") != "gauge"})
        self._retired_metrics = reg.dump()

    def _drain_busy_slots(self) -> set:
        """Both ends of every active two-phase drain: off-limits to the
        scrape — a scrape frame queued ahead of (or holding the channel
        lock against) recv_migration/drain commands would stretch the
        preemption-critical hand-off for a routine metrics ask."""
        with self._lock:
            busy = set(self._draining)
            for d in self._drain_journal.values():
                busy.add(int(d.get("source", -1)))
                busy.add(int(d.get("target", -1)))
        return busy

    def _scrape_once(self, timeout_s: float = 0.1) -> list:
        """Ask every routable member for a registry dump (replies land
        asynchronously via the event loop).  A scrape is advisory, so
        the wire discipline is strict: VERY short timeout, one attempt,
        failures swallowed, and a member with an UNANSWERED ask is
        skipped until it replies (or a 3 s re-ask window lapses) — a
        put to a frozen member parks the van connection until the
        member reads it, and the single-threaded van would stall every
        other caller (including the lease sweep that is about to
        notice that very freeze) for the whole timeout.  The LAST dump
        stays current for a member that misses rounds."""
        now = time.monotonic()
        busy = self._drain_busy_slots()
        targets = []
        for s in self.svc.alive_slots():
            if not self.svc.state_of(s).healthy or s in busy:
                continue
            pending = self._scrape_pending.get(s)
            if pending is not None and now - pending < 3.0:
                continue  # don't pile blocking puts on a silent member
            targets.append(s)
        for slot in targets:
            self._scrape_pending[slot] = now
            try:
                self._send(slot, {"cmd": "metrics"}, timeout_s=timeout_s,
                           attempts=1, observe_rtt=False)
            except Exception:
                # the ask (very likely) never landed: re-ask after a
                # SHORT window, not the full reply window — a member
                # mid-jit-compile at its first ask would otherwise be
                # excluded from a whole synchronous scrape() budget
                self._scrape_pending[slot] = now - 2.5
        return targets

    def _scrape_guarded(self) -> None:
        try:
            self._scrape_once()
        except Exception:
            traceback.print_exc()
        finally:
            self._scrape_busy.clear()

    def _nudge_stale_guarded(self) -> None:
        """One replay-nudge round (one-shot side thread, like the
        scrape: a wedged member's channel must never stall the lease
        sweep).  For every member owning requests unresolved past
        ``_nudge_after_s``, ask it to re-emit their completion records
        — a no-op for rids still decoding, a recovery for any done
        event lost in transit."""
        try:
            now = time.monotonic()
            busy = self._drain_busy_slots()
            by_slot: dict = {}
            with self._lock:
                for r in self._requests.values():
                    if r.done.is_set() or r.member is None or \
                            not r.sent or r.routed_at is None or \
                            now - r.routed_at < self._nudge_after_s:
                        continue
                    by_slot.setdefault(r.member, []).append(r.rid)
            for slot, rids in by_slot.items():
                if slot in busy or \
                        self.svc.state_of(slot).state != "alive":
                    continue
                try:
                    self._send(slot, {"cmd": "replay", "rids": rids},
                               timeout_s=0.5, attempts=1,
                               observe_rtt=False)
                    self.metrics.inc("completion_replays_asked")
                except Exception:
                    pass  # the lease machinery owns unreachable members
        except Exception:
            traceback.print_exc()
        finally:
            self._nudge_busy.clear()

    def scrape(self, timeout_s: float = 3.0) -> dict:
        """One SYNCHRONOUS scrape: keep asking (under the same
        pending-window discipline as the cadence — a cadence ask
        already in flight counts, it is not re-sent) until every
        routable member has replied SINCE THIS CALL or the budget
        lapses.  Returns ``{slot: dump}`` of everything known —
        including the last dump of members that no longer answer."""
        if self._fenced:
            # fail FAST like every other fenced operation: spinning the
            # full budget on sends a newer incarnation rejects would
            # return pre-fence dumps dressed up as a fresh scrape
            raise ConnectionError(
                "controller fenced: a newer incarnation owns the fleet")
        with self._lock:
            before = dict(self._metrics_replies)
        deadline = time.monotonic() + float(timeout_s)
        while True:
            self._scrape_once()
            # recomputed every sweep: a member that dies (or enters a
            # drain window) mid-scrape drops out instead of pinning the
            # wait on a slot that will not be asked
            busy = self._drain_busy_slots()
            want = [s for s in self.svc.alive_slots()
                    if self.svc.state_of(s).healthy and s not in busy]
            with self._lock:
                done = all(self._metrics_replies.get(s, 0) >
                           before.get(s, 0) for s in want)
            if done or time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        return self.member_metric_dumps

    @property
    def member_metric_dumps(self) -> dict:
        """Last known registry dump per member slot (what the fleet
        export sums).  A SIGKILLed member keeps its final pre-kill
        dump here — and the same record sits in its span stream as the
        ``hetu_metrics`` black box."""
        with self._lock:
            return {s: dict(d) for s, d in self._member_metrics.items()}

    def fleet_metrics(self, *, scrape: bool = True,
                      timeout_s: float = 3.0):
        """ONE fleet-level registry over the whole pool: member
        counters and histograms merged under their own names (a
        counter here is the SUM across members; a histogram percentile
        is computed from summed buckets), member GAUGES under
        ``m<slot>.`` (a level like queue_depth has no fleet-wide sum —
        last-write-wins across members would silently report whichever
        slot merged last), and the controller's own metrics under
        ``ctrl.`` (its ``requests_ok`` and a member's are different
        events — summing them would double-count).  Export with
        ``.write_prometheus(path)`` / ``.prometheus_text()``."""
        from hetu_tpu_torch.telemetry.registry import MetricsRegistry
        if scrape:
            self.scrape(timeout_s=timeout_s)
        reg = MetricsRegistry()
        with self._lock:
            retired = dict(self._retired_metrics)
        reg.merge(retired)  # dead incarnations' counters stay counted
        dumps = self.member_metric_dumps
        for slot in sorted(dumps):
            dump = dumps[slot]
            gauges = {k: v for k, v in dump.items()
                      if v.get("type") == "gauge"}
            reg.merge({k: v for k, v in dump.items()
                       if v.get("type") != "gauge"})
            reg.merge(gauges, prefix=f"m{slot}.")
        reg.merge(self.metrics.registry.dump(), prefix="ctrl.")
        # the controller's own durable-tier health (ledger append/
        # compaction bytes, replication lag, promotions observed) lives
        # in the process-default registry — exported under ctrl. like
        # the rest of its metrics
        from hetu_tpu_torch.telemetry import default_registry
        if self._replica is not None:
            self._replica.export_lag()
        reg.merge({k: v for k, v in default_registry.dump().items()
                   if k.startswith(MemberHarness._DURABLE_TIER_METRICS)},
                  prefix="ctrl.")
        reg.gauge("fleet.members_reporting",
                  help="member slots with a scraped registry dump"
                  ).set(len(dumps))
        reg.gauge("fleet.members_alive").set(len(self.svc.alive_slots()))
        return reg

    def start_health_monitor(self, rules=None, *, interval_s: float = 0.5,
                             history_s: float = 120.0, **rule_kw):
        """Host the live health plane on this controller: a
        :class:`~hetu_tpu_torch.telemetry.health.HealthMonitor` loop over the
        cadence-scraped ``fleet_metrics()`` view plus (when telemetry
        streams are on) a streaming tail of the workdir for the fleet
        doctor's evidence.  ``rules`` defaults to
        :func:`~hetu_tpu_torch.telemetry.health.default_fleet_rules` compiled
        from this pool's ``slo_classes``; ``rule_kw`` (``burn_windows``,
        ``burn_budget``, ``burn_factor``, ``window_s``, ...) tunes that
        compilation — tests and benches shrink the burn windows to
        match runs shorter than five minutes.

        Alert state rides ``fleet_metrics()`` as ``ctrl.health.*``
        (active gauge, fired/resolved counters, doctor verdict count),
        and every transition is a ``health.alert`` instant on this
        process's span stream — alerts are themselves telemetry.
        """
        from hetu_tpu_torch.telemetry.health import (
            HealthMonitor, default_fleet_rules,
        )
        if self.health_monitor is not None:
            raise RuntimeError("health monitor already running")
        if rules is None:
            rules = default_fleet_rules(self._slo_classes, **rule_kw)
        mon = HealthMonitor(
            rules,
            # scrape=False: the poll loop's cadence scrape feeds the
            # dumps — the monitor must never block on a wedged member
            source=lambda: self.fleet_metrics(scrape=False).dump(),
            tail=(self.workdir if self._telemetry_streams else None),
            interval_s=interval_s, history_s=history_s,
            registry=self.metrics.registry)
        self.health_monitor = mon
        mon.start()
        return mon

    def _on_done(self, slot: int, ev: dict) -> None:
        req = self._requests.get(int(ev.get("rid", -1)))
        if req is None or req.done.is_set():
            return  # late duplicate from a failed-over member: first wins
        status = ev.get("status", "error")
        if status in ("error", "shutdown"):
            with self._lock:
                stale = req.member != slot
            if stale:
                return  # an old owner's drain echo; the new owner decides
            if req.retries < self.max_retries:
                # the member failed the request without serving it (engine
                # death drain, poisoned admission): fold re-prefill on a
                # peer = resubmit the original record elsewhere
                req.retries += 1
                self.metrics.inc("requests_rerouted")
                self._route(req, exclude={slot})
                return
        self._resolve(req, status, tokens=ev.get("tokens", ()),
                      ttft_s=ev.get("ttft_s"))

    def _resolve(self, req: PoolRequest, status: str, *, tokens=(),
                 ttft_s=None) -> None:
        t0 = trace.now_us()
        with self._lock:
            if req.done.is_set():
                return
            if req.member is not None:
                self._inflight[req.member] = max(
                    self._inflight.get(req.member, 1) - 1, 0)
            req.tokens = [int(t) for t in tokens]
            req.status = status
            req.ttft_s = ttft_s
            req.done.set()
            # evict: a long-lived controller must not retain every
            # completed request forever (a late duplicate completion
            # for an evicted rid is simply ignored by _on_done)
            self._requests.pop(req.rid, None)
            self._resolved[req.rid] = status
            while len(self._resolved) > 1024:
                self._resolved.popitem(last=False)
        self.metrics.inc(f"requests_{status}")
        tenant = req.msg.get("tenant")
        if tenant:
            self.metrics.note_tenant(tenant, f"requests_{status}")
            if status == "shed":
                self.metrics.note_tenant(tenant, "shed")
        if ttft_s is not None:
            self.metrics.observe_ttft(float(ttft_s), tenant=tenant)
        # the terminal leg of the rid's causal chain (a SPAN, not an
        # instant: the fleet stitcher binds flow arrows to slices)
        trace.complete("serve.resolve",
                       t0, {"rid": req.rid, "status": status},
                       cat="serve")
        # resolution journaling is COALESCED (flushed by the poll loop
        # as one multi-record append): losing it with the controller is
        # safe — a resolution is recovered from the members'
        # re-announced ``_done_log`` records, token-identically — while
        # the accept record (the zero-loss contract) stays synchronous.
        self._queue_delta({"r": [req.rid, status]})

    # ---- routing ----
    def _routable(self, exclude=()) -> list:
        alive = set(self.svc.alive_slots())
        with self._lock:
            return [s for s in alive
                    if s not in exclude and s not in self._draining
                    and s not in self._quarantined
                    and s not in self._binding
                    and self.svc.state_of(s).healthy]

    def _route(self, req: PoolRequest, *, exclude=None) -> None:
        exclude = set(exclude or ())
        while True:
            with self._lock:
                cands = self._routable(exclude)
                if not cands:
                    break
                # least-loaded, where "load" counts both outstanding
                # requests AND the link penalty: a member behind a
                # degraded link serves fewer requests per unit time, so
                # its slower wire is priced like extra queue depth
                slot = min(cands,
                           key=lambda s: self._inflight.get(s, 0) +
                           self._rtt_penalty(s))
                prev = req.member
                req.member = slot
                req.sent = False
                self._inflight[slot] = self._inflight.get(slot, 0) + 1
                if prev is not None:
                    self._inflight[prev] = max(
                        self._inflight.get(prev, 1) - 1, 0)
                self._routing[slot] = self._routing.get(slot, 0) + 1
            try:
                try:
                    self._send(slot, {"cmd": "submit", "rid": req.rid,
                                      **req.msg})
                finally:
                    with self._lock:
                        self._routing[slot] -= 1
                        self._routing_cv.notify_all()
                req.sent = True
                req.routed_at = time.monotonic()
                trace.instant("serve.route",
                              {"rid": req.rid, "member": int(slot)},
                              cat="serve")
                # ownership journaling is coalesced like resolutions:
                # by the replay's own invariant, losing it is safe —
                # an unjournaled owner reads member=None, the takeover
                # re-routes, and the duplicate submit is absorbed by
                # the rid dedup token-identically.  Only the ACCEPT
                # record is load-bearing for zero loss.
                self._queue_delta({"o": [req.rid, int(slot),
                                         req.retries]})
                with self._lock:
                    self._unrouted.pop(req.rid, None)
                return
            except Exception as e:
                _fleet_event("route.send_fail",
                             {"rid": req.rid, "member": int(slot),
                              "error": f"{type(e).__name__}: {e}"})
                with self._lock:
                    self._inflight[slot] = max(
                        self._inflight.get(slot, 1) - 1, 0)
                    req.member = None
                exclude.add(slot)
        _fleet_event("route.park",
                     {"rid": req.rid,
                      "exclude": sorted(int(s) for s in exclude),
                      "states": [[int(m.slot), m.state,
                                  m.suspect_reason]
                                 for m in self.svc.members]})
        # no routable member RIGHT NOW (every member suspect during a
        # durable-tier failover's blind window, a mid-rebind wire, the
        # whole fleet draining): the request is JOURNALED, so it must
        # resolve, not error out — park it and let the poll loop
        # re-route once somebody is routable again.  Only outliving
        # its own deadline turns the outage into an error.
        with self._lock:
            if req.rid not in self._unrouted:
                self._unrouted[req.rid] = time.monotonic() + float(
                    req.msg.get("timeout_s", self.request_timeout_s))
        self.metrics.inc("requests_routing_deferred")

    def submit(self, prompt, *, max_tokens: int = 16, eos_id=None,
               timeout_s: Optional[float] = None,
               tenant: Optional[str] = None,
               slo: Optional[str] = None) -> PoolRequest:
        rid = self._next_rid()
        msg = {"prompt": [int(t) for t in prompt],
               "max_tokens": int(max_tokens), "eos_id": eos_id,
               "timeout_s": float(timeout_s if timeout_s is not None
                                  else self.request_timeout_s)}
        if tenant is not None:
            # the tenant tag rides the wire into the member (span args)
            # and the journal (a takeover keeps the attribution)
            msg["tenant"] = str(tenant)
        if slo is not None:
            # the SLO class name rides the same way — the member
            # scheduler maps it to (priority, weight) from its spawn
            # config's slo_classes; an unknown name is best-effort
            msg["slo"] = str(slo)
        req = PoolRequest(rid, msg)
        # the controller-side head of the rid's causal chain: the fleet
        # stitcher links this span to the member-side serve.request and
        # the terminal serve.resolve by the shared rid arg
        attrs = {"rid": rid}
        if tenant is not None:
            attrs["tenant"] = str(tenant)
        with trace.span("serve.submit", attrs, cat="serve"):
            with self._lock:
                self._requests[rid] = req
            # accepted ⇒ durable, BEFORE routing: once this ONE delta
            # record lands, a controller death at ANY later point still
            # resolves the request (the zero-lost-accepted-requests
            # contract).  O(record) bytes — not a full snapshot — so
            # sustained accepts never hit a capacity cliff (a full
            # delta region compacts and continues).  A journal failure
            # still REFUSES the accept.
            try:
                self._append_ledger([{"a": [rid, msg]}])
            except Exception:
                with self._lock:
                    self._requests.pop(rid, None)
                raise
            self.metrics.inc("pool_requests")
            self.metrics.note_tenant(tenant, "requests")
            self._route(req)
        return req

    def generate(self, prompt, *, max_tokens: int = 16, eos_id=None,
                 timeout_s: Optional[float] = None,
                 tenant: Optional[str] = None,
                 slo: Optional[str] = None) -> dict:
        req = self.submit(prompt, max_tokens=max_tokens, eos_id=eos_id,
                          timeout_s=timeout_s, tenant=tenant, slo=slo)
        # generous backstop over the serving deadline: a failover or a
        # suspended-then-resumed member must not strand the waiter
        if not req.done.wait(timeout=req.msg["timeout_s"] + 30.0):
            self._resolve(req, "timeout")
        return {"id": req.rid, "status": req.status or "ok",
                "tokens": list(req.tokens), "ttft_s": req.ttft_s}

    # ---- membership / failover ----
    def _sweep_unrouted(self) -> None:
        """Re-route parked requests once somebody is routable again;
        only a request that outlived its own deadline errors out."""
        with self._lock:
            items = list(self._unrouted.items())
        if not items:
            return
        now = time.monotonic()
        for rid, deadline in items:
            with self._lock:
                req = self._requests.get(rid)
            if req is None or req.done.is_set():
                with self._lock:
                    self._unrouted.pop(rid, None)
                continue
            if now > deadline:
                with self._lock:
                    self._unrouted.pop(rid, None)
                self._resolve(req, "error")
                self.metrics.inc("requests_rejected_no_member")
            elif self._routable():
                # the entry is NOT popped first: a failed route re-park
                # (setdefault) must keep the ORIGINAL deadline, or a
                # request could outlive its own budget forever while
                # members are alive but unreachable
                self._route(req)

    def _poll_loop(self, poll_s: float) -> None:
        while not self._stop.wait(poll_s):
            try:
                self.poll()
            except Exception:
                traceback.print_exc()  # the poll must survive anything
            # the durable tier failed over: rebind channels + re-send
            # unresolved submits (the poll loop owns channel surgery)
            if self._van_rebind_pending and not self._fenced:
                try:
                    self._van_rebind()
                except Exception:
                    traceback.print_exc()
                    self._van_rebind_pending = True  # retry next sweep
            try:
                self._sweep_unrouted()
            except Exception:
                traceback.print_exc()
            # fleet scrape on its cadence: triggered here (the poll loop
            # is the controller's one clock) but RUN in a one-shot side
            # thread — a member whose control channel is wedged must
            # stall the scrape, never the lease state machine
            if self._scrape_s > 0 and not self._fenced and \
                    time.monotonic() - self._last_scrape >= \
                    self._scrape_s and not self._scrape_busy.is_set():
                self._last_scrape = time.monotonic()
                self._scrape_busy.set()
                threading.Thread(target=self._scrape_guarded,
                                 daemon=True).start()
            if not self._fenced and \
                    time.monotonic() - self._last_nudge >= \
                    self._nudge_after_s and \
                    not self._nudge_busy.is_set():
                self._last_nudge = time.monotonic()
                self._nudge_busy.set()
                threading.Thread(target=self._nudge_stale_guarded,
                                 daemon=True).start()
            if self._journal_dirty and not self._fenced:
                try:
                    self._journal()
                except Exception:
                    traceback.print_exc()  # stays dirty; retried next
                    # sweep
            # proactive compaction: one amortized O(state) frame on the
            # poll thread beats paying it inside an accept
            if not self._fenced and self._ledger.needs_compaction(
                    margin_rows=max(
                        self._ledger.delta_capacity_rows() // 4, 16)):
                try:
                    self._compact_ledger()
                except Exception:
                    traceback.print_exc()

    def poll(self) -> int:
        """One membership sweep; returns how many members failed over.
        Serialized by ``_poll_lock``: the background poll thread and
        direct callers (``revive_member``'s join wait, tests) share one
        lease state machine."""
        with self._poll_lock:
            return self._poll_locked()

    def _poll_locked(self) -> int:
        # a durable-tier failover stalls every member's beats while the
        # pair promotes: grant the lease grace BEFORE this sweep so the
        # window never reads as member silence (and a loss that still
        # slips through is forgiven once the member's beats resume)
        if self._replica is not None and \
                self._replica.incarnation != self._mb_van_seen:
            self._mb_van_seen = self._replica.incarnation
            self.svc.note_van_failover()
        try:
            events = self.svc.poll()
        except _mb.ControllerFenced:
            # a newer incarnation owns the fleet: this controller is a
            # zombie — stop acting, refuse every further write, and let
            # the operator loop (controller_main) exit cleanly WITHOUT
            # touching the members it no longer owns
            self._fenced = True
            self.metrics.inc("controller_fenced")
            return 0
        n = 0
        if events:
            states = [[int(m.slot), m.state] for m in self.svc.members]
            for kind, slot in events:
                _fleet_event("membership.event",
                             {"kind": str(kind), "member": int(slot),
                              "states": states})
        for kind, slot in events:
            if kind == "suspect":
                self._suspect_t0[slot] = trace.now_us()
                self.metrics.inc("members_suspected")
            elif kind == "clear":
                t0 = self._suspect_t0.pop(slot, None)
                if t0 is not None:
                    # the retroactive recovery span: the partition HEALED
                    # — no loss, no rejoin, just a measured outage window
                    trace.complete("serve.member_suspect", t0,
                                   {"member": int(slot)}, cat="serve")
                self.metrics.inc("members_suspect_cleared")
            elif kind == "lost":
                self._suspect_t0.pop(slot, None)
                self.failover(slot)
                n += 1
            elif kind in ("join", "rejoin"):
                with self._lock:
                    self._quarantined.discard(slot)
                    self._draining.discard(slot)
                if kind == "rejoin":
                    self.metrics.inc("members_rejoined")
            elif kind == "left":
                with self._lock:
                    self._draining.discard(slot)
        # a live process whose ENGINE died reports healthy=0 in its
        # heartbeat: its queue drains 'error' member-side (each request
        # re-routes via its completion event), but stop routing NEW work
        # at it immediately
        for slot in self.svc.alive_slots():
            if not self.svc.state_of(slot).healthy and \
                    slot not in self._quarantined:
                with self._lock:
                    self._quarantined.add(slot)
                self.metrics.inc("members_engine_dead")
        # active link probe for DEGRADED slots: routing steers traffic
        # away from them, so without a probe no send would ever observe
        # the recovery and the degrade window would never close.  The
        # ping is a no-op command; its put waits on the member's ack of
        # the previous frame, so it measures the member's real read path
        for slot in list(self._degraded_t0):
            if self.svc.state_of(slot).state in ("alive", "suspect"):
                try:
                    self._send(slot, {"cmd": "ping"}, timeout_s=0.5,
                               attempts=1)
                except Exception:
                    pass  # the failure itself updated the RTT EWMA
        return n

    # ---- network-plane chaos (ps/netem.py over the command wire) ----
    def apply_net_fault(self, kind: str, member_idx: int,
                        duration_s: float = 1.0) -> None:
        """Route an injected network fault at a member by index:
        ``netem_partition`` = one-way EGRESS partition (the member's
        beats and completions black-hole; it still hears us — the
        asymmetric case), ``netem_degrade`` = gray link both ways
        (loss + latency + bandwidth cap).  Policies carry
        ``duration_s`` and heal themselves member-side — a heal
        command could not cross a cut link."""
        slot = int(member_idx) % self.n_members
        if kind == "netem_partition":
            msg = {"cmd": "netem", "direction": "egress",
                   "policy": {"partition": True,
                              "duration_s": float(duration_s)}}
        elif kind == "netem_degrade":
            msg = {"cmd": "netem", "direction": "both",
                   "policy": {"latency_s": 0.05, "jitter_s": 0.05,
                              "drop_p": 0.05, "rate_mbps": 50.0,
                              "duration_s": float(duration_s)}}
        else:
            raise ValueError(f"unknown net fault kind {kind!r}")
        self.metrics.inc(f"{kind}s_applied")
        self._send(slot, msg)

    def run_net_events(self, events) -> None:
        """Apply events drained from ``FaultInjector.pop_net_events()``
        — prefer draining with ``kinds=("netem_partition",
        "netem_degrade")`` so a mixed schedule's ``straggler`` events
        stay queued for the training supervisor that owns them; any
        straggler event handed here anyway is left untouched."""
        for kind, idx, duration_s in events:
            if kind == "straggler":
                continue
            self.apply_net_fault(kind, idx, duration_s)

    def failover(self, slot: int) -> int:
        """The member process is gone (lease expired past the suspect
        grace): every outstanding request re-routes to a survivor, which
        re-prefills from the original prompt — the cross-process fold
        (the dead process took the emitted tokens with it, and greedy
        decode regenerates them exactly)."""
        slot = int(slot)
        with self._lock:
            if slot in self._quarantined:
                return 0  # already failed over (engine-dead path)
            self._quarantined.add(slot)
            pending = [r for r in self._requests.values()
                       if r.member == slot and not r.done.is_set()]
        with trace.span("serve.failover", cat="serve") as sp:
            sp.set("member", slot)
            for req in pending:
                self._route(req, exclude={slot})
            sp.set("requests", len(pending))
        p = self.procs[slot]
        if p is not None and p.poll() is None:
            pass  # suspended-past-grace: declared lost but still exists;
            # revive_member replaces it (and reaps) if the operator asks
        self.metrics.inc("pool_failovers")
        self.metrics.inc("requests_failed_over", len(pending))
        return len(pending)

    # ---- planned drain (cross-process live migration) ----
    def _drain_begin(self, slot: int, target: int, *, codec: str,
                     close: bool, timeout_s: float) -> tuple:
        """The BEGIN phase of a two-phase drain, shared by
        :meth:`drain_member` and the chaos harness (which dies with the
        drain half-open on purpose): allocate the migrate channel,
        journal, recv_migration → mig_ready → drain.  Returns
        ``(xid, xfer)``; a failure inside rolls back its own journal
        record and xfer registration before re-raising.

        Migrate channels are incarnation-keyed like the command
        channels: the van outlives controllers, and a takeover's
        process-local ``_MIG_SEQ`` restarts — an un-keyed id could
        rebind a dead drain's channel, whose slot still holds an
        unconsumed frame at foreign seqs.  The half-open record is
        journaled BEFORE the first command: a controller death anywhere
        inside the two-phase window leaves a record its successor
        ABORTS back to a serving source (zero request loss)."""
        xid = next(_xfer_ids)
        xfer = {"evt": threading.Event(), "events": {}}
        self._xfers[xid] = xfer
        ch = _fenced_chan(CROSSHOST_MIGRATE_BASE + next(_MIG_SEQ),
                          self.svc.ctrl_incarnation)
        try:
            rec = {"source": int(slot), "target": int(target), "ch": ch,
                   "codec": codec, "state": "begin", "close": bool(close)}
            with self._lock:
                self._drain_journal[str(xid)] = rec
            self._append_ledger([{"d": [xid, rec]}])
            self._send(target, {"cmd": "recv_migration", "ch": ch,
                                "xfer": xid, "timeout_s": timeout_s})
            self._await_xfer(xfer, ("mig_ready",), timeout_s)
            self._send(slot, {"cmd": "drain", "ch": ch, "xfer": xid,
                              "codec": codec, "timeout_s": timeout_s})
        except Exception:
            self._xfers.pop(xid, None)
            with self._lock:
                dropped = self._drain_journal.pop(str(xid),
                                                  None) is not None
            if dropped:
                try:  # journal the rollback too (best effort — a
                    # takeover aborting a long-dropped record is benign)
                    self._append_ledger([{"d": [xid, None]}])
                except Exception:
                    traceback.print_exc()
            raise
        return xid, xfer

    def drain_member(self, slot: int, *, codec: Optional[str] = None,
                     close: bool = True, target: Optional[int] = None,
                     timeout_s: float = 60.0) -> int:
        """Two-phase planned drain: the source process exports its live
        KV slots + request records over the migrate wire, the target
        adopts, and only the target's confirmation releases the source
        (which then leaves cleanly and, with ``close``, exits).  Any
        failure before the commit aborts back to a still-serving source.
        Returns the number of requests migrated.

        ``codec`` overrides the pool default for THIS drain (a
        preemption-deadline drain picks "int8"; routine drains stay
        lossless)."""
        slot = int(slot)
        codec = self.migrate_codec if codec is None \
            else _migrate.check_codec(codec)
        if codec == "auto":
            codec = self._resolve_auto_codec(slot)
        with self._lock:
            if slot in self._draining or slot in self._quarantined:
                return 0
            self._draining.add(slot)
            # a submit routed here before the slot was marked draining
            # must be on the member's channel before the drain command:
            # the member reads its channel in order, so the export
            # carries the request.  Put after the drain, it would be
            # read by a member that has already exported (or has left)
            self._routing_cv.wait_for(
                lambda: not self._routing.get(slot), timeout_s)
        xid = None
        try:
            with trace.span("serve.migrate", cat="serve") as sp:
                sp.set("member", slot)
                if target is None:
                    cands = self._routable({slot})
                    if not cands:
                        raise RuntimeError(
                            f"no surviving peer to drain member {slot} "
                            f"into")
                    target = min(cands,
                                 key=lambda s: self._inflight.get(s, 0))
                sp.set("target", int(target))
                xid, xfer = self._drain_begin(
                    slot, int(target), codec=codec, close=close,
                    timeout_s=timeout_s)
                ev = self._await_xfer(
                    xfer, ("adopted", "adopt_failed", "drain_failed"),
                    timeout_s)
                if ev.get("type") != "adopted":
                    # roll the source back before surfacing the failure
                    try:
                        self._send(slot, {"cmd": "drain_abort",
                                          "xfer": xid})
                    except Exception:
                        traceback.print_exc()
                    raise RuntimeError(
                        f"cross-process drain failed: {ev.get('error', ev)}")
                n = int(ev.get("n", 0))
                # evidence for callers/tests: how many LIVE KV slots the
                # peer adopted (mid-decode continuations, zero re-prefill)
                self.last_drain = {"source": slot, "target": int(target),
                                   "requests": n,
                                   "slots": int(ev.get("slots", 0)),
                                   "queued": [int(r) for r in
                                              ev.get("queued", ())],
                                   "codec": codec}
                # the hand-off is real: re-home the outstanding rids so
                # the target's completion events find their requests
                with self._lock:
                    moved = [r for r in self._requests.values()
                             if r.member == slot and not r.done.is_set()]
                    for r in moved:
                        r.member = int(target)
                    self._inflight[int(target)] = \
                        self._inflight.get(int(target), 0) + len(moved)
                    self._inflight[slot] = 0
                self._send(slot, {"cmd": "drain_commit", "xfer": xid,
                                  "exit": bool(close)})
                with self._lock:
                    self._drain_journal.pop(str(xid), None)
                self._append_ledger([{"d": [xid, None]}])
                sp.set("requests", n)
        except Exception:
            with self._lock:
                self._draining.discard(slot)
                if xid is not None:
                    self._drain_journal.pop(str(xid), None)
            try:
                if xid is not None:
                    self._append_ledger([{"d": [xid, None]}])
            except Exception:
                traceback.print_exc()
            raise
        finally:
            if xid is not None:
                self._xfers.pop(xid, None)
        if close:
            p = self.procs[slot]
            if p is not None:
                try:
                    p.wait(timeout=10.0)
                except Exception:
                    p.kill()
        else:
            # the emptied member keeps serving (it never left the
            # blackboard): put it back in the routing set now
            with self._lock:
                self._draining.discard(slot)
        self.metrics.inc("pool_migrations")
        self.metrics.inc("requests_migrated", n)
        return n

    def _resolve_auto_codec(self, slot: int) -> str:
        """Controller-side ``codec="auto"`` resolution (the member's
        live token lengths are across a process boundary, so the
        payload is ESTIMATED from the model spec and the slot's
        outstanding requests — each assumed halfway through
        ``max_len``); the link rate is this process's best evidence
        (:func:`hetu_tpu_torch.serve.migrate.known_link_mbps`: a netem cap,
        else a previously observed BULK transfer — never the tiny
        ack-paced control frames, whose bytes/latency ratio reads
        orders of magnitude below the real wire).  No evidence resolves
        to "none": on an unmeasured link, compression is a bet, not a
        measurement."""
        m = self.model
        dtype = _DTYPES[str(m["dtype"])]
        head_dim = int(m["hidden_size"]) // int(m["num_heads"])
        per_tok = 2 * int(m["num_heads"]) * head_dim * \
            (2 if dtype == "bfloat16" else 4)  # K+V in the cache's type
        tokens = max(self._inflight.get(slot, 0), 1) * \
            int(m["max_len"]) // 2
        payload = tokens * int(m["num_layers"]) * per_tok
        return _migrate.pick_codec(_migrate.known_link_mbps(),
                                   payload, dtype)

    @staticmethod
    def _await_xfer(xfer: dict, kinds, timeout_s: float) -> dict:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for k in kinds:
                ev = xfer["events"].get(k)
                if ev is not None:
                    return ev
            xfer["evt"].wait(0.05)
            xfer["evt"].clear()
        raise TimeoutError(f"no {kinds} event within {timeout_s}s")

    # ---- the member hold (a port departure: tests, chip_smoke.py) ----
    def hold_member(self, slot: int, *, after: int = 0) -> int:
        """Park member ``slot``'s engine ``after`` decode rounds from now
        (0: its next round; a round parked now goes first).  Returns the
        hold's id, which the member reports once parked
        (:meth:`wait_held`).  Requests submitted before the hold are
        admitted by the round it parks at."""
        slot = int(slot)
        with self._held_cv:
            hid = self._hold_ids[slot] = self._hold_ids.get(slot, 0) + 1
        self._send(slot, {"cmd": "hold", "after": int(after), "id": hid})
        return hid

    def release_member(self, slot: int) -> None:
        """End member ``slot``'s hold (a parked round goes)."""
        self._send(int(slot), {"cmd": "release"})

    def wait_held(self, slots, *, at_least: Optional[int] = None,
                  timeout_s: float = 60.0) -> bool:
        """Block until each of ``slots`` has reported parked at a hold of
        id ``at_least`` or later (default: the last one sent to it; 0
        waits for the spec's ``hold_at``), or ``timeout_s`` elapses;
        returns whether they did."""
        slots = [int(s) for s in slots]
        with self._held_cv:
            want = {s: self._hold_ids.get(s, 0) if at_least is None
                    else int(at_least) for s in slots}
            return self._held_cv.wait_for(
                lambda: all(self._held.get(s, -1) >= want[s]
                            for s in slots), float(timeout_s))

    # ---- membership operations ----
    def revive_member(self, slot: int) -> None:
        """Replace a lost/drained member with a FRESH process on the
        same slot (new incarnation, new control channels); it rejoins
        routing once its first heartbeat lands."""
        slot = int(slot)
        p = self.procs[slot]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        elif slot in self._member_pids:
            # a takeover-adopted member (the dead controller's child):
            # the pid is the only handle
            try:
                os.kill(self._member_pids[slot], _signal.SIGKILL)
            except OSError:
                pass
        with self._lock:
            self._binding.add(slot)
        try:
            self._spawn([slot])
            self._wait_joined([slot])
        finally:
            with self._lock:
                self._binding.discard(slot)
        with self._lock:
            self._quarantined.discard(slot)
            self._draining.discard(slot)
        self.metrics.inc("members_revived")

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(int(pid), 0)
            return True
        except OSError:
            return False

    # ---- lifecycle ----
    def close(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self.health_monitor is not None:
            try:
                self.health_monitor.stop()
            except Exception:
                pass
            self.health_monitor = None
        if self._replica is not None:
            self._replica.unregister(self._on_van_failover)
        t = getattr(self, "_poll_thread", None)
        if t is not None:
            t.join(timeout_s)
        if self._journal_dirty and not self._fenced:
            try:
                self._journal()  # flush coalesced resolutions
            except Exception:
                traceback.print_exc()
        if not self._fenced:
            # a FENCED zombie does not own these members anymore: no
            # shutdown commands, no kills — the new incarnation does
            for slot in range(self.n_members):
                try:
                    self._send(slot, {"cmd": "shutdown"}, timeout_s=0.5,
                               attempts=1)
                except Exception:
                    pass
        for _, (th, stop) in list(self._listeners.items()):
            stop.set()
        deadline = time.monotonic() + 5.0
        if not self._fenced:
            for p in self.procs:
                if p is None:
                    continue
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except Exception:
                    p.kill()
                    p.wait()
            # takeover-adopted members have no Popen handle — wait for
            # their pids to honor the shutdown command, then SIGKILL
            # stragglers (they were reparented when their spawner died,
            # so there is no zombie-reap concern here)
            for slot, pid in list(self._member_pids.items()):
                while self._pid_alive(pid) and \
                        time.monotonic() < deadline:
                    time.sleep(0.05)
                if self._pid_alive(pid):
                    try:
                        os.kill(pid, _signal.SIGKILL)
                    except OSError:
                        pass
        for slot, ent in list(self._out.items()):
            try:
                ent[0].close()
            except Exception:
                pass
        for obj in (getattr(self, "_bb", None),
                    getattr(self, "_ledger", None)):
            if obj is not None:
                try:
                    obj.close()
                except Exception:
                    pass
        if self._own_van:
            self._van.stop()


# ---------------------------------------------------------------------------
# controller process harness (the chaos kill target)
# ---------------------------------------------------------------------------

def _begin_drain_and_hang(pool: CrossProcessServingPool, *,
                          timeout_s: float = 30.0) -> None:
    """Chaos-harness helper: START a two-phase drain (recv_migration +
    drain sent, journaled half-open) and then hang forever — the
    controller 'dies' with the drain half-exported; only a SIGKILL ends
    this process.  The takeover must abort the drain back to a
    still-serving source with zero request loss."""
    with pool._lock:
        src = max(range(pool.n_members),
                  key=lambda s: pool._inflight.get(s, 0))
        tgt = min((s for s in range(pool.n_members) if s != src),
                  key=lambda s: pool._inflight.get(s, 0))
        pool._draining.add(src)
        pool._routing_cv.wait_for(lambda: not pool._routing.get(src),
                                  timeout_s)
    pool._drain_begin(src, tgt, codec="none", close=True,
                      timeout_s=timeout_s)
    print("DRAIN_SENT", flush=True)
    while True:
        time.sleep(3600)


def controller_main(config_path: str) -> int:
    """Entry point for a spawned CONTROLLER process: build the pool
    against an EXTERNAL van (the durable tier must outlive this
    process — that is the whole point), submit a seeded request stream,
    and hold.  The chaos harness SIGKILLs/SIGSTOPs this process; its
    log carries the progress markers (``ACCEPTED k`` per accept,
    ``ALLDONE``, ``DRAIN_SENT``, ``FENCED``) the harness keys on.  A
    fenced wake-up (SIGSTOP → takeover → SIGCONT) exits WITHOUT
    touching the members the new incarnation owns."""
    cfg = json.loads(open(config_path).read())
    # the controller's own flight recorder, next to its members' (the
    # chaos harness SIGKILLs this process too — its accepted-request
    # spans must survive for the merged post-mortem)
    trace.open_process_stream(cfg["workdir"],
                              f"controller_p{os.getpid()}")
    pool = CrossProcessServingPool(
        int(cfg.get("n_members", 2)), workdir=cfg["workdir"],
        model=cfg.get("model"), port=int(cfg["port"]), own_van=False,
        hb_ms=int(cfg.get("hb_ms", 80)),
        lease_s=float(cfg.get("lease_s", 0.6)),
        suspect_grace_s=float(cfg.get("suspect_grace_s", 0.5)),
        request_timeout_s=float(cfg.get("request_timeout_s", 120.0)),
        deaf_ack_s=cfg.get("deaf_ack_s"),
        van_spec=cfg.get("van"), member_env=cfg.get("member_env"))
    print("READY", f"jax={int('jax' in sys.modules)}", flush=True)
    try:
        ac = cfg.get("autoscale")
        if ac:
            # a controller-kill target: make >= 1 JOURNALED scale
            # decision before the harness SIGKILLs this process, so a
            # takeover can show the successor resumes the loop's RAM
            # warm (no duplicate action)
            from hetu_tpu_torch.traffic.autoscale import (AutoscalePolicy,
                                                          Autoscaler)
            for s in ac.get("park", []):
                pool.drain_member(int(s), close=True)
            scaler = Autoscaler(
                pool, AutoscalePolicy(**ac["policy"]),
                active={int(s) for s in ac.get("active", [0])})
            for _ in range(int(ac.get("ticks", 1))):
                rec = scaler.tick()
                print(f"SCALED {rec['action']} {rec.get('slot', -1)}",
                      flush=True)
                time.sleep(float(ac.get("tick_gap_s", 0.1)))
        prompts = seeded_prompts(
            int(cfg.get("n_requests", 8)),
            int(cfg.get("prompt_seed", 0)),
            vocab=int(pool.model["vocab_size"]))
        gap = float(cfg.get("submit_gap_s", 0.05))
        drain_at = cfg.get("drain_at")
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(pool.submit(
                p, max_tokens=int(cfg.get("max_tokens", 24))))
            print(f"ACCEPTED {len(reqs)}", flush=True)
            if drain_at is not None and i + 1 == int(drain_at):
                _begin_drain_and_hang(pool)  # never returns
            time.sleep(gap)
        if cfg.get("wait_held"):
            # the members were spawned with a hold: every one of them is
            # parked at its decode round with its requests in flight
            if pool.wait_held(range(pool.n_members), at_least=0,
                              timeout_s=float(cfg.get("deadline_s",
                                                      300.0))):
                print("ALLHELD", flush=True)
        deadline = time.monotonic() + float(cfg.get("deadline_s",
                                                    300.0))
        while any(not r.done.is_set() for r in reqs) and \
                not pool.fenced and time.monotonic() < deadline:
            time.sleep(0.05)
        if not pool.fenced:
            print("ALLDONE", flush=True)
        hold_until = time.monotonic() + float(cfg.get("hold_s", 0.0))
        while time.monotonic() < hold_until and not pool.fenced:
            time.sleep(0.05)
    except _mb.ControllerFenced:
        pool._fenced = True  # fence mid-submit/mid-drain: exit below
    if pool.fenced:
        print("FENCED", flush=True)
        pool.close()  # fenced close: channels only, members untouched
        return 3
    pool.close()
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--controller":
        sys.exit(controller_main(sys.argv[2]))
    sys.exit(member_main(sys.argv[1]))
