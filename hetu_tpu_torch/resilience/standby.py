"""Self-promoting standby controllers: takeover without an operator
(counterpart of ``hetu_tpu/resilience/standby.py``).

Every controller of a fleet is killable, but a takeover has to be
invoked: somebody must notice the dead controller and call
``takeover()``.  A :class:`StandbyController` attaches to the fleet's
blackboard, watches the CONTROLLER row's beat exactly the way members
do, and when the beat stays silent past the lease bound it promotes
ITSELF — a single-shot van-side CAS on the controller row's incarnation
field decides the race, so of N standbys watching one fleet exactly one
wins (the losers observe the winner's incarnation in the CAS response
and exit FENCED, touching nothing).  The winner then invokes the
plane's ``takeover()`` classmethod
(:class:`~hetu_tpu_torch.serve.crosshost.CrossProcessServingPool`,
:class:`~hetu_tpu_torch.resilience.multicontroller.
MultiControllerElasticSupervisor`,
:class:`~hetu_tpu_torch.parallel.mpmd_elastic.MPMDPipelineSupervisor`),
which claims the fence one higher
again and adopts the fleet — the standby adds only the WATCHING and the
CAS-decided right to act.

Why the pre-claim is single-shot where ``claim_controller``'s CAS loop
retries: a retrying loser would out-claim the winner mid-takeover (two
controllers adopting one fleet); a standby that LOSES the claim must
stand down, not escalate.  The pre-claim writes ``beat=1`` under the new
incarnation, so members' silence clocks restart immediately — the fleet
knows a successor exists before the (slower) adoption finishes.

The ``standby_main`` harness runs this as its own process
(``python -m hetu_tpu_torch.resilience.standby <config.json>``; markers
``READY`` → ``WATCHING`` → ``PROMOTED``/``FENCED`` → ``RESOLVED`` →
``ALLDONE``), with a crash-durable span stream like every other fleet
process.

Departures from the reference: the READY line says whether the process
loaded ``jax`` and ``torch``; ``WATCHING`` is printed once the watch
starts; ``PROMOTED`` carries the seconds from the detected silence to
the end of the takeover and ``ALLDONE`` the seconds from ``PROMOTED``.
On the elastic plane the promoted standby drives the adopted fleet to
its last step, checks the consumed batches' complete cover and prints
``RESOLVED`` with the takeover report and the resizes before
``ALLDONE``; on the mpmd plane it drives the adopted pipeline to its
last step, waits for the stages to leave and prints ``RESOLVED`` with
the takeover report, the replacements and a digest of each stage's
final parameters.  The reference prints ``ALLDONE`` at once and its
close then kills the workers or stages it has just adopted.  The claim's
bridge thread is joined before :meth:`StandbyController.run_once`
returns (the reference leaves it running past the takeover).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Optional

import numpy as np

from hetu_tpu_torch.ps import membership as _mb
from hetu_tpu_torch.telemetry import trace

# the longest run_once waits for the bridge to leave its last row_cas
_BRIDGE_JOIN_S = 10.0

# the planes whose takeover() the standby invokes
PLANES = ("serving", "elastic", "mpmd")


class StandbyController:
    """Watch a fleet's controller lease; self-promote on silence.

    ``plane`` names which ``takeover()`` to invoke: ``"serving"``,
    ``"elastic"`` or ``"mpmd"``.
    ``takeover_kwargs`` are passed through (``workdir``/``port`` ride
    separately).  ``table=`` injects a pre-built blackboard surface
    (tests); otherwise the standby attaches over the van — replicated
    when ``van_spec`` names a durable-tier pair, so the standby survives
    a van failover too.
    """

    def __init__(self, *, workdir=None, port: int = 0, plane: str =
                 "serving", membership_table: int = 0, n_slots: int = 0,
                 lease_bound_s: float = 2.0, poll_s: float = 0.1,
                 van_spec: Optional[dict] = None,
                 takeover_kwargs: Optional[dict] = None,
                 table=None, name: str = "standby"):
        if plane not in PLANES:
            raise ValueError(f"unknown control plane {plane!r}")
        self.workdir = workdir
        self.port = int(port)
        self.plane = plane
        self.n_slots = int(n_slots)
        self.lease_bound_s = float(lease_bound_s)
        self.poll_s = float(poll_s)
        self.takeover_kwargs = dict(takeover_kwargs or {})
        self.name = name
        self._replica = None
        if van_spec:
            from hetu_tpu_torch.ps.replica import VanReplica
            self._replica = VanReplica.from_spec(van_spec)
        self._table = table if table is not None else \
            _mb.attach_blackboard("127.0.0.1", self.port,
                                  table_id=int(membership_table),
                                  n_slots=self.n_slots,
                                  replica=self._replica)
        self._own_table = table is None
        # observed controller lease: incarnation, beat, and when the
        # beat last ADVANCED (monotonic) — the silence clock
        self.ctrl_inc = 0
        self.ctrl_beat = -1
        self._advance = time.monotonic()
        self._stop = threading.Event()
        # outcome: None while watching; "promoted" (this standby won
        # and ran the takeover — `adopted` holds the result), or
        # "fenced" (another claimant won the CAS — stood down)
        self.outcome: Optional[str] = None
        self.adopted = None
        # monotonic stamps: the silence detected (claim attempted), the
        # takeover returned
        self.detected_at: Optional[float] = None
        self.promoted_at: Optional[float] = None
        from hetu_tpu_torch.telemetry import default_registry as reg
        self._m_promoted = reg.counter(
            "standby.promotions",
            help="standby self-promotions that WON the controller CAS")
        self._m_fenced = reg.counter(
            "standby.claims_lost",
            help="standby claims lost to a concurrent winner (stood "
                 "down FENCED)")

    # ---- observation ----
    def observe(self) -> bool:
        """One read of the controller row; returns True when the beat
        advanced (or a new incarnation appeared)."""
        row = _mb.control_rpc(
            lambda: self._table.sparse_pull([self.n_slots + 1]),
            op="standby_watch", link=f"{self.name}->van",
            deadline_s=2.0)[0]
        inc, beat = int(row[_mb.R_CINC]), int(row[_mb.R_CBEAT])
        advanced = False
        if inc > self.ctrl_inc:
            self.ctrl_inc, self.ctrl_beat = inc, beat
            advanced = True
        elif inc == self.ctrl_inc and beat != self.ctrl_beat:
            self.ctrl_beat = beat
            advanced = True
        if advanced:
            self._advance = time.monotonic()
        return advanced

    def silent(self) -> bool:
        """True when a controller has been observed and its beat has
        not advanced for the lease bound.  A fleet whose controller
        NEVER beat (died before this standby attached) goes silent on
        the same clock — the bound starts at attach."""
        return time.monotonic() - self._advance > self.lease_bound_s

    # ---- the claim ----
    def try_claim(self) -> bool:
        """ONE CAS attempt at ``observed + 1``.  True = this standby
        owns the right to take over; False = a concurrent claimant won
        (``ctrl_inc`` now carries the winner's incarnation).  Never
        retries a loss — a standby that lost must stand down."""
        observed = self.ctrl_inc
        desired = np.zeros(_mb.MEMBER_DIM, np.float32)
        desired[_mb.R_CINC] = observed + 1
        desired[_mb.R_CBEAT] = 1
        desired[_mb.R_CEPOCH] = 0
        desired[_mb.R_CPID] = os.getpid() % (1 << 24)
        try:
            swapped, actual = _mb.control_rpc(
                lambda: self._table.row_cas(
                    self.n_slots + 1, _mb.R_CINC, float(observed),
                    desired),
                op="standby_claim", link=f"{self.name}->van",
                deadline_s=5.0)
        except (NotImplementedError, AttributeError):
            # a van without OP_ROW_CAS: a single-shot claim cannot be
            # made tie-proof — refuse to self-promote rather than risk
            # two winners (the operator path still works)
            raise RuntimeError(
                "standby self-promotion needs a CAS-capable van "
                "(OP_ROW_CAS); claim refused on this server")
        if swapped:
            self.ctrl_inc = observed + 1
            self.ctrl_beat = 1
            self._m_promoted.inc()
            return True
        self.ctrl_inc = int(actual[_mb.R_CINC])
        self.ctrl_beat = int(actual[_mb.R_CBEAT])
        self._advance = time.monotonic()
        self._m_fenced.inc()
        return False

    def _bridge_beats(self, stop: threading.Event) -> None:
        """Between winning the claim and the takeover's own service
        beating the row, the promoted incarnation must not look SILENT
        — a second standby whose clock expired just behind ours would
        otherwise claim on top of a takeover already in flight (a
        legitimate sequential claim, but a pointless fleet steal).
        Beat via CAS so the write lands ONLY while the row still holds
        our incarnation: the moment the takeover's claim bumps it, the
        CAS fails and the bridge stops — it can never clobber the
        successor."""
        beat = self.ctrl_beat
        mine = self.ctrl_inc
        while not stop.is_set():
            beat = (beat + 1) % (1 << 20)
            desired = np.zeros(_mb.MEMBER_DIM, np.float32)
            desired[_mb.R_CINC] = mine
            desired[_mb.R_CBEAT] = beat
            desired[_mb.R_CPID] = os.getpid() % (1 << 24)
            try:
                swapped, _ = self._table.row_cas(
                    self.n_slots + 1, _mb.R_CINC, float(mine), desired)
            except Exception:
                swapped = True  # transient wire: keep bridging
            if not swapped:
                return  # the takeover owns the row now
            stop.wait(0.1)

    def _invoke_takeover(self):
        kw = dict(self.takeover_kwargs)
        if self.plane == "elastic":
            from hetu_tpu_torch.resilience.multicontroller import (
                MultiControllerElasticSupervisor,
            )
            return MultiControllerElasticSupervisor.takeover(
                workdir=self.workdir, port=self.port, **kw)
        if self.plane == "mpmd":
            from hetu_tpu_torch.parallel.mpmd_elastic import (
                MPMDPipelineSupervisor,
            )
            return MPMDPipelineSupervisor.takeover(
                workdir=self.workdir, port=self.port, **kw)
        from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool
        return CrossProcessServingPool.takeover(
            workdir=self.workdir, port=self.port, **kw)

    # ---- the loop ----
    def run_once(self) -> Optional[str]:
        """One watch step: observe, and when the lease is silent run
        the claim.  Returns the outcome once decided."""
        try:
            self.observe()
        except Exception:
            # an unreadable blackboard is NOT controller silence — the
            # van may be failing over under us; freeze the clock (the
            # next successful read restarts it) rather than promote on
            # blindness
            self._advance = time.monotonic()
            return None
        if not self.silent():
            return None
        self.detected_at = time.monotonic()
        t0 = trace.now_us()
        if self.try_claim():
            self.outcome = "promoted"
            trace.complete("standby.promote", t0,
                           {"incarnation": self.ctrl_inc,
                            "plane": self.plane}, cat="ctrl")
            bridge_stop = threading.Event()
            bridge = threading.Thread(target=self._bridge_beats,
                                      args=(bridge_stop,), daemon=True)
            bridge.start()
            try:
                self.adopted = self._invoke_takeover()
            finally:
                bridge_stop.set()
                # a departure from the reference, which leaves the bridge
                # running: the caller may close the table as soon as this
                # returns, and a bridge still inside row_cas would then
                # call into a closed handle
                bridge.join(timeout=_BRIDGE_JOIN_S)
            self.promoted_at = time.monotonic()
        else:
            self.outcome = "fenced"
        return self.outcome

    def watch(self, timeout_s: float = 600.0) -> str:
        """Block until promoted or fenced (or the budget lapses —
        outcome ``"timeout"``)."""
        deadline = time.monotonic() + float(timeout_s)
        while not self._stop.is_set() and time.monotonic() < deadline:
            out = self.run_once()
            if out is not None:
                return out
            time.sleep(self.poll_s)
        return self.outcome or "timeout"

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        if self._own_table:
            try:
                self._table.close()
            except Exception:
                pass


def _digest(a) -> str:
    import hashlib
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(),
                           digest_size=16).hexdigest()


def standby_main(config_path: str) -> int:
    """Entry point for a spawned STANDBY process.  Config names the
    blackboard (membership_table/n_slots/port — or a workdir whose
    member spawn configs carry them), the plane, and the lease bound.
    Markers: ``READY`` (armed) → ``WATCHING`` → ``PROMOTED``/``FENCED``
    → ``RESOLVED`` → ``ALLDONE``.  Serving plane: ``RESOLVED {rid:
    status}``, ALLDONE once every adopted request resolved.  Elastic
    plane: the adopted fleet runs to its last step within
    ``resolve_timeout_s``, its consumed batches are checked, then
    ``RESOLVED {"takeover": report, "resizes": [...], "epochs": n}``
    and ALLDONE.  Mpmd plane: the adopted pipeline runs to its last step
    and its stages leave within ``resolve_timeout_s``, then ``RESOLVED
    {"takeover": report, "replacements": [...], "epochs": n, "digests":
    {stage: blake2b of its final parameters}}`` and ALLDONE.  Exit codes: 0 promoted and done, 1 a
    failure after the promotion, 2 no decision within
    ``watch_timeout_s``, 3 fenced (another claimant won)."""
    with open(config_path) as f:
        cfg = json.load(f)
    workdir = cfg["workdir"]
    # the durable tier's flight recorder covers the standby too: the
    # promotion evidence must survive even if THIS process is killed
    # right after acting
    trace.open_process_stream(workdir, f"standby_p{os.getpid()}")
    spec = dict(cfg)
    if "membership_table" not in spec:
        # serving plane: every control-plane id is in the member spawn
        # configs on disk, same discovery the takeover classmethod uses
        from pathlib import Path

        from hetu_tpu_torch.serve.crosshost import MemberSpec
        cfgs = sorted(Path(workdir).glob("member_*.json"),
                      key=lambda p: p.stat().st_mtime)
        ms = MemberSpec.from_json(cfgs[-1].read_text())
        spec["membership_table"] = ms.membership_table
        spec["n_slots"] = ms.n_slots
        spec.setdefault("van", ms.van or None)
    sb = StandbyController(
        workdir=workdir, port=int(cfg["port"]),
        plane=cfg.get("plane", "serving"),
        membership_table=int(spec["membership_table"]),
        n_slots=int(spec["n_slots"]),
        lease_bound_s=float(cfg.get("lease_bound_s", 2.0)),
        poll_s=float(cfg.get("poll_s", 0.1)),
        van_spec=spec.get("van"),
        takeover_kwargs=cfg.get("takeover_kwargs"))
    print("READY", f"jax={int('jax' in sys.modules)}",
          f"torch={int('torch' in sys.modules)}", flush=True)
    print("WATCHING", flush=True)
    try:
        out = sb.watch(timeout_s=float(cfg.get("watch_timeout_s",
                                               600.0)))
    except Exception:
        traceback.print_exc()
        print("FENCED", flush=True)  # never won: stood down
        sb.close()
        return 3
    if out != "promoted":
        print("FENCED" if out == "fenced" else "TIMEOUT", flush=True)
        sb.close()
        return 3 if out == "fenced" else 2
    print(f"PROMOTED {sb.promoted_at - sb.detected_at:.6f}", flush=True)
    rc = 0
    try:
        if sb.plane == "elastic" and sb.adopted is not None:
            # drive the adopted fleet to its end: closing it now would
            # kill the workers this incarnation owns
            report = sb.adopted.run(deadline_s=float(
                cfg.get("resolve_timeout_s", 120.0)))
            sb.adopted.verify_consumed(report["consumed"])
            print("RESOLVED", json.dumps({
                "takeover": sb.adopted.takeover_report,
                "resizes": report["resizes"],
                "epochs": report["epochs"]}), flush=True)
        elif sb.plane == "mpmd" and sb.adopted is not None:
            # the same for the pipeline: its stages finish and leave on
            # their own, so the close below signals none of them
            timeout_s = float(cfg.get("resolve_timeout_s", 120.0))
            report = sb.adopted.run(deadline_s=timeout_s)
            sb.adopted.wait_stages_left(timeout_s)
            print("RESOLVED", json.dumps({
                "takeover": sb.adopted.takeover_report,
                "replacements": report["replacements"],
                "epochs": report["epochs"],
                "digests": {str(k): _digest(w) for k, w in
                            report["final_params"].items()}}), flush=True)
        elif sb.adopted is not None:
            results = sb.adopted.wait_adopted(
                timeout_s=float(cfg.get("resolve_timeout_s", 120.0)))
            # one rid → status map covering BOTH sources of truth: the
            # ledger's pre-kill resolutions and the adoptions resolved
            # under this incarnation (the loss-accounting surface)
            statuses = dict(sb.adopted.takeover_report.get("resolved",
                                                           {}))
            statuses.update({str(k): v.get("status")
                             for k, v in results.items()})
            print("RESOLVED", json.dumps(statuses), flush=True)
        print(f"ALLDONE {time.monotonic() - sb.promoted_at:.6f}",
              flush=True)
        if sb.plane == "serving" and sb.adopted is not None:
            # keep serving (and beating the controller row) for the
            # configured hold — the promoted incarnation must not go
            # silent the moment the adoption resolves, or a trailing
            # standby would claim a fleet that just changed hands
            hold = float(cfg.get("hold_s", 0.0))
            t_end = time.monotonic() + hold
            while time.monotonic() < t_end and not sb.adopted.fenced:
                time.sleep(0.05)
    except Exception:
        traceback.print_exc()
        rc = 1
    finally:
        if sb.adopted is not None:
            try:
                sb.adopted.close()
            except Exception:
                traceback.print_exc()
        sb.close()
    return rc


if __name__ == "__main__":
    sys.exit(standby_main(sys.argv[1]))
