"""Inference front end over the van's blob-channel transport
(counterpart of ``hetu_tpu/serve/server.py``, copied whole; it drives the
port's scheduler and engines, and its JSON is the reference's key for
key, so a client of either package talks to a server of the other).

The wire is the thread-per-connection C++ van server
(``csrc/hetu_ps_van.cpp``, :mod:`hetu_tpu_torch.ps.van`): client ``i``
talks on a dedicated request/response channel pair derived from its
``client_id`` (ids are caller-assigned, the same convention as van table
ids), with monotonically increasing seqs per channel, so every wire op
inherits the blob channel's idempotent-retry reliability.

Threads:
  * one listener per client id — blocks in a server-side blob GET (no
    polling frames while idle beyond the shutdown-check interval),
    submits to the scheduler, waits on the request's completion event
    with the per-request timeout, sends the response;
  * one engine loop — runs ``scheduler.step()`` whenever there is work
    (continuous batching: admissions interleave with decode steps).

Graceful shutdown: ``close()`` stops the loop, drains the scheduler (so
waiting listeners get 'shutdown' responses instead of hanging), joins
every thread, then stops the van if this server started it.
"""

from __future__ import annotations

import json
import threading
import time

from hetu_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler, Request, cancel_detached,
)

# channel namespace: far above the table/mailbox ids the tests use
SERVE_CHANNEL_BASE = 0x53525645  # 'SRVE'


def request_channel(client_id: int) -> int:
    return SERVE_CHANNEL_BASE + 2 * int(client_id)


def response_channel(client_id: int) -> int:
    return SERVE_CHANNEL_BASE + 2 * int(client_id) + 1


class InferenceServer:
    """Engine loop + wire listeners over one scheduler.

    ``max_clients=0`` is the LISTENER-LESS mode: only the engine loop,
    crash-requeue, and failover-grace machinery run — the deployment
    unit the reference's pools build on (its serve/pool.py routes to it
    in-process; its serve/crosshost.py wraps it in a member PROCESS whose
    submit/event channels and membership heartbeat replace the
    per-client listeners)."""

    def __init__(self, scheduler: ContinuousBatchingScheduler, *,
                 port: int = 0, max_clients: int = 4,
                 request_timeout_s: float = 60.0,
                 poll_s: float = 0.25, own_van: bool = True,
                 max_loop_errors: int = 3,
                 failover_grace_s: float = 10.0):
        """port=0 picks a free port; ``own_van=False`` attaches to a van
        already serving in this process (the server then must be handed
        that van's port).  ``max_loop_errors`` consecutive engine-loop
        exceptions (no successful step in between) declare the engine dead:
        the loop exits and ``healthy`` turns False.

        Request failover: every engine-loop exception requeues the
        in-flight requests (re-prefill from prompt + tokens emitted so
        far, bounded by the scheduler's ``max_requeues``) instead of
        failing them, so an engine crash followed by
        :meth:`restart_engine` within ``failover_grace_s`` loses ZERO
        accepted requests.  If no restart arrives inside the grace window
        (or ``failover_grace_s <= 0``), the queue drains with status
        'error' and new submits fail fast — the pre-failover behavior."""
        from hetu_tpu_torch.ps import van
        self._van = van
        self.scheduler = scheduler
        self.metrics = scheduler.metrics
        self.request_timeout_s = float(request_timeout_s)
        self._poll_s = float(poll_s)
        self._own_van = own_van
        self._max_loop_errors = int(max_loop_errors)
        self._failover_grace_s = float(failover_grace_s)
        if own_van:
            self.port = van.serve(port)
        else:
            if not port:
                raise ValueError("own_van=False needs the running van's port")
            self.port = port
        self._stop = threading.Event()
        self.last_loop_error = None
        self._loop_dead = False
        self._restart_evt = threading.Event()
        self._grace_thread = None
        self._loop = threading.Thread(target=self._engine_loop, daemon=True)
        self._listeners = [
            threading.Thread(target=self._listen, args=(cid,), daemon=True)
            for cid in range(max_clients)]
        self._loop.start()
        for t in self._listeners:
            t.start()

    @property
    def healthy(self) -> bool:
        """True while the engine loop is alive and serving.  False once the
        loop gave up after ``max_loop_errors`` consecutive failures, died
        some other way, or the server was closed — callers should stop
        sending and restart/replace the server.  ``last_loop_error`` holds
        the final traceback when the engine failed."""
        return self._loop.is_alive() and not self._loop_dead

    # ---- engine loop ----
    def _engine_loop(self) -> None:
        consecutive = 0
        while not self._stop.is_set():
            try:
                if self.scheduler.has_work():
                    self.scheduler.step()
                    consecutive = 0
                    # a drain, failover or submit waiting for the
                    # scheduler lock takes it before the next step
                    self.scheduler.yield_to_control()
                else:
                    time.sleep(0.002)
            except Exception:
                # a step blowing up must not wedge the in-flight requests
                # (the listeners are waiting on their events) OR lose them:
                # requeue them for a retry / a restarted engine, keep the
                # evidence (traceback to stderr, repr for the operator, a
                # counter for dashboards)
                import traceback
                self.last_loop_error = traceback.format_exc()
                traceback.print_exc()
                self.metrics.inc("engine_loop_errors")
                consecutive += 1
                try:
                    self.scheduler.requeue_inflight()
                except Exception:
                    traceback.print_exc()  # never let cleanup kill the loop
                if consecutive >= self._max_loop_errors:
                    self._loop_dead = True
                    self.metrics.inc("engine_loop_dead")
                    self._arm_failover_grace()
                    return

    def _arm_failover_grace(self) -> None:
        """The engine is dead; the queue (incl. requeued in-flight work) is
        intact.  Hold it for ``failover_grace_s`` awaiting restart_engine;
        expire into the fail-fast drain so clients are never wedged on a
        restart that will not come."""
        if self._stop.is_set():
            return  # closing: close() drains with 'shutdown' itself
        if self._failover_grace_s <= 0:
            self._expire_failover()
            return

        restart_evt = self._restart_evt

        def grace():
            if not restart_evt.wait(self._failover_grace_s):
                self._expire_failover()

        self._grace_thread = threading.Thread(target=grace, daemon=True)
        self._grace_thread.start()

    def _expire_failover(self) -> None:
        import traceback
        if self._stop.is_set():
            # a close() raced the grace window: the scheduler already
            # drained 'shutdown' — an expiry drain here would flip the
            # reject status under the closed server (regression-tested
            # in tests/test_torch_server.py)
            return
        try:
            self.scheduler.drain("error", stop_accepting=True)
            self.metrics.inc("failover_expired")
        except Exception:
            traceback.print_exc()

    def cancel_failover_grace(self, timeout_s: float = 5.0) -> None:
        """Disarm a pending failover-grace timer without restarting.

        The pool's unplanned-failover path calls this after it has taken
        the dead member's queue — a later expiry drain would otherwise
        finish already-migrated bookkeeping with 'error' and flip the
        reject status under the new owner.  ``close()`` uses the same
        path so a closed server can never have the grace thread fire
        afterwards."""
        self._restart_evt.set()
        t = self._grace_thread
        if t is not None:
            try:
                t.join(timeout_s)
            except RuntimeError:
                # armed-but-not-yet-started: _arm_failover_grace assigns
                # the thread before start(), and a pool failover can land
                # in that window.  The event above is the one the thread
                # waits on, so it exits immediately once started — the
                # disarm already happened; there is nothing to wait for
                pass

    # ---- engine restart (request failover) ----
    def restart_engine(self, engine) -> None:
        """Swap in a fresh/recovered engine and resume serving: the
        scheduler re-adopts its queue (requeued in-flight requests
        re-prefill from prompt + tokens emitted so far), intake reopens,
        a new engine loop starts, and ``healthy`` recovers.  Call within
        ``failover_grace_s`` of the crash for the zero-loss guarantee."""
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        if self._loop_dead:
            # the dying loop thread flips _loop_dead BEFORE it arms the
            # grace timer and exits; a caller polling `healthy` can land
            # in that window.  Join it first so the grace timer is armed
            # with the CURRENT event (cancellable below) and is_alive()
            # below reads the settled state.
            self._loop.join(timeout=10.0)
        self.cancel_failover_grace()      # cancel the pending grace timer
        self._restart_evt = threading.Event()
        self.scheduler.replace_engine(engine)
        self.last_loop_error = None
        self._loop_dead = False
        if not self._loop.is_alive():
            self._loop = threading.Thread(target=self._engine_loop,
                                          daemon=True)
            self._loop.start()
        self.metrics.inc("engine_restarts")

    # ---- one listener per client channel pair ----
    def _listen(self, cid: int) -> None:
        req_ch = self._van.BlobChannel("127.0.0.1", self.port,
                                       request_channel(cid))
        resp_ch = self._van.BlobChannel("127.0.0.1", self.port,
                                        response_channel(cid))
        seq = 1
        sent_seq = 0  # last response seq that reached the slot
        # idempotent-resubmission dedup: the client protocol is one
        # request in flight per channel pair, so remembering the LAST
        # request id per listener is sufficient — a timed-out client
        # that re-puts the same id gets the original request's result,
        # never a second generation (or a second token-budget charge)
        dedup: dict = {}
        try:
            while not self._stop.is_set():
                try:
                    raw = req_ch.get(seq, timeout_s=self._poll_s)
                except TimeoutError:
                    # reconnect probe: a client that RESTARTED with this
                    # id begins again at seq 1 while we wait at seq N+1 —
                    # without this it could never be served again.  An
                    # EMPTY read is the already-consumed seq-1 slot (ack
                    # frees the payload but keeps its seq), not a request.
                    if seq > 1:
                        try:
                            raw = req_ch.get(1, timeout_s=0.05)
                        except (TimeoutError, RuntimeError):
                            continue
                        if not raw:
                            continue
                        seq = 1
                    else:
                        continue
                except RuntimeError:
                    break  # van stopped under us
                resp = self._handle(raw, dedup)
                payload = json.dumps(resp).encode()
                for attempt in range(2):
                    try:
                        resp_ch.put(payload, seq,
                                    timeout_s=min(self.request_timeout_s,
                                                  10.0))
                        sent_seq = seq
                        break
                    except (TimeoutError, RuntimeError):
                        # unread slot: a client-side wire timeout left our
                        # previous response stored unacked, which would
                        # wedge this channel FOREVER (puts only overwrite
                        # acked slots).  Consume our own stale response
                        # (get acks it) and retry once; failing that, drop
                        # this response but keep the listener alive.
                        if attempt == 0 and sent_seq:
                            try:
                                resp_ch.get(sent_seq, timeout_s=0.2)
                                continue
                            except (TimeoutError, RuntimeError):
                                pass
                        self.metrics.inc("responses_dropped")
                        break
                seq += 1
        finally:
            req_ch.close()
            resp_ch.close()

    # ---- wire-format hooks (the reference's recsys.RecsysServer
    # overrides them) ----
    def _build_request(self, msg: dict) -> Request:
        """Parse one request message into a scheduler Request.  Raise
        KeyError/TypeError/ValueError for a malformed message — the
        listener answers 'bad_request' without touching the scheduler.
        Subclasses serving a different workload (the CTR front-end)
        override this and :meth:`_build_response`; the listener/dedup/
        engine-loop machinery is shared."""
        if not msg["prompt"]:
            raise ValueError("empty prompt")
        return Request(
            prompt=[int(t) for t in msg["prompt"]],
            max_tokens=int(msg.get("max_tokens", 16)),
            eos_id=msg.get("eos_id"),
            timeout_s=min(float(msg.get("timeout_s",
                                        self.request_timeout_s)),
                          self.request_timeout_s))

    def _build_response(self, msg: dict, req: Request) -> dict:
        return {"id": msg.get("id"), "status": req.status or "ok",
                "tokens": list(req.tokens),
                "ttft_s": req.ttft_s}

    def _bad_request(self, err: Exception) -> dict:
        return {"id": None, "status": "bad_request", "error": str(err),
                "tokens": []}

    def _handle(self, raw: bytes, dedup: dict | None = None) -> dict:
        try:
            msg = json.loads(raw)
            req = self._build_request(msg)
        except (KeyError, TypeError, ValueError) as e:
            return self._bad_request(e)
        # dedup key includes the client's per-incarnation nonce: a
        # RESTARTED client reusing id 1 with a new prompt must not be
        # served the previous incarnation's answer.  A message WITHOUT a
        # nonce is undedupable for the same reason — (None, 1) would
        # collide across incarnations of a raw-JSON client.
        rid = None if msg.get("id") is None or msg.get("cn") is None \
            else (msg["cn"], msg["id"])
        if dedup is not None and rid is not None \
                and dedup.get("id") == rid:
            # a retried submit of the in-flight (or just-finished)
            # request: attach to the original instead of generating twice
            req = dedup["req"]
            self.metrics.inc("requests_deduped")
        else:
            self.scheduler.submit(req)
            if dedup is not None:
                dedup["id"], dedup["req"] = rid, req
        # event wait (not scheduler polling): the engine loop completes the
        # request and sets the event; the deadline here backstops a wedged
        # loop so the client always gets a response frame
        if not req.done.wait(timeout=req.timeout_s + self._poll_s + 5.0):
            # resolve 'timeout', not 'cancelled' — unless the request
            # finished in the race, in which case the finish guard keeps
            # its real terminal status.  Detached: this deadline exists
            # to backstop a WEDGED engine loop, which holds the
            # scheduler lock across the stuck step — a plain
            # scheduler.cancel would hang this handler on that lock and
            # the client would never get its response frame
            cancel_detached(self.scheduler, req, "timeout")
        return self._build_response(msg, req)

    # ---- lifecycle ----
    def close(self, timeout_s: float = 10.0) -> None:
        self._stop.set()  # set BEFORE the cancel: _expire_failover checks it
        self.cancel_failover_grace(timeout_s)  # a grace timer must not
        # outlive us; bounded by the CALLER's close budget
        self.scheduler.drain("shutdown", stop_accepting=True)
        self._loop.join(timeout_s)
        for t in self._listeners:
            t.join(timeout_s)
        if self._own_van:
            self._van.stop()


class InferenceClient:
    """Blocking client for one channel pair.  ``client_id`` must be unique
    per concurrently-connected client and < the server's ``max_clients``
    (the van-table-id convention: caller-assigned, concurrent collision =
    crossed wires).  A RESTARTED client may reuse its id: the listener
    detects the seq reset and resyncs."""

    def __init__(self, host: str, port: int, client_id: int, *,
                 connect_timeout_s: float = 20.0):
        from hetu_tpu_torch.ps import van
        self._req = van.BlobChannel(host, port, request_channel(client_id),
                                    connect_timeout_s=connect_timeout_s)
        self._resp = van.BlobChannel(host, port, response_channel(client_id),
                                     connect_timeout_s=connect_timeout_s)
        self._seq = 0
        self._rid = 0  # request id: stable across retries of one generate
        import os as _os
        self._nonce = _os.urandom(4).hex()  # distinguishes incarnations

    def generate(self, prompt, *, max_tokens: int = 16, eos_id=None,
                 timeout_s: float = 120.0, deadline_s=None,
                 wire_retries: int = 1) -> dict:
        """prompt: token ids in → {'tokens': [...], 'status': ...} out.

        ``timeout_s`` bounds the WIRE wait (put + blocking get) of each
        attempt; ``deadline_s`` is the per-request serving deadline
        enforced by the scheduler (queue wait + decode), defaulting to
        ``timeout_s``.

        Idempotent resubmission: a timed-out attempt retries (up to
        ``wire_retries`` times) with the SAME request id — the server
        dedups on id, so a retry after a slow ack attaches to the
        original request instead of generating (and billing the token
        budget) twice.  A timed-out put reuses its seq (the frame never
        landed); a timed-out response re-puts at the next seq.
        """
        self._rid += 1
        msg = {"id": self._rid, "cn": self._nonce,
               "prompt": [int(t) for t in prompt],
               "max_tokens": int(max_tokens),
               "timeout_s": timeout_s if deadline_s is None
               else float(deadline_s)}
        if eos_id is not None:
            msg["eos_id"] = int(eos_id)
        return self._roundtrip(msg, timeout_s, wire_retries)

    def _roundtrip(self, msg: dict, timeout_s: float,
                   wire_retries: int = 1) -> dict:
        """One idempotent request/response exchange for an already-built,
        already-id-stamped message (the retry/dedup dance the reference
        shares with its CTR client, serve/recsys.py)."""
        payload = json.dumps(msg).encode()
        last_exc: Exception = TimeoutError("generate: no attempts ran")
        for _attempt in range(max(int(wire_retries), 0) + 1):
            self._seq += 1
            try:
                self._req.put(payload, self._seq, timeout_s=timeout_s)
            except TimeoutError as e:
                # the frame never reached the slot (previous one unread):
                # this seq is still ours — reuse it on the next attempt
                self._seq -= 1
                last_exc = e
                continue
            try:
                return self._get_response(self._seq, timeout_s)
            except TimeoutError as e:
                last_exc = e
                # grace drain before resubmitting: the response may land
                # moments late — if so it IS our answer (ids are unique
                # per client incarnation); otherwise the drain attempt
                # leaves the slot for the listener's dedup response
                try:
                    resp = self._get_response(self._seq, 0.2)
                    if resp.get("id") == msg["id"]:
                        return resp
                except (TimeoutError, RuntimeError):
                    pass
                # else: resubmit the same id at the next seq; the server
                # dedups and answers there
        raise last_exc

    def _get_response(self, seq: int, timeout_s: float) -> dict:
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                return json.loads(self._resp.get(
                    seq, timeout_s=max(deadline - time.monotonic(), 0.05)))
            except RuntimeError as e:
                # rc=-5: the slot still holds a PREVIOUS incarnation's
                # response (this client restarted with a reused id); the
                # server overwrites it with our seq once it resyncs —
                # retry until the deadline
                if "rc=-5" not in str(e) or time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    def close(self) -> None:
        self._req.close()
        self._resp.close()
