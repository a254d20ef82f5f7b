"""The port's inference front end (``hetu_tpu_torch.serve.server``) over
its van, against hetu_tpu's on the CPU.

The reference's tiny GPT (V 97, H 64, 2 layers), its parameters drawn
with numpy from a seed and loaded into the port through ``interop`` in
f32, behind ``InferenceServer(ContinuousBatchingScheduler(ServeEngine))``.
Mirrored here: the 15 tests of ``tests/test_serve_server.py`` (end to end
generate, concurrent clients, the per-request timeout, graceful shutdown,
a client's restart, a malformed request, a dead engine, crash and restart
with zero loss, a poisoned request, the failover grace's three guards,
dedup of a retried submit, the client's retry, and the van's counters
reset across ``serve()`` incarnations, here with blob traffic).  Every
answer is held to the reference's greedy oracle, token for token.

Across the packages: the same prompts sent by clients of both packages
to a port server and to a reference server (the JAX engine on the same
weights) get the same answers, token for token, in JSON of the same
keys.

The engine crash is triggered by a count of decode rounds, not by a
timer, and every wait is on a thread join, an event or a deadline of its
own: the reference's crash test, whose crash lands after a poll, fails
from run to run.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from hetu_tpu.ps import van as jax_van
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import InferenceClient as JaxClient
from hetu_tpu.serve import InferenceServer as JaxServer
from hetu_tpu_torch.ps import van
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, InferenceClient, InferenceServer, Request,
    ServeEngine, request_channel, response_channel,
)
from hetu_tpu_torch.serve.metrics import ServeMetrics
from test_torch_gpt_serve import _jax_model as _jax_gpt
from test_torch_gpt_serve import _torch_model as _torch_gpt
from test_torch_migrate import _jax_engine, _ref_greedy

torch.set_num_threads(2)

HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def gpt():
    """(JAX model, JAX variables, the port's model), f32, plain path."""
    jm, jv = _jax_gpt("xla")
    return jm, jv, _torch_gpt("xla")


def _engine(tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("min_bucket", 8)
    return ServeEngine(tm, device="cpu", **kw)


@pytest.fixture
def server(gpt):
    jm, jv, tm = gpt
    sched = ContinuousBatchingScheduler(_engine(tm, num_slots=4))
    srv = InferenceServer(sched, max_clients=3, request_timeout_s=60.0,
                          poll_s=0.1)
    yield srv, (lambda prompt, n: _ref_greedy(jm, jv, prompt, n))
    srv.close()


def _threads(fn, args):
    ts = [threading.Thread(target=fn, args=(a,), daemon=True) for a in args]
    for t in ts:
        t.start()
    return ts


def _join(ts, timeout=60):
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a client thread hung"


def test_generate_end_to_end_matches_reference(server):
    srv, ref = server
    prompt = [3, 14, 15, 9, 2, 6]
    client = InferenceClient(HOST, srv.port, 0)
    try:
        resp = client.generate(prompt, max_tokens=8, timeout_s=30.0)
    finally:
        client.close()
    assert resp["status"] == "ok"
    assert resp["tokens"] == ref(prompt, 8)
    assert resp["ttft_s"] > 0
    assert set(resp) == {"id", "status", "tokens", "ttft_s"}


def test_concurrent_clients_each_get_their_own_answer(server):
    srv, ref = server
    prompts = {0: [1, 2, 3], 1: [9, 8, 7, 6], 2: [42]}
    results = {}
    errors = []

    def worker(cid):
        c = InferenceClient(HOST, srv.port, cid)
        try:
            for j in range(2):  # two sequential requests per client
                results[(cid, j)] = c.generate(prompts[cid], max_tokens=5,
                                               timeout_s=30.0)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((cid, repr(e)))
        finally:
            c.close()

    _join(_threads(worker, prompts))
    assert not errors, errors
    assert len(results) == 6
    for (cid, _), resp in results.items():
        assert resp["status"] == "ok"
        assert resp["tokens"] == ref(prompts[cid], 5)


def test_per_request_timeout_returns_timeout_status(server):
    """A request whose deadline is past when admission runs comes back
    status timeout with no tokens."""
    srv, _ = server
    client = InferenceClient(HOST, srv.port, 1)
    try:
        resp = client.generate([1, 2, 3], max_tokens=8, deadline_s=0.0,
                               timeout_s=30.0)
    finally:
        client.close()
    assert resp["status"] in ("timeout", "cancelled")
    assert resp["tokens"] == []


def test_graceful_shutdown_drains_and_stops_van(gpt):
    sched = ContinuousBatchingScheduler(_engine(gpt[2], max_len=32))
    srv = InferenceServer(sched, max_clients=1, poll_s=0.05)
    client = InferenceClient(HOST, srv.port, 0)
    try:
        assert client.generate([5, 6], max_tokens=3,
                               timeout_s=30.0)["status"] == "ok"
    finally:
        client.close()
    srv.close()
    assert not srv._loop.is_alive()
    assert not any(t.is_alive() for t in srv._listeners)
    # the van really stopped: a fresh serve() binds again in this process
    port = van.serve(0)
    assert port > 0
    van.stop()


def test_client_restart_with_same_id_is_served(server):
    """A client that dies and reconnects under the same id starts its
    seqs over at 1; the listener resyncs."""
    srv, ref = server
    first = InferenceClient(HOST, srv.port, 0)
    try:
        for _ in range(2):  # the listener's seq moves past 1
            assert first.generate([1, 2], max_tokens=3,
                                  timeout_s=30.0)["status"] == "ok"
    finally:
        first.close()
    reborn = InferenceClient(HOST, srv.port, 0)  # seq restarts at 1
    try:
        resp = reborn.generate([9, 8, 7], max_tokens=4, timeout_s=30.0)
    finally:
        reborn.close()
    assert resp["status"] == "ok"
    assert resp["tokens"] == ref([9, 8, 7], 4)


def test_malformed_request_gets_error_response(server):
    srv, _ = server
    ch_req = van.BlobChannel(HOST, srv.port, request_channel(2))
    ch_resp = van.BlobChannel(HOST, srv.port, response_channel(2))
    try:
        ch_req.put(json.dumps({"max_tokens": 4}).encode(), 1)  # no prompt
        resp = json.loads(ch_resp.get(1, timeout_s=30))
        assert resp["status"] == "bad_request" and resp["tokens"] == []
        assert "prompt" in resp["error"]
        ch_req.put(json.dumps({"prompt": []}).encode(), 2)  # empty prompt
        resp = json.loads(ch_resp.get(2, timeout_s=30))
        assert resp == {"id": None, "status": "bad_request",
                        "error": "empty prompt", "tokens": []}
        ch_req.put(b"{not json", 3)
        resp = json.loads(ch_resp.get(3, timeout_s=30))
        assert resp["status"] == "bad_request"
    finally:
        ch_req.close()
        ch_resp.close()


class _BoomEngine:
    """Engine double whose prefill and decode always raise: the
    unexpected engine-loop exception the server must survive visibly."""

    class _Cache:
        num_slots = 2
        max_len = 16
        num_free = 2
        active_tokens = 0
        occupancy = 0.0
        lengths = [0, 0]

    def __init__(self):
        self.cache = self._Cache()
        self.metrics = ServeMetrics()

    def alloc_slot(self):
        return 0

    def release(self, slot):
        pass

    def prefill(self, slot, prompt):
        raise RuntimeError("boom: engine exploded mid-step")

    def decode(self):
        raise RuntimeError("boom: engine exploded mid-step")


def test_dead_engine_fails_requests_and_reports_unhealthy():
    """With no failover grace, in-flight requests get 'error' once the
    loop gives up after max_loop_errors consecutive failures, `healthy`
    turns False, and later requests fail fast."""
    sched = ContinuousBatchingScheduler(_BoomEngine())
    srv = InferenceServer(sched, max_clients=1, poll_s=0.05,
                          request_timeout_s=10.0, max_loop_errors=3,
                          failover_grace_s=0.0)
    client = InferenceClient(HOST, srv.port, 0)
    try:
        assert srv.healthy
        # a request can ride an earlier error's drain without a step of
        # its own, so send until the errors add up to the loop's death
        deadline = time.monotonic() + 30
        while srv.healthy and time.monotonic() < deadline:
            resp = client.generate([1, 2, 3], max_tokens=4, timeout_s=20.0)
            assert resp["status"] == "error"
            assert resp["tokens"] == []
        srv._loop.join(10)
        assert not srv.healthy
        assert "boom" in srv.last_loop_error
        assert srv.metrics.count("engine_loop_errors") == 3
        assert srv.metrics.count("engine_loop_dead") == 1
        t0 = time.monotonic()
        resp = client.generate([4, 5], max_tokens=4, timeout_s=20.0)
        assert resp["status"] == "error"
        assert time.monotonic() - t0 < 5.0
    finally:
        client.close()
        srv.close()


class _FlakyEngine:
    """Proxy over a real ServeEngine that crashes at its ``crash_at``-th
    decode round and stays dead: the engine that dies mid-decode."""

    def __init__(self, inner, crash_at):
        self.inner = inner
        self.crash_at = crash_at
        self.dead = False
        self.decode_rounds = 0

    @property
    def cache(self):
        return self.inner.cache

    @property
    def metrics(self):
        return self.inner.metrics

    def _check(self):
        if self.dead:
            raise RuntimeError("flaky: engine crashed")

    def alloc_slot(self):
        self._check()
        return self.inner.alloc_slot()

    def release(self, slot):
        self._check()
        self.inner.release(slot)

    def prefill(self, slot, prompt):
        self._check()
        return self.inner.prefill(slot, prompt)

    def decode(self):
        self._check()
        if self.decode_rounds == self.crash_at:
            self.dead = True
            self._check()
        out = self.inner.decode()
        self.decode_rounds += 1
        return out


def test_engine_crash_restart_loses_zero_requests(gpt):
    """The engine dies mid-generation; restart_engine installs a fresh one
    inside the grace window: every accepted request completes 'ok' with
    the greedy answer (re-prefill of prompt + tokens so far), and
    `healthy` recovers."""
    jm, jv, tm = gpt
    flaky = _FlakyEngine(_engine(tm), crash_at=2)
    sched = ContinuousBatchingScheduler(flaky)
    srv = InferenceServer(sched, max_clients=3, poll_s=0.05,
                          request_timeout_s=120.0, max_loop_errors=2,
                          failover_grace_s=60.0)
    prompts = {0: [1, 2, 3], 1: [9, 8, 7, 6], 2: [42, 5]}
    results = {}
    errors = []

    def worker(cid):
        c = InferenceClient(HOST, srv.port, cid)
        try:
            results[cid] = c.generate(prompts[cid], max_tokens=12,
                                      timeout_s=60.0)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((cid, repr(e)))
        finally:
            c.close()

    ts = _threads(worker, prompts)
    try:
        srv._loop.join(60)  # the loop dies at the crash's second strike
        assert not srv.healthy and flaky.dead
        assert "flaky" in srv.last_loop_error
        srv.restart_engine(_engine(tm))  # inside the grace window
        assert srv.healthy
        _join(ts)
        assert not errors, errors
        assert len(results) == 3
        for cid, resp in results.items():
            assert resp["status"] == "ok", (cid, resp)
            assert resp["tokens"] == _ref_greedy(jm, jv, prompts[cid], 12)
        assert sched.metrics.count("requests_requeued") >= 1
        assert sched.metrics.count("engine_restarts") == 1
        assert sched.metrics.count("failover_expired") == 0
    finally:
        srv.close()


class _SelectivePoisonEngine:
    """Proxy over a real ServeEngine whose prefill raises for ONE magic
    prompt: the poisoned request that must fail alone."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def cache(self):
        return self.inner.cache

    @property
    def metrics(self):
        return self.inner.metrics

    def alloc_slot(self):
        return self.inner.alloc_slot()

    def release(self, slot):
        self.inner.release(slot)

    def prefill(self, slot, prompt):
        if int(np.asarray(prompt).reshape(-1)[0]) == 66:
            raise RuntimeError("poisoned prompt")
        return self.inner.prefill(slot, prompt)

    def decode(self):
        return self.inner.decode()


def test_poisoned_request_fails_alone_server_stays_healthy(gpt):
    jm, jv, tm = gpt
    sched = ContinuousBatchingScheduler(_SelectivePoisonEngine(_engine(tm)))
    srv = InferenceServer(sched, max_clients=2, poll_s=0.05,
                          request_timeout_s=60.0, max_loop_errors=3)
    good = InferenceClient(HOST, srv.port, 0)
    bad = InferenceClient(HOST, srv.port, 1)
    try:
        r_bad = bad.generate([66, 2, 3], max_tokens=6, timeout_s=30.0)
        assert r_bad["status"] == "error"
        r_good = good.generate([5, 6, 7], max_tokens=6, timeout_s=30.0)
        assert r_good["status"] == "ok"
        assert r_good["tokens"] == _ref_greedy(jm, jv, [5, 6, 7], 6)
        assert srv.healthy
        assert srv.metrics.count("engine_loop_dead") == 0
    finally:
        good.close()
        bad.close()
        srv.close()


def test_close_mid_grace_cannot_flip_state_after_shutdown():
    """close() while the failover-grace timer is armed cancels it: a
    closed server's grace thread never drains with 'error' afterwards."""
    sched = ContinuousBatchingScheduler(_BoomEngine())
    srv = InferenceServer(sched, max_clients=0, poll_s=0.05,
                          max_loop_errors=1, failover_grace_s=0.6)
    try:
        sched.submit(Request(prompt=[1, 2], max_tokens=4, timeout_s=30.0))
        srv._loop.join(30)
        assert not srv.healthy  # engine dead, grace timer armed
        assert srv._grace_thread is not None
    finally:
        srv.close()  # mid-grace
    # close() joined the timer: it cannot fire past its expiry
    assert not srv._grace_thread.is_alive()
    assert sched._reject_status == "shutdown"  # not flipped to 'error'
    assert srv.metrics.count("failover_expired") == 0
    late = sched.submit(Request(prompt=[3], max_tokens=2))
    assert late.status == "shutdown"


def test_cancel_grace_tolerates_armed_but_unstarted_thread():
    """cancel_failover_grace inside the window where the grace thread is
    assigned but not started must not raise, and must still disarm."""
    sched = ContinuousBatchingScheduler(_BoomEngine())
    srv = InferenceServer(sched, max_clients=0, poll_s=0.05,
                          max_loop_errors=1, failover_grace_s=30.0)
    try:
        evt = srv._restart_evt
        srv._grace_thread = threading.Thread(target=lambda: None,
                                             daemon=True)
        srv.cancel_failover_grace()  # must not raise
        assert evt.is_set()          # the disarm still happened
    finally:
        srv.close()


def test_close_before_loop_death_sync_expiry_guarded():
    """The grace_s <= 0 synchronous expiry: a loop dying after close()
    began must not drain with 'error' over the shutdown drain."""
    sched = ContinuousBatchingScheduler(_BoomEngine())
    srv = InferenceServer(sched, max_clients=0, poll_s=0.05,
                          max_loop_errors=1, failover_grace_s=0.0)
    srv._stop.set()  # close() has begun; the loop may still be striking
    srv._arm_failover_grace()
    assert srv.metrics.count("failover_expired") == 0
    srv.close()


def test_duplicate_submit_same_id_dedups(server):
    """A retried submit with the same request id and nonce attaches to
    the original request: one generation, one token-budget charge."""
    srv, ref = server
    ch_req = van.BlobChannel(HOST, srv.port, request_channel(2))
    ch_resp = van.BlobChannel(HOST, srv.port, response_channel(2))
    before = srv.metrics.count("requests_submitted")
    try:
        msg = json.dumps({"id": 7, "cn": "abc", "prompt": [1, 2, 3],
                          "max_tokens": 5}).encode()
        ch_req.put(msg, 1)
        ch_req.put(msg, 2)  # the retry: same id and nonce, next seq
        r1 = json.loads(ch_resp.get(1, timeout_s=30))
        r2 = json.loads(ch_resp.get(2, timeout_s=30))
        want = ref([1, 2, 3], 5)
        assert r1["status"] == "ok" and r1["tokens"] == want
        assert r2["status"] == "ok" and r2["tokens"] == want
        assert srv.metrics.count("requests_submitted") - before == 1
        assert srv.metrics.count("requests_deduped") == 1
        # a new nonce (a restarted client) with the same id is fresh
        ch_req.put(json.dumps({"id": 7, "cn": "xyz", "prompt": [4, 5],
                               "max_tokens": 3}).encode(), 3)
        r3 = json.loads(ch_resp.get(3, timeout_s=30))
        assert r3["tokens"] == ref([4, 5], 3)
        assert srv.metrics.count("requests_submitted") - before == 2
    finally:
        ch_req.close()
        ch_resp.close()


def test_client_retries_timed_out_response_without_regenerating(server):
    """A response wait that times out retries the SAME id at the next
    seq; the server dedups and the client gets the original answer."""
    srv, ref = server
    client = InferenceClient(HOST, srv.port, 1)
    try:
        calls = [0]
        orig_get = client._resp.get

        def flaky_get(seq, *, timeout_s=60.0):
            calls[0] += 1
            if calls[0] == 1:  # the first wait "times out" on the wire
                raise TimeoutError("injected response timeout")
            return orig_get(seq, timeout_s=timeout_s)

        client._resp.get = flaky_get
        before = srv.metrics.count("requests_submitted")
        resp = client.generate([6, 5, 4], max_tokens=4, timeout_s=30.0,
                               wire_retries=2)
        assert resp["status"] == "ok"
        assert resp["tokens"] == ref([6, 5, 4], 4)
        assert srv.metrics.count("requests_submitted") - before == 1
    finally:
        client.close()


def test_van_stats_reset_across_serve_incarnations():
    """The server's frame and byte counters start at zero with each
    serve(): OP_STATS reads "since server start"."""
    port = van.serve(0)
    try:
        tx = van.BlobChannel(HOST, port, 701)
        rx = van.BlobChannel(HOST, port, 701)
        tx.put(np.arange(64, dtype=np.float32), 1)
        assert len(rx.get(1, timeout_s=30)) == 256
        tx.close()
        rx.close()
        s1 = van.stats(HOST, port)
        assert s1["frames"] > 2 and s1["bytes_rx"] > 0
    finally:
        van.stop()
    port = van.serve(0)
    try:
        s2 = van.stats(HOST, port)
        # only the probe's own frame counts in this incarnation
        assert s2["frames"] <= 2, s2
        assert s2["bytes_rx"] < s1["bytes_rx"], (s1, s2)
    finally:
        van.stop()


# ---- across the packages ----

def test_answers_cross_the_packages_both_ways(gpt):
    """Clients of both packages against a port server and a reference
    server (the JAX engine on the same weights): the same answers, token
    for token, in JSON of the same keys."""
    jm, jv, tm = gpt
    port_srv = InferenceServer(ContinuousBatchingScheduler(
        _engine(tm, num_slots=4)), max_clients=2, poll_s=0.1)
    jax_srv = JaxServer(JaxScheduler(_jax_engine(jm, jv, num_slots=4)),
                        max_clients=2, poll_s=0.1)
    prompts = ([3, 14, 15, 9, 2, 6], [42], [9, 8, 7, 6])
    answers = {}
    try:
        for server_name, srv in (("port", port_srv), ("reference", jax_srv)):
            for cid, (client_name, cls) in enumerate(
                    (("port", InferenceClient), ("reference", JaxClient))):
                c = cls(HOST, srv.port, cid)
                try:
                    answers[server_name, client_name] = [
                        c.generate(p, max_tokens=6, timeout_s=30.0)
                        for p in prompts]
                finally:
                    c.close()
    finally:
        port_srv.close()
        jax_srv.close()
    want = [_ref_greedy(jm, jv, p, 6) for p in prompts]
    for key, resps in answers.items():
        assert [r["status"] for r in resps] == ["ok"] * 3, key
        assert [r["tokens"] for r in resps] == want, key
        assert [r["id"] for r in resps] == [1, 2, 3], key
        assert all(set(r) == {"id", "status", "tokens", "ttft_s"}
                   for r in resps), key
    # both vans are down: each package binds a fresh one
    for module in (van, jax_van):
        module.serve(0)
        module.stop()
