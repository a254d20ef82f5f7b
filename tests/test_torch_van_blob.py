"""The port's van (``hetu_tpu_torch.ps.van``) against hetu_tpu's on the
CPU: the bulk-blob channel, the barrier, the transport counters and the
chunked migration wire over real channels.

Mirrored here: every test of ``tests/test_van_blob.py`` but the MPMD
mailbox's frame-count A/B (in ``tests/test_torch_mpmd.py``, beside the
mailbox) and the slow soak.
Across the packages, both ways: a port channel writes where a reference
channel reads, on a van of either package, and a payload sent by one
package's ``send_payload`` is received by the other's ``recv_payload``,
byte for byte.  Also: the van's client metrics in the process-default
registry, the fault and netem hooks, and the library's rebuild when it
was built from another list of sources.

Every wait is on a thread join, an event or a channel op with its own
deadline.
"""

import ctypes
import shutil
import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest

from hetu_tpu.ps import available as jax_ps_available
from hetu_tpu.ps import van as jax_van
from hetu_tpu.serve import migrate as jax_mg
from hetu_tpu_torch.ps import binding, van
from hetu_tpu_torch.serve import migrate as mg
from hetu_tpu_torch.telemetry import default_registry, prometheus_text

HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def server_port():
    port = van.serve(0)
    yield port
    van.stop()


@pytest.fixture(scope="module")
def jax_port():
    """The reference's van, started in this process beside the port's
    (each library keeps its own server state)."""
    assert jax_ps_available()
    port = jax_van.serve(0)
    yield port
    jax_van.stop()


def _writer(fn, *args, **kw):
    t = threading.Thread(target=fn, args=args, kwargs=kw, daemon=True)
    t.start()
    return t


def _joined(t, timeout=30):
    t.join(timeout)
    assert not t.is_alive(), "a writer thread hung"


def test_blob_roundtrip_in_order(server_port):
    tx = van.BlobChannel(HOST, server_port, 9001)
    rx = van.BlobChannel(HOST, server_port, 9001)
    msgs = [np.arange(64, dtype=np.float32) + i for i in range(5)]

    def writer():
        for i, m in enumerate(msgs):
            tx.put(m, seq=i + 1)

    t = _writer(writer)
    for i, m in enumerate(msgs):
        got = np.frombuffer(rx.get(i + 1, timeout_s=30), np.float32)
        np.testing.assert_array_equal(got, m)
    _joined(t)
    tx.close()
    rx.close()


def test_blob_put_blocks_until_acked(server_port):
    """A second put must not overwrite an unread message."""
    tx = van.BlobChannel(HOST, server_port, 9002)
    rx = van.BlobChannel(HOST, server_port, 9002)
    tx.put(b"first", 1)
    with pytest.raises(TimeoutError):  # the slot is unread: put times out
        tx.put(b"second", 2, timeout_s=0.3)
    assert rx.get(1, timeout_s=30) == b"first"
    tx.put(b"second", 2, timeout_s=5.0)  # freed by the ack
    assert rx.get(2, timeout_s=30) == b"second"
    tx.close()
    rx.close()


def test_blob_large_message_grows_buffer(server_port):
    """Messages larger than the reader's first 1 MB buffer round-trip;
    the buffer keeps its size for the next message."""
    tx = van.BlobChannel(HOST, server_port, 9003)
    rx = van.BlobChannel(HOST, server_port, 9003)
    big = np.random.default_rng(0).standard_normal(1 << 19).astype(np.float32)
    t = _writer(tx.put, big, 1)  # a 2 MB payload
    np.testing.assert_array_equal(
        np.frombuffer(rx.get(1, timeout_s=30), np.float32), big)
    _joined(t)
    assert len(rx._rbuf) >= big.nbytes
    tx.close()
    rx.close()


def test_blob_get_timeout(server_port):
    rx = van.BlobChannel(HOST, server_port, 9004)
    with pytest.raises(TimeoutError):  # the reference's contract for an
        rx.get(1, timeout_s=0.2)       # undelivered seq
    rx.close()


def test_barrier_releases_all(server_port):
    n = 4
    released = []

    def worker(i):
        b = van.RemoteBarrier(HOST, server_port, 9100, n)
        for round_ in range(3):  # reusable across rounds (generations)
            b.wait(timeout_s=10.0)
            released.append((round_, i))
        b.close()

    ts = [_writer(worker, i) for i in range(n)]
    for t in ts:
        _joined(t)
    assert len(released) == 3 * n
    for r in range(3):
        assert sum(1 for rr, _ in released if rr == r) == n


def test_barrier_timeout_withdraws_arrival(server_port):
    """A timed-out waiter must not leave a ghost arrival behind."""
    b = van.RemoteBarrier(HOST, server_port, 9101, 2)
    with pytest.raises(TimeoutError):
        b.wait(timeout_s=0.2)
    done = threading.Event()

    def late():
        b2 = van.RemoteBarrier(HOST, server_port, 9101, 2)
        b2.wait(timeout_s=10.0)
        done.set()
        b2.close()

    t = _writer(late)
    # one live arrival only: the late waiter is still held after 0.3 s
    assert not done.wait(0.3)
    b.wait(timeout_s=10.0)  # the second arrival releases both
    _joined(t)
    assert done.is_set()
    b.close()


def test_blob_message_costs_three_frames(server_port):
    """The blob channel's frame count, the number the reference's A/B
    against the sparse mailbox rests on: put + get + ack a message, no
    polling, however long the reader waits (+1 for the stats query)."""
    n = 8
    tx = van.BlobChannel(HOST, server_port, 9200)
    rx = van.BlobChannel(HOST, server_port, 9200)
    f0 = van.stats_frames(HOST, server_port)
    t = _writer(lambda: [tx.put(np.full(64, i, np.float32), i + 1)
                         for i in range(n)])
    for i in range(n):
        rx.get(i + 1, timeout_s=30)
    _joined(t)
    frames = van.stats_frames(HOST, server_port) - f0
    assert frames <= 3 * n + 2, frames
    tx.close()
    rx.close()


@pytest.mark.migrate
def test_chunked_transfer_survives_kill_between_chunks(server_port):
    """A chunked migration transfer whose CONNECTION dies between chunks
    resumes after a reconnect: every blob op is idempotent under a
    same-seq resend, so the killed side continues at the chunk it was
    on."""

    class _DropsAfterEveryPut(van.BlobChannel):
        def put(self, data, seq, *, timeout_s=60.0):
            super().put(data, seq, timeout_s=timeout_s)
            self.reconnect()  # connection killed; the next put starts fresh

    payload = np.random.default_rng(3).bytes(40_000)
    tx = _DropsAfterEveryPut(HOST, server_port, 9300)
    rx = van.BlobChannel(HOST, server_port, 9300)
    got = {}
    before = default_registry.counter("van.blob_channel.reconnects").value

    def reader():
        # the READER's connection also dies mid-stream (after chunk 2)
        orig_get = rx.get
        calls = [0]

        def flaky_get(seq, *, timeout_s=60.0):
            calls[0] += 1
            if calls[0] == 3:
                rx.reconnect()
            return orig_get(seq, timeout_s=timeout_s)

        rx.get = flaky_get
        got["payload"] = mg.recv_payload(rx, timeout_s=30.0)

    t = _writer(reader)
    mg.send_payload(tx, payload, chunk_bytes=4096, timeout_s=30.0)
    _joined(t)
    assert got["payload"] == payload
    # ten chunks, a reconnect after each put, one on the reader's side
    assert default_registry.counter(
        "van.blob_channel.reconnects").value - before == 11
    tx.close()
    rx.close()


@pytest.mark.migrate
def test_chunked_transfer_corruption_fails_clean(server_port):
    """A corrupted chunk fails the receive loudly (CRC) with nothing
    assembled, and the channel stays usable for a fresh transfer."""
    payload = np.random.default_rng(4).bytes(12_000)
    tx = van.BlobChannel(HOST, server_port, 9301)
    rx = van.BlobChannel(HOST, server_port, 9301)

    def corrupt_sender():
        chunk, n = 4096, 3
        for i in range(n):
            part = payload[i * chunk:(i + 1) * chunk]
            crc = zlib.crc32(part)
            if i == 1:
                crc ^= 0xDEADBEEF  # frame 1 lies about its payload
            frame = mg._CHUNK_HDR.pack(mg.MAGIC, mg.VERSION, i, n,
                                       crc) + part
            tx.put(frame, i + 1, timeout_s=30.0)

    t = _writer(corrupt_sender)
    with pytest.raises(mg.MigrationError, match="CRC"):
        mg.recv_payload(rx, timeout_s=30.0)
    _joined(t)
    rx.get(3, timeout_s=30.0)  # drain the undelivered tail, then reuse
    t2 = _writer(mg.send_payload, tx, payload, seq0=4, chunk_bytes=4096,
                 timeout_s=30.0)
    assert mg.recv_payload(rx, seq0=4, timeout_s=30.0) == payload
    _joined(t2)
    tx.close()
    rx.close()


# ---- across the packages ----

@pytest.mark.parametrize("server", ["port", "reference"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_channels_of_both_packages_share_a_van(server_port, jax_port,
                                               server, writer):
    """A channel of either package writes where a channel of the other
    reads, on either package's van: one wire format."""
    port = server_port if server == "port" else jax_port
    ch = 9400 + 2 * (server == "port") + (writer == "port")
    mods = {"port": van, "reference": jax_van}
    tx = mods[writer].BlobChannel(HOST, port, ch)
    rx = mods["reference" if writer == "port" else "port"].BlobChannel(
        HOST, port, ch)
    big = np.random.default_rng(5).bytes(3 << 20)  # grows either buffer
    t = _writer(lambda: [tx.put(b"small", 1), tx.put(big, 2)])
    assert rx.get(1, timeout_s=30) == b"small"
    assert rx.get(2, timeout_s=30) == big
    _joined(t)
    tx.close()
    rx.close()


@pytest.mark.migrate
@pytest.mark.parametrize("sender", ["port", "reference"])
def test_payload_stream_crosses_the_packages(server_port, sender):
    """``send_payload`` of one package, ``recv_payload`` of the other,
    over one van: the frames are the reference's, chunk for chunk."""
    send, recv = (mg, jax_mg) if sender == "port" else (jax_mg, mg)
    mods = {mg: van, jax_mg: jax_van}
    ch = 9500 + (sender == "port")
    tx = mods[send].BlobChannel(HOST, server_port, ch)
    rx = mods[recv].BlobChannel(HOST, server_port, ch)
    payload = np.random.default_rng(6).bytes(70_001)
    got = {}
    t = _writer(lambda: got.setdefault(
        "next", send.send_payload(tx, payload, chunk_bytes=8192,
                                  timeout_s=30.0)))
    assert recv.recv_payload(rx, timeout_s=30.0) == payload
    _joined(t)
    assert got["next"] == 1 + 9  # ceil(70001 / 8192) chunks
    tx.close()
    rx.close()


def test_chunk_frames_are_the_references_bytes():
    """The same payload framed by both packages' ``send_payload`` gives
    the same frames at the same seqs."""

    class _Store:
        def __init__(self):
            self.frames = {}

        def put(self, data, seq, *, timeout_s=None):
            self.frames[seq] = bytes(data)

    payload = np.random.default_rng(7).bytes(5000)
    mine, theirs = _Store(), _Store()
    assert mg.send_payload(mine, payload, seq0=3, chunk_bytes=1024) == \
        jax_mg.send_payload(theirs, payload, seq0=3, chunk_bytes=1024) == 8
    assert mine.frames == theirs.frames
    assert mg.DEFAULT_CHUNK_BYTES == jax_mg.DEFAULT_CHUNK_BYTES
    assert mg._CHUNK_HDR.format == jax_mg._CHUNK_HDR.format


# ---- telemetry and hooks ----

def test_op_metrics_land_in_the_default_registry(server_port):
    stats0 = van.op_stats()
    tx = van.BlobChannel(HOST, server_port, 9600)
    rx = van.BlobChannel(HOST, server_port, 9600)
    tx.put(b"x" * 100, 1)
    assert rx.get(1, timeout_s=30) == b"x" * 100
    with pytest.raises(TimeoutError):
        rx.get(2, timeout_s=0.05)
    stats = van.op_stats()

    def delta(op, field):
        return stats[op][field] - stats0.get(op, {}).get(field, 0)

    assert delta("blob_put", "calls") == 1
    assert delta("blob_put", "bytes") == 100
    assert delta("blob_get", "calls") == 2
    assert delta("blob_get", "bytes") == 100  # known on delivery
    assert delta("blob_get", "errors") == 1   # the timed-out get
    assert stats["blob_get"]["latency"]["count"] >= 1
    assert "van_blob_put_latency_s_bucket" in prometheus_text()
    tx.close()
    rx.close()


def test_fault_hook_raises_before_the_op_and_netem_sees_the_bytes(
        server_port):
    seen = []
    tx = van.BlobChannel(HOST, server_port, 9601)
    rx = van.BlobChannel(HOST, server_port, 9601)

    def fault(op):
        if op == "blob_put" and not seen:
            seen.append(("fault", op))
            raise ConnectionError("injected")

    prev_f = van.set_fault_hook(fault)
    prev_n = van.set_netem_hook(lambda op, n: seen.append((op, n)))
    try:
        with pytest.raises(ConnectionError, match="injected"):
            tx.put(b"abc", 1)
        tx.put(b"abc", 1)  # nothing landed: the same seq is free
        assert rx.get(1, timeout_s=30) == b"abc"
    finally:
        van.set_fault_hook(prev_f)
        van.set_netem_hook(prev_n)
    # the faulted op never reached the netem hook; get's size is unknown
    assert seen == [("fault", "blob_put"), ("blob_put", 3), ("blob_get", 0)]
    tx.close()
    rx.close()


def test_known_link_rate_reads_netem_then_the_measured_rate():
    class _Emu:
        def current_rate_mbps(self):
            return 80.0

        def hook(self, op, nbytes):
            pass

    gauge = default_registry.gauge("migrate.wire.mbps_last")
    last = gauge.value
    prev = van.set_netem_hook(_Emu().hook)
    try:
        gauge.set(1234.5)
        assert mg.known_link_mbps() == 80.0  # the emulated cap wins
        van.set_netem_hook(prev)
        assert mg.known_link_mbps() == mg.measured_link_mbps() == 1234.5
        gauge.set(0.0)
        assert mg.known_link_mbps() is None  # no evidence
    finally:
        van.set_netem_hook(prev)
        gauge.set(last)


# ---- the library ----

def test_a_library_built_from_the_old_source_list_is_rebuilt(tmp_path,
                                                            monkeypatch):
    """A library built from ``hetu_ps.cpp`` alone (the in-process tier's
    list) is newer than every source, yet has no van and no remote tier:
    ``build()`` must rebuild it from the four sources."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    so = tmp_path / "_build" / "libhetu_ps.so"
    so.parent.mkdir()
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", str(binding._SRCS[0]), "-o", str(so)],
                   check=True, capture_output=True)
    old = ctypes.CDLL(str(so))
    assert not hasattr(old, "ps_van_start")
    monkeypatch.setattr(binding, "_BUILD", so.parent)
    monkeypatch.setattr(binding, "_SO", so)
    assert so.stat().st_mtime >= max(
        p.stat().st_mtime
        for p in (*binding._SRCS, *binding._HDRS))
    assert binding.build() == so
    # loaded from another path: dlopen hands back the library already
    # loaded under a name
    shutil.copy(so, tmp_path / "rebuilt.so")
    rebuilt = ctypes.CDLL(str(tmp_path / "rebuilt.so"))
    for symbol in ("ps_van_start", "ps_group_create_dt", "ps_rcache_create"):
        assert hasattr(rebuilt, symbol), symbol
    assert (so.parent / "libhetu_ps.so.srcs").read_text() == \
        "hetu_ps.cpp\nhetu_ps_van.cpp\nhetu_ps_group.cpp\nhetu_ps_rcache.cpp\n"
    mtime = so.stat().st_mtime_ns
    assert binding.build() == so and so.stat().st_mtime_ns == mtime


class _LateTransportLib:
    """The port's native library with one wire op made to fail the way a
    stopped-then-resumed caller sees it: the call returns the transport
    rc (-101) only after the op's deadline has passed."""

    def __init__(self, real, op, delay_s):
        self._real, self._op, self._delay = real, op, delay_s
        self.fired = 0
        self.connects = 0         # connects that returned a descriptor
        self.failed_connects = 0  # connects the van retried (fd < 0)

    def __getattr__(self, name):
        fn = getattr(self._real, name)
        if name == "ps_van_connect":
            def connect(*args):
                fd = fn(*args)
                if fd >= 0:
                    self.connects += 1
                else:
                    self.failed_connects += 1
                return fd
            return connect
        if name != self._op:
            return fn

        def late(*args):
            if not self.fired:
                self.fired += 1
                import time
                time.sleep(self._delay)
                return -101
            return fn(*args)
        return late


def test_blob_transport_failure_past_the_deadline_reconnects(
        server_port, monkeypatch):
    """A member SIGSTOPped inside a blob get resumes to a transport
    failure after the get's deadline: the channel reconnects, then raises
    ``BlobTransportError``, a ``RuntimeError`` as every failed blob op
    raises (the reference's contract, which the server's listeners
    catch), and the next get on the same channel object reads the
    message."""
    tx = van.BlobChannel(HOST, server_port, 9011)
    rx = van.BlobChannel(HOST, server_port, 9011)
    fake = _LateTransportLib(van.lib, "ps_van_blob_get", 0.3)
    monkeypatch.setattr(van, "lib", fake)
    before = default_registry.counter("van.blob_channel.reconnects").value
    with pytest.raises(van.BlobTransportError,
                       match=r"blob get failed \(rc=-101\)") as err:
        rx.get(1, timeout_s=0.05)
    assert isinstance(err.value, RuntimeError)
    assert fake.fired == 1
    assert default_registry.counter(
        "van.blob_channel.reconnects").value == before + 1
    t = _writer(tx.put, b"after the stop", 1, timeout_s=10.0)
    assert rx.get(1, timeout_s=10.0) == b"after the stop"
    _joined(t)
    tx.close()
    rx.close()


def test_membership_table_ops_reconnect_after_a_transport_failure(
        server_port, monkeypatch):
    """``sparse_set`` / ``sparse_pull`` / ``row_cas`` replace a connection
    that failed in transport before raising, so the membership plane's
    retry runs on a clean stream."""
    t = van.RemotePSTable(HOST, server_port, 4, 8, init="zeros",
                          optimizer="sgd", lr=0.0)
    row = np.arange(8, dtype=np.float32).reshape(1, 8)
    for op, call in (
            ("ps_van_sparse_set_dt", lambda: t.sparse_set([1], row)),
            ("ps_van_sparse_pull_dt", lambda: t.sparse_pull([1])),
            ("ps_van_row_cas", lambda: t.row_cas(2, 0, 0.0, row[0]))):
        fake = _LateTransportLib(binding.lib, op, 0.0)
        monkeypatch.setattr(van, "lib", fake)
        with pytest.raises(RuntimeError, match="rc=-101"):
            call()
        # exactly one new connection replaced the failed one; a connect
        # that failed on a busy host and was retried within the deadline
        # (_connect_with_deadline) returned no descriptor and is not one
        assert fake.connects == 1 and t.fd >= 0, (fake.connects,
                                                  fake.failed_connects)
        monkeypatch.setattr(van, "lib", binding.lib)
        call()  # the retry on the new connection
    np.testing.assert_array_equal(t.sparse_pull([1, 2]), np.stack([row[0],
                                                                   row[0]]))
    t.close()


_CLOSE_RACE_SRC = """
import os, sys, threading, time
sys.path.insert(0, {repo!r})
from hetu_tpu_torch.ps.binding import lib
host, port = b"127.0.0.1", {port}
state = {{"fd": lib.ps_van_connect(host, port)}}
stop = threading.Event()
closes = [0]

def pinger():
    while not stop.is_set():
        lib.ps_van_ping(state["fd"])

def closer():
    while not stop.is_set():
        lib.ps_van_close(state["fd"])
        state["fd"] = lib.ps_van_connect(host, port)
        closes[0] += 1

threads = [threading.Thread(target=pinger, daemon=True) for _ in range(4)]
threads.append(threading.Thread(target=closer, daemon=True))
for t in threads:
    t.start()
time.sleep({seconds})
stop.set()
for t in threads:
    t.join(5.0)
print("STUCK", sum(t.is_alive() for t in threads), "CLOSES", closes[0],
      flush=True)
os._exit(0)
"""


def test_a_close_racing_requests_on_its_connection_wedges_no_thread(
        tmp_path):
    """One thread closes and reopens a connection while four others send
    requests on it, for 2 s, in a process of their own (a stale fd number
    must not reach this test process's descriptors) against a van process:
    every thread ends, and the close ran hundreds of times.  With a close
    that frees the connection's mutex (the van's own), a request that
    looked it up just before locks freed memory, or two requests
    interleave their frames on one socket, and the threads wedge within
    a few closes — the member wedge behind
    ``tests/test_torch_vanchaos.py::test_vankill_serving_promotes_zero_loss_token_exact``'s
    2 s ack."""
    from pathlib import Path

    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )
    binding.lib  # built (or rebuilt) here, not in the child
    port = free_port()
    server = spawn_shard_server(tmp_path, port, "close_race")
    try:
        out = subprocess.run(
            [sys.executable, "-c", _CLOSE_RACE_SRC.format(
                repo=str(Path(__file__).resolve().parents[1]), port=port,
                seconds=2.0)],
            capture_output=True, text=True, timeout=60)
    finally:
        server.kill()
        server.wait()
    assert out.returncode == 0, out.stderr[-2000:]
    words = out.stdout.split()
    stuck, closes = int(words[1]), int(words[3])
    assert stuck == 0 and closes >= 100, out.stdout
