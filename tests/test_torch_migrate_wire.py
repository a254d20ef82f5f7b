"""The chunked migration wire of hetu_tpu_torch (``send_payload`` /
``recv_payload`` and ``migrate_inflight(wire=...)``) against hetu_tpu on
the CPU.

Mirrored here: the four wire tests of ``tests/test_migrate.py`` (chunk
CRC and framing, a corrupt compressed body named by its chunk, ``stop``
aborting a wedged sender, and a dead wire rolling back to the source).
Then real van channels: a mid-decode burst of the reference's tiny GPT
(f32 weights loaded through ``interop``) moved by the port's
``migrate_inflight`` over two of the port's ``BlobChannel`` s with each
codec gives the streams, the adopter counters and the wire bytes of the
reference's ``migrate_inflight`` over the reference's van (with codec
none, the reference's greedy oracle), with zero re-prefill; a receive
that fails mid-stream stops the sender at once and rolls back; a bulk
send leaves the link-rate sample the ``auto`` codec reads.

Every wait is on an event, a thread join or a channel op with its own
deadline.
"""

import threading
import time

import numpy as np
import pytest
import torch

from hetu_tpu.ps import van as jax_van
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu.serve import migrate as jax_mg
from hetu_tpu.telemetry import default_registry as jax_registry
from hetu_tpu_torch.ps import van
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, MigrationError, Request,
)
from hetu_tpu_torch.serve import migrate as mg
from hetu_tpu_torch.telemetry import default_registry
from test_torch_gpt_serve import _jax_model as _jax_gpt
from test_torch_gpt_serve import _torch_model as _torch_gpt
from test_torch_migrate import _counts, _engine, _jax_engine, _ref_greedy

torch.set_num_threads(2)

pytestmark = pytest.mark.migrate

HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def gpt():
    """(JAX model, JAX variables, the port's model), f32, plain path."""
    jm, jv = _jax_gpt("xla")
    return jm, jv, _torch_gpt("xla")


@pytest.fixture(scope="module")
def ports():
    """The port's van and the reference's, side by side in this
    process."""
    port, jax_port = van.serve(0), jax_van.serve(0)
    yield port, jax_port
    van.stop()
    jax_van.stop()


class _ListChannel:
    """In-memory stand-in for a van BlobChannel (seq-keyed slots)."""

    def __init__(self, store):
        self.store = store

    def put(self, data, seq, *, timeout_s=None):
        self.store[seq] = bytes(data)

    def get(self, seq, *, timeout_s=None):
        return self.store[seq]


def test_chunked_frames_roundtrip_and_crc_detection():
    payload = np.random.default_rng(0).bytes(10_000)
    store: dict = {}
    nxt = mg.send_payload(_ListChannel(store), payload, chunk_bytes=1024)
    assert nxt - 1 == len(store) == 10  # ceil(10000 / 1024)
    assert mg.recv_payload(_ListChannel(store)) == payload
    # the reference frames the same payload into the same frames
    ref: dict = {}
    jax_mg.send_payload(_ListChannel(ref), payload, chunk_bytes=1024)
    assert ref == store
    # one chunk's payload corrupted: its CRC catches it
    bad = dict(store)
    frame = bytearray(bad[4])
    frame[-1] ^= 0x01
    bad[4] = bytes(frame)
    with pytest.raises(MigrationError, match="CRC"):
        mg.recv_payload(_ListChannel(bad))
    # the framing header corrupted: caught before the CRC
    bad2 = dict(store)
    bad2[1] = b"\x00" * 30
    with pytest.raises(MigrationError, match="magic|header"):
        mg.recv_payload(_ListChannel(bad2))


def test_corrupt_compressed_body_names_chunk(gpt):
    """A compressed payload crossing the chunked wire with a flipped byte
    fails with a MigrationError NAMING the chunk, and nothing decodes
    (the body CRC refuses the direct unpack too)."""
    eng = _engine(gpt[2])
    slot = eng.alloc_slot()
    eng.prefill(slot, list(range(1, 30)))
    payload = mg.pack(eng.cache.spec, eng.export_slots([slot]),
                      codec="int8")
    store: dict = {}
    mg.send_payload(_ListChannel(store), payload, chunk_bytes=2048)
    assert len(store) >= 3
    bad = dict(store)
    frame = bytearray(bad[3])
    frame[-1] ^= 0x40
    bad[3] = bytes(frame)
    for module in (mg, jax_mg):  # the reference names it the same way
        with pytest.raises(module.MigrationError,
                           match="chunk 2 CRC mismatch"):
            module.recv_payload(_ListChannel(bad))
    corrupt = bytearray(payload)
    corrupt[-1] ^= 0x40
    with pytest.raises(MigrationError, match="CRC"):
        mg.unpack(bytes(corrupt))


class _NeverAckedWire:
    """A channel whose single ack slot never frees: every put times out,
    the shape of a receiver that died mid-stream.  ``entered`` is set at
    the first put."""

    def __init__(self):
        self.entered = threading.Event()

    def put(self, data, seq, *, timeout_s=None):
        self.entered.set()
        time.sleep(min(timeout_s or 0.05, 0.05))
        raise TimeoutError("ack of the previous message not observed")


def test_send_payload_stop_aborts_wedged_sender():
    """``stop`` aborts the sender between short put slices, well inside
    the 60 s ack window it would otherwise wait out."""
    stop = threading.Event()
    wire = _NeverAckedWire()
    exc = []

    def run():
        try:
            mg.send_payload(wire, b"x" * 100, chunk_bytes=10,
                            timeout_s=60.0, stop=stop)
        except Exception as e:
            exc.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert wire.entered.wait(10.0)  # wedged in the first chunk's ack wait
    stop.set()
    t.join(5.0)
    assert not t.is_alive()
    assert exc and isinstance(exc[0], mg.MigrationError)
    assert "chunk 0/10" in str(exc[0])


class _BoomWire:
    def put(self, data, seq, *, timeout_s=None):
        raise ConnectionError("wire died mid-transfer")

    def get(self, seq, *, timeout_s=None):
        raise ConnectionError("wire died mid-transfer")


def test_dead_wire_rolls_back_to_the_source(gpt):
    """A dead wire mid-migration re-adopts the requests AND their slots
    at the source: the migration completes or the source serves on."""
    jm, jv, tm = gpt
    s1 = ContinuousBatchingScheduler(_engine(tm))
    s2 = ContinuousBatchingScheduler(_engine(tm))
    req = Request(prompt=[3, 1, 4], max_tokens=9)
    s1.submit(req)
    for _ in range(2):
        s1.step()
    with pytest.raises(ConnectionError):
        mg.migrate_inflight(s1, s2, wire=(_BoomWire(), _BoomWire()))
    assert s1.has_work()  # rolled back, still mid-decode on the source
    s1.run([])
    assert req.status == "ok"
    assert req.tokens == _ref_greedy(jm, jv, [3, 1, 4], 9)
    assert s2.engine.cache.num_free == s2.engine.cache.num_slots
    assert s1.metrics.count("requests_exported") == 0


class _FailsAfterFirstChunk:
    """A receiving channel that delivers chunk 1, then fails: the sender,
    on a channel nobody drains, is left in its ack wait."""

    def __init__(self, inner):
        self.inner = inner

    def get(self, seq, *, timeout_s=60.0):
        if seq > 1:
            raise ConnectionError("receiver died after chunk 1")
        return self.inner.get(seq, timeout_s=timeout_s)


def test_failed_receive_stops_the_sender_and_rolls_back(gpt, ports):
    """The receive fails mid-stream: ``migrate_inflight`` stops its
    sender (wedged in a 60 s ack window) and rolls back at once."""
    port, _ = ports
    tm = gpt[2]
    s1 = ContinuousBatchingScheduler(_engine(tm))
    s2 = ContinuousBatchingScheduler(_engine(tm))
    reqs = [Request(prompt=[5, 6, 7, 8, 9], max_tokens=12),
            Request(prompt=[2, 4], max_tokens=12)]
    for r in reqs:
        s1.submit(r)
    s1.step()
    tx = van.BlobChannel(HOST, port, 7001)
    rx = van.BlobChannel(HOST, port, 7001)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="after chunk 1"):
        mg.migrate_inflight(s1, s2, wire=(tx, _FailsAfterFirstChunk(rx)),
                            chunk_bytes=512, timeout_s=60.0)
    assert time.monotonic() - t0 < 10.0
    assert not any(t.name == "migrate-send" and t.is_alive()
                   for t in threading.enumerate())
    assert all(s1.owns(r) for r in reqs) and not s2.has_work()
    s1.run([])
    assert [r.status for r in reqs] == ["ok", "ok"]
    tx.close()
    rx.close()


def _burst_over_wire(module, van_module, sched_cls, req_cls, make, port,
                     channel, codec, specs):
    """``specs`` on a source scheduler, stepped until every request is
    mid-decode, moved by ``module.migrate_inflight`` over two blob
    channels of ``van_module`` with ``codec`` in chunks of 1 KiB, then
    drained on the destination; returns (requests, destination, blob
    bytes the send put on the wire, K/V body bytes of the payload)."""
    s1, s2 = sched_cls(make()), sched_cls(make())
    reqs = [req_cls(prompt=list(p), max_tokens=m) for p, m in specs]
    for r in reqs:
        s1.submit(r)
    for _ in range(3):
        s1.step()
    assert all(r.tokens and not r.done.is_set() for r in reqs)
    tx = van_module.BlobChannel(HOST, port, channel)
    rx = van_module.BlobChannel(HOST, port, channel)
    reg = default_registry if van_module is van else jax_registry
    # the port's pack counts into the source scheduler's registry, the
    # reference's into its default one
    body_reg = s1.metrics.registry if module is mg else jax_registry
    put_bytes = reg.counter("van.blob_put.bytes")
    body_bytes = body_reg.counter("serve.migrate.bytes_wire")
    before, body0 = put_bytes.value, body_bytes.value
    slot_map = module.migrate_inflight(s1, s2, wire=(tx, rx), codec=codec,
                                       chunk_bytes=1024, timeout_s=30.0)
    sent, body = put_bytes.value - before, body_bytes.value - body0
    tx.close()
    rx.close()
    assert sorted(slot_map) == [0, 1]
    assert not s1.has_work()
    assert s1.engine.cache.num_free == s1.engine.cache.num_slots
    while s2.has_work():
        s2.step()
    return reqs, s2, sent, body


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_migrate_over_the_van_matches_the_reference(gpt, ports, codec):
    jm, jv, tm = gpt
    port, jax_port = ports
    specs = [([3, 14, 15, 9, 2, 6], 12), ([7, 1], 10)]
    ch = 7100 + mg.CODECS.index(codec)
    reqs, s2, sent, body = _burst_over_wire(
        mg, van, ContinuousBatchingScheduler, Request, lambda: _engine(tm),
        port, ch, codec, specs)
    jreqs, js2, jsent, jbody = _burst_over_wire(
        jax_mg, jax_van, JaxScheduler, JaxRequest,
        lambda: _jax_engine(jm, jv), jax_port, ch, codec, specs)
    assert [r.status for r in reqs] == ["ok", "ok"]
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    if codec == "none":
        assert [r.tokens for r in reqs] == [
            _ref_greedy(jm, jv, p, m) for p, m in specs]
    # zero re-prefill: the adopter imported both slots and prefilled none
    assert s2.engine.metrics.count("prefill_tokens") == 0
    assert s2.engine.metrics.count("slots_adopted") == 2
    assert _counts(s2.metrics) == _counts(js2.metrics)
    # the same K/V body; the frames differ only where the header spells
    # the body's CRC in decimal (f32 rows of two packages differ in their
    # last bits)
    assert body == jbody > 0
    assert abs(sent - jsent) < 10 and sent > body


def test_bulk_send_leaves_the_link_rate_sample(ports):
    port, _ = ports
    tx = van.BlobChannel(HOST, port, 7200)
    rx = van.BlobChannel(HOST, port, 7200)
    samples = default_registry.counter("migrate.wire.rate_samples")
    before = samples.value
    payload = np.random.default_rng(1).bytes(mg.MIN_RATE_SAMPLE_BYTES * 4)
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "p", mg.recv_payload(rx, timeout_s=30.0)), daemon=True)
    t.start()
    nxt = mg.send_payload(tx, payload, chunk_bytes=1 << 14, timeout_s=30.0)
    t.join(30)
    assert not t.is_alive() and got["p"] == payload
    assert samples.value == before + 1
    assert mg.measured_link_mbps() > 0
    # a send under the sample floor leaves no sample
    t = threading.Thread(target=lambda: got.__setitem__(
        "small", mg.recv_payload(rx, seq0=nxt, timeout_s=30.0)),
        daemon=True)
    t.start()
    mg.send_payload(tx, b"y" * 100, seq0=nxt, timeout_s=30.0)
    t.join(30)
    assert not t.is_alive() and got["small"] == b"y" * 100
    assert samples.value == before + 1
    tx.close()
    rx.close()
