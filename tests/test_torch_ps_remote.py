"""The remote PS tiers of hetu_tpu_torch against hetu_tpu's, on the CPU:
the remote table over the van, the table key-range-partitioned over
several van servers, the HET cache over it, the scheduler role (the
servers' registration, its map, a rejoin at a new address), SSP clocks
and partial reduce (in process and over the wire), and ``PSEmbedding``'s
remote tiers, its layered prefetch and its close order.

Mirrored here: ``tests/test_ps_van.py`` (but the membership plane's
controller claim, which belongs to the fleet slice), the group, cache and
``PSEmbedding`` tests of ``tests/test_ps_multiserver.py`` and
``tests/test_ps_remote_cache.py``, the remote cases of
``tests/test_ps_dtype.py``, ``tests/test_ps_scheduler.py``, and
``SSPController`` / ``PartialReduce`` from ``tests/test_ps.py``.  Across
the packages, both ways: a port client on reference servers and a
reference client on port servers give the same rows bit for bit.

Servers are processes of their own (a process runs one van server of a
library), spawned by module-scoped fixtures: a port server imports
``hetu_tpu_torch.ps.van`` and never ``jax``; a reference server imports
``hetu_tpu.ps.van``.  Each prints READY within a deadline, and lives until
its standard input closes (killed at teardown, and gone with this process
if it dies).  Every other wait has a deadline too.  Only the runs that
kill a server and restart it are ``slow``, as in the reference.
"""

import select
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hetu_tpu.ps import van as jvan
from hetu_tpu_torch import optim
from hetu_tpu_torch.models import WideDeep
from hetu_tpu_torch.ps import (
    PartialReduce, PSEmbedding, PSTable, SSPController, binding, client, van,
)
from hetu_tpu_torch.telemetry import default_registry

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
HOST = "127.0.0.1"
READY_S = 60.0  # a server's start, torch's import included

_SERVE = "print('READY', van.serve(int(sys.argv[2])), flush=True)\n"
PORT_SERVER = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
               "from hetu_tpu_torch.ps import van\n" + _SERVE +
               "sys.stdin.read()\n")
REF_SERVER = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
              "from hetu_tpu.ps import van\n" + _SERVE +
              "sys.stdin.read()\n")
# a port server that registers with the scheduler at sys.argv[3]
REG_SERVER = ("import sys\nsys.path.insert(0, sys.argv[1])\n"
              "from hetu_tpu_torch.ps import van\n"
              "port, rank = van.serve_and_register(\n"
              "    '127.0.0.1', int(sys.argv[3]), port=int(sys.argv[2]),\n"
              "    rank_hint=int(sys.argv[4]), beat_ms=200)\n"
              "print('READY', port, rank, flush=True)\n"
              "sys.stdin.read()\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


class _Server:
    """A van server process: ``port`` (and ``rank`` for a registered
    one) from its READY line."""

    def __init__(self, src, *args, ready_s=READY_S):
        binding.load()  # built here first: the children only load it
        self.proc = subprocess.Popen(
            [sys.executable, "-c", src, str(REPO), *map(str, args)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            ready = select.select([self.proc.stdout], [], [], ready_s)[0]
            line = self.proc.stdout.readline() if ready else ""
            assert line.startswith("READY"), \
                f"server did not start (exit {self.proc.poll()}): {line!r}"
        except BaseException:
            self.kill()
            raise
        fields = line.split()
        self.port = int(fields[1])
        self.rank = int(fields[2]) if len(fields) > 2 else None

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)


class _Servers(list):
    def eps(self):
        return [(HOST, s.port) for s in self]

    def kill(self):
        for s in self:
            s.kill()


def _spawn(n, src=PORT_SERVER):
    servers = _Servers()
    try:
        for _ in range(n):
            servers.append(_Server(src, 0))
    except BaseException:
        servers.kill()
        raise
    return servers


@pytest.fixture(scope="module")
def server_port():
    """The port's van, run in this process."""
    port = van.serve(0)
    yield port
    van.stop()


@pytest.fixture(scope="module")
def two_servers():
    servers = _spawn(2)
    yield servers
    servers.kill()


@pytest.fixture(scope="module")
def ref_servers():
    """Two of the reference's van servers, each in a process of its own."""
    servers = _spawn(2, REF_SERVER)
    yield servers
    servers.kill()


@pytest.fixture
def fresh_servers():
    """Two port servers for a test that kills one."""
    servers = _spawn(2)
    yield servers
    servers.kill()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _deadline_retry(fn, timeout_s=20.0):
    """``fn()`` until it stops raising RuntimeError, or None after
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            return fn()
        except RuntimeError:
            time.sleep(0.2)
    return None


# ---- one remote table (tests/test_ps_van.py) ----

def test_remote_table_roundtrip(server_port):
    t = van.RemotePSTable(HOST, server_port, 20, 4, init="constant",
                          init_a=2.0, optimizer="sgd", lr=0.5)
    assert t.ping()
    np.testing.assert_allclose(t.sparse_pull([1, 5, 19]), 2.0)
    t.sparse_push([1, 5], np.ones((2, 4), np.float32))
    np.testing.assert_allclose(t.sparse_pull([1, 5]), 1.5)
    np.testing.assert_allclose(t.sparse_pull([2]), 2.0)
    assert t.dense_pull().shape == (20, 4)
    t.dense_push(np.ones((20, 4), np.float32))
    np.testing.assert_allclose(t.dense_pull()[2], 1.5)
    t.close()


def test_remote_matches_local_semantics(server_port):
    """Server-side adagrad through the van equals the in-process table,
    bit for bit (one library, one optimizer)."""
    local = PSTable(8, 2, init="zeros", optimizer="adagrad", lr=0.5)
    remote = van.RemotePSTable(HOST, server_port, 8, 2, init="zeros",
                               optimizer="adagrad", lr=0.5)
    idx = np.array([0, 3, 3])
    g = np.asarray([[1, 1], [2, 2], [2, 2]], np.float32)
    local.sparse_push(idx, g)
    remote.sparse_push(idx, g)
    np.testing.assert_array_equal(_bits(remote.sparse_pull([0, 3])),
                                  _bits(local.sparse_pull([0, 3])))
    remote.close()


def test_malformed_frames_rejected(server_port):
    """Short or unknown frames get rc -3 / -100 and the server lives on."""
    s = socket.create_connection((HOST, server_port), timeout=5)
    try:
        s.sendall(struct.pack("<IB", 2, 1) + b"x")  # OP_CREATE, 1-byte body
        s.recv(4)
        assert struct.unpack("<i", s.recv(4))[0] == -3
        s.sendall(struct.pack("<IB", 1, 200))       # an unknown op
        s.recv(4)
        assert struct.unpack("<i", s.recv(4))[0] == -100
    finally:
        s.close()
    t = van.RemotePSTable(HOST, server_port, 4, 2, init="zeros")
    assert t.ping()
    t.close()


def test_connection_refused_raises():
    with pytest.raises(ConnectionError):
        van.RemotePSTable(HOST, 1, 4, 4, connect_timeout_s=0.2)


def test_multiprocess_worker(server_port, tmp_path):
    """A worker process (the port's client, no jax) trains against this
    process's server, on a table this process made."""
    t = van.RemotePSTable(HOST, server_port, 10, 2, init="zeros",
                          optimizer="sgd", lr=1.0)
    script = tmp_path / "worker.py"
    script.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import numpy as np
from hetu_tpu_torch.ps import van
t = van.RemotePSTable("127.0.0.1", {server_port}, 10, 2, create=False,
                      table_id={t.id})
for _ in range(3):
    t.sparse_pull([7])
    t.sparse_push([7], np.ones((1, 2), np.float32))
print("final", t.sparse_pull([7]).tolist())
print("jax" in sys.modules)
""")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "final [[-3.0, -3.0]]\nFalse" in out.stdout
    np.testing.assert_allclose(t.sparse_pull([7]), -3.0)
    t.close()


def test_row_cas_semantics(server_port):
    t = van.RemotePSTable(HOST, server_port, 6, 4, init="zeros",
                          optimizer="sgd", lr=0.0)
    desired = np.asarray([7.0, 1.0, 2.0, 3.0], np.float32)
    ok, actual = t.row_cas(2, 0, 0.0, desired)
    assert ok and np.array_equal(actual, desired)
    ok2, actual2 = t.row_cas(2, 0, 0.0, np.zeros(4, np.float32))
    assert not ok2 and np.array_equal(actual2, desired)
    ok3, actual3 = t.row_cas(2, 3, 3.0, np.full(4, 9.0, np.float32))
    assert ok3 and np.array_equal(actual3, np.full(4, 9.0))
    t.close()


def test_row_cas_validates(server_port):
    t = van.RemotePSTable(HOST, server_port, 4, 3, init="zeros",
                          optimizer="sgd", lr=0.0)
    with pytest.raises(ValueError, match="fields"):
        t.row_cas(0, 0, 0.0, np.zeros(5, np.float32))
    with pytest.raises(RuntimeError):
        t.row_cas(0, 7, 0.0, np.zeros(3, np.float32))
    t.close()


def test_row_cas_two_claimant_race(server_port):
    """Two claimants CAS the same expected value at once: exactly one wins
    each round, and the loser reads the winner's row."""
    t1 = van.RemotePSTable(HOST, server_port, 4, 4, init="zeros",
                           optimizer="sgd", lr=0.0)
    t2 = van.RemotePSTable(HOST, server_port, 4, 4, create=False,
                           table_id=t1.id)
    for rnd in range(30):
        cur = float(t1.sparse_pull([1])[0][0])
        barrier = threading.Barrier(2, timeout=10)
        res = [None, None]

        def claim(i, tbl):
            barrier.wait()
            d = np.zeros(4, np.float32)
            d[0], d[1] = cur + 1, i
            res[i] = tbl.row_cas(1, 0, cur, d)

        ts = [threading.Thread(target=claim, args=(i, tt))
              for i, tt in enumerate((t1, t2))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(30)
            assert not th.is_alive()
        wins = [r[0] for r in res]
        assert sum(wins) == 1, (rnd, wins)
        loser = res[wins.index(False)][1]
        assert loser[0] == cur + 1 and loser[1] == wins.index(True)
    t1.close()
    t2.close()


def test_push_request_id_dedup(server_port):
    """A push re-sent with the same request id is applied once."""
    t = van.RemotePSTable(HOST, server_port, 4, 2, init="zeros",
                          optimizer="sgd", lr=1.0)
    g = np.ones((4, 2), np.float32)
    for _ in range(2):
        assert binding.lib.ps_van_dense_push_id(t.fd, t.id, client._f32p(g),
                                                8, 42) == 0
    np.testing.assert_allclose(t.dense_pull(), -1.0)
    idx = np.arange(2, dtype=np.int64)
    gs = np.ones((2, 2), np.float32)
    for _ in range(2):
        assert binding.lib.ps_van_sparse_push_id(
            t.fd, t.id, client._i64p(idx), client._f32p(gs), 2, 2, 43) == 0
    np.testing.assert_allclose(t.sparse_pull([0, 1]), -2.0)
    np.testing.assert_allclose(t.sparse_pull([2, 3]), -1.0)
    assert binding.lib.ps_van_dense_push_id(t.fd, t.id, client._f32p(g), 8,
                                            44) == 0
    np.testing.assert_allclose(t.sparse_pull([3]), -2.0)
    t.close()


def test_slots_and_checkpoint_over_the_wire(server_port, tmp_path):
    """Adam's slots read over the wire equal the in-process table's; a
    saved remote table loads back bit for bit; ``clear`` zeroes it."""
    kw = dict(init="normal", init_b=0.1, seed=4, optimizer="adam", lr=0.05)
    remote = van.RemotePSTable(HOST, server_port, 16, 4, **kw)
    local = PSTable(16, 4, **kw)
    g = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    idx = np.array([1, 2, 2, 9, 15, 0])
    remote.sparse_push(idx, g)
    local.sparse_push(idx, g)
    for a, b in zip(remote.slots_get(np.arange(16)),
                    local.slots_get(np.arange(16))):
        np.testing.assert_array_equal(a, b)
    s1, s2, step = local.slots_get([3])
    remote.slots_set([3], s1 + 1, s2 + 2, step + 3)
    got = remote.slots_get([3])
    np.testing.assert_array_equal(got[0], s1 + 1)
    np.testing.assert_array_equal(got[2], step + 3)
    rows = remote.dense_pull()
    remote.save(tmp_path / "t.ps")
    remote.clear()
    assert not remote.dense_pull().any()
    remote.load(tmp_path / "t.ps")
    np.testing.assert_array_equal(_bits(remote.dense_pull()), _bits(rows))
    remote.close()


def test_int8_gradient_wire_with_error_feedback(server_port):
    """The same gradient pushed 25 times over the int8 wire with sgd lr 1:
    error feedback keeps the table within 2 % of 25 g, and the registry
    records at least 3x fewer wire bytes than logical ones."""
    dim = 64
    t = van.RemotePSTable(HOST, server_port, 8, dim, init="zeros",
                          optimizer="sgd", lr=1.0, wire="int8")
    g = np.random.default_rng(1).standard_normal((2, dim)).astype(np.float32)
    logical = default_registry.counter("van.van_sparse_push.bytes_logical")
    wire = default_registry.counter("van.van_sparse_push.bytes_wire")
    l0, w0 = logical.value, wire.value
    for _ in range(25):
        t.sparse_push([3, 5], g)
    err = np.abs(t.sparse_pull([3, 5]) + 25 * g).max()
    assert err <= 0.02 * np.abs(25 * g).max(), err
    assert logical.value - l0 >= 3 * (wire.value - w0) > 0
    assert default_registry.counter(
        "van.van_sparse_push.bytes_saved").value > 0
    t.close()


def test_a_server_without_the_quantized_wire_falls_back_to_f32(
        server_port, monkeypatch):
    """rc -100 from a quantised op: the push is retried on the f32 ops and
    lands once, the client speaks f32 from then on, and the fallback is
    counted."""
    t = van.RemotePSTable(HOST, server_port, 4, 4, init="zeros",
                          optimizer="sgd", lr=1.0, wire="int8")

    class OldServer:
        def __getattr__(self, name):
            if name.endswith("_w"):
                return lambda *a: -100
            return getattr(binding.lib, name)

    monkeypatch.setattr(van, "lib", OldServer())
    fallbacks = default_registry.counter("van.wire_negotiation.fallbacks")
    before = fallbacks.value
    t.sparse_push([1], np.ones((1, 4), np.float32))
    assert t.wire is None and fallbacks.value == before + 1
    np.testing.assert_allclose(t.sparse_pull([1]), -1.0)
    t.close()


def test_unknown_wire_dtype_raises(server_port):
    with pytest.raises(ValueError, match="wire dtype"):
        van.RemotePSTable(HOST, server_port, 4, 4, wire="fp4")


def test_q8_codec_is_the_references(server_port):
    """The native int8 row codec of the port's library equals the
    reference's, NaN and ±Inf included."""
    from hetu_tpu.ps import client as jclient
    v = np.random.default_rng(2).standard_normal((6, 16)).astype(np.float32)
    v[0, 0], v[1, 1], v[2, 2] = np.nan, np.inf, -np.inf
    v[3] = 0.0
    q, s = client.q8_encode(v)
    jq, js = jclient.q8_encode(v)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(client.q8_decode(q, s),
                                  jclient.q8_decode(jq, js))
    with pytest.raises(ValueError, match=r"\[n, dim\]"):
        client.q8_encode(v[0])


def test_error_feedback_folds_a_duplicate_once():
    ef = client.ErrorFeedback(2)
    idx = np.array([4, 4, 7])
    intended = np.ones((3, 2), np.float32)
    ef.absorb_sparse(idx, intended, intended - 0.25)
    out = ef.fold_sparse(idx, np.zeros((3, 2), np.float32))
    np.testing.assert_array_equal(out, [[0.5, 0.5], [0, 0], [0.25, 0.25]])
    ef.absorb_dense(np.ones(3), np.zeros(3))
    np.testing.assert_array_equal(ef.fold_dense(np.ones(3)), 2.0)


# ---- the dtype'd rows over the wire (tests/test_ps_dtype.py) ----

def test_bf16_nan_quieting_preserves_sign_and_wire_path(server_port):
    t = van.RemotePSTable(HOST, server_port, 4, 4, init="zeros",
                          dtype="bf16")
    t.sparse_set([2], np.full((1, 4), np.nan, np.float32))
    assert np.isnan(t.sparse_pull([2])).all()
    t.close()


def _stat(port, key):
    return van.stats(HOST, port)[key]


@pytest.mark.parametrize("dtype,op,lo,hi", [
    ("bf16", "pull", 0.45, 0.6), ("bf16", "push", 0.45, 0.65),
    ("int8", "pull", 0.2, 0.35)])
def test_dtype_rows_shrink_the_wire(server_port, dtype, op, lo, hi):
    """bf16 rows move about half the bytes of f32 ones (pulls and pushes),
    int8 rows about a quarter (pulls); pulled values within the type's
    rounding."""
    rows, dim, n = 128, 64 if dtype == "int8" else 32, 20
    idx = np.arange(rows)
    g = np.random.default_rng(4).standard_normal((rows, dim)) \
        .astype(np.float32)

    def measure(dt):
        t = van.RemotePSTable(HOST, server_port, rows, dim, init="normal",
                              init_b=0.1, seed=5, optimizer="sgd", lr=0.1,
                              dtype=dt)
        t.sparse_pull(idx) if op == "pull" else t.sparse_push(idx, g)
        key = "bytes_tx" if op == "pull" else "bytes_rx"
        before = _stat(server_port, key)
        for _ in range(n):
            t.sparse_pull(idx) if op == "pull" else t.sparse_push(idx, g)
        delta = _stat(server_port, key) - before
        out = t.sparse_pull(idx)
        t.close()
        return out, delta

    a, f32_bytes = measure("f32")
    b, small_bytes = measure(dtype)
    assert lo < small_bytes / f32_bytes < hi, (f32_bytes, small_bytes)
    if op == "push":  # 21 pushes rounded to bf16 each: not compared,
        return        # as in the reference
    if dtype == "int8":
        scales = np.abs(a).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(a - b) <= scales * 0.51 + 1e-7)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2)


def test_partitioned_bf16_group_roundtrip(server_port):
    rows, dim, n = 128, 32, 10
    idx = np.arange(rows)

    def measure(dtype):
        t = van.PartitionedPSTable([(HOST, server_port)], rows, dim,
                                   init="normal", init_b=0.1, seed=9,
                                   optimizer="sgd", lr=0.1, dtype=dtype)
        t.sparse_pull(idx)
        before = van.stats(HOST, server_port)
        for _ in range(n):
            out = t.sparse_pull(idx)
            t.sparse_push(idx, np.ones((rows, dim), np.float32) * 0.01)
        after = van.stats(HOST, server_port)
        t.close()
        return out, (after["bytes_tx"] - before["bytes_tx"],
                     after["bytes_rx"] - before["bytes_rx"])

    a, (tx32, rx32) = measure("f32")
    b, (tx16, rx16) = measure("bf16")
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2)
    assert 0.45 < tx16 / tx32 < 0.6, (tx32, tx16)
    assert 0.45 < rx16 / rx32 < 0.65, (rx32, rx16)


def test_remote_cache_tier_on_bf16_rows(server_port):
    rows, dim = 256, 16

    def run(dtype):
        rng = np.random.default_rng(3)
        t = van.PartitionedPSTable([(HOST, server_port)], rows, dim,
                                   init="normal", init_b=0.1, seed=11,
                                   optimizer="sgd", lr=0.1, dtype=dtype)
        cache = van.RemoteCacheTable(t, capacity=64, policy="lru")
        before = _stat(server_port, "bytes_tx")
        for _ in range(6):
            ids = rng.integers(0, rows, 32)
            assert cache.embedding_lookup(ids).shape == (32, dim)
            cache.embedding_update(ids, np.full((32, dim), 0.01, np.float32))
        cache.flush()
        delta = _stat(server_port, "bytes_tx") - before
        vals = t.sparse_pull(np.arange(8))
        cache.close()
        t.close()
        return vals, delta

    a, tx32 = run("f32")
    b, tx16 = run("bf16")
    np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)
    assert tx16 < 0.75 * tx32, (tx32, tx16)


def test_shared_table_id_dtype_mismatch_rejected(server_port):
    tid = van.fresh_table_id()
    t = van.PartitionedPSTable([(HOST, server_port)], 32, 8, table_id=tid,
                               init="zeros", dtype="bf16")
    with pytest.raises(ConnectionError, match="rc=-8"):
        van.PartitionedPSTable([(HOST, server_port)], 32, 8, table_id=tid,
                               init="zeros", dtype="f32")
    van.PartitionedPSTable([(HOST, server_port)], 32, 8, table_id=tid,
                           init="zeros", dtype="bf16").close()
    t.close()


def test_scheduler_tier_bf16(server_port):
    """The in-process van doubles as its own scheduler: rank 0 registers
    pointing at itself, and the group resolves through it."""
    h = binding.lib.ps_sched_beat_start(HOST.encode(), server_port, 0,
                                        server_port, 500, 10.0)
    assert h > 0
    try:
        emb = PSEmbedding(500, 8, optimizer="sgd", lr=0.1, seed=2,
                          scheduler=(HOST, server_port, 1), dtype="bf16")
        ids = np.arange(32).reshape(8, 4)
        rows = emb.pull(ids)
        assert rows.shape == (8, 4, 8) and rows.dtype == torch.float32
        emb.push(ids, np.full((8, 4, 8), 0.01, np.float32))
        emb.close()
    finally:
        binding.lib.ps_sched_beat_stop(h)


# ---- the partitioned table (tests/test_ps_multiserver.py) ----

def test_keys_are_range_sharded(two_servers):
    t = van.PartitionedPSTable(two_servers.eps(), rows=10, dim=2,
                               init="zeros", optimizer="sgd", lr=1.0)
    assert t.n_servers == 2 and t.shard_starts == [0, 5]
    assert t.alive == [True, True]
    vals = np.arange(20, dtype=np.float32).reshape(10, 2)
    t.sparse_set(np.arange(10), vals)
    for server, lo in zip(two_servers, [0, 5]):
        shard = van.RemotePSTable(HOST, server.port, 5, 2, table_id=t.id,
                                  create=False)
        np.testing.assert_array_equal(shard.sparse_pull(np.arange(5)),
                                      vals[lo:lo + 5])
        shard.close()
    t.close()


def test_group_matches_single_table_semantics(two_servers):
    """Partitioned adagrad equals an in-process table fed the same
    traffic: within rtol 1e-6 as the reference holds it (bit for bit
    here); the dense plane crosses the shard boundary too."""
    eps = ",".join(f"{h}:{p}" for h, p in two_servers.eps())
    t = van.PartitionedPSTable(eps, rows=16, dim=3, init="zeros",
                               optimizer="adagrad", lr=0.5)
    local = PSTable(16, 3, init="zeros", optimizer="adagrad", lr=0.5)
    rng = np.random.default_rng(0)
    for _ in range(4):
        idx = rng.integers(0, 16, 6)
        g = rng.standard_normal((6, 3)).astype(np.float32)
        t.sparse_push(idx, g)
        local.sparse_push(idx, g)
    np.testing.assert_allclose(t.sparse_pull(np.arange(16)),
                               local.sparse_pull(np.arange(16)), rtol=1e-6)
    np.testing.assert_allclose(t.dense_pull(), local.dense_pull(), rtol=1e-6)
    g = rng.standard_normal((16, 3)).astype(np.float32)
    t.dense_push(g)
    local.dense_push(g)
    np.testing.assert_array_equal(_bits(t.dense_pull()),
                                  _bits(local.dense_pull()))
    for a, b in zip(t.slots_get(np.arange(16)), local.slots_get(
            np.arange(16))):
        np.testing.assert_array_equal(a, b)
    t.close()


def test_two_workers_share_group(two_servers, tmp_path):
    """Two worker processes (the port's client) push to one partitioned
    table."""
    eps = ",".join(f"{h}:{p}" for h, p in two_servers.eps())
    tid = van.fresh_table_id()
    t = van.PartitionedPSTable(eps, rows=10, dim=2, init="zeros",
                               optimizer="sgd", lr=1.0, table_id=tid)
    worker = tmp_path / "worker.py"
    worker.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import numpy as np
from hetu_tpu_torch.ps import van
t = van.PartitionedPSTable({eps!r}, rows=10, dim=2, init="zeros",
                           optimizer="sgd", lr=1.0, table_id={tid})
t.sparse_push([2, 7], np.ones((2, 2), np.float32))
t.close()
print("OK", flush=True)
""")
    procs = [subprocess.Popen([sys.executable, str(worker)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0 and "OK" in out
    np.testing.assert_allclose(t.sparse_pull([2, 7]), -2.0)
    t.close()


def test_uneven_rows_partition(two_servers):
    t = van.PartitionedPSTable(two_servers.eps(), rows=11, dim=1,
                               init="zeros", optimizer="sgd", lr=1.0)
    assert t.shard_starts == [0, 5]
    t.sparse_push(np.arange(11), np.ones((11, 1), np.float32))
    np.testing.assert_allclose(t.sparse_pull(np.arange(11)), -1.0)
    np.testing.assert_allclose(t.sparse_pull([-1, 11]), 0.0)
    t.sparse_push([-1, 11], np.ones((2, 1), np.float32))
    np.testing.assert_allclose(t.sparse_pull([0, 10]), -1.0)
    t.close()


def test_group_save_and_load(two_servers, tmp_path):
    """Each server saves its shard beside the path; a load brings the
    rows back bit for bit."""
    t = van.PartitionedPSTable(two_servers.eps(), rows=12, dim=3,
                               init="normal", init_b=0.5, seed=1)
    rows = t.dense_pull()
    t.save(tmp_path / "g.ps")
    t.sparse_set(np.arange(12), np.zeros((12, 3), np.float32))
    t.load(tmp_path / "g.ps")
    np.testing.assert_array_equal(_bits(t.dense_pull()), _bits(rows))
    t.close()


@pytest.mark.slow
def test_killed_server_fails_cleanly_then_recovers(fresh_servers):
    eps = fresh_servers.eps()
    t = van.PartitionedPSTable(eps, rows=10, dim=2, init="zeros",
                               optimizer="sgd", lr=1.0, heartbeat_ms=100)
    t.sparse_set(np.arange(10), np.ones((10, 2), np.float32))
    port1 = fresh_servers[1].port
    fresh_servers[1].kill()
    with pytest.raises(RuntimeError):
        t.sparse_pull([7])
    np.testing.assert_allclose(t.sparse_pull([2]), 1.0)
    fresh_servers[1] = _Server(PORT_SERVER, port1)
    got = _deadline_retry(lambda: t.sparse_pull([7]))
    assert got is not None, "group never recovered after server restart"
    np.testing.assert_allclose(got, 0.0)
    assert t.recovered >= 1
    t.sparse_set([7], np.full((1, 2), 5.0, np.float32))
    np.testing.assert_allclose(t.sparse_pull([7]), 5.0)
    # a sparse write must itself trigger the recovery
    fresh_servers[1].kill()
    fresh_servers[1] = _Server(PORT_SERVER, port1)
    before = t.recovered
    ok = _deadline_retry(lambda: t.sparse_set(
        [8], np.full((1, 2), 9.0, np.float32)) or True)
    assert ok and t.recovered > before
    np.testing.assert_allclose(t.sparse_pull([8]), 9.0)
    t.close()


# ---- the remote HET cache (tests/test_ps_remote_cache.py) ----

NOT_CACHED = np.uint64(0xFFFFFFFFFFFFFFFF)


def test_sync_pull_version_bound_semantics(two_servers):
    t = van.PartitionedPSTable(two_servers.eps(), rows=10, dim=2,
                               init="zeros", optimizer="sgd", lr=1.0)
    sel, base, rows = t.sync_pull([1, 6], [NOT_CACHED, NOT_CACHED])
    assert sorted(sel.tolist()) == [0, 1]
    np.testing.assert_allclose(rows, 0.0)
    v1, v6 = base[list(sel).index(0)], base[list(sel).index(1)]
    assert t.sync_pull([1, 6], [v1, v6], bound=0)[0].size == 0
    t.sparse_push([1, 6], np.ones((2, 2), np.float32))
    sel, _, rows = t.sync_pull([1, 6], [v1, v6], bound=0)
    assert sorted(sel.tolist()) == [0, 1]
    np.testing.assert_allclose(rows, -1.0)
    assert t.sync_pull([1, 6], [v1, v6], bound=1)[0].size == 0
    sel, _, _ = t.sync_pull([1, 6], [v1 + 50, v6 + 50], bound=1000)
    assert sorted(sel.tolist()) == [0, 1]
    with pytest.raises(ValueError, match="cached_versions"):
        t.sync_pull([1, 6], [v1])
    t.close()


def test_remote_cache_matches_mirror_single_worker(two_servers):
    rows, dim, lr = 64, 4, 0.5
    t = van.PartitionedPSTable(two_servers.eps(), rows=rows, dim=dim,
                               init="zeros", optimizer="sgd", lr=lr)
    cache = van.RemoteCacheTable(t, capacity=16, policy="lfuopt",
                                 pull_bound=0)
    mirror = np.zeros((rows, dim), np.float32)
    rng = np.random.default_rng(7)
    for _ in range(30):
        idx = rng.integers(0, rows, 8)
        np.testing.assert_allclose(cache.embedding_lookup(idx), mirror[idx],
                                   rtol=1e-5, atol=1e-6)
        g = rng.standard_normal((8, dim)).astype(np.float32)
        cache.embedding_update(idx, g)
        for k in np.unique(idx):
            mirror[k] -= lr * g[idx == k].sum(axis=0)
    assert cache.size <= 16
    assert cache.hit_rate > 0.1
    cache.flush()
    np.testing.assert_allclose(t.sparse_pull(np.arange(rows)), mirror,
                               rtol=1e-5, atol=1e-6)
    cache.close()
    t.close()


def test_remote_cache_bounded_staleness_two_workers(two_servers, tmp_path):
    """Two worker processes, each with its own cache, update disjoint key
    halves and read every key under a staleness bound; after both flush,
    the servers hold the combined mirror."""
    eps = ",".join(f"{h}:{p}" for h, p in two_servers.eps())
    rows, dim, lr, steps = 32, 2, 1.0, 12
    tid = van.fresh_table_id()
    t = van.PartitionedPSTable(eps, rows=rows, dim=dim, init="zeros",
                               optimizer="sgd", lr=lr, table_id=tid)
    worker = tmp_path / "cache_worker.py"
    worker.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import numpy as np
from hetu_tpu_torch.ps import van
wid = int(sys.argv[1])
t = van.PartitionedPSTable({eps!r}, rows={rows}, dim={dim}, init="zeros",
                           optimizer="sgd", lr={lr}, table_id={tid})
cache = van.RemoteCacheTable(t, capacity=12, policy="lru", pull_bound=2)
own = np.arange(wid * {rows} // 2, (wid + 1) * {rows} // 2)
g = ((own % 3 + 1).astype(np.float32))[:, None].repeat({dim}, 1)
for step in range({steps}):
    assert cache.embedding_lookup(np.arange({rows})).shape == ({rows}, {dim})
    cache.embedding_update(own, g)
cache.flush()
want = -{lr} * {steps} * g
np.testing.assert_allclose(cache.embedding_lookup(own), want, rtol=1e-5)
assert cache.hit_rate > 0.0
cache.close(); t.close()
print("OK", flush=True)
""")
    procs = [subprocess.Popen([sys.executable, str(worker), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0 and "OK" in out, err[-2000:]
    allk = np.arange(rows)
    want = (-lr * steps * (allk % 3 + 1).astype(np.float32))[:, None]
    np.testing.assert_allclose(t.sparse_pull(allk), want.repeat(dim, 1),
                               rtol=1e-5)
    t.close()


def test_remote_cache_eviction_pushes_dirty_victims(two_servers):
    t = van.PartitionedPSTable(two_servers.eps(), rows=40, dim=2,
                               init="zeros", optimizer="sgd", lr=1.0)
    cache = van.RemoteCacheTable(t, capacity=4, policy="lru", pull_bound=0)
    first = np.arange(4)
    cache.embedding_lookup(first)
    cache.embedding_update(first, np.ones((4, 2), np.float32))
    cache.embedding_lookup(np.arange(4, 8))
    assert cache.size <= 4
    np.testing.assert_allclose(t.sparse_pull(first), -1.0)
    cache.close()
    t.close()


def test_remote_cache_concurrent_threads_consistent(two_servers):
    rows, dim, lr, threads, steps = 64, 2, 1.0, 4, 15
    t = van.PartitionedPSTable(two_servers.eps(), rows=rows, dim=dim,
                               init="zeros", optimizer="sgd", lr=lr)
    cache = van.RemoteCacheTable(t, capacity=24, policy="lru", pull_bound=3)
    errs = []

    def worker(wid):
        try:
            own = np.arange(wid, rows, threads)
            g = np.ones((own.size, dim), np.float32) * (wid + 1)
            rng = np.random.default_rng(wid)
            for _ in range(steps):
                cache.embedding_lookup(rng.integers(0, rows, 16))
                cache.embedding_update(own, g)
        except Exception as e:  # reported below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(60)
        assert not th.is_alive()
    assert not errs, errs
    cache.flush()
    want = np.zeros((rows, dim), np.float32)
    for wid in range(threads):
        want[np.arange(wid, rows, threads)] = -lr * steps * (wid + 1)
    np.testing.assert_allclose(t.sparse_pull(np.arange(rows)), want,
                               rtol=1e-5)
    cache.close()
    t.close()


def test_remote_cache_metrics_go_to_the_registry_passed(two_servers):
    from hetu_tpu_torch.telemetry import MetricsRegistry
    reg = MetricsRegistry()
    t = van.PartitionedPSTable(two_servers.eps(), rows=20, dim=2,
                               init="zeros")
    cache = van.RemoteCacheTable(t, capacity=8, registry=reg)
    cache.embedding_lookup([1, 2, 1])
    cache.embedding_lookup([1, 2])
    assert reg.counter("ps.cache.lookups").value == 5
    assert reg.gauge("ps.cache.hit_rate").value == pytest.approx(
        cache.hit_rate)
    cache.reset_stats()
    assert cache.lookups == 0
    cache.close()
    t.close()


@pytest.mark.slow
def test_failed_push_retries_exactly_once(fresh_servers):
    t = van.PartitionedPSTable(fresh_servers.eps(), rows=10, dim=2,
                               init="zeros", optimizer="sgd", lr=1.0)
    cache = van.RemoteCacheTable(t, capacity=4, policy="lru", pull_bound=0)
    port1 = fresh_servers[1].port
    fresh_servers[1].kill()
    with pytest.raises(RuntimeError):
        cache.embedding_update([7], np.ones((1, 2), np.float32))
    fresh_servers[1] = _Server(PORT_SERVER, port1)
    assert _deadline_retry(lambda: cache.flush() or True), \
        "outstanding push never drained after restart"
    np.testing.assert_allclose(t.sparse_pull([7]), -1.0)
    cache.flush()
    np.testing.assert_allclose(t.sparse_pull([7]), -1.0)
    cache.close()
    t.close()


# ---- PSEmbedding's remote tiers, layered prefetch, close order ----

def _wdl_loop(emb, steps=25, seed=0):
    """The hybrid Wide & Deep loop on the CPU (pull, step, push); its
    losses."""
    b, fields, dense, vocab = 64, 4, 3, emb.table.rows
    model = WideDeep(fields, emb.dim, dense, hidden=(32,),
                     generator=torch.Generator().manual_seed(seed),
                     device="cpu")
    step = model.hybrid_step_fn(optim.AdamOptimizer(5e-3))
    rng = np.random.default_rng(seed)
    n = 512
    sparse = rng.integers(0, vocab, (n, fields)).astype(np.int64)
    dense_x = rng.standard_normal((n, dense)).astype(np.float32)
    w = rng.standard_normal(fields)
    y = ((sparse % 5 - 2) @ w * 0.3 + rng.standard_normal(n) > 0) \
        .astype(np.float32)
    losses = []
    for it in range(steps):
        lo = (it * b) % (n - b)
        ids = sparse[lo:lo + b]
        rows = emb.pull(ids)
        loss, _, g_rows = step(dense_x[lo:lo + b], rows, y[lo:lo + b])
        emb.push(ids, g_rows)
        losses.append(float(loss))
    emb.flush()
    return losses


@pytest.mark.parametrize("cache", [None, 256])
def test_psembedding_remote_tier_trains_wdl(two_servers, cache):
    """PSEmbedding over a table partitioned across two server processes,
    with and without the remote HET cache: the loss falls, and the cache
    hits."""
    emb = PSEmbedding(500, 8, optimizer="adagrad", lr=0.1, seed=0,
                      endpoints=two_servers.eps(), cache_capacity=cache,
                      pull_bound=1)
    assert emb.table.n_servers == 2
    assert isinstance(emb.cache, van.RemoteCacheTable if cache else
                      type(None))
    losses = _wdl_loop(emb)
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    if cache:
        assert emb.cache.hit_rate > 0.0
    emb.close()
    assert emb.table.gid == 0


def test_psembedding_argument_checks(two_servers):
    with pytest.raises(ValueError, match="not both"):
        PSEmbedding(10, 2, endpoints=two_servers.eps(),
                    scheduler=(HOST, 1, 2))
    with pytest.raises(ValueError, match="remote tiers only"):
        PSEmbedding(10, 2, table_id=5)


def test_psembedding_shares_a_remote_table_by_id(two_servers):
    tid = van.fresh_table_id()
    a = PSEmbedding(50, 4, optimizer="sgd", lr=1.0, init="zeros",
                    endpoints=two_servers.eps(), table_id=tid)
    b = PSEmbedding(50, 4, optimizer="sgd", lr=1.0, init="zeros",
                    endpoints=two_servers.eps(), table_id=tid)
    a.push([3, 40], np.ones((2, 4), np.float32))
    np.testing.assert_allclose(b.pull([3, 40]).numpy(), -1.0)
    a.close()
    b.close()


def test_close_flushes_the_cache_then_closes_cache_and_table(two_servers):
    """close(): the prefetch in flight finishes, the cache's pending
    gradients reach the servers, then the cache and the group close."""
    tid = van.fresh_table_id()
    emb = PSEmbedding(40, 2, optimizer="sgd", lr=1.0, init="zeros",
                      endpoints=two_servers.eps(), table_id=tid,
                      cache_capacity=16)
    emb.pull([1, 30])
    emb.push([1, 30], np.ones((2, 2), np.float32))
    emb.prefetch([5, 6])
    cache, table = emb.cache, emb.table
    emb.close()
    assert cache.id == 0 and table.gid == 0
    probe = van.PartitionedPSTable(two_servers.eps(), 40, 2, init="zeros",
                                   table_id=tid)
    np.testing.assert_allclose(probe.sparse_pull([1, 30]), -1.0)
    probe.close()


@pytest.mark.parametrize("tier", ["in-process", "remote"])
def test_prefetch_layered_segments_equal_direct_pulls(two_servers, tier):
    """P3's priority pull: segments issued by layer, collected in any
    order, each equal to a direct pull of its ids."""
    kw = dict(endpoints=two_servers.eps()) if tier == "remote" else {}
    emb = PSEmbedding(300, 4, seed=3, **kw)
    rng = np.random.default_rng(0)
    segs = {li: rng.integers(0, 300, (8, 2)) for li in (2, 0, 5)}
    emb.prefetch_layered(segs.items())
    with pytest.raises(RuntimeError, match="not fully collected"):
        emb.prefetch_layered([(9, [1])])
    for li in (5, 0, 2):
        got = emb.pull_layered(li)
        assert got.shape == (8, 2, 4)
        np.testing.assert_array_equal(got.numpy(), emb.pull(segs[li]).numpy())
    with pytest.raises(RuntimeError, match="no layered prefetch"):
        emb.pull_layered(0)
    with pytest.raises(ValueError, match="duplicate"):
        emb.prefetch_layered([(1, [1]), (1, [2])])
    emb.close()


def test_prefetch_layered_issues_segments_by_layer(monkeypatch):
    """The pulls reach the worker in ascending layer order, whatever the
    order of the segments."""
    emb = PSEmbedding(100, 2)
    order = []
    pull = emb.pull
    monkeypatch.setattr(emb, "pull",
                        lambda idx: order.append(int(idx[0])) or pull(idx))
    emb.prefetch_layered([(3, [30]), (1, [10]), (2, [20])])
    for li in (3, 1, 2):
        emb.pull_layered(li)
    assert order == [10, 20, 30]
    emb.close()


# ---- across the packages ----

def _same_traffic(table, pushes):
    for idx, g in pushes:
        table.sparse_push(idx, g)
    return table.sparse_pull(np.arange(table.rows))


def _pushes(rows, dim, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, rows, 12),
             rng.standard_normal((12, dim)).astype(np.float32))
            for _ in range(n)]


def test_partitioned_rows_are_bitwise_across_the_packages(two_servers,
                                                          ref_servers):
    """A port client on reference servers, a reference client on port
    servers and a port client on port servers: the same initial rows (the
    native init from one seed) and the same adagrad pushes give the same
    rows bit for bit."""
    kw = dict(init="normal", init_b=0.1, seed=7, optimizer="adagrad",
              lr=0.3)
    rows, dim = 37, 4
    pushes = _pushes(rows, dim)
    port_on_ref = van.PartitionedPSTable(ref_servers.eps(), rows, dim, **kw)
    ref_on_port = jvan.PartitionedPSTable(two_servers.eps(), rows, dim, **kw)
    port_on_port = van.PartitionedPSTable(two_servers.eps(), rows, dim, **kw)
    got = [_same_traffic(t, pushes)
           for t in (port_on_ref, ref_on_port, port_on_port)]
    for other in got[1:]:
        np.testing.assert_array_equal(_bits(got[0]), _bits(other))
    for t in (port_on_ref, ref_on_port, port_on_port):
        t.close()


def test_remote_rows_over_the_int8_wire_are_bitwise_across_the_packages(
        ref_servers, two_servers):
    """RemotePSTable with the int8 gradient wire and error feedback: a port
    client on a reference server and a reference client on a port server
    end on the same rows."""
    kw = dict(init="zeros", optimizer="sgd", lr=0.5, wire="int8")
    pushes = _pushes(16, 8, n=6, seed=1)
    a = van.RemotePSTable(HOST, ref_servers[0].port, 16, 8, **kw)
    b = jvan.RemotePSTable(HOST, two_servers[0].port, 16, 8, **kw)
    np.testing.assert_array_equal(_bits(_same_traffic(a, pushes)),
                                  _bits(_same_traffic(b, pushes)))
    a.close()
    b.close()


def test_remote_cache_rows_are_bitwise_across_the_packages(ref_servers,
                                                          two_servers):
    """The remote HET cache of each package over the other's servers:
    every lookup and the flushed table bit for bit."""
    kw = dict(init="normal", init_b=0.1, seed=3, optimizer="sgd", lr=0.2)
    ta = van.PartitionedPSTable(ref_servers.eps(), 64, 4, **kw)
    tb = jvan.PartitionedPSTable(two_servers.eps(), 64, 4, **kw)
    ca = van.RemoteCacheTable(ta, capacity=16, policy="lfuopt")
    cb = jvan.RemoteCacheTable(tb, capacity=16, policy="lfuopt")
    rng = np.random.default_rng(5)
    for _ in range(10):
        idx = rng.integers(0, 64, 8)
        np.testing.assert_array_equal(_bits(ca.embedding_lookup(idx)),
                                      _bits(cb.embedding_lookup(idx)))
        g = rng.standard_normal((8, 4)).astype(np.float32)
        ca.embedding_update(idx, g)
        cb.embedding_update(idx, g)
    ca.flush()
    cb.flush()
    np.testing.assert_array_equal(_bits(ta.sparse_pull(np.arange(64))),
                                  _bits(tb.sparse_pull(np.arange(64))))
    for x in (ca, cb, ta, tb):
        x.close()


def test_van_op_metrics_count_logical_and_wire_bytes(server_port):
    """``_OpSpan``'s logical bytes: a quantised op records the pair (and
    the saving) under its op's name; an f32 op records none."""
    t = van.RemotePSTable(HOST, server_port, 8, 16, init="zeros",
                          wire="bf16")
    pull_logical = default_registry.counter(
        "van.van_dense_pull.bytes_logical")
    before = pull_logical.value
    t.dense_pull()
    assert pull_logical.value - before == 8 * 16 * 4
    stats = van.op_stats()["van_dense_pull"]
    assert stats["bytes_wire"] >= 8 * 16 * 2
    assert "bytes_logical" not in van.op_stats().get("van_sparse_set", {})
    t.sparse_set([0], np.ones((1, 16), np.float32))
    assert "bytes_logical" not in van.op_stats()["van_sparse_set"]
    t.close()


# ---- the scheduler role (tests/test_ps_scheduler.py) ----

class _Cluster:
    """A scheduler (a plain van server) and ``n`` servers registered with
    it."""

    def __init__(self, n):
        self.sched = _Server(PORT_SERVER, 0)
        self.servers = _Servers()
        try:
            for _ in range(n):
                self.servers.append(self.register())
        except BaseException:
            self.kill()
            raise

    def register(self, port=0, rank_hint=-1):
        return _Server(REG_SERVER, port, self.sched.port, rank_hint)

    def map(self):
        return {e["rank"]: e for e in van.scheduler_map(HOST,
                                                        self.sched.port)}

    def kill(self):
        self.servers.kill()
        self.sched.kill()


@pytest.fixture(scope="module")
def cluster():
    c = _Cluster(2)
    yield c
    c.kill()


@pytest.fixture
def fresh_cluster():
    c = _Cluster(2)
    yield c
    c.kill()


def test_registration_assigns_ranks_and_map_lists_alive(cluster):
    assert sorted(s.rank for s in cluster.servers) == [0, 1]
    m = cluster.map()
    assert sorted(m) == [0, 1] and all(e["alive"] for e in m.values())
    for s in cluster.servers:
        assert m[s.rank]["port"] == s.port and m[s.rank]["host"] == HOST


def test_reference_client_reads_the_port_schedulers_map(cluster):
    """The scheduler's wire is the reference's: its ``scheduler_map``
    reads the port's scheduler alike."""
    assert sorted(jvan.scheduler_map(HOST, cluster.sched.port),
                  key=lambda e: e["rank"]) == \
        sorted(van.scheduler_map(HOST, cluster.sched.port),
               key=lambda e: e["rank"])


def test_group_via_scheduler(cluster):
    t = van.PartitionedPSTable.from_scheduler(
        HOST, cluster.sched.port, 2, rows=10, dim=2, init="zeros",
        optimizer="sgd", lr=1.0)
    assert t.n_servers == 2 and t.alive == [True, True]
    t.sparse_set(np.arange(10), np.ones((10, 2), np.float32))
    t.sparse_push([2, 8], np.ones((2, 2), np.float32))
    np.testing.assert_allclose(t.sparse_pull([2, 8, 5]),
                               [[0, 0], [0, 0], [1, 1]])
    t.close()


def test_psembedding_scheduler_tier_trains_wdl(cluster):
    emb = PSEmbedding(500, 8, optimizer="adagrad", lr=0.1, seed=0,
                      scheduler=(HOST, cluster.sched.port, 2),
                      cache_capacity=128)
    assert emb.table.n_servers == 2
    losses = _wdl_loop(emb, steps=20)
    assert losses[-1] < losses[0] and emb.cache.hit_rate > 0
    emb.close()


def test_dead_server_goes_stale_in_map():
    c = _Cluster(2)
    try:
        dead = c.servers[0].rank
        c.servers[0].kill()
        deadline = time.monotonic() + 15
        m = c.map()
        while m[dead]["alive"] and time.monotonic() < deadline:
            time.sleep(0.3)
            m = c.map()
        assert not m[dead]["alive"], "dead server never marked stale"
        assert m[1 - dead]["alive"]
    finally:
        c.kill()


def test_rank_takeover_converges_no_flap():
    """A register with a live rank's hint takes the rank over; the old
    server stops advertising, and the map shows one owner."""
    c = _Cluster(1)
    try:
        new_port = _free_port()
        c.servers.append(c.register(new_port, rank_hint=0))
        deadline = time.monotonic() + 15
        seen = []
        while time.monotonic() < deadline:
            seen.append(c.map()[0]["port"])
            if seen[-4:] == [new_port] * 4:
                break
            time.sleep(0.3)
        assert seen[-4:] == [new_port] * 4, (seen, new_port)
        assert c.map()[0]["alive"]
    finally:
        c.kill()


@pytest.mark.slow
def test_group_via_scheduler_and_rejoin_at_new_port(fresh_cluster):
    c = fresh_cluster
    t = van.PartitionedPSTable.from_scheduler(
        HOST, c.sched.port, 2, rows=10, dim=2, init="zeros",
        optimizer="sgd", lr=1.0)
    t.sparse_set(np.arange(10), np.ones((10, 2), np.float32))
    next(s for s in c.servers if s.rank == 1).kill()
    with pytest.raises(RuntimeError):
        t.sparse_pull([7])
    np.testing.assert_allclose(t.sparse_pull([2]), 1.0)
    new_port = _free_port()
    c.servers.append(c.register(new_port, rank_hint=1))
    assert c.servers[-1].port == new_port
    got = _deadline_retry(lambda: t.sparse_pull([7]))
    assert got is not None, "group never recovered at the new endpoint"
    np.testing.assert_allclose(got, 0.0)
    assert t.recovered >= 1
    t.sparse_set([7], np.full((1, 2), 5.0, np.float32))
    np.testing.assert_allclose(t.sparse_pull([7]), 5.0)
    t.close()


@pytest.mark.slow
def test_cache_tier_survives_rejoin_at_new_port(fresh_cluster):
    c = fresh_cluster
    t = van.PartitionedPSTable.from_scheduler(
        HOST, c.sched.port, 2, rows=20, dim=2, init="zeros",
        optimizer="sgd", lr=1.0)
    cache = van.RemoteCacheTable(t, capacity=8, policy="lru", pull_bound=0)
    cache.embedding_lookup(np.arange(10, 16))
    cache.embedding_update([12], np.ones((1, 2), np.float32))
    cache.flush()
    np.testing.assert_allclose(t.sparse_pull([12]), -1.0)
    next(s for s in c.servers if s.rank == 1).kill()
    c.servers.append(c.register(_free_port(), rank_hint=1))
    got = _deadline_retry(lambda: cache.embedding_lookup([12]), 25.0)
    assert got is not None, "cache never recovered through the scheduler"
    np.testing.assert_allclose(got, 0.0)
    cache.embedding_update([12], np.ones((1, 2), np.float32))
    cache.flush()
    np.testing.assert_allclose(cache.embedding_lookup([12]), -1.0)
    cache.close()
    t.close()


# ---- SSP and partial reduce: in process (tests/test_ps.py) and over the
# wire (tests/test_ps_scheduler.py) ----

def test_remote_ssp_blocks_fast_worker(server_port):
    a = van.RemoteSSP(HOST, server_port, ssp_id=501, n_workers=2,
                      staleness=1)
    b = van.RemoteSSP(HOST, server_port, ssp_id=501, n_workers=2,
                      staleness=1, create=True)  # -2 tolerated
    assert a.clock_and_wait(0, timeout_ms=2000)
    assert a.clock_and_wait(0, timeout_ms=200) is False
    assert b.clock_and_wait(1, timeout_ms=2000)
    assert a.clock(0) == 2 and b.clock(1) == 1
    a.close()
    b.close()


def test_remote_preduce_forms_groups(server_port):
    a = van.RemotePReduce(HOST, server_port, pool_id=601, max_group=2,
                          wait_ms=5000)
    b = van.RemotePReduce(HOST, server_port, pool_id=601, max_group=2,
                          wait_ms=5000)
    out = {}
    ts = [threading.Thread(target=lambda n, c, w: out.__setitem__(
        n, c.get_partner(w)), args=args) for args in (("a", a, 0),
                                                      ("b", b, 3))]
    for th in ts:
        th.start()
    for th in ts:
        th.join(30)
        assert not th.is_alive()
    assert out["a"] == out["b"] == [0, 3]
    with pytest.raises(ValueError, match="worker id"):
        a.get_partner(64)
    a.close()
    b.close()


def test_preduce_and_ssp_instances_are_independent():
    pr_a = PartialReduce(max_group=2, wait_ms=1500)
    pr_b = PartialReduce(max_group=2, wait_ms=1500)
    out = {}

    def w(pool, wid, key):
        out[key] = pool.get_partner(wid)

    ts = [threading.Thread(target=w, args=args) for args in
          ((pr_a, 0, "a0"), (pr_a, 1, "a1"), (pr_b, 2, "b2"),
           (pr_b, 3, "b3"))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert out["a0"] == out["a1"] == [0, 1]
    assert out["b2"] == out["b3"] == [2, 3]
    s1 = SSPController(2, staleness=10)
    s2 = SSPController(3, staleness=0)
    s1.clock_and_wait(0, timeout_ms=100)
    assert s1.clock(0) == 1 and s2.clock(0) == 0
    with pytest.raises(ValueError, match="worker id"):
        pr_a.get_partner(64)


def test_ssp_bounded_staleness():
    ssp = SSPController(2, staleness=1)
    results = {}

    def fast():
        ok0 = ssp.clock_and_wait(0, timeout_ms=200)
        ok1 = ssp.clock_and_wait(0, timeout_ms=2000)  # must wait for slow
        results["fast"] = (ok0, ok1, time.monotonic())

    def slow():
        time.sleep(0.15)
        ssp.clock_and_wait(1, timeout_ms=200)
        results["slow"] = time.monotonic()

    ts = [threading.Thread(target=fast), threading.Thread(target=slow)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    ok0, ok1, t_fast = results["fast"]
    assert ok0 and ok1
    assert t_fast >= results["slow"] - 0.05


def test_preduce_matchmaking():
    pr = PartialReduce(max_group=2, wait_ms=2000)
    groups = {}
    ts = [threading.Thread(target=lambda w: groups.__setitem__(
        w, pr.get_partner(w)), args=(w,)) for w in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert groups[0] == groups[1] == [0, 1]
    assert PartialReduce(max_group=4, wait_ms=50).get_partner(3) == [3]


def test_scheduler_map_of_an_unreachable_scheduler_raises():
    with pytest.raises(ConnectionError):
        van.scheduler_map(HOST, 1)


def test_stop_ends_the_heartbeats_before_the_van(monkeypatch):
    """``stop()`` stops every beat it started first, then the van."""
    calls = []

    class Lib:
        def ps_sched_beat_stop(self, h):
            calls.append(("beat", h))

        def ps_van_stop(self):
            calls.append(("van",))

    monkeypatch.setattr(van, "lib", Lib())
    monkeypatch.setattr(van, "_beat_handles", [3, 4])
    van.stop()
    assert calls == [("beat", 4), ("beat", 3), ("van",)]


def test_no_jax_in_a_port_server_process():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\nsys.path.insert(0, sys.argv[1])\n"
         "from hetu_tpu_torch.ps import van\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'hetu_tpu')))", str(REPO)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"

