"""Live KV-slot migration in hetu_tpu_torch against hetu_tpu on the CPU.

The reference's tiny GPT (V 97, H 64, 2 layers, 4 heads) and GQA Llama (4
query heads over 2 kv heads), with parameters drawn with numpy from a seed
in the JAX package's layout and loaded into the port through ``interop``,
are the fixtures of every test.  Mirrored here: every in-process test of
``tests/test_migrate.py`` and the migration tests of
``tests/test_paged_kv.py``.  A request migrated mid-decode must give the
reference's ``_ref_greedy`` stream token for token, and the adopting
engine's counters (zero prefill for a migrated slot) must equal those of
the reference's adopter after the same migration.

Across the packages: the port's payload is byte-identical to the
reference's for the same rows under codecs none, bf16 and int8, each
package unpacks the other's payload, the int8 block codec is bitwise the
reference's numpy codec (NaN, ±Inf and all-zero blocks included), and the
paged adopter's bookkeeping (page tables, refcounts, free list, prefix
keys) equals the reference's.  Last, the ``migrate`` phase of
``chip_smoke.py`` runs on the CPU at a small size.
"""

import gc
import importlib.util
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import hetu_tpu.quantwire as jax_qw
from hetu_tpu.models.gpt import GPTConfig as JaxGPTConfig
from hetu_tpu.models.gpt import GPTModel as JaxGPTModel
from hetu_tpu.serve import ContinuousBatchingScheduler as JaxScheduler
from hetu_tpu.serve import PagedServeEngine as JaxPagedServeEngine
from hetu_tpu.serve import Request as JaxRequest
from hetu_tpu.serve import ServeEngine as JaxServeEngine
from hetu_tpu.serve import migrate as jax_mg
from hetu_tpu.serve.kv_cache import KVCacheSpec as JaxKVCacheSpec
from hetu_tpu.serve.kv_cache import KVSlotSnapshot as JaxSnapshot
from hetu_tpu_torch import quantwire
from hetu_tpu_torch.serve import (
    ContinuousBatchingScheduler, KVCacheSpec, KVSlotSnapshot, MigrationError,
    PagedServeEngine, Request, ServeEngine,
)
from hetu_tpu_torch.serve import migrate as mg
from hetu_tpu_torch.serve.migrate import MigrationTargetError
from hetu_tpu_torch.serve.scheduler import finish_request
from hetu_tpu_torch.telemetry import MetricsRegistry
from test_torch_gpt_serve import _jax_model as _jax_gpt
from test_torch_gpt_serve import _torch_model as _torch_gpt
from test_torch_llama import _jax_model as _jax_llama
from test_torch_llama import _jax_vars as _jax_llama_vars
from test_torch_llama import _torch_model as _torch_llama

torch.set_num_threads(2)

pytestmark = pytest.mark.migrate

# the adopter's counters held to the reference's adopter
COUNTERS = ("prefill_tokens", "prefill_compiles", "decode_steps",
            "decode_compiles", "slots_adopted", "requests_adopted",
            "requests_exported")


@pytest.fixture(scope="module")
def gpt():
    """(JAX model, JAX variables, the port's model), f32, plain path."""
    jm, jv = _jax_gpt("xla")
    return jm, jv, _torch_gpt("xla")


@pytest.fixture(scope="module")
def llama():
    return (_jax_llama("gqa", "xla"), _jax_llama_vars("gqa"),
            _torch_llama("gqa", "xla"))


@pytest.fixture(scope="module")
def gpt_bf16():
    jm = JaxGPTModel(JaxGPTConfig(
        vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
        ffn_size=128, max_position=64, dropout_rate=0.0,
        attention_impl="xla", dtype=jnp.bfloat16))
    _, jv = _jax_gpt("xla")
    return jm, jv, _torch_gpt("xla", dtype=torch.bfloat16)


_FORWARD = {}


def _ref_greedy(jm, jv, prompt, n):
    """The reference's oracle: greedy argmax of the JAX full forward.  The
    forward runs jitted at the model's ``max_position`` with the ids
    right-padded, so one shape compiles per model: a causal model's
    logits at a position do not see the positions after it (the same
    tokens as the reference's unpadded loop on every prompt here)."""
    if id(jm) not in _FORWARD:
        _FORWARD[id(jm)] = jax.jit(lambda ids: jm.apply(jv, ids)[0][0])
    forward, width = _FORWARD[id(jm)], jm.c.max_position
    ids, out = list(prompt), []
    for _ in range(n):
        padded = np.zeros((1, width), np.int32)
        padded[0, :len(ids)] = ids
        logits = forward(jnp.asarray(padded))[len(ids) - 1]
        out.append(int(jnp.argmax(logits)))
        ids.append(out[-1])
    return out


def _engine(tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("min_bucket", 8)
    return ServeEngine(tm, device="cpu", **kw)


def _jax_engine(jm, jv, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("min_bucket", 8)
    return JaxServeEngine(jm, jv, **kw)


def _counts(metrics):
    return {name: metrics.count(name) for name in COUNTERS}


def _migrate_mid_decode(make, module, prompt, n_total, n_before, *,
                        via_wire=False, codec="none"):
    """Decode ``n_before`` tokens on a source engine, migrate the live slot
    to a fresh peer (through a packed payload with ``via_wire``), decode
    the rest there; returns (tokens, destination engine).  ``make`` and
    ``module`` pick the package."""
    src, dst = make(), make()
    slot = src.alloc_slot()
    toks = [src.prefill(slot, prompt)]
    for _ in range(n_before - 1):
        toks.append(src.decode()[slot])
    snaps = src.export_slots([slot])
    if via_wire:
        spec_d, snaps, _ = module.unpack(
            module.pack(src.cache.spec, snaps, codec=codec))
        module.check_spec(dst.cache.spec, spec_d)
    slot_map = dst.adopt_slots(snaps)
    src.release(slot)
    new = slot_map[slot]
    while len(toks) < n_total:
        toks.append(dst.decode()[new])
    return toks, dst


def _hold_to_reference(fixture, prompt, n_total, n_before, **kw):
    """The port's migration against the reference's: the same stream as
    ``_ref_greedy`` and the same adopter counters, with no prefill."""
    jm, jv, tm = fixture
    toks, dst = _migrate_mid_decode(lambda: _engine(tm), mg, prompt,
                                    n_total, n_before, **kw)
    want, jdst = _migrate_mid_decode(lambda: _jax_engine(jm, jv), jax_mg,
                                     prompt, n_total, n_before, **kw)
    assert toks == _ref_greedy(jm, jv, prompt, n_total) == want
    assert _counts(dst.metrics) == _counts(jdst.metrics)
    assert dst.metrics.count("prefill_tokens") == 0
    assert dst.metrics.count("prefill_compiles") == 0
    assert dst.metrics.count("slots_adopted") == 1
    return dst


# ---- migration parity: zero re-prefill on the adopter ----

@pytest.mark.parametrize("n_before", [1, 4])
def test_gpt_migrated_decode_parity_zero_prefill(gpt, n_before):
    _hold_to_reference(gpt, [3, 14, 15, 9, 2, 6], 10, n_before)


def test_llama_gqa_migrated_decode_parity(llama):
    assert llama[2].c.num_kv_heads < llama[2].c.num_heads  # really GQA
    _hold_to_reference(llama, [7, 3, 1, 88], 9, 3)


def test_parity_through_packed_wire_payload(gpt):
    """The same with the rows through pack -> unpack -> check_spec."""
    _hold_to_reference(gpt, [5, 6, 7], 8, 2, via_wire=True)


def test_exported_rows_are_the_cache_rows_and_import_writes_only_its_slot(
        gpt):
    _, _, tm = gpt
    src = _engine(tm)
    a, b = src.alloc_slot(), src.alloc_slot()
    src.prefill(a, [3, 1, 4, 1, 5])
    src.prefill(b, [2, 7])
    src.decode()
    (snap,) = src.export_slots([a])
    assert snap.k.device.type == "cpu" and snap.k.dtype == torch.float32
    assert snap.length == 6 and snap.meta["last_token"] == \
        int(src.last_tokens[a])
    assert torch.equal(snap.k, src.cache.k[:, a, :6])
    assert torch.equal(snap.v, src.cache.v[:, a, :6])
    dst = _engine(tm)
    other = dst.alloc_slot()
    dst.prefill(other, [9, 9, 9])
    before = (dst.cache.k.clone(), dst.cache.v.clone())
    new = dst.adopt_slots([snap])[a]
    assert torch.equal(dst.cache.k[:, new, :6], snap.k)
    assert torch.equal(dst.cache.v[:, new, :6], snap.v)
    keep = [s for s in range(dst.cache.num_slots) if s != new]
    for got, was in zip((dst.cache.k, dst.cache.v), before):
        assert torch.equal(got[:, keep], was[:, keep])
        assert torch.equal(got[:, new, 6:], was[:, new, 6:])


# ---- geometry and dtype gates: loud errors, nothing partially adopted ----

def test_geometry_mismatch_errors_loudly_adopts_nothing(gpt, llama):
    src = _engine(gpt[2])
    dst = _engine(llama[2])  # 2 kv heads against GPT's 4
    slot = src.alloc_slot()
    src.prefill(slot, [1, 2, 3])
    snaps = src.export_slots([slot])
    free_before = dst.cache.num_free
    with pytest.raises(ValueError, match="mismatch"):
        dst.adopt_slots(snaps)
    assert dst.cache.num_free == free_before
    spec_d, _, _ = mg.unpack(mg.pack(src.cache.spec, snaps))
    with pytest.raises(MigrationError, match="geometry mismatch"):
        mg.check_spec(dst.cache.spec, spec_d)


def test_snapshot_longer_than_peer_max_len_rejected(gpt):
    tm = gpt[2]
    src = _engine(tm, max_len=48)
    dst = _engine(tm, max_len=8)
    slot = src.alloc_slot()
    src.prefill(slot, list(range(1, 11)))  # 10 cached tokens
    snaps = src.export_slots([slot])
    with pytest.raises(ValueError, match="room to decode"):
        dst.adopt_slots(snaps)
    assert dst.cache.num_free == dst.cache.num_slots


def test_export_validates_slot_state(gpt):
    eng = _engine(gpt[2])
    with pytest.raises(ValueError):  # a free slot: nothing to export
        eng.cache.export_slots([0])
    slot = eng.alloc_slot()
    with pytest.raises(ValueError):  # allocated, never prefilled
        eng.export_slots([slot])


def test_adopt_refuses_a_snapshot_without_last_token(gpt):
    eng = _engine(gpt[2])
    slot = eng.alloc_slot()
    eng.prefill(slot, [4, 2])
    snaps = eng.cache.export_slots([slot])  # a cache export: no meta
    dst = _engine(gpt[2])
    with pytest.raises(ValueError, match="last_token"):
        dst.adopt_slots(snaps)
    assert dst.cache.num_free == dst.cache.num_slots
    assert dst.metrics.count("slots_adopted") == 0


def test_exported_slots_suspend_until_released_or_resumed(gpt):
    eng = _engine(gpt[2])
    a = eng.alloc_slot()
    eng.prefill(a, [3, 1, 4])
    b = eng.alloc_slot()
    eng.prefill(b, [2, 7])
    len_a = int(eng.cache.lengths[a])
    eng.export_slots([a])
    out = eng.decode()  # the decode step inside the transfer window
    assert b in out and a not in out
    assert int(eng.cache.lengths[a]) == len_a
    eng.resume_slots([a])
    out2 = eng.decode()  # rollback: resumes where it stopped
    assert a in out2
    assert int(eng.cache.lengths[a]) == len_a + 1


def test_failed_export_suspends_nothing(gpt):
    """Suspension comes after every snapshot: an export that fails on its
    second slot leaves the first one decoding."""
    eng = _engine(gpt[2])
    a = eng.alloc_slot()
    eng.prefill(a, [3, 1, 4])
    with pytest.raises(ValueError):
        eng.export_slots([a, 1])  # slot 1 is free
    assert eng.active[a]


# ---- wire format ----

def test_pack_unpack_roundtrip_with_records(gpt):
    eng = _engine(gpt[2])
    slot = eng.alloc_slot()
    first = eng.prefill(slot, [4, 5, 6])
    req = Request(prompt=[4, 5, 6], max_tokens=9, eos_id=7, timeout_s=30.0)
    req.tokens = [first]
    req.submitted_at = time.monotonic() - 1.5
    snaps = eng.export_slots([slot])
    payload = mg.pack(eng.cache.spec, snaps,
                      records=[mg.request_record(req)])
    spec_d, snaps2, recs = mg.unpack(payload)
    assert spec_d["dtype"] == "float32"
    (s,) = snaps2
    assert torch.equal(s.k, snaps[0].k) and torch.equal(s.v, snaps[0].v)
    assert s.meta["last_token"] == first
    (rec,) = recs
    got = mg.request_from_record(rec)
    assert got.prompt == [4, 5, 6] and got.tokens == [first]
    assert got.max_tokens == 9 and got.eos_id == 7
    assert 1.0 < time.monotonic() - got.submitted_at < 3.0


def test_corrupt_body_fails_clean(gpt):
    eng = _engine(gpt[2])
    slot = eng.alloc_slot()
    eng.prefill(slot, [1, 2, 3, 4])
    payload = bytearray(mg.pack(eng.cache.spec, eng.export_slots([slot])))
    payload[-3] ^= 0xFF  # a K/V byte: the body CRC catches it
    with pytest.raises(MigrationError, match="CRC"):
        mg.unpack(bytes(payload))
    with pytest.raises(MigrationError, match="magic"):
        mg.unpack(b"JUNK" + bytes(payload[4:]))
    with pytest.raises(MigrationError):
        mg.unpack(bytes(payload[:10]))  # a truncated header


def test_bf16_model_pack_unpack_roundtrip(gpt_bf16):
    """A bf16 cache's rows cross as bf16, named as numpy names them."""
    eng = _engine(gpt_bf16[2])
    slot = eng.alloc_slot()
    eng.prefill(slot, [4, 5, 6, 7])
    snaps = eng.export_slots([slot])
    assert snaps[0].k.dtype == torch.bfloat16
    spec_d, snaps2, _ = mg.unpack(mg.pack(eng.cache.spec, snaps))
    assert spec_d["dtype"] == "bfloat16"
    (s,) = snaps2
    assert torch.equal(s.k, snaps[0].k) and torch.equal(s.v, snaps[0].v)


def test_int8_codec_shrinks_and_bounds_error(gpt):
    tm = gpt[2]
    eng = _engine(tm)
    slot = eng.alloc_slot()
    eng.prefill(slot, list(range(1, 25)))
    snaps = eng.export_slots([slot])
    raw = mg.pack(eng.cache.spec, snaps)
    packed = mg.pack(eng.cache.spec, snaps, codec="int8")
    assert len(raw) >= 3 * len(packed)  # about 4x on an f32 cache
    spec_d, snaps2, _ = mg.unpack(packed)
    assert spec_d["dtype"] == "float32"
    (s,) = snaps2
    assert s.k.dtype == torch.float32 and s.length == snaps[0].length
    for a, b in ((snaps[0].k, s.k), (snaps[0].v, s.v)):
        # one scale per (layer, head): |err| <= blockmax / 254 an element
        bound = a.abs().amax(dim=(1, 3), keepdim=True) / 254 + 1e-7
        assert bool(((a - b).abs() <= bound).all())
    dst = _engine(tm)
    assert snaps[0].slot in dst.adopt_slots(snaps2)


def test_bf16_codec_token_parity_on_bf16_model(gpt_bf16):
    """The bf16 codec over a bf16 cache is lossless: a request migrated
    through the compressed payload decodes as one never migrated (the
    port's unmigrated engine and the reference's migration)."""
    jm, jv, tm = gpt_bf16
    prompt = [3, 1, 4, 1, 5]
    toks, dst = _migrate_mid_decode(lambda: _engine(tm), mg, prompt, 10, 4,
                                    via_wire=True, codec="bf16")
    eng = _engine(tm)
    slot = eng.alloc_slot()
    alone = [eng.prefill(slot, prompt)]
    while len(alone) < 10:
        alone.append(eng.decode()[slot])
    assert toks == alone
    want, jdst = _migrate_mid_decode(lambda: _jax_engine(jm, jv), jax_mg,
                                     prompt, 10, 4, via_wire=True,
                                     codec="bf16")
    assert want == _ref_greedy(jm, jv, prompt, 10)
    assert toks == want
    assert _counts(dst.metrics) == _counts(jdst.metrics)


def test_unknown_codec_rejected_both_ways(gpt):
    eng = _engine(gpt[2])
    slot = eng.alloc_slot()
    eng.prefill(slot, [1, 2, 3])
    snaps = eng.export_slots([slot])
    with pytest.raises(ValueError, match="codec"):
        mg.pack(eng.cache.spec, snaps, codec="zstd")
    payload = mg.pack(eng.cache.spec, snaps)
    magic, ver, hlen = mg._PAYLOAD_HDR.unpack_from(payload)
    off = mg._PAYLOAD_HDR.size
    hdr = json.loads(payload[off:off + hlen])
    hdr["codec"] = "zstd"
    hb = json.dumps(hdr, separators=(",", ":")).encode()
    tampered = mg._PAYLOAD_HDR.pack(magic, ver, len(hb)) + hb + \
        payload[off + hlen:]
    with pytest.raises(MigrationError, match="unknown KV codec"):
        mg.unpack(tampered)


# ---- scheduler hand-off ----

def _requests(cls, specs):
    return [cls(prompt=list(p), max_tokens=m) for p, m in specs]


def _run_schedulers(make_src, make_dst, module, sched_cls, req_cls, specs,
                    steps):
    """Submit ``specs`` to a source scheduler, step it ``steps`` times,
    migrate everything, drain the destination; returns (requests, src,
    dst)."""
    s1, s2 = sched_cls(make_src()), sched_cls(make_dst())
    reqs = _requests(req_cls, specs)
    for r in reqs:
        s1.submit(r)
    for _ in range(steps):
        s1.step()
    module.migrate_inflight(s1, s2)
    for _ in range(200):
        if not s2.has_work():
            break
        s2.step()
    return reqs, s1, s2


def _scheduler_pair(fixture, specs, steps, src_kw=None, dst_kw=None,
                    paged=(False, False)):
    """The same traffic through the port's and the reference's schedulers
    and ``migrate_inflight``; returns both (requests, src, dst)."""
    jm, jv, tm = fixture
    src_kw, dst_kw = src_kw or {}, dst_kw or {}

    def port(kw, is_paged):
        if is_paged:
            return lambda: PagedServeEngine(tm, device="cpu", **kw)
        return lambda: _engine(tm, **kw)

    def ref(kw, is_paged):
        if is_paged:
            return lambda: JaxPagedServeEngine(jm, jv, **kw)
        return lambda: _jax_engine(jm, jv, **kw)

    got = _run_schedulers(port(src_kw, paged[0]), port(dst_kw, paged[1]),
                          mg, ContinuousBatchingScheduler, Request, specs,
                          steps)
    want = _run_schedulers(ref(src_kw, paged[0]), ref(dst_kw, paged[1]),
                           jax_mg, JaxScheduler, JaxRequest, specs, steps)
    return got, want


def test_scheduler_migration_mid_decode_parity(gpt):
    jm, jv, _ = gpt
    specs = [([1, 2, 3], 10), ([9, 8, 7, 6], 12)]
    (reqs, s1, s2), (jreqs, _, js2) = _scheduler_pair(gpt, specs, 4)
    assert all(r.tokens for r in reqs)
    assert not s1.has_work()
    assert s1.engine.cache.num_free == s1.engine.cache.num_slots
    assert [r.status for r in reqs] == ["ok", "ok"]
    assert [r.tokens for r in reqs] == [
        _ref_greedy(jm, jv, p, m) for p, m in specs] == \
        [r.tokens for r in jreqs]
    assert s2.engine.metrics.count("prefill_tokens") == 0
    assert _counts(s2.metrics) == _counts(js2.metrics)
    assert s1.metrics.count("requests_exported") == 2


def test_scheduler_migration_carries_queued_requests(gpt):
    """A queued request rides the same hand-off and prefills on the peer;
    the running one does not."""
    jm, jv, _ = gpt
    specs = [([1, 2], 8), ([5, 6, 7], 6)]
    (reqs, _, s2), (jreqs, _, js2) = _scheduler_pair(
        gpt, specs, 1, src_kw=dict(num_slots=1))
    assert [r.tokens for r in reqs] == [
        _ref_greedy(jm, jv, p, m) for p, m in specs] == \
        [r.tokens for r in jreqs]
    assert s2.engine.metrics.count("prefill_tokens") == 3  # the queued one
    assert s2.metrics.count("slots_adopted") == 1
    assert _counts(s2.metrics) == _counts(js2.metrics)


def test_export_fold_charges_requeue_and_frees_slots(gpt):
    s1 = ContinuousBatchingScheduler(_engine(gpt[2]))
    req = Request(prompt=[1, 2, 3], max_tokens=10)
    s1.submit(req)
    for _ in range(3):
        s1.step()
    emitted = list(req.tokens)
    pairs = s1.export_inflight(fold=True)
    assert pairs == [(req, None)]
    assert req.requeues == 1
    assert req.prompt == [1, 2, 3] + emitted
    assert s1.engine.cache.num_free == s1.engine.cache.num_slots


class _DeadWire:
    def put(self, data, seq, *, timeout_s=None):
        raise ConnectionError("wire died mid-transfer")

    def get(self, seq, *, timeout_s=None):
        raise ConnectionError("wire died mid-transfer")


def test_migrate_with_a_wire_raises_and_moves_nothing(gpt):
    """A wire that dies moves nothing and is never replaced by the
    in-process hand-off: the transport's error surfaces and the request
    stays on the source, mid-decode."""
    s1 = ContinuousBatchingScheduler(_engine(gpt[2]))
    s2 = ContinuousBatchingScheduler(_engine(gpt[2]))
    req = Request(prompt=[3, 1, 4], max_tokens=6)
    s1.submit(req)
    s1.step()
    with pytest.raises(ConnectionError, match="wire died"):
        mg.migrate_inflight(s1, s2, wire=(_DeadWire(), _DeadWire()))
    assert s1.owns(req) and s1.engine.active.any()
    assert not s2.has_work()
    assert s2.engine.metrics.count("slots_adopted") == 0
    s1.run([])
    assert req.status == "ok"


# ---- rollback: the source serves on, or every request resolves ----

class EngineKilled(RuntimeError):
    pass


class _KillableEngine:
    """A proxy over an engine whose every verb raises once ``kill()`` has
    run (the reference pool's ``_GuardedEngine``); the raw cache stays
    readable, so a dead engine's slots can still be freed."""

    def __init__(self, inner):
        self.inner = inner
        self.killed = False

    @property
    def cache(self):
        return self.inner.cache

    @property
    def metrics(self):
        return self.inner.metrics

    def kill(self):
        self.killed = True

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if not callable(fn):
            return fn

        def verb(*args, **kw):
            if self.killed:
                raise EngineKilled("engine killed")
            return fn(*args, **kw)
        return verb


def test_rollback_onto_dead_engine_attaches_nothing(gpt):
    eng = _KillableEngine(_engine(gpt[2]))
    sched = ContinuousBatchingScheduler(eng)
    req = Request(prompt=[3, 1, 4], max_tokens=9)
    sched.submit(req)
    for _ in range(2):
        sched.step()
    pairs, _snaps = sched.export_inflight_with_slots()
    eng.kill()  # the fault lands mid-rollback
    with pytest.raises(EngineKilled):
        sched.adopt_inflight(pairs)
    assert not sched._running and not sched._queue
    assert not req.done.is_set()  # the caller (migrate_inflight) resolves it


def test_export_rollback_does_not_count_requests_exported(gpt):
    eng = _KillableEngine(_engine(gpt[2]))
    sched = ContinuousBatchingScheduler(eng)
    req = Request(prompt=[3, 1, 4], max_tokens=9)
    sched.submit(req)
    for _ in range(2):
        sched.step()
    eng.kill()  # export_slots raises mid-export
    with pytest.raises(EngineKilled):
        sched.export_inflight_with_slots()
    assert sched.metrics.count("requests_exported") == 0
    assert sched._running  # re-attached where it was


def test_export_rollback_releases_done_in_transit_slot(gpt):
    eng = _KillableEngine(_engine(gpt[2]))  # 2 slots
    sched = ContinuousBatchingScheduler(eng)
    live = Request(prompt=[3, 1, 4], max_tokens=9)
    doomed = Request(prompt=[2, 7], max_tokens=9)
    sched.submit(live)
    sched.submit(doomed)
    for _ in range(2):
        sched.step()
    assert len(sched._running) == 2 and eng.cache.num_free == 0
    finish_request(doomed, "timeout")  # a backstop cancel, mid-export
    eng.kill()
    with pytest.raises(EngineKilled):
        sched.export_inflight_with_slots()
    assert eng.cache.num_free == 1  # doomed's slot freed, not leaked
    assert list(sched._running.values()) == [live]


def test_refused_adoption_rolls_back_to_the_source(gpt):
    """A destination that refuses (its intake stopped) leaves requests and
    slots at the source, which serves them to the reference's stream;
    the destination adopts nothing."""
    jm, jv, tm = gpt
    s1 = ContinuousBatchingScheduler(_engine(tm))
    s2 = ContinuousBatchingScheduler(_engine(tm))
    s2.stop_intake()
    req = Request(prompt=[3, 1, 4], max_tokens=9)
    queued = [Request(prompt=[5, 6], max_tokens=4) for _ in range(2)]
    for r in [req] + queued:
        s1.submit(r)
    for _ in range(2):
        s1.step()
    with pytest.raises(MigrationTargetError, match="drained"):
        mg.migrate_inflight(s1, s2)
    assert s1.has_work() and s1.engine.cache.num_free == 0
    s1.run([])
    assert req.status == "ok"
    assert req.tokens == _ref_greedy(jm, jv, [3, 1, 4], 9)
    assert all(q.tokens == _ref_greedy(jm, jv, [5, 6], 4) for q in queued)
    assert s2.engine.cache.num_free == s2.engine.cache.num_slots
    assert s1.metrics.count("requests_exported") == 0


def test_double_failure_resolves_every_request(gpt):
    """The destination refuses and the source engine dies before the
    rollback: every request resolves ('error') and the source's slots are
    freed through the raw cache."""
    tm = gpt[2]
    eng = _KillableEngine(_engine(tm))
    s1 = ContinuousBatchingScheduler(eng)
    s2 = ContinuousBatchingScheduler(_engine(tm))
    reqs = [Request(prompt=[3, 1, 4], max_tokens=9),
            Request(prompt=[2, 7], max_tokens=9),
            Request(prompt=[8], max_tokens=3)]
    for r in reqs:
        s1.submit(r)
    for _ in range(2):
        s1.step()

    def refuse(pairs, snapshots=None, **kw):
        eng.kill()  # the source dies while the destination refuses
        raise RuntimeError("destination lost")

    s2.adopt_inflight = refuse
    with pytest.raises(MigrationTargetError, match="destination lost"):
        mg.migrate_inflight(s1, s2)
    assert all(r.done.is_set() and r.status == "error" for r in reqs)
    assert eng.cache.num_free == eng.cache.num_slots
    assert not s1.has_work()


# ---- paged engines: live pages only, slot <-> paged ----

def _paged(**kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    return kw


def _bookkeeping(cache):
    return (cache.tables, cache.ref_table.tolist(), cache.ref_index.tolist(),
            list(cache._free_pages), list(cache._free_slots),
            list(cache._prefix), cache.lengths.tolist(),
            cache._reserve.tolist())


def _oracle(jm, jv, prompts, n):
    return [_ref_greedy(jm, jv, p, n) for p in prompts]


def _prompts(seed, lengths):
    g = np.random.default_rng(seed)
    return [[int(t) for t in g.integers(0, 97, k)] for k in lengths]


def test_paged_to_paged_migration_token_parity(gpt):
    """Also the adopter's bookkeeping equals the reference's right after
    the adoption (pages rebuilt locally, adopted slots re-indexed)."""
    jm, jv, tm = gpt
    prompts = _prompts(7, (11, 23, 6))
    specs = [(p, 10) for p in prompts]
    s1, s2 = (ContinuousBatchingScheduler(PagedServeEngine(
        tm, device="cpu", **_paged())) for _ in range(2))
    j1, j2 = (JaxScheduler(JaxPagedServeEngine(jm, jv, **_paged()))
              for _ in range(2))
    runs = []
    for a, b, mod, req_cls in ((s1, s2, mg, Request),
                               (j1, j2, jax_mg, JaxRequest)):
        reqs = _requests(req_cls, specs)
        for r in reqs:
            a.submit(r)
        for _ in range(5):
            a.step()  # mid-decode
        mod.migrate_inflight(a, b)
        runs.append(reqs)
    assert _bookkeeping(s2.engine.cache) == _bookkeeping(j2.engine.cache)
    assert s2.metrics.count("prefix_reindexed") == \
        j2.metrics.count("prefix_reindexed") > 0
    for sch in (s2, j2):
        for _ in range(80):
            if not sch.has_work():
                break
            sch.step()
    want = _oracle(jm, jv, prompts, 10)
    assert [r.tokens for r in runs[0]] == want == [r.tokens for r in runs[1]]
    assert s2.engine.metrics.count("slots_adopted") >= 1
    assert _counts(s2.metrics) == _counts(j2.metrics)
    # the source holds pages only in its prefix index
    assert not s1.engine.cache.ref_table.any()
    assert s1.engine.cache.pages_in_use == s1.engine.cache.reclaimable_pages


def test_slot_to_paged_cross_allocator_migration(gpt):
    jm, jv, _ = gpt
    prompts = _prompts(8, (9, 17))
    (reqs, _, s2), (jreqs, _, js2) = _scheduler_pair(
        gpt, [(p, 10) for p in prompts], 4,
        src_kw=dict(num_slots=2, max_len=64, min_bucket=16),
        dst_kw=_paged(), paged=(False, True))
    want = _oracle(jm, jv, prompts, 10)
    assert [r.tokens for r in reqs] == want == [r.tokens for r in jreqs]
    assert _counts(s2.metrics) == _counts(js2.metrics)
    assert s2.metrics.count("prefill_tokens") == 0


def test_paged_to_slot_migration(gpt):
    """The reverse drain: paged pages into a slot engine's rows."""
    jm, jv, _ = gpt
    prompts = _prompts(9, (12, 5, 30))
    (reqs, _, s2), (jreqs, _, js2) = _scheduler_pair(
        gpt, [(p, 8) for p in prompts], 6, src_kw=_paged(),
        dst_kw=dict(num_slots=4, max_len=64), paged=(True, False))
    want = _oracle(jm, jv, prompts, 8)
    assert [r.tokens for r in reqs] == want == [r.tokens for r in jreqs]
    assert _counts(s2.metrics) == _counts(js2.metrics)


def test_mid_prefill_request_migrates_as_queued(gpt):
    """A request whose chunked prefill is still running moves as queued
    and prefills again on the peer from its prompt alone (no requeue
    charged), to the reference's stream and counters."""
    jm, jv, _ = gpt
    prompts = _prompts(21, (6, 30))  # one chunk of 8 a step, oldest first
    (reqs, s1, s2), (jreqs, _, js2) = _scheduler_pair(
        gpt, [(p, 6) for p in prompts], 2,
        src_kw=_paged(num_slots=2, prefill_chunk=8),
        dst_kw=_paged(num_slots=2), paged=(True, True))
    assert [r.tokens for r in reqs] == _oracle(jm, jv, prompts, 6) == \
        [r.tokens for r in jreqs]
    assert s2.metrics.count("prefill_tokens") == 30  # the long prompt
    assert s2.metrics.count("slots_adopted") == 1
    assert reqs[1].requeues == 0
    assert _counts(s2.metrics) == _counts(js2.metrics)
    assert not s1.engine.cache.ref_table.any()


def test_paged_payload_roundtrip_with_codec(gpt):
    """export_payload / adopt_payload between paged schedulers (live
    pages only on the wire), with the int8 codec through the same
    unpack; the wire bytes land in the source's registry."""
    jm, jv, tm = gpt
    prompts = _prompts(13, (10, 19))
    src = ContinuousBatchingScheduler(PagedServeEngine(
        tm, device="cpu", **_paged(num_slots=2)))
    reqs = _requests(Request, [(p, 12) for p in prompts])
    for r in reqs:
        src.submit(r)
    for _ in range(3):
        src.step()
    payload, pairs = mg.export_payload(src, codec="none")
    spec = src.engine.cache.spec
    per_tok = 2 * spec.num_layers * spec.num_kv_heads * spec.head_dim * 4
    live = int(src.engine.cache.lengths.sum())
    assert len(payload) < live * per_tok + 4096
    reg = src.metrics.registry.metrics()
    assert reg["serve.migrate.bytes_logical"].value == \
        reg["serve.migrate.bytes_wire"].value == live * per_tok
    dst = ContinuousBatchingScheduler(PagedServeEngine(
        tm, device="cpu", **_paged(num_slots=2)))
    adopted, slot_map = mg.adopt_payload(dst, payload)
    mg.release_exported(src, pairs)
    assert len(adopted) == 2 and len(slot_map) == 2
    assert not src.engine.cache.ref_table.any()
    assert src.metrics.count("requests_exported") == 2
    for _ in range(80):
        if not dst.has_work():
            break
        dst.step()
    assert [r.tokens for r in adopted] == _oracle(jm, jv, prompts, 12)


def test_import_respects_outstanding_reservations(gpt):
    """An adoption must not take pages that a running chunked prefill's
    admission reserved, and a refused one leaves the pool as it was."""
    tm = gpt[2]
    e = PagedServeEngine(tm, device="cpu", num_slots=4, max_len=64,
                         page_size=8, num_pages=9, prefix_sharing=False)
    slot = e.alloc_slot()
    e.begin_prefill(slot, list(range(1, 30)), max_tokens=8)  # reserves
    assert int(e.cache._reserve[slot]) > 0
    spec = e.cache.spec
    n = 17  # 3 pages
    rows = torch.zeros((spec.num_layers, n, spec.num_kv_heads,
                        spec.head_dim), dtype=spec.dtype)
    snap = KVSlotSnapshot(slot=0, length=n, k=rows, v=rows,
                          meta={"last_token": 1})
    assert 3 > e.cache.available_pages()
    before = _bookkeeping(e.cache)
    with pytest.raises(RuntimeError, match="available"):
        e.adopt_slots([snap])
    assert _bookkeeping(e.cache) == before
    while e.prefill_step(slot) is None:
        pass
    assert e.active[slot]


def _pool_state(cache):
    """The pool's bookkeeping up to the order of its free lists."""
    return (cache.tables, cache.ref_table.tolist(), cache.ref_index.tolist(),
            sorted(cache._free_pages), sorted(cache._free_slots),
            list(cache._prefix), cache.lengths.tolist(),
            cache._reserve.tolist())


def test_failed_paged_import_frees_its_pages(gpt):
    """A write that fails half way through an adoption of two slots frees
    both slots and every page the call took."""
    e = PagedServeEngine(gpt[2], device="cpu", **_paged())
    spec = e.cache.spec

    def rows(n):
        return torch.ones((spec.num_layers, n, spec.num_kv_heads,
                           spec.head_dim), dtype=spec.dtype)

    snaps = [KVSlotSnapshot(slot=s, length=n, k=rows(n), v=rows(n),
                            meta={"last_token": 1})
             for s, n in ((0, 11), (1, 9))]
    before = _pool_state(e.cache)
    real, calls = e.cache._rows_index, []

    def failing(table, n):  # the second slot's write fails
        calls.append(n)
        if len(calls) == 2:
            raise RuntimeError("write failed")
        return real(table, n)

    e.cache._rows_index = failing
    with pytest.raises(RuntimeError, match="write failed"):
        e.adopt_slots(snaps)
    del e.cache._rows_index
    assert _pool_state(e.cache) == before
    assert e.metrics.count("slots_adopted") == 0
    assert not e.active.any()


# ---- across the packages: the payload, its codecs, the records ----

def _rows(g, shape, dtype):
    """Seeded K/V rows with a few bf16 rounding ties and an all-zero
    (layer, head) block."""
    x = g.standard_normal(shape).astype(np.float32)
    bits = x.view(np.uint32)
    bits[0, :, 0, :4] = (bits[0, :, 0, :4] & 0xFFFF0000) | 0x8000
    x[1, :, 1, :] = 0.0
    return x.astype(dtype)


_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _snapshot_pair(dtype, seed=0):
    """The same two slots' rows as reference and port snapshots."""
    g = np.random.default_rng(seed)
    L, H, D = 3, 2, 8
    ref, port = [], []
    for slot, n, last in ((5, 7, 11), (2, 13, 42)):
        k = _rows(g, (L, n, H, D), _NP[dtype])
        v = _rows(g, (L, n, H, D), _NP[dtype])
        ref.append(JaxSnapshot(slot=slot, length=n, k=k, v=v,
                               meta={"last_token": last}))
        port.append(KVSlotSnapshot(slot=slot, length=n, k=_to_torch(k),
                                   v=_to_torch(v),
                                   meta={"last_token": last}))
    return (JaxKVCacheSpec(L, H, D, _JNP[dtype]),
            KVCacheSpec(L, H, D, _TORCH[dtype]), ref, port)


def _record(cls):
    req = cls(prompt=[4, 5, 6], max_tokens=9, eos_id=7, timeout_s=30.0)
    req.rid = 17
    req.tokens = [1, 2]
    req.submitted_at = 100.0
    req.first_token_at = 100.5
    return req


CODEC_CASES = [(c, d) for d in ("float32", "bfloat16")
               for c in ("none", "bf16", "int8")]


@pytest.mark.parametrize("codec,dtype", CODEC_CASES)
def test_pack_is_byte_identical_to_the_reference(codec, dtype):
    jspec, spec, ref, port = _snapshot_pair(dtype)
    records = [jax_mg.request_record(_record(JaxRequest), now=101.5)]
    want = jax_mg.pack(jspec, ref, records, codec=codec)
    got = mg.pack(spec, port, records, codec=codec)
    assert isinstance(got, bytes)
    assert got == want


@pytest.mark.parametrize("codec,dtype", CODEC_CASES)
def test_each_package_unpacks_the_others_payload(codec, dtype):
    jspec, spec, ref, port = _snapshot_pair(dtype, seed=1)
    theirs = jax_mg.pack(jspec, ref, codec=codec)
    mine = mg.pack(spec, port, codec=codec)
    ref_spec, ref_snaps, _ = jax_mg.unpack(theirs)
    got_spec, got_snaps, _ = mg.unpack(theirs)
    back_spec, back_snaps, _ = jax_mg.unpack(mine)
    assert got_spec == ref_spec == back_spec
    mg.check_spec(spec, got_spec)
    for r, p, b in zip(ref_snaps, got_snaps, back_snaps):
        assert (p.slot, p.length, p.meta) == (r.slot, r.length, r.meta)
        for name in ("k", "v"):
            want = np.asarray(getattr(r, name))
            assert getattr(p, name).dtype == _TORCH[dtype]
            np.testing.assert_array_equal(
                _to_numpy(getattr(p, name)).view(np.uint8),
                want.view(np.uint8))
            np.testing.assert_array_equal(
                np.asarray(getattr(b, name)).view(np.uint8),
                want.view(np.uint8))


def test_request_records_are_the_references():
    got = mg.request_record(_record(Request), now=101.5)
    want = jax_mg.request_record(_record(JaxRequest), now=101.5)
    assert json.dumps(got) == json.dumps(want)
    req = mg.request_from_record(got, now=200.0)
    assert (req.rid, req.prompt, req.tokens, req.eos_id, req.max_tokens) \
        == (17, [4, 5, 6], [1, 2], 7, 9)
    assert req.submitted_at == req.first_token_at == 198.5


def _q8_input(dtype):
    g = np.random.default_rng(3)
    a = (g.standard_normal((3, 5, 4, 6)) * 3).astype(np.float32)
    a[0, 1, 0, 2] = np.nan
    a[0, 2, 0, 3] = np.inf
    a[1, 0, 2, 1] = -np.inf
    a[1, :, 3, :] = 0.0                    # an all-zero block
    a[2, :, 1, :] = np.nan                 # an all-nonfinite block
    a[2, 0, 1, 0] = np.inf
    a[2, 1, 1, 1] = -np.inf
    a[2, :, 2, :] = np.float32(1.5) * np.arange(30).reshape(5, 6)  # ties
    return a.astype(_NP[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_codec_is_bitwise_the_references(dtype):
    a = _q8_input(dtype)
    want_q, want_s = jax_qw.q8_encode_axes(a, (1, 3))
    got_q, got_s = quantwire.q8_encode_axes(_to_torch(a), (1, 3))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    assert (got_s.numpy()[1, 0, 3, 0], got_s.numpy()[2, 0, 1, 0]) == (0, 0)
    want = jax_qw.q8_decode_axes(want_q, want_s)
    got = quantwire.q8_decode_axes(got_q, got_s)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # the decode to bf16: an f32 product rounded to nearest even, as
    # ml_dtypes' astype
    np.testing.assert_array_equal(
        _to_numpy(got.to(torch.bfloat16)).view(np.uint16),
        want.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_record_wire_bytes_counts_into_the_callers_registry():
    reg = MetricsRegistry()
    quantwire.record_wire_bytes(reg, "serve.migrate", 1000, 260)
    quantwire.record_wire_bytes(reg, "serve.migrate", 10, 20)
    m = reg.metrics()
    assert (m["serve.migrate.bytes_logical"].value,
            m["serve.migrate.bytes_wire"].value,
            m["serve.migrate.bytes_saved"].value) == (1010, 280, 740)


def test_codec_policy_is_the_references(gpt, monkeypatch):
    for rate in (None, 0.0, 1.0, 100.0, 1e4, 1e6):
        for size in (0, 1 << 10, 1 << 20, 1 << 30):
            for dt in ("float32", "bfloat16"):
                assert mg.pick_codec(rate, size, dt) == \
                    jax_mg.pick_codec(rate, size, dt)
    for bad in ("zstd", "auto"):
        with pytest.raises(ValueError):
            mg.check_codec(bad, allow_auto=False)
    assert mg.check_codec("auto") == "auto"
    jm, jv, tm = gpt
    eng, jeng = _engine(tm), _jax_engine(jm, jv)
    for e in (eng, jeng):
        e.prefill(e.alloc_slot(), [1, 2, 3, 4, 5])
    assert mg.estimate_payload_bytes(eng) == \
        jax_mg.estimate_payload_bytes(jeng) == 5 * 2 * 2 * 4 * 16 * 4
    # "auto" without a rate reads the process's link signal
    # (known_link_mbps): none, no evidence; a slow link, int8
    for rate, want in ((None, "none"), (1e-3, "int8")):
        for module in (mg, jax_mg):
            monkeypatch.setattr(module, "known_link_mbps",
                                lambda rate=rate: rate)
        assert mg.resolve_codec("auto", eng) == \
            jax_mg.resolve_codec("auto", jeng) == want
    assert mg.resolve_codec("auto", eng, rate_mbps=1e-3) == "int8"
    assert mg.resolve_codec("bf16", eng) == "bf16"


# ---- chip_smoke.py's migrate phase, rehearsed on the CPU ----

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the phase at the sizes of tests/test_torch_chip_smoke.py's paged
# rehearsal (page 4 for 16): every gate runs, and CPU tensors launch no
# flash kernel, so the launch gate expects none
TINY_MIGRATE = dict(
    V=97, H=64, L=2, NH=4, FFN=128, MAX_LEN=192, SLOTS=8, N_REQUESTS=16,
    GPT_PROMPT=(1, 32), LLAMA_V=97, LLAMA_H=64, LLAMA_L=2, LLAMA_NH=4,
    LLAMA_FFN=96, LLAMA_P=256, LLAMA_MAX_LEN=256, LLAMA_PROMPT=(1, 128),
    PAGE_SIZE=4, MIGRATE_STEPS=4)


def _live_engines():
    gc.collect()
    return sum(isinstance(o, (ServeEngine, PagedServeEngine))
               for o in gc.get_objects())


def test_migrate_phase_runs_on_the_cpu(monkeypatch, capsys):
    """Also: nothing the phase returns keeps an engine it built alive (a
    finished request's ``owner`` holds its scheduler, and so the engine,
    which on the card would hold the later phases' memory)."""
    from hetu_tpu_torch.models import LlamaConfig, LlamaModel

    for name, value in TINY_MIGRATE.items():
        monkeypatch.setattr(chip_smoke, name, value)
    c = chip_smoke
    cfg = LlamaConfig(vocab_size=c.LLAMA_V, hidden_size=c.LLAMA_H,
                      num_layers=c.LLAMA_L, num_heads=c.LLAMA_NH,
                      num_kv_heads=2, ffn_size=c.LLAMA_FFN,
                      max_position=c.LLAMA_P, dtype=torch.bfloat16,
                      attention_impl="flash")
    engine = ServeEngine(LlamaModel(cfg, device="cpu"),
                         num_slots=c.LLAMA_SLOTS, max_len=c.LLAMA_MAX_LEN,
                         device="cpu")
    pairs = c.burst(np.random.default_rng(3), c.LLAMA_V, c.LLAMA_REQUESTS,
                    c.LLAMA_PROMPT, c.LLAMA_GEN)
    ref = c._serve_burst(engine, pairs, "cpu")
    ref = [r.tokens for r in ref["requests"]]
    before = _live_engines()
    out = c.phase_migrate("cpu", 0, engine, ref, device="cpu")
    assert _live_engines() == before
    text = capsys.readouterr().out
    for route in ("slot->slot", "slot->paged", "paged->paged"):
        assert f"[migrate] gpt {route}: 16 of 16 streams token-exact" in text
        assert f"[migrate] llama {route}:" in text
    for codec in ("none", "bf16", "int8"):
        assert f"[migrate] llama drain {codec}:" in text
    assert out["llama"]["drain"]["int8"]["ratio"] >= 1.9
    assert out["launches"] == 0
    assert {m.attention_impl for m in engine.model.modules()
            if hasattr(m, "attention_impl")} == {"flash"}
