"""The port's link emulator (``hetu_tpu_torch.ps.netem``) against
hetu_tpu's on the CPU.

Mirrored: the 7 emulator tests of ``tests/test_netem.py`` (direction
classification, byte-for-byte replay of drops, the one-way partition, a
partition that heals itself, latency and bandwidth delay, the JSON round
trips, a schedule that applies and clears a policy) and
``test_resolve_codec_prefers_netem_visible_rate`` on the port's engine.

Added: one seed's sequence of drops and delays, held equal in both
packages (the per-link rng is seeded from ``(seed << 32) ^ crc32(link)``
in each), through the hook and through ``LinkPolicy.delay_for`` alone.

The policies that heal themselves run on timers; every wait on one has a
deadline of its own.
"""

import time

import numpy as np
import pytest
import torch

from hetu_tpu.ps import netem as jne
from hetu_tpu_torch.ps import netem as ne

WAIT_S = 5.0


# ---------------------------------------------------------------- mirrors

def test_op_direction_classification():
    assert ne.op_directions("van_sparse_push") == (ne.EGRESS,)
    assert ne.op_directions("van_sparse_set") == (ne.EGRESS,)
    assert ne.op_directions("blob_put") == (ne.EGRESS,)
    assert ne.op_directions("van_dense_pull") == (ne.INGRESS,)
    assert ne.op_directions("blob_get") == (ne.INGRESS,)
    # control ops need both directions up
    assert set(ne.op_directions("van_ping")) == {ne.EGRESS, ne.INGRESS}


def _drops(module, seed, n=50):
    em = module.NetEm(local="a", peer="van", seed=seed)
    em.set_link(module.LinkPolicy(drop_p=0.4), direction="egress")
    out = []
    for _ in range(n):
        try:
            em.hook("van_sparse_set", 64)
            out.append(0)
        except module.NetemDrop:
            out.append(1)
    return out


def test_drop_decisions_replay_byte_for_byte():
    a, b = _drops(ne, 7), _drops(ne, 7)
    assert a == b and 0 < sum(a) < 50
    assert _drops(ne, 8) != a  # a different seed is a different run


def test_asymmetric_partition_is_one_way():
    em = ne.NetEm(local="m0", peer="van", seed=0)
    em.set_link(ne.LinkPolicy(partition=True), direction="egress")
    # m0's writes black-hole...
    with pytest.raises(ne.NetemDrop) as ei:
        em.hook("van_sparse_set", 32)
    assert "m0->van" in str(ei.value)
    # ...while its reads still work (the controller-ward half is up)
    em.hook("van_sparse_pull", 32)
    em.clear_link(direction="egress")
    em.hook("van_sparse_set", 32)  # healed


def test_partition_auto_expires():
    em = ne.NetEm(seed=0)
    em.set_link(ne.LinkPolicy(partition=True, duration_s=0.15),
                direction="egress")
    with pytest.raises(ne.NetemDrop):
        em.hook("blob_put", 8)
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        try:
            em.hook("blob_put", 8)
            break
        except ne.NetemDrop:
            time.sleep(0.02)
    else:
        pytest.fail("partition did not self-heal")


def test_latency_and_bandwidth_delay():
    em = ne.NetEm(seed=0)
    em.set_link(ne.LinkPolicy(latency_s=0.05, rate_mbps=8.0),
                direction="egress")
    t0 = time.perf_counter()
    em.hook("van_dense_push", 100_000)  # 100 KB @ 1 MB/s = 0.1 s
    dt = time.perf_counter() - t0
    assert dt >= 0.14  # latency + serialization
    # ingress ops see neither (policy is egress-only)
    t0 = time.perf_counter()
    em.hook("van_dense_pull", 100_000)
    assert time.perf_counter() - t0 < 0.05


def test_policy_and_schedule_json_roundtrip():
    pol = ne.LinkPolicy(latency_s=0.01, jitter_s=0.2, drop_p=0.01,
                        rate_mbps=50.0, duration_s=1.5)
    assert ne.LinkPolicy.from_dict(pol.to_dict()) == pol
    sched = ne.NetemSchedule(
        [ne.NetemEvent(0.5, ne.EGRESS, pol.to_dict()),
         ne.NetemEvent(2.0, ne.EGRESS, None)], t0_unix=123.0)
    back = ne.NetemSchedule.from_json(sched.to_json())
    assert back.t0_unix == 123.0
    assert [(e.t_s, e.direction, e.policy) for e in back.events] == \
        [(e.t_s, e.direction, e.policy) for e in sched.events]
    # the reference reads the port's schedule, byte for byte
    assert jne.NetemSchedule.from_json(sched.to_json()).to_json() == \
        sched.to_json()


def test_schedule_applies_and_clears_policies():
    em = ne.NetEm(seed=0)
    ne.NetemSchedule(
        [ne.NetemEvent(0.05, ne.EGRESS,
                       ne.LinkPolicy(partition=True).to_dict()),
         ne.NetemEvent(0.25, ne.EGRESS, None)]).start(em)
    deadline = time.monotonic() + WAIT_S
    dropped = False
    while time.monotonic() < deadline:
        try:
            em.hook("blob_put", 8)
            if dropped:
                return  # partitioned then healed, in order
        except ne.NetemDrop:
            dropped = True
        time.sleep(0.02)
    pytest.fail("schedule never applied+cleared the partition")


def test_resolve_codec_prefers_netem_visible_rate():
    """With a netem bandwidth cap installed, the port's resolve_codec
    uses the emulator's known rate — no op-span traffic needed."""
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.serve import ServeEngine
    from hetu_tpu_torch.serve.migrate import resolve_codec
    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, ffn_size=64, max_position=32,
                    dropout_rate=0.0)
    torch.manual_seed(0)
    engine = ServeEngine(GPTModel(cfg, device="cpu"), num_slots=2,
                         max_len=32, device="cpu")
    slot = engine.alloc_slot()
    engine.prefill(slot, [1, 2, 3, 4, 5, 6, 7, 8])
    em = ne.NetEm(seed=0).install()
    try:
        em.set_link(ne.LinkPolicy(rate_mbps=0.001), direction="egress")
        # an absurdly slow emulated link: even this small payload takes
        # seconds — auto must pick the compressed codec
        assert resolve_codec("auto", engine) == "int8"
        em.clear()
        # no cap, no measured traffic: auto stays uncompressed
        assert resolve_codec("auto", engine) == "none"
        assert resolve_codec("bf16", engine) == "bf16"  # passthrough
        with pytest.raises(ValueError):
            resolve_codec("gzip", engine)
    finally:
        em.uninstall()
        engine.release(slot)


# ---------------------------------------------------------------- added

def test_one_seed_replays_the_same_drops_in_both_packages():
    for seed in (0, 7, 123456):
        assert _drops(ne, seed, 200) == _drops(jne, seed, 200)


def _shaped(module, seed):
    """A lossy, jittery, rate-capped link both ways: each op's outcome
    (dropped, or the seconds it was delayed) in op order.  The delays
    are microseconds, so the hook's sleeps cost nothing."""
    em = module.NetEm(local="m1", peer="van", seed=seed)
    em.set_link(module.LinkPolicy(latency_s=1e-6, jitter_s=2e-6,
                                  drop_p=0.2, dup_p=0.3, reorder_p=0.25,
                                  reorder_s=3e-6, rate_mbps=1e6),
                direction="both")
    out = []
    for i in range(120):
        op = ("blob_put", "van_sparse_pull", "van_ping")[i % 3]
        before = {k: v["delay_s"] for k, v in em.stats.items()}
        try:
            em.hook(op, 64 * (i + 1))
        except module.NetemDrop as e:
            out.append(("drop", str(e)))
            continue
        out.append(tuple(sorted(
            (k, v["delay_s"] - before.get(k, 0.0))
            for k, v in em.stats.items())))
    return out, {k: dict(v) for k, v in em.stats.items()}


def test_one_seed_replays_the_same_delays_in_both_packages():
    got, got_stats = _shaped(ne, 11)
    want, want_stats = _shaped(jne, 11)
    assert got == want
    assert got_stats == want_stats
    assert 0 < sum(o[0] == "drop" for o in got) < len(got)


def test_delay_draws_match_the_reference_policy():
    pol = dict(latency_s=0.001, jitter_s=0.2, dup_p=0.5, reorder_p=0.5,
               reorder_s=0.03, rate_mbps=80.0)
    for nbytes in (0, 1500, 1 << 20):
        key = "m0->van"
        g_port = np.random.default_rng((5 << 32) ^ ne.zlib.crc32(
            key.encode()))
        g_ref = np.random.default_rng((5 << 32) ^ jne.zlib.crc32(
            key.encode()))
        a = [ne.LinkPolicy(**pol).delay_for(nbytes, g_port)
             for _ in range(64)]
        b = [jne.LinkPolicy(**pol).delay_for(nbytes, g_ref)
             for _ in range(64)]
        assert a == b
