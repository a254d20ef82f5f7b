"""The port's ``MetricLogger`` (``hetu_tpu_torch.utils.logger``) against
hetu_tpu's, on the CPU: the same calls give equal ``counters_snapshot()``,
``counters``, ``means()`` and ``prometheus_text()``, and log files equal
record for record but for the wall-clock ``t``.  Mirrored from
``tests/test_telemetry.py``: parent directories made, the reset flag,
means and the exposition, a shared registry rendered with its real
types.
"""

import json

import pytest

from hetu_tpu.telemetry.registry import MetricsRegistry as JRegistry
from hetu_tpu.utils.logger import MetricLogger as JLogger
from hetu_tpu_torch.telemetry.registry import MetricsRegistry
from hetu_tpu_torch.utils import MetricLogger

# one script of calls, run against both loggers
CALLS = [
    ("log", {"loss": 2.0, "acc": 0.5}, None),
    ("inc", "retries", 1),
    ("log", {"loss": 4.0}, 7),
    ("inc", "checkpoints", 2),
    ("inc", "retries", 3),
    ("log", {"checkpoints": 2.0, "loss": 1.25}, None),
]


def _drive(lg):
    outs = []
    for op, a, b in CALLS:
        if op == "log":
            lg.log(a, step=b)
        else:
            outs.append(lg.inc(a, b))
    return outs


@pytest.mark.parametrize("shared", [False, True])
def test_same_calls_give_the_references_numbers_and_text(tmp_path, shared):
    kw, jkw = {}, {}
    if shared:
        reg, jreg = MetricsRegistry(), JRegistry()
        for r in (reg, jreg):
            r.histogram("van.op.latency_s").observe(0.01)
            r.gauge("width").set(4)
        kw, jkw = {"registry": reg}, {"registry": jreg}
    lg = MetricLogger(str(tmp_path / "port" / "log.jsonl"), **kw)
    ref = JLogger(str(tmp_path / "ref" / "log.jsonl"), **jkw)
    assert _drive(lg) == _drive(ref) == [1, 2, 4]
    assert lg.counters_snapshot() == ref.counters_snapshot() == \
        {"retries": 4, "checkpoints": 2}
    assert lg.counters == ref.counters
    assert lg.means() == ref.means()
    assert lg.step == ref.step == 8
    assert lg.prometheus_text() == ref.prometheus_text()
    lg.close()
    ref.close()
    got, want = ([json.loads(x) for x in
                  (tmp_path / d / "log.jsonl").read_text().splitlines()]
                 for d in ("port", "ref"))
    for r in got + want:
        r.pop("t")
    assert got == want and len(got) == 3


def test_metric_logger_creates_parent_dirs(tmp_path):
    p = tmp_path / "not" / "yet" / "there" / "log.jsonl"
    lg = MetricLogger(str(p))
    lg.log({"loss": 1.5}, step=3)
    lg.close()
    rec = json.loads(p.read_text().strip())
    assert rec["step"] == 3 and rec["loss"] == 1.5


def test_metric_logger_reset_flag():
    for lg in (MetricLogger(), JLogger()):
        lg.log({"loss": 2.0})
        assert lg.inc("faults", 2) == 2
        lg.reset()  # means clear, monotonic counters survive
        assert lg.means() == {}
        assert lg.counters_snapshot() == {"faults": 2}
        lg.reset(counters=True)
        assert lg.counters_snapshot() == {"faults": 0}


def test_metric_logger_means_and_prometheus():
    lg = MetricLogger()
    lg.log({"loss": 2.0})
    lg.log({"loss": 4.0})
    lg.inc("retries")
    assert lg.means() == {"loss": 3.0}
    assert lg.counters == {"retries": 1}
    text = lg.prometheus_text()
    assert "retries_total 1" in text and "loss 4.0" in text


def test_metric_logger_shared_registry_prometheus():
    reg = MetricsRegistry()
    reg.histogram("van.op.latency_s").observe(0.01)
    reg.gauge("width").set(4)
    lg = MetricLogger(registry=reg)
    lg.inc("retries", 2)
    text = lg.prometheus_text()
    assert "retries_total 2" in text
    assert "# TYPE van_op_latency_s histogram" in text
    assert "# TYPE width gauge" in text and "width 4.0" in text
