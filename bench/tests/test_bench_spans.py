"""The readers of the program's spans (bench/metrics/_spans.py and the
metrics on it) against a hand-built trace: two rounds, each a
`bench.round` range holding LocalUpdate (its score, train with fwd and
bwd, and eq8 children), ScoreSelect with a device-to-host read, Downlink
with a copy from pageable host memory, and the benchmark's own draw and
loss read outside every program span."""
from types import SimpleNamespace

import pytest

from bench import harness
from bench.trace import DeviceOp, Trace

DEVICE_MS = ("stage_device_ms.LocalUpdate.score",
             "stage_device_ms.LocalUpdate.train",
             "stage_device_ms.LocalUpdate.train.fwd",
             "stage_device_ms.LocalUpdate.train.bwd",
             "stage_device_ms.LocalUpdate.eq8",
             "stage_device_ms.GlobalLoss")


def _round(t0: float) -> tuple[dict, list, list]:
    """One round from t0 (us): (ranges, device ops, host ops)."""
    ranges = {
        "bench.round": [(t0, t0 + 1000)],
        "LocalUpdate": [(t0 + 10, t0 + 500)],
        "LocalUpdate.score": [(t0 + 20, t0 + 60), (t0 + 400, t0 + 450)],
        "LocalUpdate.train": [(t0 + 100, t0 + 300)],
        "LocalUpdate.train.fwd": [(t0 + 110, t0 + 150)],
        "LocalUpdate.train.bwd": [(t0 + 160, t0 + 280)],
        "LocalUpdate.eq8": [(t0 + 310, t0 + 390)],
        "ScoreSelect": [(t0 + 500, t0 + 700)],
        "Downlink": [(t0 + 700, t0 + 715)],
        "BestTracking": [(t0 + 720, t0 + 900)],
        "GlobalLoss": [(t0 + 730, t0 + 800)],
    }
    # (launch, device ms, name): score 2 + 1, fwd 4, bwd 8, train's own
    # SGD step 1, eq8 2 and a copy on the device; one op in ScoreSelect,
    # a copy from pageable memory in Downlink, GlobalLoss 3; the
    # benchmark's draw copied in before LocalUpdate
    h2d, d2d = "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoD"
    launched = [(t0 + 30, 2, "k"), (t0 + 420, 1, "k"), (t0 + 120, 4, "k"),
                (t0 + 170, 8, "k"), (t0 + 290, 1, "k"), (t0 + 320, 1.75, "k"),
                (t0 + 332, 0.25, d2d), (t0 + 510, 0.5, "k"),
                (t0 + 703, 0.01, h2d), (t0 + 740, 3, "k"),
                (t0 + 5, 0.25, h2d)]
    ops = [DeviceOp(t0 + 2000 + i, t0 + 2000 + i + 1e3 * ms, name, at)
           for i, (at, ms, name) in enumerate(launched)]
    host = [(t0 + 520, t0 + 620, "aten::item"),
            (t0 + 521, t0 + 619, "aten::_local_scalar_dense"),
            (t0 + 950, t0 + 990, "aten::item"),
            (t0 + 951, t0 + 989, "aten::_local_scalar_dense"),
            (t0 + 330, t0 + 340, "aten::copy_"),
            (t0 + 702, t0 + 712, "aten::copy_"),
            (t0 + 4, t0 + 8, "aten::copy_")]
    return ranges, ops, host


def _trace(drop: tuple = ()) -> Trace:
    ranges, ops, host = {}, [], []
    for t0 in (0.0, 100000.0):
        r, o, h = _round(t0)
        for k, v in r.items():
            if k not in drop:
                ranges.setdefault(k, []).extend(v)
        ops += o
        host += h
    return Trace(ops=sorted(ops), ranges=ranges, host_ops=sorted(host),
                 window=(0.0, 200000.0), rounds=2)


def _read(metric: str, tr: Trace):
    return harness.reader(metric)(SimpleNamespace(trace=tr))


def test_children_sum_to_the_parent():
    tr = _trace()
    got = {m: _read(m, tr) for m in DEVICE_MS}
    assert got == pytest.approx({
        "stage_device_ms.LocalUpdate.score": 3.0,
        "stage_device_ms.LocalUpdate.train": 13.0,
        "stage_device_ms.LocalUpdate.train.fwd": 4.0,
        "stage_device_ms.LocalUpdate.train.bwd": 8.0,
        "stage_device_ms.LocalUpdate.eq8": 2.0,
        "stage_device_ms.GlobalLoss": 3.0})
    parent = _read("stage_device_ms.LocalUpdate", tr)
    assert parent == pytest.approx(18.0)
    assert sum(got[f"stage_device_ms.LocalUpdate.{c}"]
               for c in ("score", "train", "eq8")) == pytest.approx(parent)
    # train = fwd + bwd + the SGD step's own 1 ms
    assert got["stage_device_ms.LocalUpdate.train"] == pytest.approx(
        got["stage_device_ms.LocalUpdate.train.fwd"]
        + got["stage_device_ms.LocalUpdate.train.bwd"] + 1.0)


def test_a_read_in_scoreselect_counts_and_the_harness_read_does_not(capsys):
    """The `_local_scalar_dense` under `aten::item` counts once (98 us a
    round), the copy from pageable memory in Downlink too (10 us); the
    copy on the device, and the draw and loss read inside `bench.round`
    alone, do not count."""
    assert _read("host_wait_ms", _trace()) == pytest.approx(0.108)
    assert "ScoreSelect 0.098, Downlink 0.010" in capsys.readouterr().err
    assert _read("host_wait_ms", _trace(drop=("ScoreSelect",))) == \
        pytest.approx(0.010)


def test_launches_only_inside_program_spans(capsys):
    """Ten of the eleven ops a round; the draw launched before
    LocalUpdate goes to standard error with its 0.25 device ms."""
    assert _read("launches_per_round", _trace()) == 10.0
    assert "1.0, 0.2500 device ms" in capsys.readouterr().err


@pytest.mark.parametrize("metric", DEVICE_MS)
def test_none_where_the_span_is_absent(metric):
    """The parent commit's trace has no such span: nothing to read."""
    span = metric.split(".", 1)[1]
    assert _read(metric, _trace(drop=(span,))) is None
    assert _read(metric, None) is None
