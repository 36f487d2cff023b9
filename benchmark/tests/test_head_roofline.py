"""``head_roofline_pct.train`` on a synthetic span log: the head's bound from
the ``train.head`` span's rows and counted classes, at the float32 peak, over
the mean device time of ``train.head`` and ``train.head_backward``; None
where the spans carry no counts (a program without them), and None off the
card."""

from __future__ import annotations

import pytest

from benchmark.harness import load_module
from benchmark.roofline import HBM_BW, PEAK_F32

NAME = "head_roofline_pct.train"
CONFIG = {"embedding_dim": 512}
COUNTS = {"path": "streaming", "classes": 85742, "blocks": 11, "block": 8192}


def _log(steps: int, counts, head_ms=(12.0, 8.0), rows: int = 512) -> list[dict]:
    """``steps`` train steps, each a root with its head, head backward and
    optimizer spans, as the program's flat log."""
    recs, ids = [], iter(range(10 ** 6))
    for i in range(steps):
        t, root = 100.0 * i, next(ids)
        recs.append({"id": root, "name": "train.step", "parent": None, "rows": rows,
                     "device_ms": 100.0, "counts": None})
        for name, ms, c in (("train.head", head_ms[0], counts),
                            ("train.head_backward", head_ms[1], None),
                            ("train.optimizer", 2.0, None)):
            recs.append({"id": next(ids), "name": name, "parent": root, "rows": rows,
                         "device_ms": ms, "counts": c})
    return recs


@pytest.fixture
def read(monkeypatch):
    from crfr_torch.utils import profiling

    def reading(log, calls):
        monkeypatch.setattr(profiling, "spans", lambda: log)
        return load_module("metrics", NAME).read([{"calls": calls}], {"config": CONFIG})

    return reading


def test_the_reading_is_the_bound_over_the_heads_device_time(read):
    ops, byts = 6.0 * 512 * 512 * 85742, 12.0 * 512 * 85742
    bound = max(ops / PEAK_F32, byts / HBM_BW)
    assert bound == pytest.approx(2.0159e-3, rel=1e-4)      # compute-bound at B=512
    assert read(_log(3, COUNTS), 3) == pytest.approx(100 * bound / 20e-3)
    # only the last ``calls`` steps count: the segment's
    early = _log(2, COUNTS, head_ms=(30.0, 10.0))
    late = [dict(r, id=r["id"] + 100, parent=None if r["parent"] is None else r["parent"] + 100)
            for r in _log(2, COUNTS)]
    assert read(early + late, 2) == pytest.approx(100 * bound / 20e-3)
    assert read(early + late, 4) == pytest.approx(100 * bound / 30e-3)


def test_the_rows_and_classes_are_the_spans(read):
    counts = dict(COUNTS, classes=10572)
    want = 100 * (6.0 * 256 * 512 * 10572 / PEAK_F32) / 20e-3
    assert read(_log(2, counts, rows=256), 2) == pytest.approx(want)


def test_without_counts_or_off_the_card_it_reads_none(read):
    assert read(_log(3, None), 3) is None
    log = _log(3, COUNTS)
    for r in log:
        r["device_ms"] = None
    assert read(log, 3) is None
    assert read([], 3) is None
