"""The readers of the program's spans (``crfr_torch.utils.profiling``'s log,
grouped by ``benchmark.spans``): a traced CPU run of each cell at a CPU's
size logs the spans of its segment and prints none of the readers (each
reads calls made on a card, whose spans hold CUDA events), and its metrics
on the host's clock as before; a program without the log gives no reading
and no error; each reader's arithmetic on a synthetic log of calls made on
a card."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import ROOT, load_cell, load_module

from _cells import CELLS, DRIVER

SEED = 2 ** 31 + 23
ROOT_OF = {"train": "train.step", "embed": "embed.call"}   # a driver's call's span
READERS = {w: [m["name"] for m in load_cell(ROOT, w).per_layer
               if m["source"] == "program_span"] for w in CELLS}
ALL = sorted({n for names in READERS.values() for n in names})


@pytest.fixture(autouse=True)
def empty_log():
    from crfr_torch.utils import profiling

    profiling.clear()
    yield
    profiling.clear()


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_cpu_run_logs_its_spans_and_prints_none_of_them(tiny_root, workload, capsys):
    from benchmark.harness import run
    from benchmark.run import parse
    from benchmark.spans import calls

    argv = ["--workload", workload, "--seed", str(SEED), "--seconds", "0.2", "--trace", "1",
            "--device", "cpu", "--root", str(tiny_root)]
    assert run(parse(argv), 0.0) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not set(ALL) & set(out["metrics"])
    host = {m["name"] for m in load_cell(tiny_root, workload).per_layer
            if m["source"] == "host_clock"}
    assert host and host <= set(out["metrics"])
    cs = calls(ROOT_OF[DRIVER[workload]])
    assert len(cs) >= 3                         # the segment's calls, and only they
    assert all(c["host_ms"] > 0 and c["device_ms"] is None and c["children"] for c in cs)


@pytest.mark.parametrize("name", ALL)
def test_without_the_spans_a_reader_gives_nothing(name, monkeypatch):
    from crfr_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert load_module("metrics", name).read([{"calls": 3}], {}) is None


def _span(start, end, host=1.0):
    return {"device_start_ms": start, "device_end_ms": end, "device_ms": end - start,
            "host_ms": host}


def _step(i):
    """A train step of 10 device ms; head 0.5 + i/10 and head backward 1.0,
    optimizer 0.9."""
    t = 10.0 * i
    return dict(_span(t, t + 10), children={
        "train.head": _span(t + 5, t + 5.5 + i / 10), "train.head_backward": _span(t + 6, t + 7),
        "train.optimizer": _span(t + 9, t + 9.9)})


# back to back, then a 1 ms wait, then 0.5 ms: 1.5 of 11.5 ms between calls
CALLS = [dict(_span(0.0, 3.0, 2.0), children={}), dict(_span(3.0, 6.0, 3.0), children={}),
         dict(_span(7.0, 9.0, 4.0), children={}), dict(_span(9.5, 11.5, 5.0), children={})]
STEPS = [_step(i) for i in range(3)]
EXPECT = {"head_ms.train": 1.6, "optimizer_ms.train": 0.9, "host_issue_ms.embed": 3.5,
          "between_calls_idle_pct.embed": 100 * 1.5 / 11.5}


def _log(calls: list[dict], root: str) -> list[dict]:
    """The calls as the program's flat log: ids, parent ids, a stray root of
    another name and a child of none of them."""
    recs, ids = [{"id": -1, "name": "other", "parent": None, "device_ms": 1.0}], iter(range(99))
    for c in calls:
        rid = next(ids)
        recs.append(dict({k: v for k, v in c.items() if k != "children"}, id=rid, name=root,
                         parent=None))
        recs += [dict(k, id=next(ids), name=n, parent=rid) for n, k in c["children"].items()]
    return recs + [{"id": 99, "name": "train.head", "parent": -1, "device_ms": 7.0}]


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_each_reader_on_a_synthetic_log(name, monkeypatch):
    from crfr_torch.utils import profiling

    root, given = (("train.step", STEPS) if name.endswith("train")
                   else ("embed.call", CALLS))
    log = _log(given, root)
    monkeypatch.setattr(profiling, "spans", lambda: log)
    read = load_module("metrics", name).read
    assert read([{"calls": len(given)}], {}) == pytest.approx(EXPECT[name])
    for r in log:                               # calls made off a card
        r["device_ms"] = None
    assert read([{"calls": len(given)}], {}) is None


def test_calls_keeps_the_last_roots_with_their_children(monkeypatch):
    from benchmark.spans import calls
    from crfr_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: _log(STEPS, "train.step"))
    cs = calls("train.step", 2)
    assert [c["device_start_ms"] for c in cs] == [10.0, 20.0]
    assert all(sorted(c["children"]) == ["train.head", "train.head_backward",
                                         "train.optimizer"] for c in cs)
    assert len(calls("train.step")) == 3 and calls("train.step", 0) == []
    assert calls("embed.call", 3) == []
