"""crfr_torch.utils.profiling's span on the CPU, at the tiny config of
tests/test_torch_train.py (ir_18 at 32 px, float32, 4 classes): off, a span
is the shared null context and reads no clock, opens no range and logs
nothing; on, under a CPU profiler, one train step logs ``train.step`` over
its children and one serving call ``embed.call`` over its own, each child
inside its parent and on the trace's clock; the numbers are bit-equal with
a profiler on and off, the streamed CE's too; the log keeps its bound;
``span_mode`` sends spans down the off path or times a ``detail`` span on
the device; ``train.head`` carries the CE's counts on the dense and the
streamed paths; the int8 conv's kernels are still grouped by its ranges,
and nested spans by the innermost one (``bench.xprof_check``)."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from crfr_torch.configs import Config, DataCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr_torch.serve import build_serving_fn
from crfr_torch.train.loop import Trainer
from crfr_torch.utils import profiling

TRAIN_CHILDREN = ("train.preprocess", "train.backbone", "train.head", "train.head_backward",
                  "train.backward", "train.optimizer")
EMBED_CHILDREN = ("embed.preprocess", "embed.backbone")
ROOTS = {"train": ("train.step", TRAIN_CHILDREN), "embed": ("embed.call", EMBED_CHILDREN)}
SLACK_NS = 200_000


def tiny_trainer(streamed: bool = False) -> Trainer:
    """The 4 classes in one dense product, or ``streamed`` in blocks of 3
    (the last block partial)."""
    head = {"ce_block": 3, "ce_streaming_threshold": 2} if streamed else {}
    cfg = Config(
        name="tiny-test", mesh=MeshCfg(data=1, model=1),
        data=DataCfg(image_size=32, num_classes=4, degrade_min=16, degrade_max=32),
        model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0, input_size=32),
        loss=LossCfg(scale=16.0, margin=0.2, **head),
        train=TrainCfg(batch_size=16, lr=0.05, warmup_steps=5, weight_decay=5e-4,
                       log_every=10, seed=0))
    return Trainer(cfg, steps_per_epoch=100, device="cpu")


def batch(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (16, 32, 32, 3), generator=g, dtype=torch.uint8)
    return images, torch.arange(16) % 4, torch.randint(16, 33, (16,), generator=g)


class Case:
    """A trainer and its serving callable; ``run(kind)`` makes one call
    (``streamed``: a train step of a trainer whose CE streams)."""

    def __init__(self, streamed: bool = False):
        self.tr = tiny_trainer(streamed)
        self.images, self.labels, self.lows = batch()
        self.fn = build_serving_fn(lambda x: self.tr.backbone_apply(self.tr.model.backbone, x),
                                   degrade_to=16, image_size=32, device="cpu")
        self.tr.train_step(self.images, self.labels, lows=self.lows)   # warm, outside any trace

    def run(self, kind: str):
        if kind in ("train", "streamed"):
            m = self.tr.train_step(self.images, self.labels, lows=self.lows)
            return [m["loss"], m["grad_norm"],
                    *[p.grad for p in self.tr.model.parameters() if p.grad is not None],
                    *self.tr.model.parameters()]
        return [self.fn(self.images)]


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def case():
    return Case()


def roots(name: str) -> list[dict]:
    """The log's spans named ``name`` with no parent, each with
    ``children``: {name: span}."""
    recs = profiling.spans()
    out = [dict(r, children={}) for r in recs if r["name"] == name and r["parent"] is None]
    for root in out:
        root["children"] = {r["name"]: r for r in recs if r["parent"] == root["id"]}
    return out


def traced(case: Case, kind: str, path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = case.run(kind)
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())


class NoClock:
    @staticmethod
    def time_ns():
        raise AssertionError("a span off read the clock")


def _no_range(name):
    raise AssertionError(f"a span off opened the range {name!r}")


@pytest.mark.parametrize("kind", ["train", "embed"])
def test_off_a_span_is_the_null_context_and_does_nothing(case, kind, monkeypatch):
    monkeypatch.setattr(profiling, "time", NoClock)
    monkeypatch.setattr(profiling, "record_function", _no_range)
    monkeypatch.setattr(torch.cuda, "Event", _no_range)
    assert profiling.annotate("x", torch.device("cpu"), call=1, rows=2) is profiling._NULL
    assert profiling.annotate("x", counts={"blocks": 1}) is profiling._NULL
    assert profiling.annotate("y") is profiling.annotate("z")
    assert profiling.begin("x") is None
    profiling.end(None)
    case.run(kind)
    assert profiling.spans() == []


@pytest.mark.parametrize("kind", ["train", "embed"])
def test_on_the_call_logs_its_root_over_its_children(case, kind, tmp_path):
    traced(case, kind, tmp_path / "t.json")
    root_name, children = ROOTS[kind]
    recs = profiling.spans()
    assert sorted(r["name"] for r in recs) == sorted((root_name, *children))
    (root,) = roots(root_name)
    assert root["parent"] is None and root["rows"] == 16
    if kind == "train":
        assert root["call"] == 1                          # host_step: the second step
    assert set(root["children"]) == set(children)
    covered = 0
    for name, ch in root["children"].items():
        assert ch["parent"] == root["id"] and ch["call"] == root["call"], name
        assert ch["rows"] == 16
        assert root["start_ns"] <= ch["start_ns"] <= ch["end_ns"] <= root["end_ns"], name
        assert ch["device_ms"] is None and ch["self_ms"] == ch["host_ms"]
        covered += ch["host_ms"]
    assert root["self_ms"] == pytest.approx(root["host_ms"] - covered, abs=1e-6)


@pytest.mark.parametrize("kind", ["train", "embed"])
def test_the_log_is_on_the_traces_clock(case, kind, tmp_path):
    """Each span lies inside a range of its name in the trace, within
    ``SLACK_NS`` (the profiler maps its own clock onto the unix clock; on an
    8-core host beside six busy processes spans open 3.6 µs or more inside
    their ranges). Every range of the name is a candidate: a trace may hold
    more than one range of a name, and the one the span opened need not be
    the last."""
    _, trace = traced(case, kind, tmp_path / "t.json")
    base = trace["baseTimeNanoseconds"]
    ranges: dict[str, list] = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"] * 1000 + base, (e["ts"] + e["dur"]) * 1000 + base))
    events = profiling.span_events(base)
    for rec, ev in zip(profiling.spans(), events):
        edges = ranges[rec["name"]]
        assert any(lo - SLACK_NS <= rec["start_ns"] <= rec["end_ns"] <= hi + SLACK_NS
                   for lo, hi in edges), (rec["name"], rec["start_ns"], rec["end_ns"], edges)
        assert ev["cat"] == "crfr_span" and ev["ph"] == "X" and ev["name"] == rec["name"]
        assert ev["ts"] * 1000 + base == pytest.approx(rec["start_ns"], abs=1)
        assert ev["dur"] * 1000 == pytest.approx(rec["end_ns"] - rec["start_ns"], abs=1)
    assert len(events) == len(ROOTS[kind][1]) + 1


@pytest.mark.parametrize("kind", ["train", "embed", "streamed"])
def test_numbers_are_bit_equal_with_the_profiler_on_and_off(kind, tmp_path):
    streamed = kind == "streamed"
    off = Case(streamed).run(kind)
    on, _ = traced(Case(streamed), kind, tmp_path / "t.json")
    if kind != "embed":                 # the trainer's CE took the path the case names
        (head,) = [r for r in profiling.spans() if r["name"] == "train.head"]
        assert head["counts"]["path"] == ("streaming" if streamed else "dense")
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_the_log_keeps_its_bound(case, tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "LOG", profiling.SpanLog(bound=4))
    traced(case, "train", tmp_path / "t.json")
    names = [r["name"] for r in profiling.spans()]
    assert len(profiling.LOG._records) == 4
    # in start order: the step, its three forward children, the head's and
    # the rest of the backward, the optimizer; the first three went
    assert names == ["train.head", "train.head_backward", "train.backward", "train.optimizer"]
    assert roots("train.step") == []


def test_the_int8_convs_ranges_still_group_its_kernels(tmp_path):
    from crfr_torch.bench.xprof_check import _QUANT_SPANS, _span_groups
    from crfr_torch.models.quant import QuantConv

    q = QuantConv(torch.nn.Conv2d(8, 16, 3, 1, 1), 1.0)
    x = torch.randn(2, 8, 6, 6).to(memory_format=torch.channels_last)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        q(x)
    prof.export_chrome_trace(str(tmp_path / "q.json"))
    events = json.loads((tmp_path / "q.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    assert sorted(e["name"] for e in ranges) == sorted(_QUANT_SPANS)
    launches, kernels = [], []
    for i, r in enumerate(ranges):             # a launch inside each range, one outside
        launches.append({"cat": "cuda_runtime", "ts": r["ts"] + r["dur"] / 2,
                         "args": {"correlation": i}})
        kernels.append({"args": {"correlation": i}})
    launches.append({"cat": "cuda_runtime", "ts": max(r["ts"] + r["dur"] for r in ranges) + 5,
                     "args": {"correlation": -1}})
    kernels.append({"args": {"correlation": -1}})
    groups = _span_groups(events + launches, kernels, _QUANT_SPANS)
    assert groups == [_QUANT_SPANS[r["name"]] for r in ranges] + [None]
    assert roots("quant::quantize")                       # logged as roots


def test_self_time_is_the_span_less_its_childrens_union():
    assert profiling.union_length([(1.0, 3.0), (2.0, 4.0), (8.0, 10.0)]) == 5.0
    assert profiling.union_length([]) == 0
    assert profiling.union_length([(0.0, 1.0), (1.0, 2.0), (0.5, 0.75)]) == 2.0
    assert np.isclose(profiling.union_length([(-1.0, 2.0), (0.0, 1.0)]), 3.0)


@pytest.mark.parametrize("kind", ["train", "embed"])
def test_the_off_mode_logs_nothing_under_a_profiler(case, kind, tmp_path):
    with profiling.span_mode("off"):
        _, trace = traced(case, kind, tmp_path / "t.json")
        assert profiling.annotate("x") is profiling._NULL and profiling.begin("x") is None
    assert profiling.spans() == []
    assert not [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"
                and e["name"].startswith(("train.", "embed."))]
    with pytest.raises(ValueError):
        with profiling.span_mode("some"):
            pass


@pytest.mark.parametrize("mode, timed", [("read", {"a", "c"}), ("all", {"a", "b", "c", "d"})])
def test_a_detail_span_is_device_timed_only_in_the_all_mode(mode, timed, monkeypatch):
    given = {}
    real = profiling.LOG.open

    def spy(name, device, call, rows, parent):
        given[name] = device
        return real(name, None, call, rows, parent)

    monkeypatch.setattr(profiling.LOG, "open", spy)
    cuda = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CPU]), profiling.span_mode(mode):
        with profiling.annotate("a", cuda), profiling.annotate("b", cuda, detail=True):
            pass
        profiling.end(profiling.begin("c", cuda))
        profiling.end(profiling.begin("d", cuda, detail=True))
    assert {n for n, d in given.items() if d is not None} == timed
    assert sorted(r["name"] for r in profiling.spans()) == ["a", "b", "c", "d"]


def test_nested_spans_group_a_launch_by_the_innermost():
    from crfr_torch.bench.xprof_check import _span_groups

    spans = [("step", 0, 100), ("head", 10, 20), ("optimizer", 80, 90), ("other", 200, 210)]
    events = [{"cat": "crfr_span", "name": n, "ts": s, "dur": e - s} for n, s, e in spans]
    at = [5, 15, 50, 85, 95, 150, 205]
    events += [{"cat": "cuda_runtime", "ts": t, "args": {"correlation": t}} for t in at]
    kernels = [{"args": {"correlation": t}} for t in at]
    assert _span_groups(events, kernels, {n: n for n, _, _ in spans}, cat="crfr_span") == \
        ["step", "head", "step", "optimizer", "step", None, "other"]


@pytest.mark.parametrize("streamed,counts", [
    (False, {"path": "dense", "classes": 4, "blocks": 1, "block": 4}),
    (True, {"path": "streaming", "classes": 4, "blocks": 2, "block": 3}),
])
def test_the_head_span_carries_the_ces_counts(streamed, counts, tmp_path):
    """Under a profiler ``train.head`` carries the CE's path, this rank's
    classes, the class blocks and their width, which hold together
    (``bench.spans_check.head_counts_hold``); no other span carries any."""
    from crfr_torch.bench.spans_check import head_counts_hold

    traced(Case(streamed), "train", tmp_path / "t.json")
    (root,) = roots("train.step")
    head = root["children"]["train.head"]
    assert head["counts"] == counts and head["rows"] == 16
    assert head_counts_hold(head["counts"])
    assert [r["name"] for r in profiling.spans() if r["counts"] is not None] == ["train.head"]
    for bad in ({**counts, "blocks": counts["blocks"] + 1}, {**counts, "block": 1},
                {k: v for k, v in counts.items() if k != "path"}, None):
        assert not head_counts_hold(bad), bad


def test_a_sharded_heads_counts_leave_out_the_padding():
    """On a model axis of 2, 5 classes padded to 6 (3 a rank): rank 0 holds 3
    classes, rank 1 2 and a padding column."""
    from crfr_torch.parallel.mesh import Sharding

    tr = tiny_trainer()
    tr._ce_impl = "sharded"
    tr.model.head.weight = torch.nn.Parameter(torch.zeros(512, 3))
    tr.model.head.num_valid = 5
    got = []
    for index in (0, 1):
        tr._w_shard = Sharding(2, index, 1)
        got.append(tr._count_head())
    assert got == [{"path": "sharded", "classes": c, "blocks": 1, "block": 3} for c in (3, 2)]
