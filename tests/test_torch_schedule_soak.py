"""crfr_torch.bench.schedule_soak against crfr.bench.schedule_soak on the
CPU: ``build_fixtures`` writes crfr's pack and ``.bin`` byte for byte (the
pairs interleaved, genuine at even indices, as both renderers draw them);
``analyze`` returns crfr's verdicts on the metrics stream of crfr's own
``test_analyze_verdicts``; ``bn_drift`` over two port checkpoints, by
hand."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json
import os

import numpy as np
import pytest
import torch

from crfr.bench import schedule_soak as ref
from crfr_torch.bench import schedule_soak as ss
from crfr_torch.data.bins import load_bin
from crfr_torch.data.records import open_source
from crfr_torch.train.checkpoints import Checkpointer


def test_build_fixtures_are_crfrs(tmp_path):
    kw = dict(ids=6, train_ids=4, per_id=5, image_size=40, n_pairs=8, seed=3)
    rp, rb = ref.build_fixtures(str(tmp_path / "ref"), **kw)
    pp, pb = ss.build_fixtures(str(tmp_path / "port"), **kw)
    assert os.path.basename(pp) == os.path.basename(rp)
    assert open(pp, "rb").read() == open(rp, "rb").read()
    assert open(pb, "rb").read() == open(rb, "rb").read()

    src = open_source(pp)
    assert len(src) == 4 * 5 and {src[i][0] for i in range(len(src))} == set(range(4))
    i1, i2, issame = load_bin(pb, 40)
    assert len(i1) == len(i2) == len(issame) == 16
    assert issame[0::2].all() and not issame[1::2].any()          # interleaved

    t0 = os.path.getmtime(pp)                                       # cached
    ss.build_fixtures(str(tmp_path / "port"), **kw)
    assert os.path.getmtime(pp) == t0


def _write_jsonl(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _stream():
    """crfr's test_analyze_verdicts stream: 2 epochs of 10 steps, warmup 4,
    a drop at step 10, log_every 1, eval every 5."""
    lr0, rows = 0.1, []
    for s in range(1, 21):
        lr = lr0 * s / 4 if s < 4 else (lr0 if s < 10 else lr0 * 0.1)
        loss = 10.0 - 0.2 * s - (1.0 if s >= 10 else 0.0)
        rows.append({"step": s, "loss": loss, "lr": lr})
        if s % 5 == 0:
            rows.append({"step": s, "eval_accuracy": 0.5 + 0.01 * s})
    return lr0, rows


@pytest.mark.parametrize("case", ["as_logged", "a_hole", "a_wrong_drop"])
def test_analyze_verdicts_are_crfrs(tmp_path, case):
    lr0, rows = _stream()
    if case == "a_hole":
        rows = [r for r in rows if r["step"] not in range(8, 12) or "loss" not in r]
    elif case == "a_wrong_drop":
        rows = [dict(r, lr=lr0) if r.get("step", 0) >= 10 and "lr" in r else r for r in rows]
    ckdir = tmp_path / "ckpt"
    _write_jsonl(str(ckdir / "metrics.jsonl"), rows)
    _write_jsonl(str(ckdir / "recycles.jsonl"), [{"step": 12, "gen": 1, "max_rss_mb": 512.0}])
    kw = dict(steps_per_epoch=10, epochs=2, lr=lr0, warmup_steps=4, drop_epochs=(1,), window=5)
    got = ss.analyze(str(tmp_path), **kw)
    want = ref.analyze(str(tmp_path), **kw)
    assert got == want
    assert got["continuity_gaps"] == [] and got["bn_drift"] == []
    assert got["drops"][0]["lr_ok"] == (case != "a_wrong_drop")
    assert got["recycles"] == [{"step": 12, "gen": 1, "max_rss_mb": 512.0}]


def test_bn_drift_by_hand(tmp_path):
    """Two checkpoints of a model whose running statistics move: the
    relative L2 change of all running means and variances together; the
    weights and the batch counter are not statistics."""
    ck = Checkpointer(str(tmp_path / "ckpt"), keep=5)
    a = {"a.running_mean": torch.tensor([1.0, 2.0]), "a.running_var": torch.tensor([2.0]),
         "a.weight": torch.tensor([5.0]), "a.num_batches_tracked": torch.tensor(3)}
    b = dict(a, **{"a.running_mean": torch.tensor([1.0, 4.0]),
                   "a.running_var": torch.tensor([1.0]), "a.weight": torch.tensor([50.0])})
    for step, model in ((3, a), (6, b)):
        ck.save(step, {"model": model, "step": step})
    got = ss.bn_drift(str(tmp_path / "ckpt"))
    want = np.linalg.norm([0.0, 2.0, -1.0]) / np.linalg.norm([1.0, 2.0, 2.0])   # √5 / 3
    assert got == [{"from_step": 3, "to_step": 6, "rel_l2": round(float(want), 5)}]
    assert ss.bn_drift(str(tmp_path / "none")) == []
