"""The trainer's host side and resume on the CPU: SyntheticFaces and packed
records against crfr, the record pipeline's resumable stream, the device
feed's resume state, checkpoints with a bitwise next step, the
degradation table and ``random_degrade``, the metrics writer, and the
learning bar of tests/test_train.py:38-54."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json
import sys

import numpy as np
import pytest
import torch

from crfr.data import records as ref_records
from crfr.data.synthetic import SyntheticFaces as RefSyntheticFaces
from crfr.ops.bicubic import degrade_matrix as ref_degrade_matrix
from crfr_torch.configs import get_config
from crfr_torch.data import records
from crfr_torch.data.pipeline import PipelineCfg, ResumableBatches, train_batches
from crfr_torch.data.synthetic import SyntheticFaces
from crfr_torch.train.checkpoints import Checkpointer
from crfr_torch.train.feed import ResumableDeviceFeed, device_feed
from crfr_torch.train.loop import Trainer

TINY = ["data.image_size=32", "model.input_size=32", "data.num_classes=4",
        "data.degrade_min=8", "data.degrade_max=32", "model.backbone=ir_18",
        "model.compute_dtype=float32", "model.dropout=0.0", "loss.scale=16.0",
        "loss.margin=0.2", "train.batch_size=16", "train.lr=0.05", "train.warmup_steps=5",
        "train.seed=0"]


def test_synthetic_faces_equal_crfr():
    for kw in ({}, {"fine_detail": True}):
        a = RefSyntheticFaces(num_classes=5, image_size=32, seed=3, **kw)
        b = SyntheticFaces(num_classes=5, image_size=32, seed=3, **kw)
        assert np.array_equal(a.prototypes, b.prototypes)
        for (ia, la), (ib, lb) in zip(a.batches(6, 2, seed=4), b.batches(6, 2, seed=4)):
            assert np.array_equal(ia, ib) and np.array_equal(la, lb)
        pa, pb = (d.eval_pairs(np.random.default_rng(1), 8) for d in (a, b))
        assert all(np.array_equal(x, y) for x, y in zip(pa, pb))


def _faces(n, size=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(int(i % 5), rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
            for i in range(n)]


def test_pack_written_by_crfr_reads_back_equal(tmp_path):
    recs = _faces(23)
    ref_records.write_pack(str(tmp_path / "a.crfrpack"), recs)
    records.write_pack(str(tmp_path / "b.crfrpack"), recs)
    assert (tmp_path / "a.crfrpack").read_bytes() == (tmp_path / "b.crfrpack").read_bytes()
    src = records.open_source(str(tmp_path / "a.crfrpack"))
    assert len(src) == 23
    for i, (label, img) in enumerate(recs):
        got_label, got = src[i]
        assert got_label == label and np.array_equal(got, img)
    sub = records.SubsetSource(src, 5, 9)
    assert len(sub) == 4 and np.array_equal(sub[0][1], recs[5][1])
    with pytest.raises(IndexError):
        sub[4]
    blob = ref_records.encode_record(3, recs[0][1])
    assert records.encode_record(3, recs[0][1]) == blob
    assert records.decode_record(blob)[0] == 3


def test_records_refuse_what_is_not_ported(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="array_record"):
        records.open_source(str(tmp_path / "x.array_record"))
    with pytest.raises(NotImplementedError, match=r"\.rec"):
        records.open_source(str(tmp_path / "x.rec"))
    blob = records.encode_record(1, b"\xff\xd8 not a jpeg", fmt="jpeg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        records.decode_record(blob)


def _pipeline(n=23, **kw):
    cfg = PipelineCfg(**{"batch_size": 5, "seed": 7, **kw})
    return ResumableBatches([(i, np.full((2, 3, 1), i, np.uint8)) for i in range(n)], cfg)


def test_pipeline_epochs_hold_every_record_once():
    it = _pipeline()
    labels = np.concatenate([next(it)[1] for _ in range(23)])       # 115 records, 5 epochs
    for e in range(5):
        assert sorted(labels[23 * e:23 * (e + 1)]) == list(range(23))
    assert not np.array_equal(labels[:23], labels[23:46])          # a new order each epoch
    ordered = _pipeline(shuffle=False, random_flip=False)
    assert next(ordered)[1].tolist() == [0, 1, 2, 3, 4]


def test_pipeline_resumes_the_same_stream():
    it = _pipeline()
    head = [next(it) for _ in range(7)]
    state = json.loads(json.dumps(it.get_state()))
    tail = [next(it) for _ in range(6)]
    again = _pipeline()
    again.set_state(state)
    for (a, la), (b, lb) in zip(tail, (next(again) for _ in range(6))):
        assert np.array_equal(a, b) and np.array_equal(la, lb)
    skipped = train_batches(again._source, again._cfg, start_step=7)
    assert np.array_equal(next(skipped)[1], tail[0][1])
    threaded = _pipeline(num_workers=3)
    for a, la in head:
        b, lb = next(threaded)
        assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_pipeline_flips_by_global_index():
    """A record is flipped or not by its (epoch, position) alone: the same
    record at the same place flips alike in a resumed stream."""
    src = [(i, np.arange(6, dtype=np.uint8).reshape(1, 6, 1) + i) for i in range(10)]
    it = ResumableBatches(src, PipelineCfg(batch_size=10, seed=1))
    imgs, labels = next(it)
    flipped = [bool(imgs[k, 0, 0, 0] != labels[k]) for k in range(10)]
    assert 0 < sum(flipped) < 10
    for k in range(10):
        want = src[labels[k]][1][:, ::-1] if flipped[k] else src[labels[k]][1]
        assert np.array_equal(imgs[k], want)


def test_pipeline_finite_epochs_drop_the_remainder():
    it = _pipeline(num_epochs=2)
    assert sum(1 for _ in it) == 46 // 5
    keep = _pipeline(num_epochs=1, drop_remainder=False)
    sizes = [len(b[1]) for b in keep]
    assert sizes == [5, 5, 5, 5, 3]


def test_resumable_feed_state_lags_the_prefetch():
    it = _pipeline()
    feed = ResumableDeviceFeed(it, "cpu", depth=2)
    assert feed.state == {"epoch": 0, "position": 0}
    images, labels = next(feed)
    assert isinstance(images, torch.Tensor) and labels.dtype == torch.int32
    assert feed.state == {"epoch": 0, "position": 5}
    assert it.get_state() == {"epoch": 0, "position": 15}             # two batches ahead
    next(feed)
    assert feed.state == {"epoch": 0, "position": 10}
    feed.close()
    out = list(device_feed(iter([(np.zeros((2, 4, 4, 3), np.uint8), [1, 2])]), "cpu"))
    assert len(out) == 1 and out[0][1].tolist() == [1, 2]


def _batches(n, seed=9):
    return list(SyntheticFaces(num_classes=4, image_size=32, seed=0).batches(16, n, seed=seed))


def test_checkpoint_restore_and_next_step_are_bitwise(tmp_path):
    cfg = get_config("casia_arcface", TINY + ["model.dropout=0.4"])
    batches = _batches(3)
    tr = Trainer(cfg, device="cpu")
    for imgs, labels in batches[:2]:
        tr.train_step(imgs, labels)
    ck = Checkpointer(str(tmp_path / "ckpt"), keep=2)
    assert ck.save(tr.host_step, tr.state, cfg.to_json())
    assert not ck.save(tr.host_step, tr.state, cfg.to_json())          # exists
    ck.wait()
    assert not list((tmp_path / "ckpt").glob("*.tmp*"))
    tr2 = Trainer(cfg, device="cpu")
    tr2.state = ck.restore(tr2.state)
    assert tr2.host_step == 2 and ck.latest_step() == 2
    assert ck.state_keys() == ["model", "opt", "step", "seed"]
    m1, m2 = tr.train_step(*batches[2]), tr2.train_step(*batches[2])
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"], m2["grad_norm"])
    for (k, a), b in zip(tr.model.state_dict().items(), tr2.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert ck.restore_config()["name"] == "casia_arcface"
    for step in (5, 7):
        ck.save(step, tr.state)
    assert ck.steps() == [5, 7]                                        # keeps the 2 latest
    assert ck.restore_config() is None                                 # saved without one
    with pytest.raises(KeyError):
        ck.restore({"model": None})
    ck.close()


def test_degrade_table_and_random_degrade():
    from crfr_torch.ops.bicubic import degrade_table, degrade_updown, random_degrade

    table = degrade_table(32, range(8, 33), "cv2")
    want = np.stack([ref_degrade_matrix(32, low, "cv2") for low in range(8, 33)])
    assert np.array_equal(table, want)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (3, 32, 32, 3)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(random_degrade(x, g, 12, 12), degrade_updown(x, 12),
                               rtol=0, atol=0)
    y = random_degrade(x, g, 8, 16)
    assert any(torch.allclose(y, degrade_updown(x, low), atol=1e-4) for low in range(8, 17))


def test_synthetic_training_learns(tmp_path):
    """tests/test_train.py's bar: 30 steps of ir_18 at 32 px on the 4-class
    synthetic set; the last 10 losses below 0.7 of the first 10, and 4-fold
    verification above 0.75 on pairs embedded by ``embed_fn``."""
    from crfr_torch.eval.verification import evaluate_verification
    from crfr_torch.utils.logging import MetricsWriter

    cfg = get_config("casia_arcface", TINY + ["train.log_every=10", "train.eval_every_steps=16"])
    path = tmp_path / "metrics.jsonl"
    tr = Trainer(cfg, steps_per_epoch=100, device="cpu",
                 metrics=MetricsWriter(str(path), stdout=False))
    data = SyntheticFaces(num_classes=4, image_size=32, seed=0)
    losses = [float(tr.train_step(*b)["loss"]) for b in data.batches(16, 30, seed=1)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7, (losses[:5], losses[-5:])
    i1, i2, issame = data.eval_pairs(np.random.default_rng(5), 64)
    embed = tr.embed_fn()
    res = evaluate_verification(embed(i1), embed(i2), issame, n_folds=4, device="cpu")
    assert res.accuracy_mean > 0.75, res.accuracy_mean
    assert tr.model.training                               # embed_fn restores train mode
    calls = []
    last = tr.fit(data.batches(16, 2, seed=2), max_steps=2,
                  eval_fn=lambda t: calls.append(t.host_step) or {"probe": 1.0})
    assert calls == [32] and last["probe"] == 1.0 and "loss" in last and tr.host_step == 32
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows[-2]["step"] == 32 and "imgs_per_sec" in rows[-2] and "loss" in rows[-2]
    assert rows[-1] == {"step": 32, "t": rows[-1]["t"], "eval_probe": 1.0}
