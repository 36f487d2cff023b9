"""The headline experiment's port (crfr_torch.experiments.headline) against
crfr/experiments/headline.py on the CPU: ``HeadlineCfg``'s fields and
defaults, each stage's ``_cfg``, ``_epoch_feed``'s batches (with and without
landmarks), ``_embed_arrays``' tail padding, ``_pair_correct``,
``_bootstrap_ci``, ``_evaluate_probe`` (on the same rendered identities and
deterministic embedders) and ``ordering_holds`` equal on the same inputs;
``_probe_embedders`` sends each system through its model (and only
``student_sr`` through G); the int8 row: ``_evaluate_probe``'s ``int8``
table equal to crfr's on deterministic embedders, and
``_int8_probe_embedders`` sending each system through its quantized
backbone, its residual and G; ``bench.headline_compare`` counts sign
agreement; every stage run end to end at 32 px on the CPU with the int8
row off and on (and at crfr's micro scale, marked slow as crfr's own test
is), with the table's schema, the stage checkpoints and the JSON
artifact."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from crfr.experiments import headline as ref
from crfr_torch.experiments import headline as port
from tests.test_headline import _table
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)


def test_cfg_fields_and_defaults_equal_crfr():
    assert dataclasses.asdict(port.HeadlineCfg()) == dataclasses.asdict(ref.HeadlineCfg())
    h = port.HeadlineCfg(batch_size=16, out_dir="/x", grad_clip=1.0)
    hr = ref.HeadlineCfg(batch_size=16, out_dir="/x", grad_clip=1.0)
    for kw in (dict(num_classes=96, degrade=None, lr=0.1, steps=1200, name="teacher"),
               dict(num_classes=96, degrade=16, lr=1e-4, steps=800, name="sr16"),
               dict(num_classes=96, degrade=8, lr=0.05, steps=7, distill=0.05,
                    name="student_sr8")):
        assert port._cfg(h, **kw).to_dict() == ref._cfg(hr, **kw).to_dict(), kw


@pytest.mark.parametrize("with_landmarks", [False, True])
def test_epoch_feed_equals_crfr(with_landmarks):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (23, 4, 4, 3)).astype(np.uint8)
    labels = np.arange(23, dtype=np.int32)
    lms = rng.normal(size=(23, 5, 2)).astype(np.float32) if with_landmarks else None
    want = list(ref._epoch_feed(imgs, labels, 5, 11, seed=4, lms=lms))
    got = list(port._epoch_feed(imgs, labels, 5, 11, seed=4, lms=lms))
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert len(g) == len(w) == (3 if with_landmarks else 2)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_embed_arrays_pads_the_tail_as_crfr():
    imgs = np.random.default_rng(1).uniform(0, 255, (11, 4, 4, 3)).astype(np.float32)
    seen = []

    def fn(chunk):
        seen.append(chunk.shape)
        return torch.from_numpy(chunk).sum(dim=(1, 2))

    want = ref._embed_arrays(lambda c: c.sum(axis=(1, 2)), imgs, 4)
    got = port._embed_arrays(fn, imgs, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.shape == (11, 3) and seen == [(4, 4, 4, 3)] * 3


def test_pair_correct_and_bootstrap_equal_crfr():
    rng = np.random.default_rng(2)
    e1, e2 = rng.normal(size=(2, 64, 16)).astype(np.float32)
    issame = rng.random(64) < 0.5
    thr = rng.uniform(1.5, 2.5, 8)
    np.testing.assert_array_equal(port._pair_correct(e1, e2, issame, thr),
                                  ref._pair_correct(e1, e2, issame, thr))
    hits = {s: {"verification_acc": rng.random(64) < p, "rank1": rng.random(64) < p / 2}
            for s, p in (("teacher_lr", 0.5), ("student_bic", 0.7), ("student_sr", 0.8))}
    assert port._bootstrap_ci(hits, 300, 7) == ref._bootstrap_ci(hits, 300, 7)


def test_ordering_holds_equals_crfr():
    cases = [{}, {"student_bic_va": 0.8}, {"student_sr_va": 0.55}, {"teacher_lr_va": 0.9},
             {"student_sr_va": 0.6, "student_bic_va": 0.6}, {"student_sr_r1": 0.1}]
    for vals in cases:
        for metric in ("verification_acc", "rank1"):
            t = _table(**vals)
            assert port.ordering_holds(t, 16, metric) == ref.ordering_holds(t, 16, metric)


def _pooled_projection(factor, proj):
    """A fixed numpy embedder: ``factor``× block means (a coarser probe for a
    larger factor), upsampled back by repetition, centred per image and
    projected by ``proj``."""
    def f(chunk):
        b, s = chunk.shape[0], chunk.shape[1]
        x = chunk.reshape(b, s // factor, factor, s // factor, factor, 3).mean(axis=(2, 4))
        x = x.repeat(factor, axis=1).repeat(factor, axis=2).reshape(b, -1) / 255.0
        return (x - x.mean(axis=1, keepdims=True)).astype(np.float32) @ proj

    return f


def test_evaluate_probe_equals_crfr():
    """``_evaluate_probe`` on the same rendered identities, the same rng and
    the same deterministic embedders (block means of the pixels at 1/2/4/8×,
    one fixed random projection): every protocol's number and the paired
    bootstrap equal crfr's exactly. The tail batch is padded (96 pairs and
    48 probes in batches of 20)."""
    from crfr.data.render import RenderedIdentities as RefRenderer
    from crfr_torch.data.render import RenderedIdentities

    kw = dict(ids_train=2, ids_eval=16, ids_distract=6, image_size=32, n_pairs=48,
              probes_per_id=3, eval_batch=20, bootstrap=300, seed=3, int8_eval=False)
    h, hr_cfg = port.HeadlineCfg(**kw), ref.HeadlineCfg(**kw)
    n_ids = h.ids_train + h.ids_eval + h.ids_distract
    ranges = ((h.ids_train, h.ids_train + h.ids_eval), (h.ids_train + h.ids_eval, n_ids))
    proj = np.random.default_rng(0).normal(size=(32 * 32 * 3, 128)).astype(np.float32)
    factors = {"teacher_lr": 8, "student_bic": 4, "student_sr": 2}
    ref_sys = {s: _pooled_projection(f, proj) for s, f in factors.items()}
    port_sys = {s: (lambda c, f=f: torch.from_numpy(f(c))) for s, f in ref_sys.items()}
    hr = _pooled_projection(1, proj)

    want = ref._evaluate_probe(hr_cfg, RefRenderer(n_ids, image_size=32, seed=h.seed),
                               hr, ref_sys, *ranges, np.random.default_rng(7))
    got = port._evaluate_probe(h, RenderedIdentities(n_ids, image_size=32, seed=h.seed),
                               lambda c: torch.from_numpy(hr(c)), port_sys, *ranges,
                               np.random.default_rng(7), device="cpu")
    assert got == want
    # the embedders tell the systems apart, and the open-set protocol is not idle
    for metric in ("verification_acc", "rank1"):
        assert len({got[s][metric] for s in factors}) > 1, metric
    assert all(got[s]["tpir_at_fpir0.1"] > 0 for s in factors)
    assert set(got["bootstrap"]["gaps"]) == {"verification_acc", "rank1", "cmc5"}


def test_evaluate_probe_int8_row_equals_crfr():
    """``_evaluate_probe(sys_lr_int8=...)``: the ``int8`` table (verification
    and rank-1 per system) equal to crfr's exactly, on the same rendered
    identities and deterministic embedders as above, the int8 twins being
    other projections of the same pooled pixels."""
    from crfr.data.render import RenderedIdentities as RefRenderer
    from crfr_torch.data.render import RenderedIdentities

    kw = dict(ids_train=2, ids_eval=16, ids_distract=6, image_size=32, n_pairs=48,
              probes_per_id=3, eval_batch=20, bootstrap=0, seed=3)
    h, hr_cfg = port.HeadlineCfg(**kw), ref.HeadlineCfg(**kw)
    n_ids = h.ids_train + h.ids_eval + h.ids_distract
    ranges = ((h.ids_train, h.ids_train + h.ids_eval), (h.ids_train + h.ids_eval, n_ids))
    rng = np.random.default_rng(0)
    proj = rng.normal(size=(32 * 32 * 3, 128)).astype(np.float32)
    proj8 = (proj + 0.3 * rng.normal(size=proj.shape)).astype(np.float32)
    factors = {"teacher_lr": 8, "student_bic": 4, "student_sr": 2}
    ref_sys = {s: _pooled_projection(f, proj) for s, f in factors.items()}
    ref_int8 = {s: _pooled_projection(f, proj8) for s, f in factors.items()}
    hr = _pooled_projection(1, proj)

    def as_port(fns):
        return {s: (lambda c, f=f: torch.from_numpy(f(c))) for s, f in fns.items()}

    want = ref._evaluate_probe(hr_cfg, RefRenderer(n_ids, image_size=32, seed=h.seed),
                               hr, ref_sys, *ranges, np.random.default_rng(7),
                               sys_lr_int8=ref_int8)
    got = port._evaluate_probe(h, RenderedIdentities(n_ids, image_size=32, seed=h.seed),
                               lambda c: torch.from_numpy(hr(c)), as_port(ref_sys), *ranges,
                               np.random.default_rng(7), device="cpu",
                               sys_lr_int8=as_port(ref_int8))
    assert got == want
    assert set(got["int8"]) == set(factors)
    for s in factors:
        assert set(got["int8"][s]) == {"verification_acc", "rank1"}
    assert got["int8"] != {s: {m: got[s][m] for m in ("verification_acc", "rank1")}
                           for s in factors}


def test_probe_embedders_route_each_system():
    """``_probe_embedders`` with a hallucinator at init (G = bicubic): the HR
    embedder is the teacher on the normalised HR faces; ``teacher_lr`` the
    teacher, ``student_bic`` the bicubic student and ``student_sr`` the
    hallucinated student, each (s + r for the students) on the kernel-1
    bicubic probe, G called on ``student_sr``'s batches alone. The two
    students' weights differ, so a swap shows."""
    from crfr_torch.models.sr import build_hallucinator
    from crfr_torch.ops.fused_preprocess import fused_degrade_normalize
    from crfr_torch.ops.normalize import normalize
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import sr_apply_from_state

    size, probe = 32, 8
    h = port.HeadlineCfg(ids_train=4, image_size=size, compute_dtype="float32",
                         probe_sizes=(probe,), int8_eval=False)
    teacher = Trainer(port._cfg(h, num_classes=4, degrade=None, lr=0.1, steps=2),
                      device="cpu")
    scfg = port._cfg(h, num_classes=4, degrade=probe, lr=0.05, steps=2, distill=0.05)
    students = {n: DistillTrainer(scfg, teacher_from_trainer(teacher), device="cpu")
                for n in ("student_bic", "student_sr")}
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for prm in students["student_sr"].model.parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    plug, calls = sr_apply_from_state(build_hallucinator(size // probe, 16)), []

    def g(lr):
        calls.append(tuple(lr.shape))
        return plug(lr)

    hr_fn, sys_lr = port._probe_embedders(h, teacher, students, g, probe, device="cpu")
    x = np.random.default_rng(4).integers(0, 256, (6, size, size, 3)).astype(np.uint8)
    xt = torch.from_numpy(x)
    bic = fused_degrade_normalize(xt, probe, "pil", torch.float32)
    t_bb = teacher.model.backbone
    want = {"hr": teacher.backbone_apply(t_bb, normalize(xt)),
            "teacher_lr": teacher.backbone_apply(t_bb, bic),
            **{n: st.student_apply(st.model, bic) for n, st in students.items()}}
    scale = max(v.abs().max().item() for v in want.values())
    np.testing.assert_allclose(hr_fn(x).numpy(), want["hr"].numpy(), rtol=0, atol=1e-5 * scale)
    for name in ("teacher_lr", "student_bic"):
        np.testing.assert_allclose(sys_lr[name](x).numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    assert calls == []
    np.testing.assert_allclose(sys_lr["student_sr"](x).numpy(), want["student_sr"].numpy(),
                               rtol=0, atol=1e-4 * scale)
    assert calls == [(6, probe, probe, 3)]
    gap = (want["student_sr"] - want["student_bic"]).abs().max().item()
    assert gap > 100 * 1e-4 * scale, gap


def test_int8_probe_embedders_route_each_system():
    """``_int8_probe_embedders``: each system through its own backbone
    quantized on the first two eval batches of the calibration faces
    (the plain down-up operator at the probe size), the students' residual
    branches float on top, G on ``student_sr``'s batches alone; each within
    cosine 0.99 of its float twin."""
    from crfr_torch.models.quant import QuantConv, calibration_batch, quantize_backbone
    from crfr_torch.models.sr import build_hallucinator
    from crfr_torch.ops.fused_preprocess import fused_degrade_normalize, fused_resize_normalize
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import sr_apply_from_state

    size, probe = 32, 8
    h = port.HeadlineCfg(ids_train=4, image_size=size, compute_dtype="float32",
                         probe_sizes=(probe,), eval_batch=4)
    teacher = Trainer(port._cfg(h, num_classes=4, degrade=None, lr=0.1, steps=2),
                      device="cpu")
    scfg = port._cfg(h, num_classes=4, degrade=probe, lr=0.05, steps=2, distill=0.05)
    students = {n: DistillTrainer(scfg, teacher_from_trainer(teacher), device="cpu")
                for n in ("student_bic", "student_sr")}
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for prm in students["student_sr"].model.parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=gen))
    plug, calls = sr_apply_from_state(build_hallucinator(size // probe, 16)), []

    def g(lr):
        calls.append(tuple(lr.shape))
        return plug(lr)

    calib_raw = np.random.default_rng(5).integers(0, 256, (10, size, size, 3)).astype(np.uint8)
    sys8 = port._int8_probe_embedders(h, teacher, students, g, probe, calib_raw, device="cpu")
    assert set(sys8) == {"teacher_lr", "student_bic", "student_sr"} and calls == []

    calib = [calibration_batch(calib_raw[i:i + 4], probe, "pil") for i in (0, 4)]
    x = np.random.default_rng(4).integers(0, 256, (6, size, size, 3)).astype(np.uint8)
    xt = torch.from_numpy(x)
    bic = fused_degrade_normalize(xt, probe, "pil", torch.float32)
    sr_in = plug(fused_resize_normalize(xt, (probe, probe), "pil", out_dtype=torch.float32))
    inputs = {"teacher_lr": bic, "student_bic": bic, "student_sr": sr_in}
    models = {"teacher_lr": teacher.model.backbone,
              **{n: st.model.backbone for n, st in students.items()}}
    with torch.no_grad():
        for name, model in models.items():
            q = quantize_backbone(model, calib)
            assert sum(isinstance(m, QuantConv) for m in q.modules()) == 21
            want, float_want = q(inputs[name]), model.eval()(inputs[name])
            if name != "teacher_lr":
                res = students[name].model.residual.eval()
                want, float_want = want + res(want), float_want + res(float_want)
            got = sys8[name](x)
            scale = want.abs().max().item()
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                       err_msg=name)
            cos = torch.nn.functional.cosine_similarity(got, float_want, dim=-1)
            assert cos.min() > 0.99, (name, cos)
    assert calls == [(6, probe, probe, 3)]


def _check_table(table, h, probes):
    for p in probes:
        res = table["results"][str(p)]
        for system in ("teacher_lr", "student_bic", "student_sr"):
            for metric in ("verification_acc", "rank1", "cmc5", "tpir_at_fpir0.1"):
                v = res[system][metric]
                assert 0.0 <= v <= 1.0, (system, metric, v)
        assert res["student_sr"]["cmc5"] >= res["student_sr"]["rank1"]
        assert port.ordering_holds(table, p) in (True, False)
        st = table["stages"][f"students{p}"]
        assert np.isfinite(st["loss_sr"]) and np.isfinite(st["loss_bic"])
        assert np.isfinite(table["stages"][f"sr{p}"]["g_loss"])
        if h.int8_eval:
            assert set(res["int8"]) == {"teacher_lr", "student_bic", "student_sr"}
            for system, row in res["int8"].items():
                assert set(row) == {"verification_acc", "rank1"}
                assert all(0.0 <= v <= 1.0 for v in row.values()), (system, row)
            assert set(table["stages"][f"int8_{p}"]) == {"quantize_s", "int8_eval_s"}
        else:
            assert "int8" not in res and f"int8_{p}" not in table["stages"]
    assert os.path.isdir(os.path.join(h.out_dir, "teacher"))
    with open(os.path.join(h.out_dir, "headline.json")) as f:
        loaded = json.load(f)
    assert loaded["results"] == json.loads(json.dumps(table["results"]))
    assert loaded["stages"]["n_train_imgs"] == h.ids_train * h.samples_per_id
    assert np.isfinite(loaded["stages"]["teacher"]["loss"])
    assert loaded["cfg"]["int8_eval"] is h.int8_eval


@pytest.mark.parametrize("int8_eval", [False, True])
def test_headline_end_to_end_at_32px(tmp_path, int8_eval):
    """Every stage at 32 px (a 4× hallucinator for 8 px probes), float32,
    with the int8 row off and on."""
    h = port.HeadlineCfg(
        ids_train=4, ids_eval=3, ids_distract=2, samples_per_id=4, image_size=32,
        compute_dtype="float32", batch_size=8, teacher_steps=2, sr_steps=1,
        distill_steps=2, probe_sizes=(8,), n_pairs=4, probes_per_id=2, eval_batch=8,
        bootstrap=50, int8_eval=int8_eval, out_dir=str(tmp_path / "headline"),
        log_every=1000)
    _check_table(port.run_headline(h, device="cpu"), h, (8,))


@pytest.mark.slow
def test_headline_micro_end_to_end(tmp_path):
    """crfr's micro scale (tests/test_headline.py:41-54) at 112 px."""
    h = port.HeadlineCfg(
        ids_train=6, ids_eval=4, ids_distract=4, samples_per_id=8,
        batch_size=8, teacher_steps=4, sr_steps=3, distill_steps=3,
        probe_sizes=(16,), n_pairs=8, probes_per_id=2, eval_batch=8, int8_eval=False,
        out_dir=str(tmp_path / "headline"), log_every=1000)
    _check_table(port.run_headline(h, device="cpu"), h, (16,))


def test_seed_replicates_aggregate_as_crfr(tmp_path, monkeypatch):
    """``run_headline_seeds``' aggregation (mean, std, values, the ordering
    per seed) on the same per-seed tables, and its artifact."""
    def fake(h, device=None):
        rng = np.random.default_rng(h.seed)
        res = {str(p): {s: {m: float(rng.random()) for m in
                            ("verification_acc", "rank1", "cmc5", "tpir_at_fpir0.1")}
                        for s in ("teacher_lr", "student_bic", "student_sr")}
               for p in h.probe_sizes}
        return {"results": res}

    monkeypatch.setattr(port, "run_headline", fake)
    monkeypatch.setattr(ref, "run_headline", fake)
    kw = dict(int8_eval=False, out_dir=str(tmp_path / "seeds"))
    got = port.run_headline_seeds(port.HeadlineCfg(**kw), 3, device="cpu")
    want = ref.run_headline_seeds(ref.HeadlineCfg(**kw), 3)
    for k in ("n_seeds", "cfg", "aggregate", "per_seed"):
        assert got[k] == want[k], k
    with open(tmp_path / "seeds" / "headline_seeds.json") as f:
        assert json.load(f)["aggregate"] == json.loads(json.dumps(got["aggregate"]))


def test_headline_cli_parses_fields_as_crfr(tmp_path, monkeypatch, capsys):
    """``python -m crfr_torch headline``: booleans from 0/1, tuples from
    commas, other fields by their type; an unknown field raises naming the
    valid ones."""
    from crfr_torch.cli import main

    seen = []

    def fake(h, device=None):
        seen.append((h, device))
        return {"results": {str(p): {s: {"verification_acc": 0.5, "rank1": 0.5}
                                     for s in ("teacher_lr", "student_bic", "student_sr")}
                            for p in h.probe_sizes}, "stages": {}, "total_s": 0.0}

    monkeypatch.setattr(port, "run_headline", fake)
    assert main(["headline", "--out", str(tmp_path), "--device", "cpu", "int8_eval=0",
                 "probe_sizes=8", "teacher_steps=5", "hard=0.5"]) == 0
    h, device = seen[0]
    assert (h.int8_eval, h.probe_sizes, h.teacher_steps, h.hard, h.out_dir, device) == \
        (False, (8,), 5, 0.5, str(tmp_path), "cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ordering"] == {"8": False} and out["ordering_rank1"] == {"8": False}
    with pytest.raises(KeyError, match="unknown headline field 'nope'"):
        main(["headline", "--out", str(tmp_path), "nope=1"])


def test_headline_compare_counts_sign_agreement(tmp_path, capsys):
    """``bench.headline_compare`` on two per-seed tables: each gap's sign
    compared seed by seed, a zero gap its own sign, and runs at different
    fields refused."""
    from crfr_torch.bench import headline_compare

    def table(vals, **cfg):
        per_seed = [{"16": {s: {"verification_acc": v[i], "rank1": v[i]}
                            for i, s in enumerate(("teacher_lr", "student_bic", "student_sr"))}}
                    for v in vals]
        return {"n_seeds": len(vals), "cfg": {"seed": 0, "out_dir": "x", **cfg},
                "per_seed": per_seed}

    a = table([(0.5, 0.6, 0.7), (0.5, 0.6, 0.6)])
    b = table([(0.5, 0.7, 0.6), (0.6, 0.6, 0.6)])
    out = headline_compare.compare(a, b)
    assert out["counts"] == {"sr_minus_bic": {"agree": 2, "of": 4},
                             "bic_minus_teacher": {"agree": 2, "of": 4}}
    for name, t in (("a", a), ("b", b), ("c", table([(0.5, 0.6, 0.7)], seed=1))):
        (tmp_path / name).write_text(json.dumps(t))
    assert headline_compare.main([str(tmp_path / "a"), str(tmp_path / "b")]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["counts"] == out["counts"]
    with pytest.raises(ValueError, match="different HeadlineCfg"):
        headline_compare.main([str(tmp_path / "a"), str(tmp_path / "c")])
