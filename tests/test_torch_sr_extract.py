"""Hallucinated probes and ``python -m crfr_torch train-sr`` on the CPU.

- ``make_extract_fn(sr_apply=...)`` against crfr's with the same G (random
  correction heads, scale 4, 4 priors) and the same IR-18 at 32 px: ↓ to
  8 px, G ↑, the backbone, flip-TTA; embeddings within 1e-4 of their scale.
- ``build_serving_fn(sr_apply=...)`` equals ``make_extract_fn`` on the same
  rows; with G at the port's init the hallucinated path equals the plain
  bicubic ``degrade_to`` path (tests/test_sr_recognition.py:47-73).
- ``load_sr_apply`` from a checkpoint equals the trainer's plug.
- ``train-sr`` for 4 steps, then ``--resume`` to 6, ends in the state of 6
  steps straight (synthetic batches and a ``.crfrpack``); the teacher
  options restore a ``train`` checkpoint."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import nnx

from crfr.eval.extract import make_extract_fn as ref_extract_fn
from crfr.train.sr_loop import sr_apply_from_state as ref_sr_apply
from crfr_torch.cli import main
from crfr_torch.data.records import write_pack
from crfr_torch.eval.extract import make_extract_fn
from crfr_torch.models.sr import build_hallucinator
from crfr_torch.serve import build_serving_fn
from crfr_torch.train.checkpoints import Checkpointer
from crfr_torch.train.loop import Trainer
from crfr_torch.train.sr_loop import SRTrainer, load_sr_apply, sr_apply_from_state
from tests.test_torch_irse import jax_backbone, torch_twin
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_sr_models import twins as sr_twins
from tests.test_torch_sr_train import _equal_states, batches, port_cfg

SIZE, LOW, B = 32, 8, 4


@pytest.fixture(scope="module")
def nets():
    jb = jax_backbone(input_size=SIZE, seed=21)
    jg, tg = sr_twins(4, 4, np.random.default_rng(5))
    return jb, torch_twin(jb, input_size=SIZE), jg, tg.eval()


def _faces(seed, n=B):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


@pytest.mark.parametrize("flip_fusion", ["sum", "concat"])
def test_hallucinated_extract_matches_crfr(nets, flip_fusion):
    jb, tb, jg, tg = nets
    x = _faces(1)
    want = np.asarray(ref_extract_fn(lambda v: jb(v, train=False), degrade_to=LOW,
                                     flip_fusion=flip_fusion, image_size=SIZE,
                                     sr_apply=ref_sr_apply(*nnx.split(jg)))(
        jnp.asarray(x, jnp.float32)))
    got = make_extract_fn(tb, degrade_to=LOW, flip_fusion=flip_fusion, image_size=SIZE,
                          sr_apply=sr_apply_from_state(tg), device="cpu")(x)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("flip_tta", [False, True])
def test_serving_fn_equals_extract(nets, flip_tta):
    _, tb, _, tg = nets
    sr = sr_apply_from_state(tg)
    x = _faces(2)
    got = build_serving_fn(tb, degrade_to=LOW, image_size=SIZE, flip_tta=flip_tta,
                           sr_apply=sr, device="cpu")(x)
    want = make_extract_fn(tb, degrade_to=LOW, image_size=SIZE, flip=flip_tta,
                           sr_apply=sr, device="cpu")(x)
    assert torch.equal(got, want)


def test_g_at_init_equals_the_bicubic_path(nets):
    _, tb, _, _ = nets
    x = _faces(3)
    sr = make_extract_fn(tb, degrade_to=LOW, image_size=SIZE, device="cpu",
                         sr_apply=sr_apply_from_state(build_hallucinator(4, 4)))(x)
    bic = make_extract_fn(tb, degrade_to=LOW, image_size=SIZE, device="cpu")(x)
    np.testing.assert_allclose(sr.numpy(), bic.numpy(), rtol=0,
                               atol=1e-4 * bic.abs().max().item())


def test_sr_apply_is_a_frozen_snapshot(nets):
    _, _, _, tg = nets
    f = sr_apply_from_state(tg)
    lr = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (2, LOW, LOW, 3))
                          .astype(np.float32))
    before = f(lr)
    with torch.no_grad():
        tg.gen.out.weight.add_(1.0)
    try:
        assert torch.equal(f(lr), before) and not before.requires_grad
        lr.requires_grad_(True)
        out = sr_apply_from_state(tg, trainable=True)(lr)
        out.sum().backward()
        assert lr.grad is not None and lr.grad.abs().sum() > 0
    finally:
        with torch.no_grad():
            tg.gen.out.weight.sub_(1.0)


def test_load_sr_apply_equals_the_trainer(tmp_path):
    cfg = port_cfg()
    tr = SRTrainer(cfg, device="cpu", scale=4, n_priors=4)
    tr.train_step(batches(1)[0])
    ck = Checkpointer(str(tmp_path))
    ck.save(tr.step, tr.state_dict(), cfg.to_json())
    lr = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (2, LOW, LOW, 3))
                          .astype(np.float32))
    for ema in (True, False):
        got = load_sr_apply(str(tmp_path), cfg, scale=4, n_priors=4, ema=ema, device="cpu")(lr)
        assert torch.equal(got, tr.sr_apply(ema=ema)(lr))
    with pytest.raises(ValueError, match="bicubic_skip"):
        load_sr_apply(str(tmp_path), cfg, scale=4, n_priors=4, bicubic_skip=False, device="cpu")


def test_extract_needs_degrade_to_for_sr(nets):
    _, tb, _, tg = nets
    with pytest.raises(ValueError, match="sr_apply needs degrade_to"):
        make_extract_fn(tb, sr_apply=sr_apply_from_state(tg), device="cpu")


OVERRIDES = ["data.image_size=32", "model.input_size=32", "data.num_classes=4",
             "model.backbone=ir_18", "model.compute_dtype=float32", "loss.scale=16.0",
             "loss.margin=0.2", "train.batch_size=4", "train.checkpoint_every_steps=2",
             "train.log_every=3"]


def _train_sr(ckpt, steps, *extra, resume=False):
    argv = ["train-sr", "--preset", "casia_arcface", "--device", "cpu", "--scale", "4",
            *OVERRIDES, f"train.checkpoint_dir={ckpt}", "--max-steps", str(steps),
            "--warmup-steps", "1", "--n-d-steps", "2", *extra]
    return main(argv + (["--resume"] if resume else []))


@pytest.mark.parametrize("source", ["synthetic", "records"])
def test_cli_resume_equals_straight_run(tmp_path, capsys, source):
    extra = []
    if source == "records":
        rng = np.random.default_rng(0)
        recs = [(int(i % 4), rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
                for i in range(10)]
        write_pack(str(tmp_path / "train.crfrpack"), recs)
        extra = ["--train-records", str(tmp_path / "train.crfrpack")]
    assert _train_sr(tmp_path / "a", 4, *extra) == 0
    assert _train_sr(tmp_path / "a", 6, *extra, resume=True) == 0
    assert _train_sr(tmp_path / "b", 6, *extra) == 0
    out = capsys.readouterr()
    finals = [json.loads(line) for line in out.out.splitlines() if '"steps"' in line]
    assert [f["steps"] for f in finals] == [4, 6, 6]
    assert all(np.isfinite(f["g_loss"]) and np.isfinite(f["d_loss"]) for f in finals)
    assert "resumed SR from step 4" in out.err
    a, b = (Checkpointer(str(tmp_path / r / "sr")) for r in "ab")
    assert a.steps() == b.steps() == [2, 4, 6]
    assert _equal_states(a.restore(step=6), b.restore(step=6))
    rows = [json.loads(r) for r in (tmp_path / "a" / "sr_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [3, 6] and {"psnr", "ssim"} <= set(rows[0])


def test_cli_teacher_options(tmp_path, capsys):
    """``--teacher-ckpt`` restores a ``train`` checkpoint as the frozen
    teacher; ``--perceptual`` needs it."""
    with pytest.raises(ValueError, match="--perceptual requires --teacher-ckpt"):
        _train_sr(tmp_path / "x", 1, "--perceptual", "0.5")
    from tests.test_torch_train import tiny_cfg

    from crfr_torch.configs import Config

    tcfg = Config.from_dict(tiny_cfg().to_dict())
    t = Trainer(tcfg, device="cpu")
    Checkpointer(str(tmp_path / "teacher")).save(0, t.state, tcfg.to_json())
    assert _train_sr(tmp_path / "s", 1, "--teacher-ckpt", str(tmp_path / "teacher"),
                     "--perceptual", "0.5") == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 1 and np.isfinite(res["g_loss"])
    cfg = Checkpointer(str(tmp_path / "s" / "sr")).restore_config()
    assert cfg["loss"]["sr_perceptual_weight"] == 0.5


def test_cli_wants_cuda_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train-sr", "--preset", "casia_arcface", "--scale", "4", *OVERRIDES,
            f"train.checkpoint_dir={tmp_path}", "--max-steps", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    # WORLD_SIZE alone describes no launch: the one process still wants CUDA;
    # a mesh larger than the processes raises
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        main([*argv, "--device", "cpu", "mesh.data=2"])
