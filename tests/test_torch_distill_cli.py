"""``python -m crfr_torch train-distill`` on the CPU.

A teacher from 2 steps of ``train``; then 4 distillation steps and
``--resume`` to 6 end in the state of 6 steps straight (student,
momentum, step), on synthetic batches drawn from (seed, step); the same
with a frozen G from a ``train-sr`` checkpoint (``--sr-ckpt``), and with G
trained jointly (``--sr-finetune``), whose state and Adam moments
checkpoint with the student. What is not ported raises."""

import json

import numpy as np
import pytest
import torch

from crfr_torch.cli import main
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_sr_train import _equal_states
from tests.test_torch_train_cli import OVERRIDES

KD = ["loss.distill_weight=0.05", "train.grad_clip_norm=5.0", "model.dropout=0.4"]


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    ck = tmp_path_factory.mktemp("teacher")
    assert main(["train", "--preset", "casia_arcface", "--device", "cpu", *OVERRIDES,
                 f"train.checkpoint_dir={ck}", "--max-steps", "2"]) == 0
    return ck


@pytest.fixture(scope="module")
def sr_ckpt(tmp_path_factory):
    ck = tmp_path_factory.mktemp("sr")
    assert main(["train-sr", "--preset", "casia_arcface", "--device", "cpu", "--scale", "4",
                 *OVERRIDES, "train.batch_size=4", f"train.checkpoint_dir={ck}",
                 "--max-steps", "1"]) == 0
    return ck / "sr"


def _distill(teacher, ckpt, steps, *extra, resume=False):
    argv = ["train-distill", "--preset", "casia_arcface", "--device", "cpu",
            "--teacher-ckpt", str(teacher), *OVERRIDES, *KD, f"train.checkpoint_dir={ckpt}",
            "--max-steps", str(steps), *extra]
    return main(argv + (["--resume"] if resume else []))


def _state(ckpt, step):
    return torch.load(ckpt / "student" / f"step_{step:09d}.pt", weights_only=True)["state"]


@pytest.mark.parametrize("sr", ["", "frozen", "joint"])
def test_resume_equals_straight_run(tmp_path, capsys, teacher_ckpt, sr_ckpt, sr):
    extra = {"": [], "frozen": ["--sr-ckpt", str(sr_ckpt), "--sr-scale", "4"],
             "joint": ["--sr-ckpt", str(sr_ckpt), "--sr-scale", "4", "--sr-finetune"]}[sr]
    a, b = tmp_path / "a", tmp_path / "b"
    assert _distill(teacher_ckpt, a, 4, *extra) == 0
    assert _distill(teacher_ckpt, a, 6, *extra, resume=True) == 0
    assert _distill(teacher_ckpt, b, 6, *extra) == 0
    out = capsys.readouterr()
    assert "resumed student from step 4" in out.err
    finals = [json.loads(line) for line in out.out.strip().splitlines()
              if line.startswith('{"loss"')]
    assert [f["steps"] for f in finals] == [4, 6, 6]
    assert all(np.isfinite([f["loss"], f["ce"], f["kd"]]).all() for f in finals)
    assert ("sr_px" in finals[-1]) == (sr == "joint")
    sa, sb = _state(a, 6), _state(b, 6)
    assert sa["step"] == 6 and _equal_states(sa, sb)
    assert ({"g", "g_opt"} <= set(sa)) == (sr == "joint")
    assert (a / "distill_metrics.jsonl").exists()


def test_refusals(tmp_path, teacher_ckpt):
    with pytest.raises(NotImplementedError, match="item 13"):
        _distill(teacher_ckpt, tmp_path, 2, "--eval-bin", "lfw.bin")
    with pytest.raises(ValueError, match="--sr-finetune requires --sr-ckpt"):
        _distill(teacher_ckpt, tmp_path, 2, "--sr-finetune")
