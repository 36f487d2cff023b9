"""``python -m crfr_torch train-distill`` on the CPU.

A teacher from 2 steps of ``train``; then 4 distillation steps and
``--resume`` to 6 end in the state of 6 steps straight (student,
momentum, step), on synthetic batches drawn from (seed, step); the same
with a frozen G from a ``train-sr`` checkpoint (``--sr-ckpt``), and with G
trained jointly (``--sr-finetune``), whose state and Adam moments
checkpoint with the student. ``--eval-bin`` writes what the restored
student reads. What is not ported raises."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json

import numpy as np
import pytest
import torch

from crfr_torch.cli import main
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_sr_train import _equal_states
from tests.test_torch_train_cli import OVERRIDES, eval_bin_file

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


def test_eval_bin_equals_the_restored_student(tmp_path, teacher_ckpt):
    """``--eval-bin`` at steps 2 and 4 writes what the student restored
    from that step's checkpoint reads on the same ``.bin`` (its embedding
    plus the residual, as crfr's in-loop eval)."""
    from crfr_torch.configs import Config
    from crfr_torch.data.bins import evaluate_bin
    from crfr_torch.train.distill_loop import DistillTrainer

    ebin = eval_bin_file(tmp_path)
    ck = tmp_path / "ck"
    assert _distill(teacher_ckpt, ck, 4, "--eval-bin", str(ebin), "train.eval_every_steps=2") == 0
    rows = [json.loads(line) for line in (ck / "distill_metrics.jsonl").read_text().splitlines()]
    evals = [r for r in rows if "eval_accuracy" in r]
    assert [r["step"] for r in evals] == [2, 4]
    for r in evals:
        saved = torch.load(ck / "student" / f"step_{r['step']:09d}.pt", weights_only=True)
        cfg = Config.from_dict(json.loads(saved["config"]))
        st = DistillTrainer(cfg, teacher_fn=lambda x: None, device="cpu")
        st.load_state_dict(saved["state"])
        res = evaluate_bin(str(ebin), st.student_embed_fn(with_residual=True),
                           cfg.eval.batch_size, cfg.model.input_size, cfg.eval.n_folds,
                           device="cpu")
        assert (res.accuracy_mean, res.eer) == (r["eval_accuracy"], r["eval_eer"]), r


def test_refusals(tmp_path, teacher_ckpt):
    with pytest.raises(ValueError, match="--sr-finetune requires --sr-ckpt"):
        _distill(teacher_ckpt, tmp_path, 2, "--sr-finetune")
