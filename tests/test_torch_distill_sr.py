"""The distilled student on hallucinated input against crfr on the CPU.

The config and the checks of tests/test_torch_distill.py (ir_18 at 32 px,
float32, batch 16, lr 2e-3, λ = 1e-3, a teacher at init, each step from
crfr's student and momentum), with G a ``Hallucinator`` at scale 4 with 4
priors and random correction heads (tests/test_torch_sr_models.py's
``twins``), so that the student sees 8 px probes hallucinated to 32 px:

- a frozen G (``sr_fn``): three steps, loss, CE and KD within 1e-4
  relative, the student within rtol 2e-4 / atol 2e-5 after each step.
  crfr's ↓ operator runs on normalised pixels and the port's kernel
  resizes raw pixels and normalises in the same pass; the operator's rows
  sum to 1, so the two differ by float32 rounding, which the tolerances
  cover;
- a trainable G (``sr_module``): the same, and the pixel anchor within
  1e-4 relative; after each step G's parameters and BN statistics within
  the same tolerance but for Adam's sign flips (an element whose gradient
  is within rounding of 0 moves by ±lr in one stack and not the other):
  each within 2·lr of crfr's, fewer than 1e-4 of G's elements; then the
  port takes crfr's G and Adam moments with the student, since G's output
  is the student's input (a flipped element of G moved the student's BN
  statistics by 2.3× the tolerance by step 3 otherwise); the student must
  match with none;
- the joint trainer's checkpoint resumes bit for bit (G and its Adam state
  too), and ``sr_apply`` is a frozen snapshot of G.
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax
from flax import nnx

from crfr.train.sr_loop import sr_apply_from_state as ref_sr_apply
from crfr_torch.models.convert import params_from_jax
from crfr_torch.train.checkpoints import Checkpointer
from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
from crfr_torch.train.sr_loop import sr_apply_from_state
from tests.test_torch_distill import (assert_metrics_match, assert_student_matches,  # noqa
                                      batches, port_cfg, run_twins, sync_student, teachers,
                                      tiny_cfg, twin_students)
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_sr_models import jax_flat, twins
from tests.test_torch_sr_train import _equal_states, assert_state_matches

SCALE, SR_LR, STEPS = 4, 1e-5, 3


def _twin_runs(teachers, joint: bool):
    cfg = tiny_cfg()
    jg, tg = twins(SCALE, 4, np.random.default_rng(11))
    if joint:
        ref_kw = dict(sr_module=nnx.split(jg), sr_lr=SR_LR)
        port_kw = dict(sr_module=tg, sr_lr=SR_LR)
    else:
        ref_kw = dict(sr_fn=ref_sr_apply(*nnx.split(jg)))
        port_kw = dict(sr_fn=sr_apply_from_state(tg))
    ref, port = twin_students(cfg, teachers, dict(sr_scale=SCALE, **ref_kw),
                              dict(sr_scale=SCALE, **port_kw))
    flips = []
    if joint:
        def check(ref, port):
            assert_student_matches(ref, port)
            flips.append(assert_state_matches(params_from_jax(jax_flat(ref.g_state)),
                                              port.g.state_dict(), 1, lr=SR_LR))

        def sync(ref, port):
            sync_student(ref, port)
            sync_g(ref, port)
    else:
        check = sync = None
    metrics = run_twins(cfg, ref, port, with_lows=False, check=check, sync=sync)
    return ref, port, metrics, flips


def sync_g(ref, port) -> None:
    """The port's G and its Adam moments set to crfr's."""
    port.g.load_state_dict(params_from_jax(jax_flat(ref.g_state)))
    moments = {}
    for which in ("mu", "nu"):
        flat = {}
        for path, v in jax.tree_util.tree_flatten_with_path(ref.g_opt)[0]:
            names = [str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                     for p in path]
            if which in names:
                flat["/".join(n for n in names[names.index(which) + 1:] if n != "value")] = \
                    np.asarray(v)
        moments[which] = params_from_jax(flat)
    for name, p in port.g.named_parameters():
        st = port.g_opt.opt.state[p]
        st["exp_avg"].copy_(moments["mu"][name])
        st["exp_avg_sq"].copy_(moments["nu"][name])


@pytest.fixture(scope="module")
def frozen_run(teachers):
    return _twin_runs(teachers, joint=False)


@pytest.fixture(scope="module")
def joint_run(teachers):
    return _twin_runs(teachers, joint=True)


def test_frozen_g_three_steps_match_crfr(frozen_run):
    _, port, metrics, _ = frozen_run
    assert_metrics_match(metrics)
    assert port.g is None and port.step == STEPS


def test_joint_g_three_steps_match_crfr(joint_run):
    _, port, metrics, flips = joint_run
    assert_metrics_match(metrics, ("loss", "ce", "kd", "sr_px"))
    assert all(mp["sr_px"] > 0 for _, mp in metrics)
    assert port.g_opt.count() == STEPS and len(flips) == STEPS
    init = twins(SCALE, 4, np.random.default_rng(11))[1].state_dict()
    assert any(not torch.equal(v, init[k]) for k, v in port.g.state_dict().items()
               if v.is_floating_point())                  # G trained


def test_joint_checkpoint_resumes_bitwise(tmp_path, teachers):
    _, port_t = teachers
    cfg = port_cfg(tiny_cfg(**{"model.dropout": 0.4}))
    _, tg = twins(SCALE, 4, np.random.default_rng(12))
    kw = dict(sr_module=tg, sr_scale=SCALE, sr_lr=SR_LR, device="cpu")
    teacher = teacher_from_trainer(port_t)
    a = DistillTrainer(cfg, teacher, **kw)
    data = batches()
    for imgs, labels in data[:2]:
        a.train_step(imgs, labels)
    ck = Checkpointer(str(tmp_path / "student"))
    ck.save(a.step, a.state_dict(), cfg.to_json())
    b = DistillTrainer(cfg, teacher, **kw)
    b.load_state_dict(ck.restore(b.state_dict()))
    assert {"g", "g_opt"} <= set(b.state_dict()) and b.g_opt.count() == 2
    assert _equal_states(a.state_dict(), b.state_dict())
    ma, mb = a.train_step(*data[2]), b.train_step(*data[2])
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert _equal_states(a.state_dict(), b.state_dict())

    plug = a.sr_apply()
    lr = torch.rand(2, 8, 8, 3) * 2 - 1
    a.g.eval()
    with torch.no_grad():
        want = a.g(lr)[0]
    a.g.train()
    assert torch.equal(plug(lr), want)
    a.train_step(*data[0])                               # the snapshot stays put
    assert torch.equal(plug(lr), want)
