"""The SR trainer's teacher terms against crfr on the CPU, with an ir_18 at
32 px carried across (``train_state_from_jax``): one G step at a constant
lr from the same G and D, without a teacher, with the identity term and
with the perceptual term (weight 1).

- The perceptual term changes G's gradient, so G after the step differs
  from the run without it, in crfr and in the port alike.
- The identity term changes the loss's value but not G's gradient: crfr's
  teacher stop-gradients its output, and the port runs it without a graph.
  G after the step equals the run without it.
- Each run's G loss matches crfr's within 1e-4 relative, and G after the
  step matches within the train tests' tolerance (with Adam's sign flips
  bounded as in tests/test_torch_sr_train.py)."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

from crfr.train.distill_loop import teacher_from_trainer as ref_teacher
from crfr.train.loop import Trainer as RefTrainer
from crfr.train.sr_loop import SRTrainer as RefSRTrainer
from crfr.train.sr_loop import perceptual_from_trainer as ref_perceptual
from crfr_torch.configs import Config as PortConfig
from crfr_torch.models.convert import params_from_jax, train_state_from_jax
from crfr_torch.train.distill_loop import teacher_from_trainer
from crfr_torch.train.loop import Trainer
from crfr_torch.train.sr_loop import SRTrainer, perceptual_from_trainer
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_sr_train import (assert_state_matches, batches, jax_flat,
                                       load_crfr_weights, port_cfg, tiny_cfg)
from tests.test_torch_train import ref_flat
from tests.test_torch_train import tiny_cfg as teacher_cfg

KW = dict(scale=4, n_priors=4)
CASES = ("none", "identity", "perceptual")


@pytest.fixture(scope="module")
def runs():
    """case → (crfr g_loss, crfr G state converted, port g_loss, port G state)."""
    ref_t = RefTrainer(teacher_cfg(), steps_per_epoch=100)
    port_t = Trainer(PortConfig.from_dict(teacher_cfg().to_dict()), device="cpu")
    port_t.model.load_state_dict(train_state_from_jax(ref_flat(ref_t)))
    x = batches(1)[0]
    out = {}
    for case in CASES:
        cfg = tiny_cfg(**({"loss.sr_perceptual_weight": 1.0} if case == "perceptual" else {}))
        ref_kw, port_kw = dict(KW), dict(KW)
        if case == "identity":
            ref_kw["teacher_fn"], port_kw["teacher_fn"] = (ref_teacher(ref_t),
                                                           teacher_from_trainer(port_t))
        if case == "perceptual":
            ref_kw["perceptual_fn"], port_kw["perceptual_fn"] = (ref_perceptual(ref_t),
                                                                 perceptual_from_trainer(port_t))
        ref = RefSRTrainer(cfg, **ref_kw)
        port = SRTrainer(PortConfig.from_dict(cfg.to_dict()), device="cpu", **port_kw)
        load_crfr_weights(port, ref)
        g_ref = float(ref.train_step(x)["g_loss"])
        g_port = float(port.train_step(x)["g_loss"])
        out[case] = (g_ref, params_from_jax(jax_flat(ref.g_state)), g_port,
                     {k: v.clone() for k, v in port.g.state_dict().items()})
    return out


@pytest.mark.parametrize("case", CASES)
def test_g_step_matches_crfr(runs, case):
    g_ref, want, g_port, got = runs[case]
    assert abs(g_port - g_ref) <= 1e-4 * abs(g_ref), (g_port, g_ref)
    assert_state_matches(want, got, 1)


def test_identity_term_changes_the_loss_not_the_gradient(runs):
    (r0, w0, p0, s0), (r1, w1, p1, s1) = runs["none"], runs["identity"]
    assert r1 > r0 * (1 + 1e-3) and p1 > p0 * (1 + 1e-3)
    assert all(torch.equal(v, s1[k]) for k, v in s0.items())
    for k, v in w0.items():
        np.testing.assert_allclose(w1[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-9, err_msg=k)


def test_perceptual_term_changes_the_gradient(runs):
    (_, w0, _, s0), (_, w1, _, s1) = runs["none"], runs["perceptual"]
    for a, b in ((w0, w1), (s0, s1)):
        moved = sum(int((a[k] != b[k]).sum()) for k in ("gen.out.weight", "coarse.out.weight"))
        assert moved > 100, moved
