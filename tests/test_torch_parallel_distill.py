"""Data-parallel distillation on the CPU.

- One ``DistillTrainer`` step per bicubic path (a fixed low, a low per
  batch with ``kd_normalize``, a low per image) on (2, 1): crfr's on two of
  tests/conftest.py's fake CPU devices, the port's as two gloo ranks
  (tests/_torch_rank_worker.py, no JAX), both from crfr's student and a
  teacher at init, with crfr's lows: the tiny config of
  tests/test_torch_distill.py (lr 2e-3, λ = 1e-3). Loss, CE and KD within
  1e-4 relative, the student within rtol 2e-4 / atol 2e-5. After the
  per-image step ``student_embed_fn`` with and without the residual, split
  over the ranks or on each rank's local snapshot, equals crfr's and is
  the same on every rank.
"""


import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np

import jax

from crfr.parallel.mesh import make_mesh as ref_make_mesh
from crfr.train.distill_loop import DistillTrainer as RefDistill
from crfr.train.distill_loop import teacher_from_trainer as ref_teacher_from_trainer
from crfr.train.loop import Trainer as RefTrainer
from crfr_torch.models.convert import student_state_from_jax, train_state_from_jax
from tests._torch_rank_worker import run_ranks
from tests.test_torch_distill import PATHS, TOL, batches, kd_lows, student_flat, tiny_cfg
from tests.test_torch_train import ref_flat


def test_one_distill_step_per_path_matches_crfr(tmp_path):
    devs = jax.devices()[:2]
    teacher_cfg = tiny_cfg(**{"loss.distill_weight": 0.0, "mesh.data": 2})
    ref_t = RefTrainer(teacher_cfg, mesh=ref_make_mesh(teacher_cfg.mesh, devs),
                       steps_per_epoch=100)
    teacher = {k[len("backbone."):]: v for k, v in train_state_from_jax(ref_flat(ref_t)).items()
               if k.startswith("backbone.")}
    imgs, labels = batches(1)[0]
    paths, refs = [], {}
    for name, (ov, kw) in PATHS.items():
        cfg = tiny_cfg(**ov, **{"mesh.data": 2})
        ref = RefDistill(cfg, ref_teacher_from_trainer(ref_t),
                         mesh=ref_make_mesh(cfg.mesh, devs), steps_per_epoch=100, **kw)
        refs[name] = (cfg, ref)
        paths.append((name, cfg.to_dict(), student_state_from_jax(student_flat(ref.state)),
                      kd_lows(cfg, 0), kw))
    x = np.random.default_rng(6).integers(0, 256, (16, 32, 32, 3)).astype(np.float32)
    inp = {"paths": paths, "teacher": teacher, "batch": (imgs, labels),
           "embed_path": "low_per_image", "embed_images": x}

    def ref_steps():
        return {name: {k: float(v) for k, v in ref.train_step(imgs, labels).items()}
                for name, (_, ref) in refs.items()}

    ranks, want_metrics = run_ranks("distill", 2, inp, tmp_path / "kd", timeout=150,
                                    wait=ref_steps)
    for name, (_, ref) in refs.items():
        want = student_state_from_jax(student_flat(ref.state))
        for out in ranks:
            got = out[name]
            for k in ("loss", "ce", "kd"):
                assert abs(got["metrics"][k] - want_metrics[name][k]) <= \
                    1e-4 * abs(want_metrics[name][k]), (name, k, got["metrics"], want_metrics)
            for k, v in want.items():
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), **TOL,
                                           err_msg=f"{name}: {k}")
    _, ref = refs["low_per_image"]
    for res in (False, True):
        want = np.asarray(ref.student_embed_fn(res)(x))
        for out in ranks:
            for snap in (False, True):
                got = out["embed"][f"{res}_{snap}"].numpy()
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
                np.testing.assert_array_equal(got, ranks[0]["embed"][f"{res}_{snap}"].numpy())
