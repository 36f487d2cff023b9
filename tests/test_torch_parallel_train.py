"""Data-parallel and class-sharded training against crfr on the CPU.

crfr's ``Trainer`` runs in this process on a (2, 2) and a (4, 1) mesh over
four of tests/conftest.py's fake CPU devices; the port's runs as four gloo
ranks (tests/_torch_rank_worker.py, no JAX) while crfr computes. The tiny
config of tests/test_torch_train.py (ir_18 at 32 px, float32, dropout 0,
batch 16, warmup 5, weight decay 5e-4, 4 classes: with 5 or more this
tiny problem is so badly conditioned by step 3 that runs part by more than
the tolerance, as that file says); the port starts from crfr's weights
(``train_state_from_jax``, each rank taking its class shard of W) and
takes crfr's lows. Three steps: loss and
gradient norm per step within 1e-4 relative, parameters and BN statistics
within rtol 2e-4 / atol 2e-5 (tests/test_train.py's own). The same three
steps at four ranks must also equal the port at one rank. A 2×2 run with
5 classes (the head padded to 6, the sixth masked) writes a checkpoint that
restores in a one-process trainer.
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax

from crfr.data.synthetic import SyntheticFaces
from crfr.parallel.mesh import make_mesh as ref_make_mesh
from crfr.train.loop import Trainer as RefTrainer
from crfr_torch.configs import Config as PortConfig
from crfr_torch.models.convert import train_state_from_jax
from crfr_torch.train.checkpoints import Checkpointer
from crfr_torch.train.loop import Trainer
from tests._torch_rank_worker import run_ranks
from tests.test_torch_train import ref_flat, ref_lows, tiny_cfg

TOL = dict(rtol=2e-4, atol=2e-5)
C = 4


def _cfg(data: int, model: int, c: int = C):
    return tiny_cfg(**{"mesh.data": data, "mesh.model": model, "data.num_classes": c})


def _batches(cfg, steps: int = 3):
    data = SyntheticFaces(num_classes=C, image_size=32, seed=0)
    return [(imgs, labels, ref_lows(cfg, step))
            for step, (imgs, labels) in enumerate(data.batches(16, steps, seed=1))]


def _assert_state(got: dict, want: dict, c: int | None = None):
    for k, v in want.items():
        g = got[k].numpy()
        v = v.numpy()
        if k == "head.weight" and c is not None:
            g, v = g[:, :c], v[:, :c]
        np.testing.assert_allclose(g, v, **TOL, err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """crfr's and the port's three steps on (2, 2) and (4, 1)."""
    out = {}
    for shape in ((2, 2), (4, 1)):
        cfg = _cfg(*shape)
        batches = _batches(cfg)
        ref = RefTrainer(cfg, mesh=ref_make_mesh(cfg.mesh, jax.devices()[:4]),
                         steps_per_epoch=100)
        start = train_state_from_jax(ref_flat(ref))

        def ref_steps(ref=ref, batches=batches):
            return [{k: float(v) for k, v in ref.train_step(i, lab).items()}
                    for i, lab, _ in batches]

        ranks, ref_metrics = run_ranks(
            "train", 4, {"cfg": cfg.to_dict(), "flat": ref_flat(ref), "batches": batches},
            tmp_path_factory.mktemp(f"train{shape}"), timeout=150, wait=ref_steps)
        out[shape] = (ref, ref_metrics, ranks, start, batches)
    return out


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_three_steps_match_crfr_on_a_mesh(runs, shape):
    ref, ref_metrics, ranks, _, _ = runs[shape]
    assert ranks[0]["ce_impl"] == ("sharded" if shape[1] > 1 else "dense")
    assert ranks[0]["w_local"] == (512, C // shape[1])
    want = train_state_from_jax(ref_flat(ref))
    for out in ranks:
        for mr, mp in zip(ref_metrics, out["metrics"]):
            for k in ("loss", "grad_norm"):
                assert abs(mp[k] - mr[k]) <= 1e-4 * abs(mr[k]), (k, ref_metrics, out["metrics"])
        _assert_state(out["state"], want)
        assert out["metrics"] == ranks[0]["metrics"]


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_four_ranks_equal_one_rank(runs, shape):
    """The port at 4 ranks against the port at 1 rank on the same global
    batch and lows: the global BN statistics, the global-batch draws and
    the summed gradients make one step."""
    _, _, ranks, start, batches = runs[shape]
    cfg = PortConfig.from_dict(_cfg(1, 1).to_dict())
    one = Trainer(cfg, steps_per_epoch=100, device="cpu")
    st = one.state
    st["model"] = dict(start, **{"head.weight": start["head.weight"][:, :C]})
    one.state = st
    metrics = [{k: float(v) for k, v in one.train_step(i, lab, lows=lows).items()}
               for i, lab, lows in batches]
    for m1, m4 in zip(metrics, ranks[0]["metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(m4[k] - m1[k]) <= 1e-5 * abs(m1[k]), (k, metrics, ranks[0]["metrics"])
    _assert_state(ranks[0]["state"], one.model.state_dict(), c=C)


def test_ms1m_preset_mesh_needs_eight_ranks(tmp_path):
    """``ms1m_ijbc``'s 4×2 mesh (85,742 classes, the head class-sharded in
    two) raises in one process, as crfr's make_mesh does on one device,
    and takes a step on 8 ranks (cut to IR-18 at 32 px, batch 16)."""
    from crfr_torch.configs import get_config

    with pytest.raises(ValueError, match="mesh 4x2 needs 8 devices, have 1"):
        Trainer(get_config("ms1m_ijbc"), device="cpu")
    ov = ["model.backbone=ir_18", "data.image_size=32", "model.input_size=32",
          "data.degrade_max=32", "train.batch_size=16", "model.compute_dtype=float32"]
    outs = run_ranks("preset", 8, {"preset": "ms1m_ijbc", "ov": ov}, tmp_path, timeout=150)
    for out in outs:
        assert out["mesh"] == (4, 2) and out["ce"] == "sharded"
        assert out["w_local"] == (512, 85742 // 2) and np.isfinite(out["loss"])
        assert out["loss"] == outs[0]["loss"]


def test_checkpoint_from_2x2_restores_on_1x1(tmp_path):
    """Rank 0 writes one checkpoint with W and its momentum whole (6 padded
    classes); a one-process trainer (5 classes) restores it and embeds as
    the 2×2 run did, and takes the next step from it."""
    cfg = _cfg(2, 2, 5)
    data = SyntheticFaces(num_classes=5, image_size=32, seed=0)
    batches = list(data.batches(16, 2, seed=1))
    probe = batches[0][0][:8]
    ck_dir = str(tmp_path / "ck")
    ranks = run_ranks("train_ckpt", 4, {"cfg": cfg.to_dict(), "batches": batches,
                                        "dir": ck_dir, "probe": probe},
                      tmp_path / "ranks", timeout=150)
    assert [r["written"] for r in ranks] == [True, True, True, True]
    ck = Checkpointer(ck_dir)
    assert ck.steps() == [2]
    saved = ck.restore()
    assert tuple(saved["model"]["head.weight"].shape) == (512, 6)
    mom = [s["momentum_buffer"] for s in saved["opt"]["state"].values()
           if tuple(s["momentum_buffer"].shape) == (512, 6)]
    assert len(mom) == 1 and float(mom[0][:, :5].abs().sum()) > 0
    one = Trainer(PortConfig.from_dict(_cfg(1, 1, 5).to_dict()), steps_per_epoch=100,
                  device="cpu")
    one.state = saved
    assert one.host_step == 2 and tuple(one.model.head.weight.shape) == (512, 5)
    np.testing.assert_array_equal(one.model.head.weight.detach().numpy(),
                                  ranks[0]["state"]["head.weight"][:, :5].numpy())
    for out in ranks:
        np.testing.assert_allclose(one.embed_fn()(probe).numpy(), out["emb"].numpy(),
                                   rtol=1e-5, atol=1e-5)
    # and back: the one-process state restores on the mesh's padding rule
    st = one.state
    assert tuple(st["model"]["head.weight"].shape) == (512, 5)
    one.train_step(*batches[1])
