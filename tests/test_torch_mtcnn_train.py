"""crfr_torch.train.mtcnn_train against crfr.train.mtcnn_train on the CPU.

The renderer and the sampler draw the same arrays from the same generator
(crops within 2e-5 in normalized units: the port's float32 resize against
crfr's float64 one, as in test_torch_mtcnn.py; targets equal). Three steps
of each net from crfr's state on the same batches: losses within 1e-4
relative, parameters within rtol 2e-4 / atol 2e-5 (crfr's own trainer
tolerance), but for Adam's sign flips: an update whose gradient sits near 0
moves by ±lr in one stack and ∓lr in the other, so each such element is
bounded by 2·lr·steps and they are counted (the SR trainer's rule,
test_torch_sr_train.py). ``train_mtcnn_synthetic`` from crfr's weights with
the same seed: the same final losses and weights by the same rules.
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax
from flax import nnx

from crfr.models import mtcnn as rm
from crfr.train import mtcnn_train as rt
from crfr_torch.models import mtcnn as pm
from crfr_torch.models.convert import mtcnn_state_from_jax, params_from_jax
from crfr_torch.train import mtcnn_train as pt
from tests.test_torch_align import crfr_native  # noqa: F401 (fixture)
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)

LR, STEPS = 2e-3, 3
TOL = dict(rtol=2e-4, atol=2e-5)


def net_flat(net) -> dict:
    return {"/".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.state(net, nnx.Param).flat_state()}


def assert_params_match(want: dict, got: dict, lr: float, steps: int) -> int:
    """Within TOL but for Adam's sign flips (≤ 2·lr·steps each, < 1e-3 of
    the elements); returns the number of flips."""
    flips = total = 0
    for k, w in want.items():
        g = got[k].numpy()
        w = w.numpy()
        total += w.size
        out = np.abs(g - w) > TOL["atol"] + TOL["rtol"] * np.abs(w)
        if out.any():
            assert np.abs(g - w)[out].max() <= 2 * lr * steps, k
            flips += int(out.sum())
    assert flips < 1e-3 * total, (flips, total)
    return flips


def test_renderer_equals_crfrs():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        fa, la = rt.render_face(a, 57)
        fb, lb = pt.render_face(b, 57)
        assert np.array_equal(fa, fb) and np.array_equal(la, lb)
        assert np.array_equal(rt._smooth_background(a, 90), pt._smooth_background(b, 90))
        sa, sb = rt.render_scene(a, 160), pt.render_scene(b, 160)
        assert np.array_equal(sa.image, sb.image) and sa.image.dtype == sb.image.dtype
        assert np.array_equal(sa.box, sb.box) and np.array_equal(sa.landmarks, sb.landmarks)
        assert rt.iou(sa.box, sa.box + 7) == pt.iou(sb.box, sb.box + 7)
        assert a.random() == b.random()


@pytest.mark.parametrize("size,n_pos,n_neg", [(12, 3, 3), (24, 4, 2), (48, 3, 3)])
def test_sampler_equals_crfrs(size, n_pos, n_neg, crfr_native):
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        sa, sb = rt.render_scene(a), pt.render_scene(b)
        want = rt.sample_crops(a, sa, size, n_pos, n_neg)
        got = pt.sample_crops(b, sb, size, n_pos, n_neg, device="cpu")
        assert got[0].shape == (n_pos + n_neg, size, size, 3)
        np.testing.assert_allclose(got[0].numpy(), (want[0] - 127.5) / 128.0, rtol=0, atol=2e-5)
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert a.random() == b.random()


def _batches(size: int, steps: int):
    rng = np.random.default_rng(1)
    scenes = [rt.render_scene(rng) for _ in range(4)]
    for _ in range(steps):
        bs = [rt.sample_crops(rng, sc, size, 3, 3) for sc in scenes]
        yield tuple(np.concatenate([b[i] for b in bs]) for i in range(4))


@pytest.mark.parametrize("net,size", [("pnet", 12), ("rnet", 24), ("onet", 48)])
def test_three_steps_match_crfr(net, size):
    ref = rm.MTCNN(seed=0)
    jnet = getattr(ref, net)
    tnet = {"pnet": pm.PNet, "rnet": pm.RNet, "onet": pm.ONet}[net]()
    tnet.load_state_dict(params_from_jax(net_flat(jnet)))
    with_lmk = net == "onet"
    tx = optax.adam(LR)
    graph, state = nnx.split(jnet)
    opt_state = tx.init(nnx.state(jnet, nnx.Param))
    jstep = rt._make_step(graph, tx, with_lmk=with_lmk)
    pstep = pt.make_step(tnet, LR, with_lmk=with_lmk)
    for xs, cl, rg, lm in _batches(size, STEPS):
        state, opt_state, lj = jstep(state, opt_state, rt._norm(xs), jnp.asarray(cl),
                                     jnp.asarray(rg), jnp.asarray(lm))
        lp = pstep(torch.from_numpy((xs - 127.5) * (1.0 / 128.0)).float(), cl, rg, lm)
        assert abs(float(lp) - float(lj)) <= 1e-4 * abs(float(lj)), (float(lp), float(lj))
    nnx.update(jnet, state)
    assert_params_match(params_from_jax(net_flat(jnet)), tnet.state_dict(), LR, STEPS)


def test_loss_masks_negatives():
    out = (torch.tensor([0.9, 0.2]), torch.tensor([[0.1, 0, 0, 0], [5.0, 5, 5, 5]]),
           torch.tensor([[0.0] * 10, [9.0] * 10]))
    cls = torch.tensor([1.0, 0.0])
    reg = torch.zeros(2, 4)
    lmk = torch.zeros(2, 10)
    ce = -(np.log(0.9 + 1e-6) + np.log(0.8 + 1e-6)) / 2
    assert float(pt.mtcnn_loss(out[:2], cls, reg)) == pytest.approx(ce + 0.5 * 0.01, rel=1e-6)
    assert float(pt.mtcnn_loss(out, cls, reg, lmk)) == pytest.approx(ce + 0.5 * 0.01, rel=1e-6)


def test_train_synthetic_matches_crfr(crfr_native):
    """Two steps of the whole loop (two scenes a step) from crfr's weights
    with the same seed: the same last losses, the same weights."""
    ref = rm.MTCNN(min_face=40, seed=0)
    port = pm.MTCNN(min_face=40, seed=9, device="cpu")
    flat = {f"{n}/{k}": v for n in ("pnet", "rnet", "onet")
            for k, v in net_flat(getattr(ref, n)).items()}
    port.load_state_dict(mtcnn_state_from_jax(flat))
    want = rt.train_mtcnn_synthetic(ref, steps=2, batch_scenes=2, seed=4)
    got = pt.train_mtcnn_synthetic(port, steps=2, batch_scenes=2, seed=4)
    assert set(got) == set(want) == {"p_loss", "r_loss", "o_loss"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    flat = {f"{n}/{k}": v for n in ("pnet", "rnet", "onet")
            for k, v in net_flat(getattr(ref, n)).items()}
    assert_params_match(mtcnn_state_from_jax(flat), port.state_dict(), 2e-3, 2)
    assert not port.training
