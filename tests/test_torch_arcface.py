"""crfr_torch.losses.arcface and the trainer's optimizer pieces against crfr
on the CPU: the margin families at 1e-6, dense and streaming CE and their
gradients against ``jax.grad``, the learning-rate schedules over steps
0..3000, and the weight-decay mask."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from crfr.configs import Config as RefConfig
from crfr.configs import TrainCfg
from crfr.losses import arcface as ref
from crfr.train.loop import lr_schedule as ref_lr_schedule
from crfr_torch.configs import Config
from crfr_torch.losses import arcface as port
from crfr_torch.train.loop import FaceTrainModel, _wd_mask, lr_schedule

FAMILIES = [("arcface", 0.5, False), ("arcface", 0.5, True), ("cosface", 0.35, False),
            ("sphereface", 4.0, False), ("normsoftmax", 0.0, False), ("arcface", 0.0, False)]


def _inputs(seed=0, b=12, d=16, c=10):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (b, d)).astype(np.float32)
    w = rng.normal(0, 1, (d, c)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    return emb, w, labels


@pytest.mark.parametrize("margin_type,m,easy", FAMILIES)
def test_apply_margin_matches_crfr(margin_type, m, easy):
    """Cosines over [-1, 1] with the ends, the θ+m>π fallback region and
    points on both sides of 0 (easy margin)."""
    cos = np.concatenate([np.linspace(-1, 1, 401), [-0.999, 0.999, math.cos(math.pi - m)]])
    cos = cos.astype(np.float32).reshape(-1, 1).repeat(2, 1)
    tgt = np.zeros(cos.shape, bool)
    tgt[:, 0] = True
    want = ref._apply_margin(jnp.asarray(cos), jnp.asarray(tgt), margin_type=margin_type, m=m,
                             easy_margin=easy)
    got = port._apply_margin(torch.from_numpy(cos), torch.from_numpy(tgt),
                             margin_type=margin_type, m=m, easy_margin=easy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy()[:, 1], cos[:, 1])      # non-targets untouched


def test_unknown_margin_raises():
    with pytest.raises(ValueError, match="unknown margin_type"):
        port._apply_margin(torch.zeros(1, 1), torch.ones(1, 1, dtype=torch.bool),
                           margin_type="bogus", m=0.5, easy_margin=False)


@pytest.mark.parametrize("num_valid", [None, 7])
@pytest.mark.parametrize("margin_type,m,easy", FAMILIES[:4])
def test_margin_logits_and_ce_match_crfr(margin_type, m, easy, num_valid):
    emb, w, labels = _inputs()
    labels = labels % 7
    kw = dict(margin_type=margin_type, s=32.0, m=m, easy_margin=easy, num_valid=num_valid)
    want = np.asarray(ref.margin_logits(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels),
                                        **kw))
    got = port.margin_logits(torch.from_numpy(emb), torch.from_numpy(w),
                             torch.from_numpy(labels), **kw).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin] / 32.0, want[fin] / 32.0, atol=1e-6, rtol=0)
    ce_want = float(ref.softmax_ce(jnp.asarray(want), jnp.asarray(labels)))
    ce_got = float(port.softmax_ce(torch.from_numpy(got), torch.from_numpy(labels)))
    assert abs(ce_got - ce_want) <= 1e-5 * abs(ce_want)


@pytest.mark.parametrize("block,c,num_valid", [(4, 10, None), (3, 10, 8), (16, 10, None)])
def test_streaming_equals_dense_with_gradients(block, c, num_valid):
    """Streaming CE against the port's dense CE and crfr's streaming CE, and
    both gradients (embeddings and W) against ``jax.grad`` of crfr's."""
    emb, w, labels = _inputs(seed=block, c=c)
    labels = labels % (num_valid or c)
    kw = dict(margin_type="arcface", s=64.0, m=0.5, easy_margin=False, num_valid=num_valid)

    def jax_loss(e, ww):
        return ref.streaming_margin_ce(e, ww, jnp.asarray(labels), block=block, **kw)

    want, (ge, gw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(emb),
                                                                   jnp.asarray(w))
    results = []
    for streaming in (True, False):
        e = torch.from_numpy(emb).requires_grad_()
        ww = torch.from_numpy(w).requires_grad_()
        lab = torch.from_numpy(labels)
        if streaming:
            loss = port.streaming_margin_ce(e, ww, lab, block=block, **kw)
        else:
            loss = port.softmax_ce(port.margin_logits(e, ww, lab, **kw), lab)
        loss.backward()
        results.append((loss.item(), e.grad.numpy(), ww.grad.numpy()))
    for loss, g_e, g_w in results:
        assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
        np.testing.assert_allclose(g_e, np.asarray(ge), atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(g_w, np.asarray(gw), atol=1e-6, rtol=1e-4)


def test_margin_head_init_and_loss():
    head = port.MarginHead(16, 10, s=64.0, m=0.5, generator=torch.Generator().manual_seed(0))
    bound = math.sqrt(6.0 / 26)
    assert head.weight.shape == (16, 10) and head.weight.dtype == torch.float32
    assert head.weight.abs().max() <= bound and head.weight.abs().max() > 0.8 * bound
    emb, _, labels = _inputs()
    w = head.weight.detach().numpy()
    want = float(ref.softmax_ce(ref.margin_logits(jnp.asarray(emb), jnp.asarray(w),
                                                  jnp.asarray(labels)), jnp.asarray(labels)))
    got = head.loss(torch.from_numpy(emb), torch.from_numpy(labels)).item()
    assert abs(got - want) <= 1e-5 * want


def test_sharded_ce_is_not_ported(tmp_path):
    """The class-sharded CE, over a (1, 2) mesh of two gloo ranks, equals
    the port's dense margin CE and its gradients (each rank holds half of
    W's 10 columns; the padding class of 9 valid ones is masked)."""
    from tests._torch_rank_worker import run_ranks

    rng = np.random.default_rng(5)
    kw = dict(margin_type="arcface", s=16.0, m=0.3, easy_margin=False)
    case = {"shape": (1, 2), "emb": rng.normal(size=(6, 16)).astype(np.float32),
            "labels": rng.integers(0, 9, 6).astype(np.int64),
            "w": rng.normal(size=(16, 10)).astype(np.float32), "num_valid": 9, "kw": kw}
    outs = run_ranks("ce", 2, {"cases": [case]}, tmp_path, timeout=90)
    emb = torch.from_numpy(case["emb"]).requires_grad_(True)
    w = torch.from_numpy(case["w"]).requires_grad_(True)
    labels = torch.from_numpy(case["labels"])
    loss = port.softmax_ce(port.margin_logits(emb, w, labels, num_valid=9, **kw), labels)
    loss.backward()
    for out in outs:
        got = out["cases"][0]
        assert abs(float(got["loss"]) - loss.item()) <= 1e-5 * loss.item()
        np.testing.assert_allclose(got["g_emb"].numpy(), emb.grad.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["g_w"].numpy(), w.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule,warmup,drops", [
    ("step", 1000, (10, 18, 22)), ("step", 0, (1, 2)), ("step", 300, (0, 1)),
    ("cosine", 1000, (10,)), ("cosine", 0, (10,))])
def test_lr_schedule_matches_crfr(schedule, warmup, drops):
    """Over steps 0..3000 with 100 steps an epoch: warmup joins, drops
    shifted by the warmup (and collapsing onto step 1), cosine decay."""
    t = dict(epochs=24, lr=0.1, warmup_steps=warmup, schedule=schedule, lr_drop_epochs=drops,
             lr_drop_factor=0.1)
    ref_cfg = RefConfig(train=TrainCfg(**t))
    want = ref_lr_schedule(ref_cfg, 100)
    got = lr_schedule(Config.from_dict(ref_cfg.to_dict()), 100)
    steps = np.arange(3001)
    w = np.asarray(jax.vmap(want)(jnp.asarray(steps)), np.float64)
    g = np.asarray([got(int(k)) for k in steps])
    # optax computes in float32: one ulp at 0.1 is 7.5e-9
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8)
    assert got(0) == 0.0 if warmup else got(0) == 0.1


def test_wd_mask_is_conv_linear_and_head():
    """Decay covers exactly the conv and linear weights (SE included) and
    the head's W: not BN scale or bias, PReLU alpha or linear biases,
    though torch names several of them ``weight``."""
    cfg = Config().override(**{"model.backbone": "ir_se_18", "model.input_size": 32,
                               "data.num_classes": 5})
    model = FaceTrainModel(cfg, torch.Generator().manual_seed(0))
    mask = _wd_mask(model)
    decayed = {n for n, on in mask.items() if on}
    mods = dict(model.named_modules())
    want = {f"{n}.weight" for n, m in mods.items()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))} | {"head.weight"}
    assert decayed == want
    assert all(n.endswith("weight") for n in decayed)
    assert any("prelu" in n for n in mask) and not any("prelu" in n for n in decayed)
    assert not any("bn" in n for n in decayed)
    assert "backbone.blocks.0.se.fc1.weight" in decayed
    assert "backbone.out_linear.bias" in mask and "backbone.out_linear.bias" not in decayed
    # crfr's mask (by path component) on crfr's model, carried to torch names
    from flax import nnx

    from crfr.train.loop import FaceTrainModel as RefModel
    from crfr.train.loop import _wd_mask as ref_wd_mask
    from crfr_torch.models.convert import train_state_from_jax

    params = nnx.state(RefModel(RefConfig.from_dict(cfg.to_dict()), rngs=nnx.Rngs(0)),
                       nnx.Param)
    flat = {}
    for (path, var), (_, on) in zip(params.flat_state(), ref_wd_mask(params).flat_state()):
        flat["/".join(map(str, path))] = np.full(np.shape(var[...]), float(on.get_value()), np.float32)
    ref_decayed = {n for n, v in train_state_from_jax(flat).items() if v.numel() and v.all()}
    assert decayed == ref_decayed


def test_sgd_chain_matches_optax():
    """clip → masked decay → SGD with momentum, two updates, against optax's
    chain on the same gradients."""
    from crfr_torch.train.loop import SGDTx

    cfg = Config().override(**{"train.grad_clip_norm": 1.0, "train.weight_decay": 0.01,
                               "train.warmup_steps": 0})
    rng = np.random.default_rng(4)
    lin = torch.nn.Linear(6, 3)
    bn = torch.nn.BatchNorm1d(3)
    model = torch.nn.Sequential(lin, bn)
    params0 = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tx = SGDTx(cfg, model, lambda k: 0.1 * (k + 1))
    mask = _wd_mask(model)
    otx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.add_decayed_weights(0.01, mask=mask),
                      optax.sgd(lambda k: 0.1 * (k + 1), momentum=0.9))
    jp = {n: jnp.asarray(v) for n, v in params0.items()}
    state = otx.init(jp)
    for k in range(2):
        grads = {n: rng.normal(0, 2, v.shape).astype(np.float32) for n, v in params0.items()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        gnorm = float(tx.step(k))
        upd, state = otx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        assert abs(gnorm - float(optax.global_norm(grads))) <= 1e-6 * gnorm
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7)
