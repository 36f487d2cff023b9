"""The reference against ``crfr_torch`` on the CPU at a tiny size, with the
same weights: the bicubic operators, the degrade, the backbone in both
modes, the blocked ArcFace CE and its gradient, and whole train steps."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.inputs import make_pool, make_weights
from benchmark.reference import arcface, bicubic, irse
from benchmark.reference.train import embed, train_steps

from _cells import float32, of

CFG = {"backbone": "ir_18", "embedding_dim": 512, "input_size": 32, "num_classes": 50}


def _program_model(cfg=CFG, seed=0):
    from crfr_torch.configs import Config, DataCfg, ModelCfg
    from crfr_torch.train.loop import FaceTrainModel

    c = Config(model=ModelCfg(backbone=cfg["backbone"], input_size=cfg["input_size"]),
               data=DataCfg(num_classes=cfg["num_classes"], image_size=cfg["input_size"]))
    return FaceTrainModel(c, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("mode", ["pil", "cv2"])
@pytest.mark.parametrize("size,low", [(112, 16), (112, 8), (112, 112), (32, 15)])
def test_operators_equal_the_program(mode, size, low):
    from crfr_torch.ops.bicubic import degrade_matrix, resize_matrix

    assert np.array_equal(bicubic.resize_matrix(size, low, mode), resize_matrix(size, low, mode))
    assert np.array_equal(bicubic.degrade_matrix(size, low, mode),
                          degrade_matrix(size, low, mode))


def test_degrade_equals_the_program_per_image_and_fixed():
    from crfr_torch.ops.fused_preprocess import fused_degrade_normalize

    x = make_pool(3, 1, 6, 32, "cpu")["images"][0]
    lows = np.array([8, 9, 16, 31, 32, 8], dtype=np.int32)
    got = bicubic.degrade_normalize(x, lows, "pil")
    want = fused_degrade_normalize(x, torch.from_numpy(lows), "pil", torch.float32, lows=(8, 32))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got = bicubic.degrade_normalize(x, 16, "cv2")
    want = fused_degrade_normalize(x, 16, "cv2", torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_specs_name_every_parameter_of_the_program():
    model = _program_model()
    specs = irse.param_specs(CFG["backbone"], 512, 32, CFG["num_classes"])
    assert [(n, tuple(s)) for n, s, _ in specs] == \
        [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def _loaded(cfg=CFG, seed=5):
    params, stats = make_weights(cfg, seed, "cpu")
    model = _program_model(cfg)
    sd = model.state_dict()
    sd.update(params)
    sd.update(stats)
    model.load_state_dict(sd)
    return model, params, stats


def test_backbone_eval_equals_the_program():
    model, params, stats = _loaded()
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.backbone.eval()(x)
    got = irse.backbone_forward(params, x, CFG["backbone"], stats=stats)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_backbone_train_with_dropout_equals_the_program():
    from benchmark.reference.train import dropout_keep

    model, params, _ = _loaded()
    x = torch.randn(6, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    keep = dropout_keep(9, 4, (6, 512, 2, 2), 0.4, torch.device("cpu"))
    gen = torch.Generator().manual_seed(((9 % (1 << 32)) << 32) | 4)
    want = model.backbone.train()(x, generator=gen)
    got = irse.backbone_forward(params, x, CFG["backbone"], keep=keep, drop=0.4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    remat = irse.backbone_forward(params, x, CFG["backbone"], keep=keep, drop=0.4, remat=True)
    torch.testing.assert_close(remat, got)


@pytest.mark.parametrize("block", [7, 16, 64])
def test_blocked_ce_and_gradient_equal_the_program(block):
    from crfr_torch.losses.arcface import MarginHead

    g = torch.Generator().manual_seed(3)
    emb = torch.randn(9, 16, generator=g, requires_grad=True)
    head = MarginHead(16, 40, generator=g)
    labels = torch.randint(0, 40, (9,), generator=g)
    want = head.loss(emb, labels)
    w = head.weight.detach().clone().requires_grad_(True)
    got = arcface.arcface_ce(emb, w, labels, s=64.0, m=0.5, block=block)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    gw, ge = torch.autograd.grad(want, (head.weight, emb))
    rw, re = torch.autograd.grad(got, (w, emb))
    torch.testing.assert_close(rw, gw, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(re, ge, rtol=1e-4, atol=1e-6)


def test_embed_equals_the_serving_function_in_float32():
    from crfr_torch.serve import build_serving_fn

    model, params, stats = _loaded()
    bb = model.backbone.eval()
    fn = build_serving_fn(lambda x: bb(x), degrade_to=8, image_size=32, device="cpu")
    x = make_pool(4, 1, 5, 32, "cpu")["images"][0]
    cfg = dict(CFG, resize_mode="pil")
    torch.testing.assert_close(embed(params, stats, x, 8, cfg, block=2), fn(x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workload", of("train"))
def test_three_train_steps_equal_the_trainer_in_float32(tiny_root, workload):
    """The harness's train driver with the program in float32: every gap at
    rounding (the same run the chip makes, at a CPU's size)."""
    from benchmark.drivers.train import Driver
    from benchmark.harness import load_cell

    rt = type("Rt", (), {"device": torch.device("cpu"), "rank": 0, "world": 1})()
    d = Driver(load_cell(float32(tiny_root), workload), 2 ** 31 + 7, rt, None)
    readings, attempted, failed = d.check(3, 0)
    assert d.detail["loss_gap"] < 1e-5
    assert readings["grad_gap"] < 1e-4 and readings["grad_diff_median"] < 1e-4
    assert readings["change_gap"] < 1e-3 and readings["change_diff_median"] < 1e-3
    assert failed == 0


def test_share_of_rows_is_a_share_of_the_mean():
    params, _ = make_weights(CFG, 1, "cpu")
    pool = make_pool(1, 1, 8, 32, "cpu", classes=CFG["num_classes"], lows=(8, 32))
    batches = [(pool["images"][0], pool["labels"][0], pool["lows"][0].numpy())]
    cfg = {"backbone": "ir_18", "input_size": 32, "dropout": 0.0, "scale": 64.0,
           "margin": 0.5, "ce_block": 16, "lr": 0.1, "warmup_steps": 1000, "momentum": 0.9,
           "weight_decay": 5e-4, "resize_mode": "pil"}
    half = train_steps(params, batches, cfg, 3, rows=slice(0, 4))
    share = train_steps(params, batches, cfg, 3, rows=slice(0, 4), share=True)
    assert share["losses"][0] == pytest.approx(half["losses"][0] / 2, rel=1e-6)
