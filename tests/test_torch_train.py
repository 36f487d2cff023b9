"""crfr_torch.train.loop against crfr.train.loop on the CPU: the tiny config
of tests/test_train.py (ir_18 at 32 px, float32, dropout 0, 4 classes,
batch 16, warmup 5, weight decay 5e-4) on a one-device mesh, the port's
trainer started from the crfr trainer's weights (``train_state_from_jax``)
and given crfr's per-image lows for each step. Three steps on each side:
loss and gradient norm per step within 1e-4 relative; parameters and BN
statistics after them within rtol 2e-4 / atol 2e-5 (the reference's own
tolerance, tests/test_train.py:188-190)."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax
from flax import nnx

from crfr.configs import Config, DataCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr.data.synthetic import SyntheticFaces
from crfr.train.loop import Trainer as RefTrainer
from crfr_torch.configs import Config as PortConfig
from crfr_torch.models.convert import train_state_from_jax
from crfr_torch.train.loop import Trainer

TOL = dict(rtol=2e-4, atol=2e-5)


def tiny_cfg(**overrides) -> Config:
    cfg = Config(
        name="tiny-test", mesh=MeshCfg(data=1, model=1),
        data=DataCfg(image_size=32, num_classes=4, degrade_min=16, degrade_max=32),
        model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0, input_size=32),
        loss=LossCfg(scale=16.0, margin=0.2),
        train=TrainCfg(batch_size=16, lr=0.05, warmup_steps=5, weight_decay=5e-4,
                       log_every=10, seed=0))
    return cfg.override(**overrides) if overrides else cfg


def ref_flat(tr: RefTrainer) -> dict:
    flat = {}
    for st in (tr.state["params"], tr.state["batch_stats"]):
        for path, var in st.flat_state():
            flat["/".join(map(str, path))] = np.asarray(var[...])
    return flat


def ref_lows(cfg: Config, step: int) -> np.ndarray:
    """The lows crfr's step ``step`` draws (crfr/train/loop.py:254-270)."""
    dc = cfg.data
    n = min(dc.degrade_max, dc.image_size) - dc.degrade_min + 1
    key = jax.random.fold_in(jax.random.key(cfg.train.seed), step)
    idx = np.asarray(jax.random.randint(key, (cfg.train.batch_size,), 0, n))
    return (dc.degrade_min + idx).astype(np.int32)


def port_steps(cfg: Config, start: dict, steps: int = 3):
    """The port's trainer from ``start`` for ``steps`` steps of tiny data
    with crfr's lows; → (trainer, per-step metrics)."""
    port = Trainer(PortConfig.from_dict(cfg.to_dict()), steps_per_epoch=100, device="cpu")
    port.model.load_state_dict(start)
    data = SyntheticFaces(num_classes=cfg.data.num_classes, image_size=32, seed=0)
    metrics = []
    for step, (imgs, labels) in enumerate(data.batches(16, steps, seed=1)):
        m = port.train_step(imgs, labels, lows=torch.from_numpy(ref_lows(cfg, step)))
        metrics.append({k: float(v) for k, v in m.items()})
    return port, metrics


def twin_run(cfg: Config, steps: int = 3):
    """``steps`` steps of each trainer from the same weights and lows."""
    ref = RefTrainer(cfg, steps_per_epoch=100)
    start = train_state_from_jax(ref_flat(ref))
    data = SyntheticFaces(num_classes=cfg.data.num_classes, image_size=32, seed=0)
    ref_metrics = [{k: float(v) for k, v in ref.train_step(imgs, labels).items()}
                   for imgs, labels in data.batches(16, steps, seed=1)]
    port, port_metrics = port_steps(cfg, start, steps)
    return ref, port, list(zip(ref_metrics, port_metrics)), start


@pytest.fixture(scope="module")
def dense_run():
    return twin_run(tiny_cfg())


@pytest.mark.parametrize("case", ["dense", "streaming", "clipped"])
def test_three_steps_match_crfr(case, dense_run):
    """Loss and gradient norm per step, then every parameter and BN
    statistic; streaming in class blocks of 3 (a whole block and a ragged
    one of 1), and a global-norm clip below the gradient norms so that
    every step clips. (With 6 to 8 classes this tiny problem is so badly
    conditioned by step 3 that the port's own dense and streaming runs part
    by more than the tolerance, and so do crfr's.)"""
    if case == "dense":
        ref, port, metrics, _ = dense_run
    elif case == "streaming":
        ref, port, metrics, _ = twin_run(tiny_cfg(**{"loss.ce_impl": "streaming",
                                                     "loss.ce_block": 3}))
        assert port._ce_impl == "streaming"
    else:
        ref, port, metrics, _ = twin_run(tiny_cfg(**{"train.grad_clip_norm": 5.0}))
    for mr, mp in metrics:
        for k in ("loss", "grad_norm"):
            assert abs(mp[k] - mr[k]) <= 1e-4 * abs(mr[k]), (k, metrics)
    if case == "clipped":
        assert all(mr["grad_norm"] > 5.0 for mr, _ in metrics)
    want = train_state_from_jax(ref_flat(ref))
    got = port.model.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL, err_msg=k)


def test_bn1d_running_variance_is_biased(dense_run, monkeypatch):
    """out_feat_bn's running variance follows flax's biased update. The same
    three steps with torch's own BatchNorm1d (the unbiased batch variance,
    16/15 of the batch term at B=16) land outside the tolerance."""
    from crfr_torch.models import irse

    ref, port, _, start = dense_run
    key = "backbone.out_feat_bn.running_var"
    want = train_state_from_jax(ref_flat(ref))[key].numpy()
    np.testing.assert_allclose(port.model.state_dict()[key].numpy(), want, **TOL)
    monkeypatch.setattr(irse.BatchNorm1d, "forward", torch.nn.BatchNorm1d.forward)
    unbiased, _ = port_steps(tiny_cfg(), start)
    got = unbiased.model.state_dict()[key].numpy()
    # the same parameters (running statistics do not feed a train step), so
    # the two differ by the unbiased terms alone: larger in every channel
    assert (got > want).all() and not np.allclose(got, want, **TOL)


def test_first_warmup_step_fills_momentum_only(dense_run):
    """With warmup the schedule is 0 at step 0: the step leaves the
    parameters where they were and fills the momentum (optax evaluates the
    schedule at the count before the update)."""
    cfg = PortConfig.from_dict(tiny_cfg().to_dict())
    tr = Trainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in tr.model.named_parameters()}
    imgs, labels = next(SyntheticFaces(num_classes=4, image_size=32, seed=0).batches(16, 1))
    tr.train_step(imgs, labels)
    assert tr.schedule(0) == 0.0 and tr.host_step == 1
    for k, v in tr.model.named_parameters():
        assert torch.equal(v, before[k]), k
    bufs = [s["momentum_buffer"] for s in tr.tx.opt.state.values()]
    assert len(bufs) == len(before) and all(b.abs().sum() > 0 for b in bufs[:3])


def test_remat_step_matches_plain():
    """model.remat (each residual block recomputed on the backward pass)
    gives the same step, and moves the BN statistics once."""
    data = SyntheticFaces(num_classes=4, image_size=32, seed=0)
    imgs, labels = data.sample(np.random.default_rng(3), 16)
    lows = torch.full((16,), 20, dtype=torch.int32)
    states = []
    for remat in (False, True):
        cfg = PortConfig.from_dict(tiny_cfg(**{"model.remat": remat}).to_dict())
        tr = Trainer(cfg, device="cpu")
        loss = float(tr.train_step(imgs, labels, lows=lows)["loss"])
        states.append((loss, tr.model.state_dict()))
    (l0, s0), (l1, s1) = states
    assert abs(l0 - l1) <= 1e-5 * max(1.0, abs(l0))
    for k, v in s0.items():
        np.testing.assert_allclose(s1[k].numpy(), v.numpy(), **TOL, err_msg=k)


def test_trainer_refuses_what_is_not_ported():
    """A mesh larger than the process group (one process: no group) raises
    as crfr's make_mesh does, and the class-sharded CE needs mesh.model > 1
    (as crfr asserts); training on a mesh is held against crfr in
    tests/test_torch_parallel_train.py."""
    cfg = PortConfig.from_dict(tiny_cfg().to_dict())
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        Trainer(cfg.override(**{"mesh.data": 2}), device="cpu")
    with pytest.raises(ValueError, match="needs mesh.model > 1"):
        Trainer(cfg.override(**{"loss.ce_impl": "sharded"}), device="cpu")


@pytest.mark.parametrize("bad", [15, 33])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_train_step_refuses_host_lows_outside_the_range(bad, as_tensor):
    """Lows from the host outside [degrade_min, degrade_max] raise before
    the step, as numpy and as CPU tensors, and the step count stays."""
    cfg = PortConfig.from_dict(tiny_cfg().to_dict())
    tr = Trainer(cfg, device="cpu")
    imgs, labels = SyntheticFaces(num_classes=4, image_size=32, seed=0).sample(
        np.random.default_rng(0), 16)
    lows = np.full(16, 20, np.int32)
    lows[5] = bad
    with pytest.raises(ValueError, match="lows outside 16..32"):
        tr.train_step(imgs, labels, lows=torch.from_numpy(lows) if as_tensor else lows)
    assert tr.host_step == 0


def test_no_silent_cpu(monkeypatch):
    """With no device named, the trainer wants CUDA and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(PortConfig.from_dict(tiny_cfg().to_dict()))


def test_port_imports_none_of_the_jax_stack():
    """The trainer's modules import neither JAX nor crfr, nor grain, optax,
    orbax or array_record."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import crfr_torch.cli, crfr_torch.train.loop, crfr_torch.train.checkpoints\n"
            "import crfr_torch.train.feed, crfr_torch.data.pipeline, crfr_torch.data.records\n"
            "import crfr_torch.bench.throughput, crfr_torch.bench.xprof_check\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'flax', 'crfr', 'grain', 'optax', 'orbax', 'array_record'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_train_trace_groups():
    """The train trace's kernel groups; the trace itself needs the card."""
    from crfr_torch.bench import xprof_check as xc

    g = xc._TRAIN_GROUPS
    assert xc._group("void degrade_lows_kernel<unsigned char, __nv_bfloat16>", g) == "preprocess"
    assert xc._group("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16", g) == "conv_backward"
    assert xc._group("sm90_xmma_dgrad_implicit_gemm_bf16bf16", g) == "conv_backward"
    assert xc._group("sm90_xmma_fprop_implicit_gemm_bf16bf16", g) == "conv_forward"
    assert xc._group("void at::native::batch_norm_backward_reduce_channels_last_kernel", g) \
        == "batch_norm"
    assert xc._group("unrolled_elementwise_kernel_for_multi_outputs<2, prelu_backward", g) \
        == "prelu"
    assert xc._group("void at::native::multi_tensor_apply_kernel<", g) == "optimizer"
    assert xc._group("void at::native::reduce_kernel<128, 4, ReduceOp<BFloat16>", g) == "reduce"
    assert xc._group("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", g) == "head_gemm"
    assert xc._group("ampere_sgemm_128x64_nn", g) == "head_gemm"
    with pytest.raises(ValueError, match="CUDA device"):
        xc.trace_train(device="cpu")
