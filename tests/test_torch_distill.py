"""Residual knowledge distillation against crfr on the CPU.

- ``ResidualBranch`` in eval and train mode (output, and the running
  statistics after two train-mode calls) within 1e-5.
- ``feature_l2`` and ``residual_kd_loss``, values and gradients against
  ``jax.grad``, with ``normalize`` on and off, within 1e-5 relative.
- ``Trainer.set_teacher``: three steps of crfr's ``Trainer`` with a teacher
  against the port's.
- ``DistillTrainer`` on the bicubic path, three steps for each of a fixed
  low, a low per batch (with ``kd_normalize``) and a low per image, against crfr's
  ``DistillTrainer`` on a one-device mesh: the tiny config of
  tests/test_torch_train.py (ir_18 at 32 px, float32, dropout 0, 4
  classes, batch 16, weight decay 5e-4) at lr 2e-3 without warmup and
  λ = 1e-3 (the KD term near the CE's size against a teacher at init);
  the student carried across with ``student_state_from_jax``, the teacher
  a crfr ``Trainer`` at init carried across with ``train_state_from_jax``,
  crfr's lows passed in. Loss, CE and KD per step within 1e-4 relative;
  parameters and BN statistics after each step within rtol 2e-4 / atol
  2e-5 (tests/test_train.py's own), each step taken from crfr's state
  (student and momentum).

  Why so: a step of this net moves with the last bits of its input. A
  PReLU input within rounding of 0 takes the other slope in one stack, and
  one such flip moves a conv weight's gradient by up to ~3e-3: from the
  same state, one step of the fixed-low batch at lr 0.01 parted the two
  stacks' ``blocks.4.conv1`` weights by 1.2× the tolerance, while the
  port's gradients agree with a float64 replica within 1e-5 of their scale
  (``test_first_step_gradients_match_float64``) and crfr's first-step
  gradient of ``blocks.0.conv1`` at tests/test_torch_train.py's lr 0.05
  stood 4e-3 of its scale off the same replica. Unsynchronised, three
  steps at lr 0.05 or 0.01 carried such flips beyond the tolerance. At lr
  2e-3 one flip moves a weight by under 1e-5 while a step moves the conv
  weights by 1.2e-4 to 1.2e-3, 6 to 60 times the absolute tolerance.
- ``student_embed_fn`` with and without the residual, against crfr's after
  those steps, within 1e-4 of the embeddings' scale.
- The weight-decay mask over ``StudentModel`` equals crfr's.
- A resumed trainer's next step equals the uninterrupted one's bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import nnx

from crfr.configs import Config, DataCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr.data.synthetic import SyntheticFaces
from crfr.losses import distill as ref_kd
from crfr.models.residual import ResidualBranch as RefResidual
from crfr.train.distill_loop import DistillTrainer as RefDistill
from crfr.train.distill_loop import teacher_from_trainer as ref_teacher_from_trainer
from crfr.train.loop import Trainer as RefTrainer
from crfr_torch.configs import Config as PortConfig
from crfr_torch.losses import feature_l2, residual_kd_loss
from crfr_torch.models.convert import params_from_jax, student_state_from_jax, \
    train_state_from_jax
from crfr_torch.models.residual import ResidualBranch
from crfr_torch.train.checkpoints import Checkpointer
from crfr_torch.train.distill_loop import DistillTrainer, StudentModel, teacher_from_trainer
from crfr_torch.train.loop import Trainer, _wd_mask
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_sr_train import _equal_states
from tests.test_torch_train import ref_flat, ref_lows

SIZE, B, STEPS, KD = 32, 16, 3, 1e-3
TOL = dict(rtol=2e-4, atol=2e-5)
T = torch.from_numpy


def tiny_cfg(**overrides) -> Config:
    cfg = Config(
        name="kd-tiny", mesh=MeshCfg(data=1, model=1),
        data=DataCfg(image_size=SIZE, num_classes=4, degrade_min=16, degrade_max=32),
        model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0,
                       input_size=SIZE),
        loss=LossCfg(scale=16.0, margin=0.2, distill_weight=KD),
        train=TrainCfg(batch_size=B, lr=2e-3, warmup_steps=0, weight_decay=5e-4,
                       log_every=10, seed=0))
    return cfg.override(**overrides) if overrides else cfg


def port_cfg(cfg: Config) -> PortConfig:
    return PortConfig.from_dict(cfg.to_dict())


def batches(n: int = STEPS):
    return list(SyntheticFaces(num_classes=4, image_size=SIZE, seed=0).batches(B, n, seed=1))


def student_flat(state) -> dict:
    """A crfr student's parameters and BN statistics by '/'-joined path."""
    return {"/".join(map(str, p)): np.asarray(v[...]) for p, v in state.flat_state()
            if issubclass(v.type, (nnx.Param, nnx.BatchStat))}


def kd_lows(cfg: Config, step: int) -> np.ndarray:
    """The lows crfr's DistillTrainer draws at ``step``
    (crfr/train/distill_loop.py:228, :239-250): each image's, one for the
    batch, or the fixed low for every image."""
    dc = cfg.data
    n = min(dc.degrade_max, dc.image_size) - dc.degrade_min + 1
    key = jax.random.fold_in(jax.random.key(cfg.train.seed + 7), step)
    shape = (B,) if dc.per_sample_degrade else ()
    idx = np.broadcast_to(np.asarray(jax.random.randint(key, shape, 0, n)), (B,))
    return (dc.degrade_min + idx).astype(np.int32)


@pytest.fixture(scope="module")
def teachers():
    """crfr's Trainer at init and the port's with its weights."""
    ref = RefTrainer(tiny_cfg(**{"loss.distill_weight": 0.0}), steps_per_epoch=100)
    port = Trainer(port_cfg(tiny_cfg()), device="cpu")
    port.model.load_state_dict(train_state_from_jax(ref_flat(ref)))
    return ref, port


def twin_students(cfg: Config, teachers, ref_kw=None, port_kw=None):
    """crfr's DistillTrainer and the port's, from the same weights."""
    ref_t, port_t = teachers
    ref = RefDistill(cfg, ref_teacher_from_trainer(ref_t), steps_per_epoch=100,
                     **(ref_kw or {}))
    port = DistillTrainer(port_cfg(cfg), teacher_from_trainer(port_t), steps_per_epoch=100,
                          device="cpu", **(port_kw or {}))
    port.model.load_state_dict(student_state_from_jax(student_flat(ref.state)))
    return ref, port


def momentum_from_jax(opt_state) -> dict:
    """crfr's SGD trace (momentum) by the port's parameter names."""
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p)))) for p in path]
        if "trace" in names:
            flat["/".join(n for n in names[names.index("trace") + 1:] if n != "value")] = \
                np.asarray(v)
    return student_state_from_jax(flat)


def sync_student(ref, port) -> None:
    """The port's student and momentum set to crfr's."""
    port.model.load_state_dict(student_state_from_jax(student_flat(ref.state)))
    trace = momentum_from_jax(ref.opt_state)
    for name, p in port.model.named_parameters():
        port.tx.opt.state[p]["momentum_buffer"].copy_(trace[name])


def run_twins(cfg: Config, ref, port, with_lows: bool = True, check=None, sync=None):
    """Three steps on each side, each from the same state: after a step
    ``check(ref, port)`` compares the two, then ``sync(ref, port)`` hands
    the port crfr's state (by default the student and momentum).
    → per-step (crfr, port) metrics."""
    metrics = []
    for step, (imgs, labels) in enumerate(batches()):
        mr = ref.train_step(imgs, labels)
        lows = T(kd_lows(cfg, step)) if with_lows else None
        mp = port.train_step(imgs, labels, lows=lows)
        metrics.append(({k: float(v) for k, v in mr.items()},
                        {k: float(v) for k, v in mp.items()}))
        (check or assert_student_matches)(ref, port)
        (sync or sync_student)(ref, port)
    return metrics


def assert_metrics_match(metrics, keys=("loss", "ce", "kd")):
    for mr, mp in metrics:
        for k in keys:
            assert abs(mp[k] - mr[k]) <= 1e-4 * abs(mr[k]), (k, metrics)


def assert_student_matches(ref, port):
    want = student_state_from_jax(student_flat(ref.state))
    got = port.model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL, err_msg=k)


# --------------------------------------------------------------------------
# the residual branch and the loss


@pytest.mark.parametrize("train", [False, True])
def test_residual_branch_matches_crfr(train):
    rng = np.random.default_rng(3)
    jm = RefResidual(32, 24, rngs=nnx.Rngs(0))
    jm.prelu.alpha.value = jnp.asarray(rng.uniform(0.1, 0.4, 24), jnp.float32)
    jm.fc2.bias.value = jnp.asarray(rng.normal(0, 0.5, 32), jnp.float32)
    tm = ResidualBranch(32, 24)
    flat = {"/".join(map(str, p)): np.asarray(v.value) for p, v in nnx.state(jm).flat_state()}
    tm.load_state_dict(params_from_jax(flat))
    tm.train(train)
    for seed in (1, 2):                    # two calls: the statistics move twice
        x = rng.normal(0, 2, (8, 32)).astype(np.float32)
        want = np.asarray(jm(jnp.asarray(x), train=train))
        with torch.no_grad():
            got = tm(T(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    after = params_from_jax({"/".join(map(str, p)): np.asarray(v.value)
                             for p, v in nnx.state(jm).flat_state()})
    for k in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), after[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    moved = not np.allclose(after["bn.running_var"].numpy(), 1.0)
    assert moved == train


@pytest.mark.parametrize("normalize", [False, True])
def test_kd_loss_and_gradients_match_jax(normalize):
    rng = np.random.default_rng(4)
    s, r, t = (rng.normal(0, 3, (6, 16)).astype(np.float32) for _ in range(3))
    want_l2 = float(ref_kd.feature_l2(jnp.asarray(s), jnp.asarray(t), normalize))
    assert float(feature_l2(T(s), T(t), normalize)) == pytest.approx(want_l2, rel=1e-5)

    def ref_loss(s, r, t):
        return ref_kd.residual_kd_loss(s, r, t, weight=0.7, normalize=normalize)

    want = float(ref_loss(jnp.asarray(s), jnp.asarray(r), jnp.asarray(t)))
    want_g = jax.grad(ref_loss, argnums=(0, 1, 2))(jnp.asarray(s), jnp.asarray(r),
                                                   jnp.asarray(t))
    ts, tr_, tt = (T(a).requires_grad_(True) for a in (s, r, t))
    got = residual_kd_loss(ts, tr_, tt, weight=0.7, normalize=normalize)
    got.backward()
    assert float(got) == pytest.approx(want, rel=1e-5)
    for g, w in zip((ts.grad, tr_.grad), want_g[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # the teacher is detached: no gradient, as stop_gradient gives zeros
    assert tt.grad is None and not np.asarray(want_g[2]).any()


# --------------------------------------------------------------------------
# the recognition trainer with a teacher


def test_set_teacher_three_steps_match_crfr(teachers):
    """crfr's Trainer.set_teacher against the port's: the teacher sees the
    normalised HR batch; the KD term is λ·‖emb − t‖²."""
    cfg = tiny_cfg()
    ref_t, port_t = teachers
    ref = RefTrainer(cfg, steps_per_epoch=100)
    ref.set_teacher(ref_teacher_from_trainer(ref_t))
    port = Trainer(port_cfg(cfg), steps_per_epoch=100, device="cpu")
    port.model.load_state_dict(train_state_from_jax(ref_flat(ref)))
    port.set_teacher(teacher_from_trainer(port_t))
    plain = Trainer(port_cfg(cfg), steps_per_epoch=100, device="cpu")
    plain.model.load_state_dict(port.model.state_dict())
    for step, (imgs, labels) in enumerate(batches()):
        lows = T(ref_lows(cfg, step)[:B])
        mr = {k: float(v) for k, v in ref.train_step(imgs, labels).items()}
        mp = {k: float(v) for k, v in port.train_step(imgs, labels, lows=lows).items()}
        for k in ("loss", "grad_norm"):
            assert abs(mp[k] - mr[k]) <= 1e-4 * abs(mr[k]), (k, mr, mp)
        if step == 0:                     # the KD term is on: above the plain CE
            assert mp["loss"] > float(plain.train_step(imgs, labels, lows=lows)["loss"]) + 0.1
    want = train_state_from_jax(ref_flat(ref))
    got = port.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL, err_msg=k)


# --------------------------------------------------------------------------
# the distilled student on bicubic input

# path → (config overrides, trainer options); the per-batch path also takes
# the KD distance between unit rows (kd_normalize), at λ = 1 since that
# distance is at most 4
PATHS = {"fixed_low": ({"data.degrade_min": 16, "data.degrade_max": 16}, {}),
         "low_per_batch": ({"data.per_sample_degrade": False, "loss.distill_weight": 1.0},
                           {"kd_normalize": True}),
         "low_per_image": ({}, {})}


@pytest.fixture(scope="module")
def bicubic_runs(teachers):
    out = {}
    for name, (ov, kw) in PATHS.items():
        cfg = tiny_cfg(**ov)
        ref, port = twin_students(cfg, teachers, kw, kw)
        out[name] = (cfg, ref, port, run_twins(cfg, ref, port))
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_three_kd_steps_match_crfr(bicubic_runs, path):
    cfg, ref, port, metrics = bicubic_runs[path]
    assert_metrics_match(metrics)
    assert all(mr["kd"] > 0.1 * mr["ce"] for mr, _ in metrics)      # both terms count


def test_first_step_gradients_match_float64(teachers):
    """The port's first-step gradients (the momentum after one step, less
    the weight decay) against the same step of a float64 copy of the
    student, within 1e-5 of each tensor's largest gradient or 1e-6 (the
    BN biases ahead of another BN have a gradient of 0 in exact arithmetic
    and ~1e-7 in float32)."""
    import copy

    from crfr_torch.ops.normalize import normalize

    cfg = tiny_cfg()
    _, port_t = teachers
    port = DistillTrainer(port_cfg(cfg), teacher_from_trainer(port_t), device="cpu")
    m64 = copy.deepcopy(port.model).double()
    m64.backbone.dtype = torch.float64
    imgs, labels = batches(1)[0]
    lows = T(kd_lows(cfg, 0))
    x_in = port._preprocess(T(imgs), None, lows).double()
    t = port._teacher_fn(normalize(T(imgs))).double()
    s = m64.backbone(x_in)
    r = m64.residual(s)
    loss = m64.head.loss(s, T(labels).long()) + KD * (s + r - t).square().sum(-1).mean()
    loss.backward()
    port.train_step(imgs, labels, lows=lows)
    decay = {n for n, on in _wd_mask(port.model).items() if on}
    for (n, p), p64 in zip(port.model.named_parameters(), m64.parameters()):
        g = port.tx.opt.state[p]["momentum_buffer"].double()
        if n in decay:
            g = g - cfg.train.weight_decay * p64.detach()
        scale = p64.grad.abs().max().item()
        assert (g - p64.grad).abs().max().item() <= max(1e-5 * scale, 1e-6), n


@pytest.mark.parametrize("with_residual", [False, True])
def test_student_embed_fn_matches_crfr(bicubic_runs, with_residual):
    _, ref, port, _ = bicubic_runs["low_per_image"]
    x = np.random.default_rng(6).integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(ref.student_embed_fn(with_residual)(x))
    got = port.student_embed_fn(with_residual)(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    other = port.student_embed_fn(not with_residual)(x).numpy()
    assert not np.allclose(other, got, rtol=0, atol=1e-4 * np.abs(want).max())
    assert port.model.training and port.model.residual.training


def test_wd_mask_covers_the_residual_branch_as_crfr():
    from crfr.train.distill_loop import StudentModel as RefStudent
    from crfr.train.loop import _wd_mask as ref_wd_mask

    cfg = tiny_cfg()
    mask = _wd_mask(StudentModel(port_cfg(cfg), torch.Generator().manual_seed(0)))
    decayed = {n for n, on in mask.items() if on}
    params = nnx.state(RefStudent(cfg, rngs=nnx.Rngs(0)), nnx.Param)
    flat = {}
    for (path, var), (_, on) in zip(params.flat_state(), ref_wd_mask(params).flat_state()):
        flat["/".join(map(str, path))] = np.full(np.shape(var[...]), float(on.get_value()),
                                                 np.float32)
    ref_decayed = {n for n, v in student_state_from_jax(flat).items()
                   if v.numel() and v.is_floating_point() and v.all()}
    assert decayed == ref_decayed
    assert {"residual.fc1.weight", "residual.fc2.weight", "head.weight"} <= decayed
    assert not {"residual.fc1.bias", "residual.prelu.weight", "residual.bn.weight"} & decayed


def test_resume_is_bitwise(tmp_path):
    """Two steps, a checkpoint, a fresh trainer restored from it: its third
    step equals the uninterrupted trainer's bit for bit (lows and dropout
    from the step's own generator)."""
    cfg = port_cfg(tiny_cfg(**{"model.dropout": 0.4}))
    teacher = teacher_from_trainer(Trainer(cfg, device="cpu"))
    a = DistillTrainer(cfg, teacher, device="cpu")
    data = batches()
    for imgs, labels in data[:2]:
        a.train_step(imgs, labels)
    ck = Checkpointer(str(tmp_path / "student"))
    ck.save(a.step, a.state_dict(), cfg.to_json())
    b = DistillTrainer(cfg, teacher, device="cpu")
    b.load_state_dict(ck.restore(b.state_dict()))
    assert b.step == 2 and _equal_states(a.state_dict(), b.state_dict())
    ma, mb = a.train_step(*data[2]), b.train_step(*data[2])
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert _equal_states(a.state_dict(), b.state_dict())


def test_refusals():
    cfg = port_cfg(tiny_cfg())
    teacher = teacher_from_trainer(Trainer(cfg, device="cpu"))
    with pytest.raises(ValueError, match="distill_weight > 0"):
        DistillTrainer(cfg.override(**{"loss.distill_weight": 0.0}), teacher, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        DistillTrainer(cfg, teacher, device="cpu", sr_fn=lambda x: x,
                       sr_module=torch.nn.Identity())
    with pytest.raises(NotImplementedError, match="more than one device"):
        DistillTrainer(cfg.override(**{"mesh.data": 2}), teacher, device="cpu")
    st = DistillTrainer(cfg, teacher, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        st.student_embed_fn(local_snapshot=True)
    with pytest.raises(ValueError, match="no trainable G"):
        st.sr_apply()
    g = DistillTrainer(cfg, teacher, device="cpu", sr_fn=lambda x: x, sr_scale=4)
    with pytest.raises(ValueError, match="bicubic path only"):
        g.train_step(*batches(1)[0], lows=np.full(B, 20, np.int32))


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistillTrainer(port_cfg(tiny_cfg()), lambda x: x)
