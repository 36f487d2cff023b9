"""crfr_torch.train.sr_loop.SRTrainer against crfr.train.sr_loop.SRTrainer
on the CPU: image size 32, scale 4, 16 priors, batch 4 of SyntheticFaces,
a cosine schedule with 2 warmup steps over 10, two D steps per G step, R1
with γ = 1, the EMA on, and landmarks on the second step (prior targets
need 5 or 16 priors, so this run takes 16: heatmaps and parsing maps). The
port starts from crfr's G and D (``params_from_jax``). Three steps on each
side: G and D losses per step within 1e-4 relative; G, D, their BN
statistics and the EMA after them within rtol 2e-4 / atol 2e-5, the train
tests' tolerance.

Adam turns a gradient below its eps (1e-8) into a step of up to ±lr, so an
element whose gradient is within rounding of 0 on either side may move by
a different ±lr step. Such elements are counted and reported; each must lie
within 2·lr·steps of crfr's, and together they must be fewer than 1e-4 of
G's elements; every other element is held to the tolerance above.

Then the port alone: its checkpoint round trip (bit for bit, and the next
step equal), the meta record's checks with crfr's texts, an EMA seeded from
G when a state has none, the logged PSNR/SSIM, and its refusals."""

import numpy as np
import pytest
import torch

from crfr.configs import Config, DataCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr.data.synthetic import SyntheticFaces
from crfr.train.sr_loop import SRTrainer as RefSRTrainer
from crfr_torch.configs import Config as PortConfig
from crfr_torch.models.convert import params_from_jax
from crfr_torch.train.checkpoints import Checkpointer
from crfr_torch.train.sr_loop import SRTrainer, adam_schedule
from crfr_torch.utils.logging import MetricsWriter
from tests.test_torch_sr_losses import landmarks, one_thread  # noqa: F401 (autouse)

STEPS, LR = 3, 1e-4
TOL = dict(rtol=2e-4, atol=2e-5)
KW = dict(scale=4, n_priors=16, schedule="cosine", warmup_steps=2, total_steps=10,
          n_d_steps=2, r1_gamma=1.0)


def tiny_cfg(**overrides) -> Config:
    cfg = Config(name="sr-tiny", mesh=MeshCfg(data=1, model=1),
                 data=DataCfg(image_size=32, num_classes=4, degrade_min=8, degrade_max=32),
                 model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0,
                                input_size=32),
                 loss=LossCfg(scale=16.0, margin=0.2),
                 train=TrainCfg(batch_size=4, log_every=10 ** 9, seed=0))
    return cfg.override(**overrides) if overrides else cfg


def port_cfg(**overrides) -> PortConfig:
    return PortConfig.from_dict(tiny_cfg(**overrides).to_dict())


def jax_flat(state) -> dict:
    return {"/".join(map(str, p)): np.asarray(v[...]) for p, v in state.flat_state()}


def batches(n: int = STEPS):
    return [imgs for imgs, _ in SyntheticFaces(num_classes=4, image_size=32, seed=0)
            .batches(4, n, seed=1)]


def load_crfr_weights(port: SRTrainer, ref: RefSRTrainer) -> None:
    port.g.load_state_dict(params_from_jax(jax_flat(ref.g_state)))
    port.d.load_state_dict(params_from_jax(jax_flat(ref.d_state)))
    port.g_ema.load_state_dict(params_from_jax(jax_flat(ref.g_ema)))


@pytest.fixture(scope="module")
def twin_run():
    ref = RefSRTrainer(tiny_cfg(), **KW)
    port = SRTrainer(port_cfg(), device="cpu", **KW)
    load_crfr_weights(port, ref)
    lm = landmarks(np.random.default_rng(7), 4, 32)
    metrics = []
    for step, imgs in enumerate(batches()):
        extra = lm if step == 1 else None
        mr = ref.train_step(imgs, landmarks=extra)
        mp = port.train_step(imgs, landmarks=extra)
        metrics.append(({k: float(v) for k, v in mr.items()},
                        {k: float(v) for k, v in mp.items()}))
    return ref, port, metrics


def test_losses_per_step_match_crfr(twin_run):
    _, _, metrics = twin_run
    for mr, mp in metrics:
        for k in ("g_loss", "d_loss"):
            assert abs(mp[k] - mr[k]) <= 1e-4 * abs(mr[k]), (k, metrics)
    assert metrics[1][0]["g_loss"] > 10 * metrics[0][0]["g_loss"]     # the prior term is on


def assert_state_matches(want: dict, got: dict, steps: int, lr: float = LR) -> list:
    """``got`` (a port state_dict) against ``want`` (crfr's, converted)
    within TOL, but for Adam's sign flips: each within 2·lr·steps, fewer
    than 1e-4 of the elements in all. Returns the flips (name, count, max)."""
    assert set(want) == set(got)
    flips, total = [], 0
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        g, w = got[k].numpy(), v.numpy()
        total += w.size
        out = np.abs(g - w) > TOL["atol"] + TOL["rtol"] * np.abs(w)
        if out.any():
            flips.append((k, int(out.sum()), float(np.abs(g - w)[out].max())))
            assert np.abs(g - w)[out].max() <= 2 * lr * steps, (k, flips[-1])
    n_flips = sum(n for _, n, _ in flips)
    assert n_flips < 1e-4 * total, f"{n_flips} Adam sign flips of {total} elements: {flips}"
    return flips


@pytest.mark.parametrize("which", ["g", "d", "g_ema"])
def test_state_after_three_steps_matches_crfr(twin_run, which):
    ref, port, _ = twin_run
    want = params_from_jax(jax_flat({"g": ref.g_state, "d": ref.d_state,
                                     "g_ema": ref.g_ema}[which]))
    flips = assert_state_matches(want, getattr(port, which).state_dict(), STEPS)
    if which == "d":
        assert not flips, flips


def test_the_step_moves_g_d_and_the_ema():
    """From the port's own init: G and D change, the EMA lags G."""
    tr = SRTrainer(port_cfg(), device="cpu", scale=4, n_priors=4)
    before = {n: {k: v.clone() for k, v in getattr(tr, n).state_dict().items()}
              for n in ("g", "d")}
    m = tr.train_step(batches(1)[0])
    assert np.isfinite(float(m["g_loss"])) and np.isfinite(float(m["d_loss"]))
    for n in ("g", "d"):
        after = getattr(tr, n).state_dict()
        assert any(not torch.equal(v, after[k]) for k, v in before[n].items()), n
    assert not torch.equal(tr.g_ema.gen.out.weight, tr.g.gen.out.weight)
    assert tr.g_opt.count() == 1 and tr.d_opt.count() == 1 and tr.step == 1


def test_adam_schedule_matches_optax():
    """Within 1e-5 relative: optax evaluates in float32, the port in float64."""
    import optax

    for kind in ("constant", "cosine"):
        for warm in (0, 3):
            main = (optax.cosine_decay_schedule(1e-4, max(20 - warm, 1)) if kind == "cosine"
                    else optax.constant_schedule(1e-4))
            want = main if not warm else optax.join_schedules(
                [optax.linear_schedule(0.0, 1e-4, warm), main], [warm])
            got = adam_schedule(1e-4, kind, 20, warm)
            for c in range(25):
                assert got(c) == pytest.approx(float(want(c)), rel=1e-5, abs=1e-12), (kind, c)
    with pytest.raises(ValueError, match="unknown schedule"):
        adam_schedule(1e-4, "step")


def _equal_states(a: dict, b: dict) -> bool:
    """Nested state dicts equal: tensors bit for bit, everything else by ==."""
    def flat(sd, prefix=""):
        out = {}
        for k, v in sd.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out

    fa, fb = flat(a), flat(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(v, fb[k]) if isinstance(v, torch.Tensor) else v == fb[k]
        for k, v in fa.items())


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    cfg = port_cfg()
    kw = dict(KW, n_priors=4, r1_gamma=0.0)
    a = SRTrainer(cfg, device="cpu", **kw)
    imgs = batches(3)
    for x in imgs[:2]:
        a.train_step(x)
    ck = Checkpointer(str(tmp_path / "sr"))
    ck.save(a.step, a.state_dict(), cfg.to_json())
    b = SRTrainer(cfg, device="cpu", **kw)
    b.restore_from(ck)
    assert b.step == 2 and _equal_states(a.state_dict(), b.state_dict())
    assert _equal_states(ck.restore(), b.state_dict())
    ma, mb = a.train_step(imgs[2]), b.train_step(imgs[2])
    assert torch.equal(ma["g_loss"], mb["g_loss"]) and torch.equal(ma["d_loss"], mb["d_loss"])
    assert _equal_states(a.state_dict(), b.state_dict())


def test_meta_record_checks_the_forward():
    cfg = port_cfg()
    sd = SRTrainer(cfg, device="cpu", scale=4, n_priors=4).state_dict()
    assert sd["meta"] == {"version": 2, "bicubic_skip": 1, "scale": 4, "n_priors": 4}
    with pytest.raises(ValueError, match="bicubic_skip=True but this trainer was built with "
                                         "False"):
        SRTrainer(cfg, device="cpu", scale=4, n_priors=4, bicubic_skip=False).load_state_dict(sd)
    with pytest.raises(ValueError, match="SR checkpoint scale 4 != trainer scale 8"):
        SRTrainer(cfg, device="cpu", scale=8, n_priors=4).load_state_dict(sd)
    with pytest.raises(ValueError, match="no meta record"):
        SRTrainer(cfg, device="cpu", scale=4, n_priors=4).load_state_dict(
            {k: v for k, v in sd.items() if k != "meta"})


def test_state_without_ema_seeds_it_from_g():
    cfg = port_cfg()
    a = SRTrainer(cfg, device="cpu", scale=4, n_priors=4, ema_decay=0.0)
    a.train_step(batches(1)[0])
    sd = a.state_dict()
    assert "g_ema" not in sd
    b = SRTrainer(cfg, device="cpu", scale=4, n_priors=4)
    b.load_state_dict(sd)
    assert _equal_states(b.g_ema.state_dict(), a.g.state_dict())


def test_logging_writes_psnr_ssim(tmp_path):
    """Every log_every steps the EMA's PSNR/SSIM on the batch go out with
    the losses; G at init is bicubic, so its PSNR is bicubic's."""
    cfg = port_cfg(**{"train.log_every": 2})
    path = tmp_path / "m.jsonl"
    tr = SRTrainer(cfg, device="cpu", scale=4, n_priors=4, metrics=MetricsWriter(str(path),
                                                                                stdout=False))
    iq0 = tr.psnr_ssim(batches(1)[0])
    assert 15 < iq0["psnr"] < 60 and 0 < iq0["ssim"] <= 1
    for x in batches(2):
        tr.train_step(x)
    import json

    rows = [json.loads(r) for r in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == [2]
    assert {"g_loss", "d_loss", "psnr", "ssim"} <= set(rows[0])
    g = tr.generator()
    assert not g.training and all(torch.equal(v, tr.g_ema.state_dict()[k])
                                  for k, v in g.state_dict().items())
    out = tr.sr_fn()(np.full((2, 8, 8, 3), 100, np.uint8))
    assert out.shape == (2, 32, 32, 3) and float(out.min()) >= 0 and float(out.max()) <= 255


def test_refusals():
    cfg = port_cfg()
    with pytest.raises(NotImplementedError, match="more than one device"):
        SRTrainer(port_cfg(**{"mesh.data": 2}), device="cpu", scale=4)
    with pytest.raises(NotImplementedError, match="more than one device"):
        SRTrainer(cfg, device="cpu", scale=4, mesh=object())
    with pytest.raises(ValueError, match="not a multiple of scale 5"):
        SRTrainer(cfg, device="cpu", scale=5)
    tr = SRTrainer(cfg, device="cpu", scale=4, n_priors=4)
    with pytest.raises(ValueError, match="n_priors=4 matches neither"):
        tr.train_step(batches(1)[0], landmarks=landmarks(np.random.default_rng(0), 4, 32))
    assert tr.step == 0


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SRTrainer(port_cfg(), scale=4)
