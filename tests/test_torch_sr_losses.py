"""The SR stage's prior targets, GAN losses and image quality against crfr
on the CPU, from the same seeded numpy inputs: ``landmark_heatmaps``,
``parsing_maps`` and ``prior_targets`` at 64 px within 1e-5; every GAN
loss in both modes within 1e-6; ``psnr`` and ``ssim`` within 1e-4."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.eval import image_quality as jiq
from crfr.losses import gan as jgan
from crfr.ops import heatmaps as jhm
from crfr_torch.eval import image_quality as iq
from crfr_torch.losses import gan
from crfr_torch.ops import heatmaps as hm

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs. The suite runs six
    workers on the machine's cores; torch's OpenMP threads spin for cores
    that other workers hold, and six such workers each running these small
    convolutions on every core took over 15× as long as on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def landmarks(rng, n: int, size: int) -> np.ndarray:
    """Five-point landmarks of a roughly frontal face at ``size`` px, jittered
    and tilted per image."""
    base = np.array([[0.34, 0.46], [0.66, 0.46], [0.50, 0.62], [0.37, 0.80], [0.63, 0.80]])
    pts = base * size + rng.normal(0, 0.03 * size, (n, 5, 2))
    ang = rng.uniform(-0.4, 0.4, n)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)      # (n, 2, 2)
    ctr = size / 2
    return (np.einsum("nij,nkj->nki", rot, pts - ctr) + ctr).astype(np.float32)


@pytest.mark.parametrize("fn,args", [("landmark_heatmaps", (64, 3.0)),
                                     ("landmark_heatmaps", (64, 1.5)),
                                     ("parsing_maps", (64, 8.0)),
                                     ("prior_targets", (64,))])
def test_priors_match_crfr(fn, args):
    """(2, 3, 5, 2) landmarks, so the leading batch shape is kept too."""
    lm = landmarks(np.random.default_rng(0), 6, 64).reshape(2, 3, 5, 2)
    want = np.asarray(getattr(jhm, fn)(jnp.asarray(lm), *args))
    got = getattr(hm, fn)(T(lm), *args)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_parsing_maps_are_soft_masks():
    lm = landmarks(np.random.default_rng(1), 4, 64)
    maps = hm.parsing_maps(T(lm)).numpy()
    assert maps.shape == (4, 112, 112, len(hm.PARSING_LABELS)) and hm.PARSING_LABELS[-1] == "background"
    assert maps.min() >= 0.0 and maps.max() <= 1.0
    with pytest.raises(ValueError, match="5-point"):
        hm.parsing_maps(T(lm[:, :4]))


def test_prior_target_fn_closes_over_the_landmarks():
    lm = T(landmarks(np.random.default_rng(2), 2, 32))
    f = hm.prior_target_fn(lm, size=32)
    np.testing.assert_array_equal(f(None).numpy(), hm.prior_targets(lm, 32).numpy())
    assert hm.prior_target_fn(lm, size=32, include_parsing=False)(None).shape == (2, 32, 32, 5)


@pytest.mark.parametrize("mode", ["lsgan", "bce"])
def test_adversarial_losses_match_crfr(mode):
    rng = np.random.default_rng(3)
    real, fake = (rng.normal(0, 3, 64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(gan.adversarial_g_loss(T(fake), mode)),
                               float(jgan.adversarial_g_loss(jnp.asarray(fake), mode)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(gan.adversarial_d_loss(T(real), T(fake), mode)),
                               float(jgan.adversarial_d_loss(jnp.asarray(real),
                                                             jnp.asarray(fake), mode)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_pixel_loss_matches_crfr(kind):
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(gan.pixel_loss(T(a), T(b), kind)),
                               float(jgan.pixel_loss(jnp.asarray(a), jnp.asarray(b), kind)),
                               rtol=1e-6, atol=1e-6)


def test_identity_prior_perceptual_match_crfr_and_detach_the_target():
    rng = np.random.default_rng(5)
    e1, e2 = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(2))
    p1, p2 = (rng.uniform(0, 1, (2, 8, 8, 5)).astype(np.float32) for _ in range(2))
    f_sr = [rng.normal(size=(2, 8, 8, 4)).astype(np.float32),
            rng.normal(size=(2, 4, 4, 8)).astype(np.float32)]
    f_hr = [rng.normal(size=f.shape).astype(np.float32) for f in f_sr]
    pairs = [
        (gan.identity_loss, jgan.identity_loss, (e1, e2)),
        (gan.prior_loss, jgan.prior_loss, (p1, p2)),
        (gan.perceptual_loss, jgan.perceptual_loss, ([*f_sr], [*f_hr])),
    ]
    for port, ref, (a, b) in pairs:
        wrap = (lambda v, rg: [T(x).requires_grad_(rg) for x in v]) if isinstance(a, list) \
            else (lambda v, rg: T(v).requires_grad_(rg))
        ta, tb = wrap(a, True), wrap(b, True)
        got = port(ta, tb)
        ja = [jnp.asarray(x) for x in a] if isinstance(a, list) else jnp.asarray(a)
        jb = [jnp.asarray(x) for x in b] if isinstance(b, list) else jnp.asarray(b)
        np.testing.assert_allclose(float(got.detach()), float(ref(ja, jb)), rtol=1e-6, atol=1e-6,
                                   err_msg=port.__name__)
        got.backward()
        tbs = tb if isinstance(tb, list) else [tb]
        assert all(t.grad is None for t in tbs), port.__name__
    assert float(gan.perceptual_loss([], [])) == 0.0


@pytest.mark.parametrize("shape", [(3, 24, 20, 3), (16, 16, 1)])
def test_psnr_ssim_match_crfr(shape):
    """On [0, 255] images and a noisy copy; a 3-D input is one image."""
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).astype(np.float32)
    np.testing.assert_allclose(iq.psnr(T(a), T(b)).numpy(),
                               np.asarray(jiq.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(iq.ssim(T(a), T(b)).numpy(),
                               np.asarray(jiq.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-4)
    assert float(iq.ssim(T(a), T(a)).min()) == pytest.approx(1.0, abs=1e-5)
    assert float(iq.psnr(T(a), T(a)).min()) == pytest.approx(120.0 + 10 * np.log10(255.0 ** 2),
                                                             rel=1e-6)
