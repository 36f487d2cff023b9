"""crfr_torch.pipeline.FaceRecognizer against crfr.pipeline.FaceRecognizer on
the CPU: ir_18 in float32 as in tests/test_pipeline_api.py, the port's
trainer holding crfr's weights (``train_state_from_jax``). The aligned
crops equal crfr's (its C++ ``align_crop``) outside pixels within float32
error of a half-integer (tests/test_torch_align.py's rule); the flip-TTA
embeddings of the same crops within 1e-4 relative; ``verify`` and the
empty case as crfr's; the cascade path and a checkpoint round trip.
"""

import numpy as np
import pytest
import torch

from crfr.configs import Config, DataCfg, LossCfg, MeshCfg, ModelCfg, TrainCfg
from crfr.ops.similarity import REFERENCE_LANDMARKS_112
from crfr.pipeline import FaceRecognizer as RefRecognizer
from crfr_torch.configs import Config as PortConfig
from crfr_torch.models.convert import train_state_from_jax
from crfr_torch.models.mtcnn import MTCNN
from crfr_torch.pipeline import FaceRecognizer
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_align import assert_u8_crops
from tests.test_torch_train import ref_flat


def api_cfg() -> Config:
    return Config(
        name="api-test", mesh=MeshCfg(data=1),
        data=DataCfg(image_size=112, num_classes=4),
        model=ModelCfg(backbone="ir_18", compute_dtype="float32", dropout=0.0),
        loss=LossCfg(), train=TrainCfg(batch_size=4))


@pytest.fixture(scope="module")
def recs():
    cfg = api_cfg()
    ref = RefRecognizer.from_config(cfg)
    port = FaceRecognizer.from_config(PortConfig.from_dict(cfg.to_dict()), device="cpu")
    port._trainer.model.load_state_dict(train_state_from_jax(ref_flat(ref._trainer)))
    return ref, port


def _lms():
    return np.stack([REFERENCE_LANDMARKS_112 + 20, REFERENCE_LANDMARKS_112 * 1.3 + 5,
                     REFERENCE_LANDMARKS_112 * 0.9 + 50]).astype(np.float32)


def test_crops_match_crfrs(recs, rng):
    ref, port = recs
    img = rng.integers(0, 256, (200, 180, 3)).astype(np.uint8)
    want = ref.detect_and_align(img, _lms())
    got = port.detect_and_align(img, _lms())
    assert got.shape == (3, 112, 112, 3) and got.dtype == np.uint8
    assert_u8_crops(got, want, img, _lms())


def test_embeddings_match_crfrs(recs, rng):
    ref, port = recs
    crops = rng.integers(0, 256, (3, 112, 112, 3)).astype(np.uint8)
    want = ref.embed(crops)
    got = port.embed(crops)
    assert got.shape == (3, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    sims = port.similarity(got, got)
    np.testing.assert_allclose(np.diag(sims), 1.0, atol=1e-5)


def test_verify_and_empty_match_crfrs(recs, rng):
    ref, port = recs
    img = rng.integers(0, 256, (160, 160, 3)).astype(np.uint8)
    other = rng.integers(0, 256, (160, 160, 3)).astype(np.uint8)
    lm = (REFERENCE_LANDMARKS_112 + 20).astype(np.float32)[None]
    same, cos = port.verify(img, img, lm, lm)
    assert same and cos == pytest.approx(1.0, abs=1e-4)
    got, want = port.verify(img, other, lm, lm), ref.verify(img, other, lm, lm)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], abs=1e-4)
    empty = np.zeros((0, 5, 2), np.float32)
    crops = port.detect_and_align(img, empty)
    assert crops.shape == (0, 112, 112, 3) and crops.dtype == np.uint8
    assert port.embed(crops).shape == (0, 512)
    assert port.verify(img, img, empty, lm) == ref.verify(img, img, empty, lm) == (False, -1.0)


def test_cascade_path(recs, rng):
    """No landmarks: the detector's landmarks, aligned as when passed in."""
    _, port = recs
    det = MTCNN(min_face=40, thresholds=(0.3, 0.0, 0.0), device="cpu")
    rec = FaceRecognizer(port._trainer, detector=det)
    img = rng.integers(0, 256, (160, 120, 3)).astype(np.uint8)
    found = det.detect(img)
    crops = rec.detect_and_align(img)
    assert len(found.landmarks) > 0 and crops.shape == (len(found.landmarks), 112, 112, 3)
    assert np.array_equal(crops, rec.detect_and_align(img, found.landmarks))


def test_from_checkpoint(recs, tmp_path, rng):
    from crfr_torch.train.checkpoints import Checkpointer

    _, port = recs
    tr = port._trainer
    Checkpointer(str(tmp_path), keep=1).save(3, tr.state, tr.cfg.to_json())
    back = FaceRecognizer.from_checkpoint(str(tmp_path), device="cpu")
    crops = rng.integers(0, 256, (2, 112, 112, 3)).astype(np.uint8)
    assert np.array_equal(back.embed(crops), port.embed(crops))
    with pytest.raises(FileNotFoundError):
        FaceRecognizer.from_checkpoint(str(tmp_path / "none"), device="cpu")


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceRecognizer.from_config(PortConfig.from_dict(api_cfg().to_dict()))


def test_slice_imports_none_of_the_jax_stack():
    """The modules of detection and alignment import neither JAX nor crfr."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import crfr_torch.pipeline, crfr_torch.models.mtcnn, crfr_torch.models.mobilefacenet\n"
            "import crfr_torch.train.mtcnn_train, crfr_torch.ops.similarity, crfr_torch.ops.warp\n"
            "import crfr_torch.data.records, crfr_torch.models.convert\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'flax', 'crfr', 'optax'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
