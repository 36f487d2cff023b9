"""FaceRecognizer: the one-call user API, detect → align → embed → match
(crfr/pipeline.py).

    rec = FaceRecognizer.from_checkpoint("ckpt/dir")       # or from_config
    faces = rec.detect_and_align(photo)                    # (N, 112, 112, 3) uint8
    embs = rec.embed(faces)                                # (N, 512) float32
    sims = rec.similarity(embs, gallery_embs)              # cosine

NumPy in and out, as ``crfr``'s. Everything between runs on the trainer's
device (CUDA unless the caller asks for the CPU): the MTCNN cascade when no
landmarks are given (``models.mtcnn``; it needs trained or imported
weights to find real faces), then one batched similarity solve and one
batched warp for all faces of the photo (``ops.warp.align_faces``), and the
embedding through ``eval.extract.make_extract_fn`` with flip TTA.
``crfr``'s host path through its C++ library has no counterpart: with a
card present nothing runs on the host but the cascade's bookkeeping.
"""

from __future__ import annotations

import numpy as np

from crfr_torch.configs import Config
from crfr_torch.eval.extract import make_extract_fn
from crfr_torch.models.mtcnn import MTCNN
from crfr_torch.ops.warp import align_faces
from crfr_torch.train.checkpoints import Checkpointer
from crfr_torch.train.loop import Trainer


class FaceRecognizer:
    def __init__(self, trainer: Trainer, detector=None, flip_tta: bool = True):
        self._trainer = trainer
        self._detector = detector
        self.cfg: Config = trainer.cfg
        self.device = trainer.device
        # state_fn threads the trainer's live weights through: keep training
        # the held trainer and embed() follows
        self._embed = make_extract_fn(
            trainer.backbone_apply, state_fn=trainer.embed_state, flip=flip_tta,
            flip_fusion=self.cfg.eval.flip_fusion, image_size=self.cfg.model.input_size,
            device=self.device)

    # -- constructors --------------------------------------------------
    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, device=None, **kw) -> "FaceRecognizer":
        """The trainer saved by ``python -m crfr_torch train`` in ``ckpt_dir``
        (its latest step, with its own config)."""
        ck = Checkpointer(ckpt_dir, keep=1)
        cfg_dict = ck.restore_config()
        if cfg_dict is None:
            raise FileNotFoundError(f"no config in checkpoint {ckpt_dir}")
        tr = Trainer(Config.from_dict(cfg_dict), steps_per_epoch=1000, device=device)
        tr.state = ck.restore(tr.state)
        return cls(tr, **kw)

    @classmethod
    def from_config(cls, cfg: Config, device=None, **kw) -> "FaceRecognizer":
        return cls(Trainer(cfg, steps_per_epoch=1000, device=device), **kw)

    # -- detection + alignment -----------------------------------------
    def detect_and_align(self, image: np.ndarray,
                         landmarks: np.ndarray | None = None) -> np.ndarray:
        """One photo (H, W, 3) → aligned crops (N, S, S, 3) uint8. With
        ``landmarks`` (N, 5, 2) given, detection is skipped; without, the
        cascade (an ``MTCNN`` on this device at its defaults unless one was
        passed) finds them."""
        size = self.cfg.model.input_size
        if landmarks is None:
            if self._detector is None:
                self._detector = MTCNN(device=self.device)
            landmarks = self._detector.detect(np.asarray(image)).landmarks
        landmarks = np.asarray(landmarks, np.float32)
        if landmarks.size == 0:
            return np.zeros((0, size, size, 3), np.uint8)
        return align_faces(np.ascontiguousarray(image), landmarks, size,
                           device=self.device).cpu().numpy()

    # -- embedding + matching ------------------------------------------
    def embed(self, aligned: np.ndarray) -> np.ndarray:
        """(N, S, S, 3) raw aligned pixels → (N, D) float32 embeddings."""
        if len(aligned) == 0:
            return np.zeros((0, self.cfg.model.embedding_dim), np.float32)
        return self._embed(np.ascontiguousarray(aligned)).float().cpu().numpy()

    @staticmethod
    def similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Cosine similarity matrix (Na, Nb)."""
        a = a / np.linalg.norm(a, axis=-1, keepdims=True).clip(1e-12)
        b = b / np.linalg.norm(b, axis=-1, keepdims=True).clip(1e-12)
        return a @ b.T

    def verify(self, img1: np.ndarray, img2: np.ndarray,
               landmarks1: np.ndarray | None = None,
               landmarks2: np.ndarray | None = None,
               threshold: float = 0.3) -> tuple[bool, float]:
        """Two photos → (same person, cosine), from the first face of each."""
        f1 = self.detect_and_align(img1, landmarks1)
        f2 = self.detect_and_align(img2, landmarks2)
        if len(f1) == 0 or len(f2) == 0:
            return False, -1.0
        e1 = self.embed(f1[:1])
        e2 = self.embed(f2[:1])
        cos = float(self.similarity(e1, e2)[0, 0])
        return cos >= threshold, cos
