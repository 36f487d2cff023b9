"""Typed config tree + named presets mirroring the five BASELINE configs: a
copy of crfr/configs.py (stdlib only), so the port reads and writes the
same config JSON and takes the same ``key=value`` overrides.

The five presets correspond 1:1 to BASELINE.json ``configs``:
  1. ``lfw_ir50_16px``     — LFW verification, IR-50, 16×16→112 probe degradation
  2. ``scface``            — SCface d1/d2/d3 identification vs HR mugshot gallery
  3. ``tinyface_survface`` — native-LR open-set identification (rank-1, TPIR@FPIR)
  4. ``casia_arcface``     — CASIA-WebFace ArcFace training w/ random multi-res aug
  5. ``ms1m_ijbc``         — MS1M-scale training (class-sharded head) + IJB-C eval
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


# ---------------------------------------------------------------------------
# Leaf configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshCfg:
    """Device-mesh layout. Axis names are the single source of truth for every
    sharding annotation in the framework (crfr/parallel/mesh.py)."""

    data: int = 1          # DP degree (batch axis)
    model: int = 1         # class-shard degree for the ArcFace head (PartialFC)
    axis_data: str = "data"
    axis_model: str = "model"


@dataclass(frozen=True)
class DataCfg:
    image_size: int = 112
    channels: int = 3
    # Degradation augmentation (BASELINE: "bicubic down-sample/up-sample
    # resolution-degradation augmentation"). ``degrade_sizes`` for training is a
    # range; eval configs pin a single size (e.g. 16 for the LFW-LR protocol).
    degrade_min: int = 8
    degrade_max: int = 112
    # True: every sample draws its own random resolution (reference
    # semantics, batched-matmul einsum); False: one resolution per batch
    # (single shared operator — marginally cheaper).
    per_sample_degrade: bool = True
    eval_degrade_size: int | None = None     # None → no degradation at eval
    # Bicubic semantics. 'pil' (a=-0.5, antialias on downscale) or 'cv2'
    # (a=-0.75, no antialias). Reference semantics unknown (mount empty —
    # SURVEY.md §7 hard part #1), so both are first-class and pinned by goldens.
    resize_mode: str = "pil"
    # Normalization: (x - 127.5) / 128.0, the insightface/face.evoLVe
    # convention named by the BASELINE contract ("mean/std normalization").
    norm_mean: float = 127.5
    norm_std: float = 128.0
    random_flip: bool = True
    num_classes: int = 10572               # CASIA-WebFace default
    train_records: str = ""
    eval_pairs: str = ""


@dataclass(frozen=True)
class ModelCfg:
    backbone: str = "ir_50"                # ir_18|ir_34|ir_50|ir_100|ir_152 (+ _se)
    embedding_dim: int = 512
    dropout: float = 0.4
    # bf16 activations/conv compute with f32 params & BN statistics — the
    # TPU-native mixed-precision policy (MXU wants bf16 inputs).
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    input_size: int = 112
    # Rematerialize residual blocks on the backward pass (jax.checkpoint):
    # trades ~33% more FLOPs for O(depth) less activation HBM — the lever
    # for IR-152 / batch-1024-scale training on a fixed-HBM chip.
    remat: bool = False


@dataclass(frozen=True)
class LossCfg:
    head: str = "arcface"                  # arcface|cosface|sphereface|normsoftmax
    scale: float = 64.0                    # s
    margin: float = 0.5                    # m (additive angular)
    easy_margin: bool = False
    # CE implementation: 'auto' → sharded when mesh.model>1, streaming when
    # num_classes>ce_streaming_threshold on one chip, else dense.
    ce_impl: str = "auto"                  # auto|dense|streaming|sharded
    ce_streaming_threshold: int = 32768
    ce_block: int = 8192                   # class-block size for streaming
    # Residual knowledge distillation (the paper's titular contribution).
    distill_weight: float = 0.0            # λ · ‖(student+residual) − teacher‖²
    # SR / hallucination losses (prior-aided GAN).
    sr_pixel_weight: float = 1.0
    sr_adv_weight: float = 1e-3
    sr_identity_weight: float = 1e-2
    sr_prior_weight: float = 1.0
    sr_perceptual_weight: float = 0.0   # recognition-feature perceptual term


@dataclass(frozen=True)
class TrainCfg:
    batch_size: int = 512
    epochs: int = 24
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_steps: int = 1000
    schedule: str = "step"                 # step (reference) | cosine
    lr_drop_epochs: tuple[int, ...] = (10, 18, 22)
    lr_drop_factor: float = 0.1
    seed: int = 42
    log_every: int = 100
    eval_every_steps: int = 2000
    checkpoint_every_steps: int = 2000
    checkpoint_dir: str = "/tmp/crfr_ckpt"
    keep_checkpoints: int = 3
    grad_clip_norm: float | None = None


@dataclass(frozen=True)
class EvalCfg:
    protocol: str = "verification"         # verification|identification|ijbc
    n_folds: int = 10
    flip_fusion: str = "sum"               # sum|concat — flip-TTA feature fusion
    far_targets: tuple[float, ...] = (1e-3, 1e-2)
    fpir_targets: tuple[float, ...] = (1e-2, 1e-1)   # open-set TPIR@FPIR
    batch_size: int = 512
    gallery_block: int = 0                 # blockwise P·Gᵀ tile; 0 = auto
                                           # (sized from probe count, see
                                           # eval.identification.topk_matches)


@dataclass(frozen=True)
class Config:
    name: str = "default"
    mesh: MeshCfg = field(default_factory=MeshCfg)
    data: DataCfg = field(default_factory=DataCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    eval: EvalCfg = field(default_factory=EvalCfg)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, Mapping):
                kw = {}
                for f in dataclasses.fields(tp):
                    if f.name in val:
                        kw[f.name] = build(f.type, val[f.name])
                return tp(**kw)
            if isinstance(val, list):
                return tuple(val)
            return val

        sub = {
            "mesh": MeshCfg, "data": DataCfg, "model": ModelCfg,
            "loss": LossCfg, "train": TrainCfg, "eval": EvalCfg,
        }
        kw: dict[str, Any] = {}
        for k, v in d.items():
            if k in sub:
                kw[k] = build(sub[k], v)
            elif k == "name":
                kw[k] = v
        return cls(**kw)

    def override(self, **updates: Any) -> "Config":
        """Dotted-path overrides: cfg.override(**{'train.lr': 0.01})."""
        d = self.to_dict()
        for key, val in updates.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = val
        out = Config.from_dict(d)
        return dataclasses.replace(out, name=self.name)


# ---------------------------------------------------------------------------
# Presets — the five BASELINE configs
# ---------------------------------------------------------------------------


def lfw_ir50_16px() -> Config:
    """BASELINE config 1: LFW verification, IR-50, 16×16→112 bicubic probe
    degradation (the CPU-runnable accuracy reference)."""
    return Config(
        name="lfw_ir50_16px",
        data=DataCfg(eval_degrade_size=16, resize_mode="pil"),
        model=ModelCfg(backbone="ir_50"),
        eval=EvalCfg(protocol="verification", n_folds=10),
    )


def scface() -> Config:
    """BASELINE config 2: SCface surveillance identification — d1/d2/d3
    low-res probes vs HR mugshot gallery (closed set, rank-1/CMC)."""
    return Config(
        name="scface",
        data=DataCfg(eval_degrade_size=None),
        model=ModelCfg(backbone="ir_50"),
        eval=EvalCfg(protocol="identification"),
    )


def tinyface_survface() -> Config:
    """BASELINE config 3: TinyFace / QMUL-SurvFace native low-resolution
    open-set identification (rank-1, TPIR@FPIR)."""
    return Config(
        name="tinyface_survface",
        data=DataCfg(eval_degrade_size=None),
        model=ModelCfg(backbone="ir_50"),
        eval=EvalCfg(protocol="identification", fpir_targets=(1e-2, 1e-1, 0.3)),
    )


def casia_arcface() -> Config:
    """BASELINE config 4: CASIA-WebFace ArcFace training with random
    multi-resolution degradation augmentation."""
    return Config(
        name="casia_arcface",
        data=DataCfg(num_classes=10572, degrade_min=8, degrade_max=112),
        model=ModelCfg(backbone="ir_50"),
        train=TrainCfg(batch_size=512, epochs=24),
    )


def ms1m_ijbc() -> Config:
    """BASELINE config 5: MS1M-scale training (class-sharded ArcFace head over
    the mesh, PartialFC-style) + IJB-C 1:1/1:N eval."""
    return Config(
        name="ms1m_ijbc",
        mesh=MeshCfg(data=4, model=2),
        data=DataCfg(num_classes=85742, degrade_min=8, degrade_max=112),
        model=ModelCfg(backbone="ir_100"),
        train=TrainCfg(batch_size=1024, epochs=20, lr_drop_epochs=(8, 14, 18)),
        eval=EvalCfg(protocol="ijbc"),
    )


PRESETS = {
    "lfw_ir50_16px": lfw_ir50_16px,
    "scface": scface,
    "tinyface_survface": tinyface_survface,
    "casia_arcface": casia_arcface,
    "ms1m_ijbc": ms1m_ijbc,
}


def parse_overrides(overrides: Sequence[str]) -> dict[str, Any]:
    """'key=value' strings → {dotted key: typed value} (JSON-typed when the
    value parses as JSON, raw string otherwise)."""
    kv: dict[str, Any] = {}
    for item in overrides:
        k, _, v = item.partition("=")
        kv[k] = json.loads(v) if _looks_like_json(v) else v
    return kv


def get_config(name: str, overrides: Sequence[str] = ()) -> Config:
    """Look up a preset and apply ``key=value`` CLI-style overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    kv = parse_overrides(overrides)
    return cfg.override(**kv) if kv else cfg


def _looks_like_json(v: str) -> bool:
    try:
        json.loads(v)
        return True
    except (ValueError, TypeError):
        return False
