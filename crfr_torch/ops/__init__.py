"""Preprocessing ops and the hand-written CUDA kernels behind them. Importing
the package registers the custom ops of ``fused_preprocess``."""

from crfr_torch.ops import fused_preprocess  # noqa: F401

from crfr_torch.ops.similarity import (  # noqa: F401
    REFERENCE_LANDMARKS_112,
    REFERENCE_LANDMARKS_96x112,
    similarity_transform,
    umeyama_transform,
)
from crfr_torch.ops.warp import warp_affine  # noqa: F401
