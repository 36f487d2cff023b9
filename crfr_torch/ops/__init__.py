"""Preprocessing ops and the hand-written CUDA kernels behind them."""

from crfr_torch.ops.similarity import (  # noqa: F401
    REFERENCE_LANDMARKS_112,
    REFERENCE_LANDMARKS_96x112,
    similarity_transform,
    umeyama_transform,
)
from crfr_torch.ops.warp import warp_affine  # noqa: F401
