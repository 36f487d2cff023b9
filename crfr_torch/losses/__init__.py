from crfr_torch.losses.arcface import (MarginHead, margin_logits, softmax_ce,
                                       streaming_margin_ce)
from crfr_torch.losses.distill import feature_l2, residual_kd_loss

__all__ = ["MarginHead", "feature_l2", "margin_logits", "residual_kd_loss", "softmax_ce",
           "streaming_margin_ce"]
