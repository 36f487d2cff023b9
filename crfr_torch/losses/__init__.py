from crfr_torch.losses.arcface import (MarginHead, margin_logits, softmax_ce,
                                       streaming_margin_ce)

__all__ = ["MarginHead", "margin_logits", "softmax_ce", "streaming_margin_ce"]
