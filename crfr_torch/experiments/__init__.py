"""Composed experiments (crfr/experiments).

headline: HR teacher → prior-aided SR GAN → student with residual KD →
cross-resolution verification and identification, as one run.
"""

from crfr_torch.experiments.headline import HeadlineCfg, run_headline  # noqa: F401
