"""Training: the step and loop, checkpoints, the device feed."""
