"""Preprocessing ops and the hand-written CUDA kernels behind them."""
