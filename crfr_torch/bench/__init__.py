"""Throughput measurement on the CUDA device."""
