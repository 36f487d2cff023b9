"""Embedding extraction and the verification protocol."""
