"""Metrics writer."""
