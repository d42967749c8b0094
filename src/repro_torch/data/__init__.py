"""Deterministic synthetic data pipeline."""
