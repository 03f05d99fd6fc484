"""Datasets (seeded NumPy generators emitting AER buffers)."""
