"""Benchmark sweeps of the PyTorch port (``sweep``)."""
