"""Benchmarks of the port, timed on a CUDA card (``table8``)."""
