"""Utilities: synthetic correspondences, carry-across helpers, per-pair
random streams, numeric-health checks, operation counts and profiling."""
