"""Utilities: synthetic correspondences and carry-across helpers."""
