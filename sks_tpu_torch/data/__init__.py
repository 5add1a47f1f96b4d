"""Data: the planar-sequence renderer (``images.planar_sequence``)."""
