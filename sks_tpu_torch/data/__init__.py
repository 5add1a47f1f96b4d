"""Data: the planar renderers (``images.planar_sequence``, ``planar_pair``,
``planar_pair_boxes``)."""
