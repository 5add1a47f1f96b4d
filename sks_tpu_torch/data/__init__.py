"""Data: the planar renderers (``images.planar_sequence``, ``planar_pair``,
``planar_pair_boxes``, ``photo_texture``), the synthetic wall fixture
(``fixture``) and the loader of the reference's real wall matches
(``wall``)."""
