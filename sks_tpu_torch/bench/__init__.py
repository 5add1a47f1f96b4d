"""Benchmarks of the port, timed on a CUDA card: the headline
(``headline``), Table 8 (``table8``, ``fp64_table``), the image-grounded
benchmark (``real_pipeline``, ``wall_real``), the pipeline's pairs/s
(``pipeline_fps``) and the kernels' instruments."""
