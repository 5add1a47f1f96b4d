"""What every cell of the benchmark shares.

Nothing here imports ``sks_tpu_torch``: the generators, the plain references,
the trace reader and the roofline counts are the yardstick, and the program
is what they measure.
"""
