"""The benchmark of ``sks_tpu_torch`` on an NVIDIA H100.

``run.py`` is the entry point.  Everything a cell is made of is found by
name from ``BENCHMARK.json`` at the checkout's root: a configuration
(``configs/<config>.json`` and its driver ``configs/<config>.py``), a
traffic mix (``traffic/<traffic>.json``), the end-to-end metrics
(``e2e/<metric>.py``) and the per-layer metrics (``metrics/<metric>.py``).
``core/`` holds what every cell shares: the input generators, the plain
references, the trace reader and the frozen roofline counts.
"""
