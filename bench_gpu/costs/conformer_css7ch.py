"""Model operations of one forward of the 7-channel CSS Conformer: the
1-channel Conformer's count (``conformer_css16x256.py``), which reads the
embedding's width from ``widths["idim"]`` (1799 here). The IPD features
and the DOA merge, which run in the same captured replay, are not model
work and are not counted. The harness finds a configuration's count by
the configuration's name, hence this file."""

from bench_gpu.costs.conformer_css16x256 import forward_flops  # noqa: F401
