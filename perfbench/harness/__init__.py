"""The benchmark harness of the PyTorch/CUDA port: one cell, one run.

`BENCHMARK.json` at the root is the one record of the cells and metrics:
a cell's configuration, traffic, chips and why, a metric's unit, layer,
source and what it moves.  The files found by those names hold the rest:
`configs/<config>.json` and `traffic/<traffic>.json` their parameters,
`cells/<cell>.json` the entry the cell's window drives,
`harness/entries/<entry>.py` that kind of call, and `metrics/<metric>.py`
the reader of one metric.  A new cell on an existing entry is data alone."""


class RunError(Exception):
    """The run cannot give a result (exit non-zero, print none)."""
