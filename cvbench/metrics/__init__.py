"""Per-layer metrics, one module each, found by the metric's name in
``BENCHMARK.json``. Each has ``read(trace)`` over a
:class:`cvbench.trace.Trace` of the traced window and returns a number,
or None where the trace holds nothing for it to read."""
