"""One reader a per-layer metric, ``<metric name>.py``, found by the name
in ``BENCHMARK.json``.  Each defines ``read(run)`` over the traced run's
:class:`portbench.harness.record.RunRecord` and returns the number, or
None when the run holds nothing for it to read (the metric is then left out
of the result line)."""
