"""One reader an end-to-end metric, ``<metric name>.py``, found by the name
in ``BENCHMARK.json``: ``read(run)`` over the untraced run's
:class:`portbench.harness.bench.RunRecord`, from the host clock."""
