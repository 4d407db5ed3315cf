"""One reader per metric, in a file named after the metric
(``<name>.py``), found by the name in ``BENCHMARK.json``.  A reader's
``read(run)`` returns the metric's number, or None where the run has
nothing for it to read (the harness then leaves the metric out)."""
