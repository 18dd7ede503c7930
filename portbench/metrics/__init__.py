"""One reader per metric, in a file named after the metric: ``read(run)``
returns the metric's value from a :class:`portbench.harness.RunRecord`,
or None where it finds nothing to read."""
