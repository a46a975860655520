"""Per-layer metric readers, one module a metric, found by the metric's
name (catalog.metric_reader).  Each has read(run) -> a number, or None
when the run holds nothing for it to read (the metric is then left out
of the result line)."""
