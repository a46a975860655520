"""End-to-end metric readers, one module a metric, found by name
(catalog.endtoend_reader): read(run) -> a number taken on the host's
clock by the benchmark itself, or None where the cell has none."""
