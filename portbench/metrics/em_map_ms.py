"""em_map_ms: host ms a batch in the program's `em_map` spans (inside
`em`: the mapping file's write and reload, each mapping's weight and
species index), counted as em_ms counts its spans."""

from portbench.metrics import em_ms


def read(run):
    return em_ms.per_batch(run, "em_map")
