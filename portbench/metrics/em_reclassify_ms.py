"""em_reclassify_ms: host ms a batch in the program's `em_reclassify`
spans (inside `em`: each read reassigned by its posterior, the EM
report, the reclassification's report and results file), counted as
em_ms counts its spans."""

from portbench.metrics import em_ms


def read(run):
    return em_ms.per_batch(run, "em_reclassify")
