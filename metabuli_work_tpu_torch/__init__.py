"""PyTorch + CUDA port of metabuli_work_tpu (the JAX package beside it,
which stays the reference): build (6-frame, ORF, CDS, accession-level,
resumable), updateDB, and classify in all three sequence modes on one
card or a (dp, db) mesh, on native or reference-format databases, with
--em and every probe layout; filter, read grouping, the UniRef tools,
and the taxonomy, report and grading tools."""
