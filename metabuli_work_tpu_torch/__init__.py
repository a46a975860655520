"""PyTorch + CUDA port of metabuli_work_tpu (the JAX package beside it,
which stays the reference).  Single-end classify on a resident,
single-device index; see ROADMAP.md for what is still to come."""
