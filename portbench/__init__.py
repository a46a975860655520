"""portbench: the benchmark of metabuli_work_tpu_torch on one CUDA card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

See README.md.  Nothing here imports JAX or the JAX package."""
