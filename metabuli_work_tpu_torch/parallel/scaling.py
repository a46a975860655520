"""Reads/s of the mesh classify path against the number of mesh cells.

Two harnesses:

* measure_scaling — mesh sizes within one process, over an explicit
  device list (virtual CPU cells in the tests, a card's cells or one
  cell per card on the GPU), driving the production mesh classify path
  (classify.pipeline.Classifier with a mesh) on a genome-derived
  synthetic workload.  Cells that share a device run one after another,
  so such a mesh measures the mechanism's cost, not a speed-up.
* measure_distributed / main(--distributed) — the multi-process entry:
  every process runs this module over the global mesh
  (parallel/distributed.py), and process 0 prints the aggregate.

    python -m metabuli_work_tpu_torch.parallel.scaling --devices 1,2,4
    python -m metabuli_work_tpu_torch.parallel.scaling --distributed \\
        --coordinator localhost:29500 --nproc 2 --pid 0
"""

import time

import numpy as np


def _workload(n_species=8, genome_len=20000, batch=256, read_len=150,
              seed=3):
    """Genome-derived index + reads (real matches, real DP work)."""
    from ..index.builder import IndexBuilder
    from ..taxonomy import Taxonomy

    rng = np.random.default_rng(seed)
    parent = [0, 1, 1] + [2] * n_species
    rank = ["no rank", "no rank", "genus"] + ["species"] * n_species
    pool = sorted(set(rank))
    n = len(parent)
    tax = Taxonomy(np.array(parent), np.array([pool.index(r) for r in rank]),
                   np.arange(n), pool, [f"n{i}" for i in range(n)],
                   np.arange(n))
    builder = IndexBuilder(tax, syncmer=False, mask_mode=0)
    genomes = []
    for s in range(n_species):
        g = "".join(rng.choice(list("ACGT"), genome_len))
        genomes.append(g)
        builder.add_sequence(g, 3 + s)
    index = builder.finalize()
    reads = np.zeros((batch, read_len), dtype=np.uint8)
    for i in range(batch):
        g = genomes[i % n_species]
        st = int(rng.integers(0, len(g) - read_len))
        reads[i] = np.frombuffer(g[st:st + read_len].encode(), np.uint8)
    lengths = np.full(batch, read_len, np.int32)
    return index, reads, lengths


def _throughput(clf, reads, lengths, iters):
    """Reads/s of this process's reads over `iters` batches (the host
    clock; classify ends in host reads of every result)."""
    names = [f"r{i}" for i in range(reads.shape[0])]

    def batches():
        for _ in range(iters):
            yield names, reads, lengths, None, None

    t0 = time.perf_counter()
    results = clf.drive_batches(batches())
    dt = time.perf_counter() - t0
    return len(results) / dt


def measure_scaling(device_counts=(1, 2, 4, 8), batch=64, length=150,
                    iters=3, genome_len=20000, devices=None):
    """Production-path reads/s per mesh size in one process: mesh size n
    takes the first n of `devices` (default: the visible cards; sizes
    beyond the list are skipped).  Returns {n: reads/s}."""
    from ..classify.pipeline import Classifier, ClassifyParams
    from .sharding import make_mesh, visible_cards

    devs = visible_cards() if devices is None else list(devices)
    index, reads, lengths = _workload(batch=batch, read_len=length,
                                      genome_len=genome_len)
    params = ClassifyParams(seq_mode=1, min_score=0.15, min_sp_score=0.5,
                            batch_size=batch)
    results = {}
    for n in device_counts:
        if n > len(devs):
            continue
        mesh = make_mesh(devices=devs[:n]) if n > 1 else None
        clf = Classifier.from_memory(index, params, mesh=mesh,
                                     device=None if mesh else devs[0])
        _throughput(clf, reads, lengths, 1)          # first-use warm-up
        results[n] = _throughput(clf, reads, lengths, iters)
    base = results.get(device_counts[0])
    print("devices\treads_per_s\tspeedup\tefficiency")
    for n, rate in results.items():
        sp = rate / base if base else 0
        print(f"{n}\t{rate:.0f}\t{sp:.2f}\t{sp / (n / device_counts[0]):.2f}")
    return results


def measure_distributed(batch_per_host=256, length=150, iters=3,
                        genome_len=20000, local_devices=None):
    """Global-mesh reads/s (call on EVERY process, after
    init_distributed).  Returns (global reads/s, this process's)."""
    import torch.distributed as dist

    from ..classify.pipeline import Classifier, ClassifyParams
    from .distributed import make_global_mesh

    mesh = make_global_mesh(local_devices=local_devices)
    n_proc = dist.get_world_size()
    batch = batch_per_host * mesh.shape["dp"]
    index, reads, lengths = _workload(batch=batch, read_len=length,
                                      genome_len=genome_len)
    params = ClassifyParams(seq_mode=1, min_score=0.15, min_sp_score=0.5,
                            batch_size=batch)
    clf = Classifier.from_memory(index, params, mesh=mesh)
    _throughput(clf, reads, lengths, 1)              # warm-up
    local = _throughput(clf, reads, lengths, iters)
    # every process scored batch / n_proc reads in the same wall time
    global_rate = local * n_proc
    if dist.get_rank() == 0:
        print(f"processes={n_proc} mesh={mesh.shape} "
              f"global_reads_per_s={global_rate:.0f} "
              f"per_process={local:.0f}")
    return global_rate, local


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--distributed", action="store_true",
                    help="measure over the global mesh of all processes "
                         "(needs --coordinator/--nproc/--pid or "
                         "MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)")
    ap.add_argument("--coordinator", default=None, help="host:port")
    ap.add_argument("--nproc", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="mesh sizes to measure, over the visible cards")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    if args.distributed:
        from .distributed import init_distributed

        init_distributed(args.coordinator, args.nproc, args.pid)
        measure_distributed(batch_per_host=args.batch, iters=args.iters)
    else:
        counts = tuple(int(x) for x in args.devices.split(","))
        measure_scaling(device_counts=counts, batch=args.batch,
                        iters=args.iters)


if __name__ == "__main__":
    main()
