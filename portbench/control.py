"""The control of the check (check.py).

    python -m portbench.control --workload <cell> --seeds 1,2,3

The control is the plain reference put in the program's place and
computed in the nearest precision below the float32 the configuration
states: bfloat16 scores (reference/scorer.py, precision "bfloat16").
For each seed it draws the cell's timed sample as a run does (stream
2; --queries N draws N queries instead of the mix's `sample_queries`),
picks the queries a run checks (stream 3) and prints
how many of them the control answers otherwise than the float32
reference: the reading that has to fail the limit of
`mismatched_reads`.  It needs no card: the reference runs on the host.
The benchmark's own runs never run it.
"""

import argparse
import sys

from portbench import catalog, check
from portbench import run as bench_run


def control_readings(cfg, traffic, seeds, n_queries, cache):
    """{seed: mismatched queries of the bfloat16 control}."""
    genomes, tax = bench_run.load_genomes(cfg, cache)
    parent, ranks, _, _, species = tax
    values, sp = check.reference_index(
        cfg, genomes, species,
        bench_run.ref_cache(cache, cfg))
    ref = check.make_reference(cfg, traffic, values, sp, parent, ranks)
    ctl = check.make_reference(cfg, traffic, values, sp, parent, ranks,
                               precision="bfloat16")
    gen = catalog.generator(traffic["kind"])
    out = {}
    for seed in seeds:
        run = bench_run.Run(cfg, traffic, seed, 0, False, "cpu", None)
        sample = gen.draw(genomes, traffic, n_queries, run.rng(2))
        idx = check.pick(sample, traffic["check_reads"], run.rng(3))
        answers = [(i, check.answer(ctl.classify(sample.mate(i, 1),
                                                 sample.mate(i, 2))))
                   for i in idx]
        out[seed] = check.compare(sample, answers, ref)[0]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=None)
    args = ap.parse_args(argv)
    bench = catalog.benchmark()
    cell = catalog.cell(bench, args.workload)
    cfg = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    got = control_readings(cfg, traffic, seeds,
                           args.queries or traffic["sample_queries"],
                           bench_run.cache_root())
    for seed, bad in got.items():
        print(f"control {args.workload} seed {seed}: mismatched_reads "
              f"{bad} of {traffic['check_reads']}+1 checked (limit "
              f"{check.LIMITS['mismatched_reads']})")
    print(f"control {args.workload}: least reading {min(got.values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
