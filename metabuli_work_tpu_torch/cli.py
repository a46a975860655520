"""Command-line interface of the torch package: `build` and `classify`
(single-end, paired-end and long reads), with the reference CLI's flag
spelling (reference src/MetabuliBase.cpp:47-351).

    python -m metabuli_work_tpu_torch.cli classify reads.fq DB OUT job \\
        --seq-mode 1 [--device cuda|cpu]
    python -m metabuli_work_tpu_torch.cli classify r1.fq r2.fq DB OUT job \\
        --seq-mode 2
    python -m metabuli_work_tpu_torch.cli classify long.fq DB OUT job \\
        --seq-mode 3

The second read file is used with --seq-mode 2 only; --seq-mode 2 with
one file classifies it unpaired.  classify runs on the CUDA card unless
--device cpu is given.  --hbm-gb G keeps an index larger than G/2 GiB on
the host and streams it through the device in range passes.  --devices
N classifies over a (dp, db) mesh of N cards (0, the default: all
visible cards, a mesh when there is more than one; 1: one card).
"""

import argparse
import sys
import time


def _add_classify_args(p):
    p.add_argument("--seq-mode", type=int, default=2,
                   help="1 single-end, 2 paired-end (two read files), "
                        "3 long reads")
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--min-sp-score", type=float, default=0.0)
    p.add_argument("--min-cons-cnt", type=int, default=4)
    p.add_argument("--min-cons-cnt-euk", type=int, default=9)
    p.add_argument("--tie-ratio", type=float, default=0.95)
    p.add_argument("--mask", type=int, default=0, dest="mask_mode")
    p.add_argument("--mask-prob", type=float, default=0.9)
    p.add_argument("--accession-level", type=int, default=0)
    p.add_argument("--em", action="store_true")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--print-lineage", action="store_true")
    p.add_argument("--print-timers", action="store_true",
                   help="print per-stage timing table after classification")
    p.add_argument("--hbm-gb", type=float, default=0.0, dest="hbm_budget_gb",
                   help="device-memory budget (GiB) for the resident index; "
                        "larger indexes stream in range passes (the "
                        "device-memory analogue of the reference --max-ram). "
                        "0 = keep the whole index resident")
    p.add_argument("--devices", type=int, default=0,
                   help="device count for multi-device classify: 0 = all "
                        "visible cards (mesh mode when >1), 1 = force a "
                        "single card")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device step runs (default: the CUDA card)")


def cmd_build(args):
    from .index.builder import build_database

    t0 = time.time()
    index = build_database(
        args.dbdir, args.fasta_list, args.acc2taxid, args.taxonomy_dir,
        syncmer=bool(args.syncmer), smer_len=args.smer_len,
        mask_mode=args.mask_mode, mask_prob=args.mask_prob,
        max_ram_gb=args.max_ram, db_name=args.db_name, threads=args.threads)
    print(f"DB creation completed ({time.time()-t0:.1f}s)")
    print(f"Total k-mer count   : {index.size}")


def cmd_classify(args):
    from .classify.pipeline import Classifier, ClassifyParams
    from .report import reporter
    from .utils.timing import rss_gb

    params = ClassifyParams(
        seq_mode=args.seq_mode,
        min_score=args.min_score,
        min_sp_score=args.min_sp_score,
        min_cons_cnt=args.min_cons_cnt,
        min_cons_cnt_euk=args.min_cons_cnt_euk,
        tie_ratio=args.tie_ratio,
        mask_mode=args.mask_mode,
        mask_prob=args.mask_prob,
        accession_level=args.accession_level,
        em=args.em,
        batch_size=args.batch_size,
        hbm_budget_gb=args.hbm_budget_gb,
    )
    t0 = time.time()
    mesh = None
    if args.devices != 1 and args.device == "cuda":
        import torch

        avail = torch.cuda.device_count()
        want = avail if args.devices == 0 else min(args.devices, avail)
        if want > 1:
            from .parallel.sharding import make_mesh

            mesh = make_mesh(want)
            print(f"Multi-chip mesh: dp={mesh.shape['dp']} x "
                  f"db={mesh.shape['db']}")
    clf = Classifier(args.dbdir, params, mesh=mesh, device=args.device)
    print(f"Database loaded: {clf.index.size} k-mers ({time.time()-t0:.1f}s)")

    t0 = time.time()
    reads2 = args.reads2 if args.seq_mode == 2 else None
    results = clf.classify_file(
        args.reads1, reads2,
        progress=lambda n: print(f"Processed read count   : {n}"))
    dt = time.time() - t0
    print(f"Classified {len(results)} reads in {dt:.2f}s "
          f"({len(results)/max(dt,1e-9):.0f} reads/s)")
    print(f"Total k-mer match count: {clf.total_match_cnt}")
    if args.print_timers:
        print(clf.timer.report())
        print(f"peak_rss_gb\t{rss_gb():.2f}")

    paths = reporter.write_all(args.outdir, args.jobid, results, clf.taxonomy,
                               print_lineage=args.print_lineage)
    for p in paths:
        print(f"Wrote {p}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="metabuli-torch",
        description="metagenomic classifier on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("build", help="create reference k-mer database")
    p.add_argument("dbdir")
    p.add_argument("fasta_list", help="file listing reference FASTA paths")
    p.add_argument("acc2taxid", help="accession2taxid mapping")
    p.add_argument("--taxonomy-dir", required=True, help="NCBI taxdump directory")
    p.add_argument("--syncmer", type=int, default=0)
    p.add_argument("--smer-len", type=int, default=5)
    p.add_argument("--mask", type=int, default=1, dest="mask_mode")
    p.add_argument("--mask-prob", type=float, default=0.9)
    p.add_argument("--max-ram", type=float, default=32.0)
    p.add_argument("--db-name", default="")
    p.add_argument("--threads", type=int, default=1,
                   help="extraction worker processes (0 = all cores)")
    p.set_defaults(func=cmd_build)

    p = sub.add_parser("classify", help="classify reads against a database")
    p.add_argument("reads1")
    p.add_argument("reads2", nargs="?", default=None)
    p.add_argument("dbdir")
    p.add_argument("outdir")
    p.add_argument("jobid")
    _add_classify_args(p)
    p.set_defaults(func=cmd_classify)

    args = parser.parse_args(argv)
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
