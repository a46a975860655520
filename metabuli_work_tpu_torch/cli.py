"""Command-line interface of the torch package: `build`, `classify`
(single-end, paired-end and long reads), the database subcommands
(`convertDB`, `validatedb`, `database-report`, `printDeltaIdx`,
`printInfo`, `expand_diffidx`) and `validate-input`, with the reference
CLI's flag spelling (reference src/MetabuliBase.cpp:47-351) and the JAX
package's output text and exit codes.

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
visible cards, a mesh when there is more than one; 1: one card).  A
database built by the reference binary (diffIdx/info or deltaIdx.mtbl
with a taxonomyDB blob) is classified as it is: it is imported on
first use (index/format.load_reference_db).  --em adds the EM
abundance re-estimation files; --validate-input checks the read files
first; --profile-dir writes a torch.profiler trace of the classify
step.
"""

import argparse
import json
import os
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
    p.add_argument("--max-ram", type=int, default=128)
    p.add_argument("--print-timers", action="store_true",
                   help="print per-stage timing table after classification")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace to this directory")
    p.add_argument("--validate-input", action="store_true",
                   help="structurally validate FASTA/FASTQ inputs first")
    # reference-CLI compatibility flags
    p.add_argument("--threads", type=int, default=0,
                   help="accepted for reference compatibility; host "
                        "threading is managed by the pipeline")
    p.add_argument("--hamming-margin", type=int, default=0,
                   help="accepted for reference compatibility; the "
                        "reference stores but never applies it "
                        "(KmerMatcher.cpp:29 vs compareDna:1136)")
    p.add_argument("--match-per-kmer", type=int, default=4,
                   help="initial per-kmer candidate budget; the probe "
                        "doubles its cap automatically on overflow "
                        "(reference retries with +=4, Classifier.cpp:128)")
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
    p.add_argument("--reduced-aa", type=int, default=0,
                   help="15-letter alphabet mode (DBs built with it are "
                        "not supported yet)")


def cmd_build(args):
    from .index.builder import build_database

    t0 = time.time()
    index = build_database(
        args.dbdir, args.fasta_list, args.acc2taxid, args.taxonomy_dir,
        syncmer=bool(args.syncmer), smer_len=args.smer_len,
        mask_mode=args.mask_mode, mask_prob=args.mask_prob,
        max_ram_gb=args.max_ram,
        write_reference_format=args.reference_format,
        db_name=args.db_name, threads=args.threads)
    print(f"DB creation completed ({time.time()-t0:.1f}s)")
    print(f"Total k-mer count   : {index.size}")


def cmd_classify(args):
    from .classify.pipeline import Classifier, ClassifyParams
    from .report import reporter
    from .utils.timing import maybe_torch_profile, rss_gb

    if args.validate_input:
        from .io.validate import validate_input

        for path in filter(None, [args.reads1, args.reads2]):
            ok, msg = validate_input(path)
            print(f"validate {path}: {'OK' if ok else 'INVALID'} ({msg})")
            if not ok:
                return 1

    if args.reduced_aa:
        print("--reduced-aa 1 (15-letter alphabet) databases are not "
              "supported yet", file=sys.stderr)
        return 1

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
    with maybe_torch_profile(args.profile_dir):
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
    if args.em:
        from .classify.em import run_em

        run_em(results, clf, args.outdir, args.jobid)
    for p in paths:
        print(f"Wrote {p}")


def cmd_validatedb(args):
    """Check DB file presence + diffIdx/info consistency (reference
    src/util/validateDatabase.cpp:17-141)."""
    import numpy as np

    from .index.delta import count_entries

    ok = True
    for f in ("kmers.npy", "infos.npy", "species.npy", "taxonomy.npz",
              "db.meta.json"):
        if not os.path.exists(os.path.join(args.dbdir, f)):
            print(f"MISSING {f}")
            ok = False
    if ok:
        values = np.load(os.path.join(args.dbdir, "kmers.npy"))
        infos = np.load(os.path.join(args.dbdir, "infos.npy"))
        if len(values) != len(infos):
            print(f"MISMATCH kmers={len(values)} infos={len(infos)}")
            ok = False
        if len(values) > 1 and not np.all(values[1:] >= values[:-1]):
            print("NOT SORTED")
            ok = False
    diff_path = os.path.join(args.dbdir, "diffIdx")
    if os.path.exists(diff_path):
        chunks = np.fromfile(diff_path, dtype="<u2")
        info_sz = os.path.getsize(os.path.join(args.dbdir, "info")) // 4
        n = count_entries(chunks)
        if n != info_sz:
            print(f"REFERENCE-FORMAT MISMATCH diffIdx entries={n} "
                  f"info={info_sz}")
            ok = False
    print("Database is valid." if ok else "Database is INVALID.")
    return 0 if ok else 1


def cmd_database_report(args):
    import numpy as np

    from .index.format import load_index

    index = load_index(args.dbdir)
    print(json.dumps(index.meta, indent=2))
    uniq, counts = np.unique(index.species, return_counts=True)
    print(f"kmer_count\t{index.size}")
    print(f"species_count\t{len(uniq)}")
    for s, c in sorted(zip(uniq.tolist(), counts.tolist()),
                       key=lambda x: -x[1])[:50]:
        print(f"{index.taxonomy.orig_of(s)}\t{index.taxonomy.name_of(s)}\t{c}")


def cmd_print_delta_idx(args):
    import numpy as np

    from .index.delta import decode_deltas

    chunks = np.fromfile(os.path.join(args.dbdir, "diffIdx"), dtype="<u2")
    values = decode_deltas(chunks)
    lim = args.limit if args.limit > 0 else len(values)
    for v in values[:lim]:
        print(v)


def cmd_print_info(args):
    import numpy as np

    infos = np.fromfile(os.path.join(args.dbdir, "info"), dtype="<u4")
    lim = args.limit if args.limit > 0 else len(infos)
    for v in infos[:lim]:
        print(v & 0x7FFFFFFF)


def cmd_expand_diffidx(args):
    import numpy as np

    from .index.delta import decode_deltas

    chunks = np.fromfile(args.diffidx, dtype="<u2")
    values = decode_deltas(chunks)
    out = args.output or (args.diffidx + ".expanded")
    values.astype("<u8").tofile(out)
    print(f"Wrote {len(values)} uint64 values to {out}")


def cmd_convert_db(args):
    """Convert a reference-format DB (diffIdx/info/split or deltaIdx.mtbl)
    to the native sorted-array layout.  The taxonomy: the DB's
    taxonomy.npz, else --taxonomy-dir's taxdump, else the DB's own
    taxonomyDB blob (whose internal ids its info stream carries), else a
    taxdump in the DB directory.  db.parameters, when present, becomes
    the native meta (syncmer, k-mer format, ...)."""
    from .index.format import (import_reference_format,
                               load_reference_taxonomy, read_db_parameters,
                               save_index)
    from .taxonomy import Taxonomy

    npz = os.path.join(args.dbdir, "taxonomy.npz")
    blob = os.path.join(args.dbdir, "taxonomyDB")
    params = os.path.join(args.dbdir, "db.parameters")
    if os.path.exists(npz):
        tax = Taxonomy.load(npz)
    elif args.taxonomy_dir is None and os.path.exists(blob):
        tax = load_reference_taxonomy(blob)
    else:
        tax = Taxonomy.from_taxdump(args.taxonomy_dir or args.dbdir)
    meta = read_db_parameters(params) if os.path.exists(params) else None
    index = import_reference_format(args.dbdir, tax, meta)
    save_index(args.output or args.dbdir, index)
    print(f"convertDB: {index.size} k-mers -> {args.output or args.dbdir}")


def cmd_validate_input(args):
    from .io.validate import validate_input

    ok, msg = validate_input(args.path)
    print(f"{'OK' if ok else 'INVALID'}: {msg}")
    return 0 if ok else 1


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
    p.add_argument("--reference-format", action="store_true",
                   help="also write reference-compatible diffIdx/info/split")
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

    p = sub.add_parser("validatedb")
    p.add_argument("dbdir")
    p.set_defaults(func=cmd_validatedb)

    p = sub.add_parser("database-report")
    p.add_argument("dbdir")
    p.set_defaults(func=cmd_database_report)

    p = sub.add_parser("printDeltaIdx")
    p.add_argument("dbdir")
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(func=cmd_print_delta_idx)

    p = sub.add_parser("printInfo")
    p.add_argument("dbdir")
    p.add_argument("--limit", type=int, default=100)
    p.set_defaults(func=cmd_print_info)

    p = sub.add_parser("expand_diffidx")
    p.add_argument("diffidx")
    p.add_argument("--output", default=None)
    p.set_defaults(func=cmd_expand_diffidx)

    p = sub.add_parser("convertDB",
                       help="reference-format DB -> native layout")
    p.add_argument("dbdir")
    p.add_argument("--taxonomy-dir", default=None)
    p.add_argument("--output", default=None)
    p.set_defaults(func=cmd_convert_db)

    p = sub.add_parser("validate-input",
                       help="structurally validate FASTA/FASTQ")
    p.add_argument("path")
    p.set_defaults(func=cmd_validate_input)

    args = parser.parse_args(argv)
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
