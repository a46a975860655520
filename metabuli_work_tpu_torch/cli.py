"""Command-line interface of the torch package, with the reference CLI's
flag spelling (reference src/MetabuliBase.cpp:47-351) and the JAX
package's output text and exit codes:

- `build` (--orf-prediction, --gene-predictor, --cds-info,
  --accession-level, --resume, --reference-format), `updateDB`,
  `classify` (single-end, paired-end and long reads) and `filter`;
- the database subcommands `convertDB`, `validatedb`, `database-report`,
  `printDeltaIdx`, `printInfo`, `expand_diffidx`, `taxdump` and
  `databases`, and `validate-input`;
- the taxonomy tools `gtdb2taxdump`, `editNames`, `createnewtaxalist`,
  `query2reference`, `filter_by_genus`, `count-common-kmers`,
  `makeAAoffset`, `accession2taxid`, `ictv-format`;
- the report and grading tools `extract`, `grade`, `classifiedRefiner`,
  `maketestsets`, `makeInclusionTestQueries`, `make-virus-benchmark-set`,
  `gradeGroup`, `gradeGroupByCoverage`, `gradeByCoverage`,
  `gradeByCladeSize`, `mapping2taxon`;
- read grouping: `create-common-kmer-list`, `grouping`, `apply-group`;
- the UniRef tools `create-uniref-tree`, `create-uniref-db`,
  `create-unique-kmer-list`, `assign_uniref`, `uniref2taxonomy`.

    python -m metabuli_work_tpu_torch.cli classify reads.fq DB OUT job \\
        --seq-mode 1 [--device cuda|cpu]
    python -m metabuli_work_tpu_torch.cli classify r1.fq r2.fq DB OUT job \\
        --seq-mode 2
    python -m metabuli_work_tpu_torch.cli classify long.fq DB OUT job \\
        --seq-mode 3

The second read file is used with --seq-mode 2 only; --seq-mode 2 with
one file classifies it unpaired.  classify and filter run on the CUDA
card unless --device cpu is given.  --hbm-gb G keeps an index larger
than G/2 GiB on the host and streams it through the device in range
passes.  --devices N classifies over a (dp, db) mesh of N cards (0, the
default: all visible cards, a mesh when there is more than one; 1: one
card).  A database built by the reference binary (diffIdx/info or
deltaIdx.mtbl with a taxonomyDB blob) is classified as it is: it is
imported on first use (index/format.load_reference_db).  --em adds the
EM abundance re-estimation files; --validate-input checks the read
files first; --profile-dir writes a torch.profiler trace of the
classify step.
"""

import argparse
import http.client
import json
import os
import sys
import tarfile
import time
import urllib.request


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
        db_name=args.db_name,
        cds_info_path=args.cds_info,
        orf_prediction=args.orf_prediction,
        threads=args.threads,
        accession_level=bool(args.accession_level),
        gene_predictor=args.gene_predictor,
        resume=args.resume)
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

    paths = reporter.write_all(args.outdir, args.jobid, results, clf.taxonomy,
                               print_lineage=args.print_lineage)
    if args.em:
        from .classify.em import run_em

        run_em(results, clf, args.outdir, args.jobid)
    if args.print_timers:
        print(clf.timer.report())
        print(f"peak_rss_gb\t{rss_gb():.2f}")
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


def cmd_extract(args):
    """Pull reads classified under a clade (reference workflow/extract.cpp)."""
    from .report.extract import extract_reads

    extract_reads(args.classifications, args.reads, args.tax_id, args.dbdir,
                  extract_mode=args.extract_mode)


def cmd_grade(args):
    from .report.grade import grade

    grade(args.classifications, args.answer, args.dbdir, ranks=args.ranks.split(","))


def cmd_filter(args):
    from .classify.filter import filter_reads
    from .classify.pipeline import ClassifyParams

    params = ClassifyParams(
        seq_mode=args.seq_mode, min_score=args.min_score,
        min_sp_score=args.min_sp_score, batch_size=args.batch_size,
    )
    with open(args.contam_list) as f:
        dbs = [ln.strip() for ln in f if ln.strip()]
    filter_reads(args.reads1, dbs, args.outdir, args.jobid, params,
                 args.reads2, device=args.device)


def cmd_refiner(args):
    from .report.refiner import refine

    refine(
        args.classifications, args.dbdir, args.output,
        min_score=args.min_score,
        include_taxids=[int(t) for t in args.include.split(",") if t],
        exclude_taxids=[int(t) for t in args.exclude.split(",") if t],
        rank=args.rank,
    )


def cmd_update_db(args):
    from .index.update import update_database

    index = update_database(args.olddb, args.newdb, args.fasta_list,
                            args.acc2taxid, args.new_taxa, args.max_ram)
    print(f"Updated DB written: {index.size} k-mers")


_PREBUILT_DBS = {
    # name: (approx size, source note) — reference `databases` command
    # (MetabuliBase.cpp:50-59 + data/metabulidatabases.sh); URLs resolve at
    # metabuli.steineggerlab.workers.dev
    "RefSeq_virus": ("8.1 GiB", "RefSeq viral genomes"),
    "RefSeq_prokaryote_virus": ("115.6 GiB", "RefSeq prokaryotes + viruses"),
    "GTDB": ("101 GiB", "GTDB 214.1 species representatives"),
    "RefSeq_release": ("619 GiB", "RefSeq release 224"),
}


# archive file names on the download host differ from the display names
# (data/metabulidatabases.sh case arms)
_PREBUILT_ARCHIVES = {
    "RefSeq_virus": "refseq_virus.tar.gz",
    "RefSeq_prokaryote_virus": "refseq_prokaryote_virus.tar.gz",
    "GTDB": "gtdb.tar.gz",
    "RefSeq_release": "refseq_release.tar.gz",
}


def _download_resumable(url, dest, timeout=30):
    """Stdlib download with byte-range resume (the reference script's
    `curl -C -` / `wget --continue` analogue).  Returns True on success;
    raises URLError/OSError on network failure."""
    part = dest + ".part"
    start = os.path.getsize(part) if os.path.exists(part) else 0
    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
        print(f"resuming at {start / 1e6:.1f} MB")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if start and resp.status == 200:
            start = 0        # server ignored the Range header: restart
        mode = "ab" if start else "wb"
        total = resp.headers.get("Content-Length")
        total = start + int(total) if total else None
        done = start
        with open(part, mode) as f:
            while True:
                chunk = resp.read(1 << 22)
                if not chunk:
                    break
                f.write(chunk)
                done += len(chunk)
                if total:
                    print(f"\r  {done / 1e9:.2f} / {total / 1e9:.2f} GB",
                          end="", flush=True)
        print()
    if total is not None and done != total:
        raise OSError(f"short download: {done} of {total} bytes "
                      f"(re-run to resume)")
    os.replace(part, dest)
    return True


def cmd_databases(args):
    """Reference `databases` workflow (data/metabulidatabases.sh):
    download <archive>.tar.gz with resume, extract into outdir, then
    point the user at convertDB.  Degrades to printed instructions when
    the host has no egress."""
    base = "https://metabuli.steineggerlab.workers.dev"
    if not args.name:
        print("Available prebuilt databases (reference-format; convert with")
        print("`metabuli-torch convertDB` after download):")
        for name, (size, note) in _PREBUILT_DBS.items():
            print(f"  {name:28s} {size:>10s}  {note}")
        print(f"Download from {base}; `databases <name> <outdir>` fetches "
              f"and extracts (resumable).")
        return 0
    if args.name not in _PREBUILT_DBS:
        print(f"Unknown database {args.name}.")
        return 1
    archive = _PREBUILT_ARCHIVES[args.name]
    url = f"{base}/{archive}"
    tmp_dir = args.tmp or args.outdir
    os.makedirs(args.outdir, exist_ok=True)
    os.makedirs(tmp_dir, exist_ok=True)
    tarball = os.path.join(tmp_dir, archive)
    if not os.path.exists(tarball):
        print(f"Downloading {url} -> {tarball} "
              f"(~{_PREBUILT_DBS[args.name][0]})")
        try:
            _download_resumable(url, tarball)
        except (OSError, http.client.HTTPException) as e:
            # no egress / transient failure
            print(f"Download failed ({e}).")
            print(f"Fetch {url} externally (resume supported), place it at")
            print(f"  {tarball}")
            print(f"then re-run: metabuli-torch databases {args.name} "
                  f"{args.outdir}")
            return 1
    else:
        print(f"Archive already present: {tarball}")
    print(f"Extracting into {args.outdir} ...")
    with tarfile.open(tarball) as tf:
        try:
            tf.extractall(args.outdir, filter="data")
        except TypeError:      # python < 3.12 without the filter kwarg
            tf.extractall(args.outdir)
    print(f"Done.  Convert to the native layout with:")
    print(f"  metabuli-torch convertDB {args.outdir}")
    return 0


def cmd_gtdb2taxdump(args):
    from .taxonomy.gtdb import gtdb_to_taxdump

    gtdb_to_taxdump(args.tsv, args.outdir, start_taxid=args.start_taxid)


def cmd_edit_names(args):
    from .taxonomy.tools import edit_names

    edit_names(args.names_dmp, args.output, args.replacements)


def cmd_new_taxa_list(args):
    from .taxonomy.tools import create_new_taxa_list

    create_new_taxa_list(args.fasta_list, args.acc2taxid, args.taxonomy_dir, args.output)


def cmd_query2reference(args):
    from .taxonomy.tools import query_to_reference

    query_to_reference(args.classifications, args.acc2taxid, args.output)


def cmd_filter_by_genus(args):
    from .taxonomy.tools import filter_by_genus

    filter_by_genus(args.classifications, args.dbdir,
                    [int(g) for g in args.genera.split(",")], args.output)


def cmd_count_common(args):
    from .taxonomy.tools import count_common_kmers

    count_common_kmers(args.dbdir_a, args.dbdir_b)


def cmd_make_aa_offset(args):
    from .taxonomy.tools import make_aa_offset

    make_aa_offset(args.dbdir, args.output)


def cmd_ictv_format(args):
    from .report.virus_benchmark import ictv_format

    ictv_format(args.tsv, args.outdir)


def cmd_virus_benchmark(args):
    from .report.virus_benchmark import make_virus_benchmark_set

    make_virus_benchmark_set(args.assembly_list, args.taxdb, args.outdir,
                             rank=args.rank, exclude_per_rank=args.exclude_per_rank,
                             seed=args.random_seed)


def cmd_maketestsets(args):
    from .report.benchmark import make_test_sets

    make_test_sets(args.assembly_list, args.taxdb, args.outdir,
                   rank=args.rank, exclude_per_rank=args.exclude_per_rank,
                   seed=args.random_seed)


def cmd_make_inclusion(args):
    from .report.benchmark import make_inclusion_queries

    make_inclusion_queries(args.assembly_list, args.outdir,
                           fraction=args.fraction, seed=args.random_seed)


def cmd_grade_group(args):
    from .report.benchmark import grade_group

    grade_group(args.groups, args.answer, args.dbdir,
                ranks=args.ranks.split(","))


def cmd_grade_by(args):
    from .report.benchmark import grade_by_strata

    grade_by_strata(args.classifications, args.answer, args.dbdir,
                    args.strata, ranks=args.ranks.split(","), label=args.label)


def cmd_grade_group_by(args):
    from .report.benchmark import grade_group_by_strata

    grade_group_by_strata(args.groups, args.answer, args.dbdir,
                          args.strata, ranks=args.ranks.split(","),
                          label="coverage")


def cmd_mapping2taxon(args):
    from .report.benchmark import mapping2taxon

    mapping2taxon(args.mapping, args.dbdir, args.output, rank=args.rank)


def cmd_accession2taxid(args):
    """Build acc2taxid.map for FASTA files from master NCBI mapping files
    (reference src/util/accession2taxid.cpp)."""
    from .io.fasta import read_fasta

    accs = []
    with open(args.fasta_list) as f:
        for fa in (ln.strip() for ln in f if ln.strip()):
            for rec in read_fasta(fa):
                accs.append(rec.name)
    wanted = {a.split(".")[0] for a in accs}
    found = {}
    for master in args.mappings:
        with open(master) as f:
            f.readline()
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 3 and parts[0] in wanted:
                    found[parts[0]] = parts[2]
    with open(args.output, "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for a in accs:
            base = a.split(".")[0]
            if base in found:
                f.write(f"{base}\t{a}\t{found[base]}\t0\n")
    print(f"accession2taxid: mapped {len(found)}/{len(wanted)} accessions -> {args.output}")


def cmd_uniref2taxonomy(args):
    """Map UniRef cluster assignments to NCBI taxa via a cluster->taxid
    TSV (reference src/util/uniref2taxonomy.cpp)."""
    mapping = {}
    with open(args.cluster2taxid) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and not line.startswith("#"):
                mapping[parts[0]] = parts[1]
    n = 0
    with open(args.uniref_results) as fin, open(args.output, "w") as fout:
        header = fin.readline()
        fout.write(header.rstrip("\n") + "\ttaxID\n")
        for line in fin:
            parts = line.rstrip("\n").split("\t")
            tid = mapping.get(parts[3], "0") if len(parts) > 3 else "0"
            fout.write(line.rstrip("\n") + f"\t{tid}\n")
            n += 1
    print(f"uniref2taxonomy: {n} rows -> {args.output}")


def cmd_create_uniref_tree(args):
    from .uniref.tree import UnirefTree

    tree = UnirefTree.from_xml(args.xml)
    tree.save(args.output)
    print(f"create-uniref-tree: {len(tree)} nodes -> {args.output}")


def cmd_create_uniref_db(args):
    from .uniref.db import build_uniref_db

    build_uniref_db(args.dbdir, args.proteins, args.tree,
                    k=args.kmer_len, syncmer=bool(args.syncmer),
                    smer_len=args.smer_len)


def cmd_unique_kmer(args):
    from .uniref.db import build_unique_kmer_db

    build_unique_kmer_db(args.dbdir, args.proteins, k=args.kmer_len,
                         syncmer=bool(args.syncmer), smer_len=args.smer_len)


def cmd_assign_uniref(args):
    from .uniref.classifier import assign_uniref

    assign_uniref(args.queries, args.dbdir, args.outdir)


def cmd_common_kmer(args):
    from .index.common import build_common_kmer_db

    build_common_kmer_db(args.dbdir, args.fasta_list, args.acc2taxid,
                         args.taxonomy_dir, k=args.kmer_len,
                         syncmer=bool(args.syncmer), smer_len=args.smer_len)


def cmd_grouping(args):
    from .readgroup.grouping import GroupingParams, run_grouping

    params = GroupingParams(
        syncmer=bool(args.syncmer), smer_len=args.smer_len,
        min_edge_weight=args.min_edge, num_iterations=args.num_iteration,
        convergence_threshold=args.convergence_thr,
        neighbor_kmers=args.neighbor_kmers, seq_mode=args.seq_mode,
    )
    run_grouping(args.reads1, args.commondb, args.outdir, params, args.reads2)


def cmd_apply_group(args):
    from .readgroup.apply import ApplyParams, apply_groups

    params = ApplyParams(
        weight_mode=args.weight_mode, min_vote_score=args.min_vote_score,
        score_col=args.score_col, read_id_col=args.readid_col,
        taxid_col=args.taxid_col,
    )
    apply_groups(args.groups, args.group_map, args.taxdb, args.org_results,
                 args.outdir, params)


def cmd_taxdump(args):
    from .index.format import load_db_taxonomy

    tax = load_db_taxonomy(args.dbdir)
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "nodes.dmp"), "w") as f:
        for i in range(1, tax.num_nodes()):
            f.write(f"{tax.orig_of(i)}\t|\t{tax.orig_of(int(tax.parent[i]))}\t|\t{tax.rank_of(i)}\t|\n")
    with open(os.path.join(args.outdir, "names.dmp"), "w") as f:
        for i in range(1, tax.num_nodes()):
            f.write(f"{tax.orig_of(i)}\t|\t{tax.name_of(i)}\t|\t\t|\tscientific name\t|\n")
    print(f"Wrote taxdump to {args.outdir}")


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
    p.add_argument("--accession-level", type=int, default=0,
                   help="1 = label k-mers per accession (adds accession "
                        "nodes under their taxa; classify can then call "
                        "individual accessions)")
    p.add_argument("--cds-info", default=None,
                   help="GFF3 or TSV of CDS spans: extract in-frame per block")
    p.add_argument("--orf-prediction", action="store_true",
                   help="extract from predicted extended ORFs (Prodigal's "
                        "role in the reference build) instead of 6 frames")
    p.add_argument("--gene-predictor", default="auto",
                   choices=["auto", "prodigal", "heuristic"],
                   help="with --orf-prediction: 'prodigal' = vendored "
                        "Prodigal 2.6.3 + reference extended-ORF "
                        "stitching (DB matches reference builds), "
                        "'heuristic' = dependency-free maximal-ORF scan")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted build from the spill "
                        "runs checkpointed in <dbdir>/.build_runs")
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

    p = sub.add_parser("extract", help="extract reads classified under a taxon")
    p.add_argument("classifications")
    p.add_argument("reads")
    p.add_argument("dbdir")
    p.add_argument("--tax-id", type=int, required=True)
    p.add_argument("--extract-mode", type=int, default=0, help="0 auto, 1 fasta, 2 fastq")
    p.set_defaults(func=cmd_extract)

    p = sub.add_parser("grade", help="precision/sensitivity/F1 vs answer sheet")
    p.add_argument("classifications")
    p.add_argument("answer", help="TSV: read name -> true taxid")
    p.add_argument("dbdir")
    p.add_argument("--ranks", default="species,genus,family,order,class,phylum")
    p.set_defaults(func=cmd_grade)

    p = sub.add_parser("filter", help="remove contaminant reads")
    p.add_argument("reads1")
    p.add_argument("reads2", nargs="?", default=None)
    p.add_argument("outdir")
    p.add_argument("jobid")
    p.add_argument("--contam-list", required=True,
                   help="file listing contaminant DB directories")
    _add_classify_args(p)
    p.set_defaults(func=cmd_filter)

    p = sub.add_parser("classifiedRefiner", help="filter/reshape classification TSV")
    p.add_argument("classifications")
    p.add_argument("dbdir")
    p.add_argument("--output", default=None)
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--include", default="", help="comma-separated taxids to keep (subtrees)")
    p.add_argument("--exclude", default="", help="comma-separated taxids to drop (subtrees)")
    p.add_argument("--rank", default="", help="collapse assignments to this rank")
    p.set_defaults(func=cmd_refiner)

    p = sub.add_parser("updateDB", help="add sequences to an existing database")
    p.add_argument("newdb")
    p.add_argument("olddb")
    p.add_argument("fasta_list")
    p.add_argument("acc2taxid")
    p.add_argument("--new-taxa", default=None,
                   help="TSV of new taxa: taxid, parent, rank, name")
    p.add_argument("--max-ram", type=float, default=32.0)
    p.set_defaults(func=cmd_update_db)

    p = sub.add_parser("ictv-format", help="ICTV species list TSV -> taxdump")
    p.add_argument("tsv")
    p.add_argument("outdir")
    p.set_defaults(func=cmd_ictv_format)

    p = sub.add_parser("make-virus-benchmark-set", help="virus exclusion benchmark")
    p.add_argument("assembly_list")
    p.add_argument("taxdb")
    p.add_argument("outdir")
    p.add_argument("--rank", default="genus")
    p.add_argument("--exclude-per-rank", type=int, default=1)
    p.add_argument("--random-seed", type=int, default=42)
    p.set_defaults(func=cmd_virus_benchmark)

    p = sub.add_parser("uniref2taxonomy", help="attach taxids to UniRef results")
    p.add_argument("uniref_results")
    p.add_argument("cluster2taxid")
    p.add_argument("output")
    p.set_defaults(func=cmd_uniref2taxonomy)

    p = sub.add_parser("databases",
                       help="list / download prebuilt databases")
    p.add_argument("name", nargs="?", default=None)
    p.add_argument("outdir", nargs="?", default=".")
    p.add_argument("--tmp", default=None,
                   help="archive download dir (default: outdir)")
    p.set_defaults(func=cmd_databases)

    p = sub.add_parser("gtdb2taxdump", help="GTDB taxonomy TSV -> taxdump")
    p.add_argument("tsv", nargs="+")
    p.add_argument("--outdir", required=True)
    p.add_argument("--start-taxid", type=int, default=10000000)
    p.set_defaults(func=cmd_gtdb2taxdump)

    p = sub.add_parser("editNames", help="sanitize names.dmp")
    p.add_argument("names_dmp")
    p.add_argument("output")
    p.add_argument("--replacements", default=None)
    p.set_defaults(func=cmd_edit_names)

    p = sub.add_parser("createnewtaxalist", help="template rows for unmapped accessions")
    p.add_argument("fasta_list")
    p.add_argument("acc2taxid")
    p.add_argument("output")
    p.add_argument("--taxonomy-dir", required=True)
    p.set_defaults(func=cmd_new_taxa_list)

    p = sub.add_parser("query2reference", help="map classified reads to reference accessions")
    p.add_argument("classifications")
    p.add_argument("acc2taxid")
    p.add_argument("output")
    p.set_defaults(func=cmd_query2reference)

    p = sub.add_parser("filter_by_genus", help="keep reads under given genera")
    p.add_argument("classifications")
    p.add_argument("dbdir")
    p.add_argument("output")
    p.add_argument("--genera", required=True, help="comma-separated genus taxids")
    p.set_defaults(func=cmd_filter_by_genus)

    p = sub.add_parser("count-common-kmers", help="k-mer overlap of two DBs")
    p.add_argument("dbdir_a")
    p.add_argument("dbdir_b")
    p.set_defaults(func=cmd_count_common)

    p = sub.add_parser("makeAAoffset", help="AA-run offsets of the sorted index")
    p.add_argument("dbdir")
    p.add_argument("--output", default=None)
    p.set_defaults(func=cmd_make_aa_offset)

    p = sub.add_parser("create-uniref-tree", help="parse UniRef100 XML into cluster tree")
    p.add_argument("xml")
    p.add_argument("output", help="output .npz path")
    p.set_defaults(func=cmd_create_uniref_tree)

    p = sub.add_parser("create-uniref-db", help="AA k-mer DB with UniRef LCA labels")
    p.add_argument("dbdir")
    p.add_argument("proteins", help="protein FASTA")
    p.add_argument("tree", help="uniref tree .npz")
    p.add_argument("--kmer-len", type=int, default=12)
    p.add_argument("--syncmer", type=int, default=0)
    p.add_argument("--smer-len", type=int, default=5)
    p.set_defaults(func=cmd_create_uniref_db)

    p = sub.add_parser("create-unique-kmer-list", help="AA k-mers unique to one protein")
    p.add_argument("dbdir")
    p.add_argument("proteins")
    p.add_argument("--kmer-len", type=int, default=12)
    p.add_argument("--syncmer", type=int, default=0)
    p.add_argument("--smer-len", type=int, default=5)
    p.set_defaults(func=cmd_unique_kmer)

    p = sub.add_parser("assign_uniref", help="classify proteins over UniRef clusters")
    p.add_argument("queries", help="protein FASTA")
    p.add_argument("dbdir")
    p.add_argument("outdir")
    p.set_defaults(func=cmd_assign_uniref)

    p = sub.add_parser("maketestsets", help="rank-stratified exclusion benchmark sets")
    p.add_argument("assembly_list", help="TSV: assembly_path, taxid")
    p.add_argument("taxdb", help="DB dir (taxonomy.npz) or taxdump dir")
    p.add_argument("outdir")
    p.add_argument("--rank", default="species")
    p.add_argument("--exclude-per-rank", type=int, default=1)
    p.add_argument("--random-seed", type=int, default=42)
    p.set_defaults(func=cmd_maketestsets)

    p = sub.add_parser("makeInclusionTestQueries", help="inclusion benchmark queries")
    p.add_argument("assembly_list")
    p.add_argument("outdir")
    p.add_argument("--fraction", type=float, default=0.3)
    p.add_argument("--random-seed", type=int, default=42)
    p.set_defaults(func=cmd_make_inclusion)

    p = sub.add_parser("gradeGroup", help="group purity grading vs answer sheet")
    p.add_argument("groups")
    p.add_argument("answer")
    p.add_argument("dbdir")
    p.add_argument("--ranks", default="species,genus,family")
    p.set_defaults(func=cmd_grade_group)

    p = sub.add_parser("gradeGroupByCoverage",
                       help="group purity grading per coverage stratum")
    p.add_argument("groups")
    p.add_argument("answer")
    p.add_argument("dbdir")
    p.add_argument("strata", help="TSV: read_id, coverage bucket")
    p.add_argument("--ranks", default="species,genus,family")
    p.set_defaults(func=cmd_grade_group_by)

    p = sub.add_parser("gradeByCoverage", help="grading stratified by coverage bucket")
    p.add_argument("classifications")
    p.add_argument("answer")
    p.add_argument("dbdir")
    p.add_argument("strata", help="TSV: read_name, coverage bucket")
    p.add_argument("--ranks", default="species,genus,family")
    p.set_defaults(func=cmd_grade_by, label="coverage")

    p = sub.add_parser("gradeByCladeSize", help="grading stratified by clade size")
    p.add_argument("classifications")
    p.add_argument("answer")
    p.add_argument("dbdir")
    p.add_argument("strata", help="TSV: read_name, clade-size bucket")
    p.add_argument("--ranks", default="species,genus,family")
    p.set_defaults(func=cmd_grade_by, label="clade_size")

    p = sub.add_parser("mapping2taxon", help="read->taxid mapping to taxon at rank")
    p.add_argument("mapping")
    p.add_argument("dbdir")
    p.add_argument("output")
    p.add_argument("--rank", default="species")
    p.set_defaults(func=cmd_mapping2taxon)

    p = sub.add_parser("accession2taxid", help="build acc2taxid.map from master files")
    p.add_argument("fasta_list")
    p.add_argument("output")
    p.add_argument("--mappings", nargs="+", required=True,
                   help="NCBI accession2taxid master files")
    p.set_defaults(func=cmd_accession2taxid)

    p = sub.add_parser("create-common-kmer-list", help="build shared-k-mer DB for grouping")
    p.add_argument("dbdir")
    p.add_argument("fasta_list")
    p.add_argument("acc2taxid")
    p.add_argument("--taxonomy-dir", required=True)
    p.add_argument("--kmer-len", type=int, default=12)
    p.add_argument("--syncmer", type=int, default=0)
    p.add_argument("--smer-len", type=int, default=5)
    p.set_defaults(func=cmd_common_kmer)

    p = sub.add_parser("grouping", help="cluster reads by shared k-mers")
    p.add_argument("reads1")
    p.add_argument("reads2", nargs="?", default=None)
    p.add_argument("commondb", help="common-kmer DB directory")
    p.add_argument("outdir")
    p.add_argument("--seq-mode", type=int, default=1)
    p.add_argument("--syncmer", type=int, default=1)
    p.add_argument("--smer-len", type=int, default=5)
    p.add_argument("--min-edge", type=int, default=10)
    p.add_argument("--num-iteration", type=int, default=10)
    p.add_argument("--convergence-thr", type=float, default=0.01)
    p.add_argument("--neighbor-kmers", type=int, default=0)
    p.set_defaults(func=cmd_grouping)

    p = sub.add_parser("apply-group", help="propagate group labels to members")
    p.add_argument("groups")
    p.add_argument("group_map")
    p.add_argument("taxdb", help="DB dir (taxonomy.npz) or taxdump dir")
    p.add_argument("org_results", help="original classifications TSV")
    p.add_argument("outdir")
    p.add_argument("--weight-mode", type=int, default=1)
    p.add_argument("--min-vote-score", type=float, default=0.15)
    p.add_argument("--score-col", type=int, default=5)
    p.add_argument("--readid-col", type=int, default=2)
    p.add_argument("--taxid-col", type=int, default=3)
    p.set_defaults(func=cmd_apply_group)

    p = sub.add_parser("taxdump", help="export DB taxonomy as taxdump files")
    p.add_argument("dbdir")
    p.add_argument("outdir")
    p.set_defaults(func=cmd_taxdump)

    args = parser.parse_args(argv)
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
