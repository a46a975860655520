"""Smoke run of metabuli_work_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--profile] [--seed N]

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions;
2. builds the two path-DP CUDA kernels (csrc/path_dp_warp.cu, the warp
   variant for cap <= 32; csrc/path_dp.cu, the block variant, a warp a
   lane, for larger caps) and the fused extraction kernel
   (csrc/extract.cu; one nvcc each, the three in parallel) and prints
   the build time;
3. holds the kernels against their plain torch version on the card, for
   exact equality, over the small parity grid, the shapes where the
   kernels branch (cap 32 | 33, a partial block, W ending inside a
   window tile, S = 1 and 3, block overflow), the empty case, random
   cases at main-path shapes, and the long rows and mate pairs that
   --seq-mode 3 and 2 give them (W in the thousands, both path layouts,
   two launches over the same lanes with different W), and caps 33 to
   1100 of a many-species database (one candidate a species, ties, a
   live count past 64, S = 1 and 3, block overflow, W ending inside a
   staged tile, more than 48 KB of shared memory at cap 384, the
   global-scratch ring at cap 1100); checks that each case went to the
   variant its cap selects;
   then runs the extraction kernel at the benchmark cells' shapes
   (paired: 2 x 1,024 rows of 168 bases; api: 1,024 rows of 168; long:
   32 rows of log-normal lengths up to 60 kb), each equal to its plain
   torch version on the same tensors, its device ms a launch beside its
   byte bound and the plain version's ms ("extract kernel ..." lines);
   the probe kernel (csrc/probe.cu) builds with them;
4. builds (or loads from ~/.cache) a syncmer DB of 8 genomes x 4 Mb in 2
   genera and drives its paths on it through Classifier(device="cuda")
   and classify_file, each after a one-batch warm-up, each with the
   kernels' launch counts set to 0 just before and read just after; each
   path prints the reader it read with (the native C++ reader unless its
   library did not build) and "<path>: N probe kernel launches, M probe
   spans" (N >= M > 0 on every path-DP flow; 0 on the host-match flow,
   whose plain probe runs) and "<path>: N redundancy kernel launches, M
   redundancy or assign spans" (N > 0 on every path-DP flow, 0 on the
   host-match flow);
   - single-end: 16,384 reads of 150 bp (1% errors, half reverse-
     complemented), batch 1024; then the probe kernel at the benchmark
     cells' shapes (batches of reads drawn from the smoke genomes, as
     the extraction kernel's shapes, at cap 20) on the single-end
     classifier's wide index, equal to the plain torch body there, its
     device ms a launch beside its byte bound and the plain body's ms
     ("probe kernel ..." lines); then the redundancy kernel
     (csrc/redundancy.cu) on the resident tensors of one fused step of
     each of those shapes, equal to the plain torch body on the stats
     column and the pairs within the count, its device ms a launch
     beside its byte bounds and the plain body's ms ("redundancy kernel
     ..." lines);
   - paired-end (--seq-mode 2): 8,192 pairs of 2 x 150 bp, insert
     280-420, mate 2 reverse-complemented, batch 1024; the path DP must
     launch twice per dispatched batch (once per mate);
   - long reads (--seq-mode 3, min_score 0.008, min_sp_score 0): 256
     reads of 10 kb at batch 32, a 24-kb and a 36-kb read (their batches
     run the 7-column path layout) and a 150-kb read (beyond the 64-kb
     row cap: redone from chunks through the host-match step);
   - host-match flow (min_cons_cnt 1): 4,096 of the single-end reads; no
     path-DP kernel belongs to this flow and none may launch;
   - streamed single-end (hbm_budget_gb 0.25): the single-end reads with
     the index kept on the host in >= 4 ranges and swept through the
     device per group of batches; every read must equal the resident
     single-end run's; prints the group size, sweeps, bytes uploaded and
     the upload rate.  (A user's streamed database is larger than the
     card; the smoke run streams its own under a small budget: mechanism
     and batch shapes are the full ones, the index size is not.)  Then
     one read a little beyond the 64-kb row cap through the streamed
     classifier's chunk pass, held equal to the resident classifier's;
   - device-assign flow (METABULI_DEVICE_ASSIGN=1), single-end and
     paired: the same reads and pairs with species scoring and tie/LCA
     assignment on the device; every batch must take the device-assign
     dispatch, and every read must equal the host-scoring run's, tax_cnt
     and top_species included;
   - the (dp, db) mesh, on a 2 x 2 mesh whose cells cycle over the
     visible cards (four cells on one card when there is one): "mesh
     single-end" (the single-end reads), "mesh paired" (the pairs),
     "mesh streamed" (the single-end reads with hbm_budget_gb 0.25, the
     index swept over the mesh in host ranges of two shards; then the
     66,000-base read through the mesh's chunk pass) and "distributed"
     (two processes of this script joined by torch.distributed over
     gloo, a global mesh of dp 2 processes x db 2 cells, the first 4,096
     single-end reads); every read must equal the resident single-device
     run's (tax_cnt and top_species included), the path DP must launch
     once per part per dp row, and each prints reads/s beside the
     resident run's, the bytes the db merge reads a batch and the peak
     device memory beside the resident run's; then measure_scaling
     prints reads/s of its own workload on 1, 2 and 4 of the cells (on
     one card the cells run one after another: the cost of the
     mechanism, not a speed-up).
   after those, so that every earlier path runs as it did before them:
   - reader: the single-end reads through the native reader and
     through the Python reader on one classifier, twice each in
     turns, equal read for read, with the input stage's ms a batch, the
     dispatch stage's ms a call and reads/s of each run;
   - reference-format (diffIdx) and reference-format (deltaIdx.mtbl):
     the smoke index written as a database of the reference binary (the
     port's export_reference_format, or the 96-bit stream of its
     encode_metamer_deltas; db.parameters and a taxonomyDB blob, no
     db.meta.json), imported by load_index (the windowed decode into the
     directory's memmap cache), then the single-end reads through
     Classifier(dir); every read must equal the native-layout single-end
     run's (tax_cnt and top_species included); prints the export and
     import seconds, the bytes of the delta stream and reads/s; then two
     spawned CPU-only processes import a fresh copy of the diffIdx
     database at once on a cold cache (one decodes under the cache's
     lock, the other waits and maps it): each index must equal the
     native one, mapped from the copy's cache, with no *.new file left;
     prints the seconds each took beside the one-process import's;
   - em: the single-end reads with em=True (made with
     METABULI_DEVICE_ASSIGN=1 set, which --em overrides: no batch may
     take the device-assign dispatch), then run_em; the species score
     lists of the first 256 reads must equal the CPU run's; prints the
     EM iterations and seconds;
   - cli (no kernel count of its own: a subprocess): `python -m
     metabuli_work_tpu_torch.cli classify` of the first 4,096 reads as
     FASTQ on the diffIdx reference DB with --em, --validate-input,
     --profile-dir and the flags the JAX CLI accepts and ignores; exit 0,
     classifications byte-equal to the em run's, the EM files and a
     trace written; then convertDB, validatedb and printDeltaIdx --limit
     5 on that directory, exit 0, the five values the index's first;
   after those, so that every earlier path and phase runs as before them:
   - orf build: ORF_GENOMES gene-structured genomes of 4 Mb in 2 genera
     (genes of 300-1,500 bp on both strands between 50-300-bp spacers,
     about 88% coding; 3.5% mutations per species) built by
     build_database(orf_prediction=True, gene_predictor="auto") with
     spawned extraction workers (cached under ~/.cache by config key);
     prints the predictor that ran (the heuristic scan of index/orf.py
     where the Prodigal library cannot be built, with the reason), the
     build seconds, the k-mer count and the share of genome bases inside
     predicted blocks; then 16,384 single-end reads of those genomes;
   - updateDB: the smoke index saved as a native DB, update_database adds
     a ninth genome (4 Mb) under a new genus and species grafted by a
     new-taxa TSV; the single-end reads and 2,048 reads of the ninth
     genome classified on the updated DB: >= 95% of the ninth genome's at
     its species; prints how many of the old reads changed against the
     resident single-end run (an observation, not a gate);
   - accession-level: the ninth genome built alone as two accessions of
     2 Mb under its species with accession_level=True; the same reads
     classified on it; prints the share of the ninth genome's reads
     called at the accession that holds them;
   - filter: filter_reads of those reads with the accession-level DB as
     the contaminant list: the removed reads are exactly the reads the
     accession-level phase classified, >= 95% of the ninth genome's and
     <= 1% of the others;
   each of the four with the kernel counts zeroed before it and read
   after it, its stage table and reads/s, and 256 reads (128 of each
   kind; for filter, their kept/removed split) equal to the CPU run's;
   - cli tools (subprocesses): filter of 4,096 of those reads as FASTQ
     (its split equal to the API run's), grade of the cli phase's
     classifications against the simulated answer sheet (F1 at species
     and genus), taxdump of the updated DB, count-common-kmers of the
     accession-level DB against the updated DB (shared = the
     accession-level DB's distinct values: both extract alike);
   after those, so that every earlier path and phase runs as before them:
   - aa-only extraction: extract_batch(aa_only=True, k=12) on the card
     over the single-end reads, plain and syncmer, equal to the CPU run
     of the same function and, for 256 reads, to the host scanner's
     per-read (k-mer, position) multisets;
   - read groups: build_common_kmer_db over the 8 genomes (six frames,
     the >= 2-species filter), run_grouping of the single-end reads and
     of the pairs (native union-find), apply_groups on the single-end
     run's classifications; fails if a group holds reads of both genera;
   - uniref: a synthetic UniRef XML and protein set from --seed (default
     0; 20 UniRef50 x 10 UniRef90 x 10 UniRef100 clusters), then
     create-uniref-tree, create-uniref-db, create-unique-kmer-list,
     assign_uniref and uniref2taxonomy as CLI subprocesses; fails unless
     every exact-copy query lands on its own cluster or an ancestor;
   after those, so that every earlier path and phase runs as before it:
   - high-cap single-end: a second syncmer DB (cached under ~/.cache) of
     a genus of 44 species and one of 4, 512 kb each, every species 1%
     of the bases away from its genus's random ancestor, so the setup
     cap (the 99.9% AA-run quantile) is above 32 (it prints it and fails
     at 32 or less); 8,192 reads of 150 bp (1% errors, half reverse-
     complemented), batch 1024, after a one-batch warm-up; every launch
     must be the cap > 32 kernel's; the first 256 reads equal to the
     CPU run's (started from the knobs the card's retry ladder settled
     at);
   after those, so that every earlier path and phase runs as before it:
   - api single-end, api paired: Classifier.classify_batch of the first
     4,096 single-end reads as strings (4 calls of 1,024) and of the
     first 2,048 pairs (seqs2), each after a one-batch warm-up; every
     read equal (tax_cnt and top_species included) to drive_batches of
     the same padded batches on a second classifier warmed up alike,
     both ending at the same retry knobs; reads/s of both; then
     models/flagship.classify_step on synthetic_db(4096) /
     synthetic_reads(32, 150) and on an index that holds some of the
     reads' own metamers, plain and syncmer, on the card (from the
     numpy arrays with no device given, and from reads on the card):
     every output equal to the same call on the CPU (device="cpu");
   For every path it checks that the plain DP never ran on the card,
   that every launch at cap <= 32 went to the warp variant, that >= 95%
   of reads land on their source species or genus, and that a subset
   matches the same classifier on the CPU (the long-read CPU run starts
   from the default knobs and climbs the overflow-retry ladder on its
   own; the card run must have retried at least once); it prints
   reads/s, the stage-timer table and the peak device memory;
5. for every path and every launch shape the path gave the kernel,
   holds the kernel against the plain version on the path's own
   captured input for exact equality ("parity main-path" lines), and
   prints the kernel's time per launch beside its bound and the plain
   version's time, the byte bound and the compare bound (same-species
   predecessor lookups of the input) apart (at the single-end path's
   first launch also the block variant's time on the same input; on the
   high-cap phase's input the time the earlier cap > 32 kernel took),
   and launches x ms/launch beside the single-end run's wall time.

Host work that only fills a cache a later phase reads runs in spawned
preparation processes (CPU only) while the card works: the smoke DB and
its wide layout and host shards during the kernel build and the parity
cases (the first path waits for all of them); after measure_scaling,
the ORF DB, the updated DB and its layout, the common-k-mer DB and the
high-cap DB, beside the reader-to-cli phases.  A phase waits for
what it reads and prints the seconds the preparation took.  The CPU runs
of the long-read and the high-cap CPU checks run the same way, while the
card runs the paths after them; each is held against the card's results
once it is done, the high-cap one before the api phase, so that no
preparation process runs beside that phase.

With --profile every path is driven once more under torch.profiler (CPU
+ CUDA activities) after its checks: the sum of all device kernel and
copy times ("busy"; the path runs on one stream, so the sum is the busy
time), the idle share 1 - busy / profiled wall, busy over the unprofiled
wall, and the ten kernels with the most device time.  The profiler slows
the host, so the idle share is an upper bound of the unprofiled run's.
The long-read path is profiled on its 10-kb reads alone.

The second-to-last line is one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero.  Exits non-zero at once when no CUDA card is visible.

    python3 chip_smoke.py --dist-worker RANK PORT READS WARM OUT

is the distributed path's worker (started by the run above, never by
hand): it joins the process group at localhost:PORT, classifies READS
after a warm-up on WARM over the global mesh and writes its own reads'
records, its launch counts and its parity checks to OUT.
"""

import glob
import hashlib
import json
import multiprocessing
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_dp_cases import (EDGES, GRID, HIGH_CAP, LONG_W,  # noqa: E402
                            db_with_read_kmers, edge_case, flipped_inputs,
                            high_cap_case, overflow_case, random_case)

N_GENOMES = 8
GENOME_LEN = 4_000_000
N_READS = 16384
READ_LEN = 150
BATCH = 1024
N_CPU_CHECK = 256
N_PAIRS = 8192
INSERT = (280, 420)
N_LONG, LONG_LEN, LONG_BATCH = 256, 10_000, 32
MID_LONG = (24_000, 36_000)      # rows >= 2^14 nt: the 7-column layout
VERY_LONG = 150_000              # beyond the 64-kb row cap: chunked
N_HOST_MATCH = 4096
N_DIST = 4096                    # reads of the two-process path
READER_TURNS = 2                 # runs of the single-end reads per reader
N_CLI = 4096                     # reads of the CLI phase
STREAM_GB = 0.25                 # budget that cuts the index into 4 ranges
OVER_CAP = 66_000                # a little beyond the 64-kb row cap
ORF_GENOMES = 4                  # ORF build: gene-structured genomes
ORF_MIN_RIGHT = 0.9              # its reads at source species or genus
NINTH_LEN = 4_000_000            # updateDB / accession level: one more genome
N_NINTH = 2048                   # its reads
SHORT = dict(min_score=0.15, min_sp_score=0.5)   # short-read thresholds
RUN_LIMIT_S = 1200               # the whole command's time limit
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate
ALU_OPS_PER_S = 67e12            # H100 SXM 32-bit non-tensor peak
QUEUE_CYCLES = 50_000_000        # ~25 ms of device spin while the host
                                 # enqueues a timed run (see time_cuda)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b
_ATG = np.frombuffer(b"ATG", dtype=np.uint8)
_STOPS = np.frombuffer(b"TAATAGTGA", dtype=np.uint8).reshape(3, 3)
_SENSE = np.array([[a, b, c] for a in b"ACGT" for b in b"ACGT"
                   for c in b"ACGT"
                   if bytes((a, b, c)) not in (b"TAA", b"TAG", b"TGA")],
                  dtype=np.uint8)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- parity
def check(max_err, name, which, got, ref):
    """One kernel result against the plain version's: paths, valid flags
    and overflow count equal, or it raises.  Returns the max abs error
    and folds it into max_err[which]."""
    err = int((got[0].long() - ref[0].long()).abs().max()) \
        if got[0].numel() else 0
    same = (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            and int(got[2]) == int(ref[2]))
    print(f"parity {name} [{which}]: {'exact' if same else 'MISMATCH'} "
          f"(paths={int(ref[1].sum())}, blk_over={int(ref[2])})")
    if not same:
        raise AssertionError(f"{which} kernel != plain version on {name}")
    max_err[which] = max(max_err[which], err)
    return err


def parity_cases():
    """(name, case, max_shift, kmer_format, dyn_gap, block_w, compact5,
    min_cons, min_cons_euk) of the parity grid: the cases of
    tests/torch_dp_cases.py (the JAX grid, block overflow, the shapes
    where the kernels branch, long rows and mate pairs, caps above 32 of
    a many-species database), the empty case, cap 384 of three species
    (a lane's 12 chunks of candidates, long hash chains) and random
    inputs at main-path shapes."""
    cases = []
    for dyn_gap, S, kf in GRID:
        case = random_case(np.random.default_rng(42 + S + kf), 4, 12, 9,
                           dyn_gap=dyn_gap)
        for compact5 in (True, False):
            cases.append((f"grid dyn_gap={dyn_gap} S={S} kf={kf} "
                          f"compact5={compact5}", case, S, kf, dyn_gap, 8,
                          compact5, 2, 3))
    cases.append(("block overflow", overflow_case(), 1, 2, False, 2, True,
                  2, 2))
    z = np.zeros((4, 12, 6), dtype=np.int32)
    cases.append(("empty", (z.astype(bool), z, z, z, z, z), 1, 2, False, 4,
                  True, 2, 3))
    for name, cap, G, W, S, kf, dyn_gap, bw, density, c5s in \
            [e + ((True, False),) for e in EDGES] + LONG_W:
        case = edge_case(name, cap, G, W, density, dyn_gap)
        for compact5 in c5s:
            cases.append((f"edge {name} compact5={compact5}", case, S, kf,
                          dyn_gap, bw, compact5, 2, 3))
    cases.append(("wide cap=384 G=24 W=10",
                  random_case(np.random.default_rng(2), 384, 24, 10,
                              n_species=3, density=0.7, dyn_gap=True),
                  3, 2, True, 16, True, 2, 3))
    for name, cap, G, W, S, kf, dyn_gap, bw, density, mode in HIGH_CAP:
        case = high_cap_case(name, cap, G, W, density, dyn_gap, mode)
        for compact5 in (True, False):
            cases.append((f"high-cap {name} compact5={compact5}", case, S,
                          kf, dyn_gap, bw, compact5, 2, 3))
    for cap in (8, 16):
        cases.append((f"main-path shapes cap={cap} G=6144 W=40",
                      random_case(np.random.default_rng(cap), cap, 6144, 40,
                                  density=0.6, dyn_gap=True),
                      3, 2, True, 16, True, 2, 3))
    return cases


def parity(dp_cuda):
    """Kernels vs plain version on the card; returns the max abs error
    per variant over all cases (must be 0) and the number of cases."""
    max_err = {"warp": 0, "block": 0}
    n_checks = 0
    # the block variant's branches: more than 48 KB of dynamic shared
    # memory at cap 384, the ring in global scratch at cap 1100
    plans = {cap: dp_cuda.block_plan(cap, 3) for cap in (48, 384, 1100)}
    print(f"block variant plans (ring on chip, shared bytes a block, "
          f"windows a tile) at S=3: {plans}")
    assert plans[384][0] and plans[384][1] > 48 * 1024
    assert not plans[1100][0]

    for name, case, S, kf, dyn_gap, bw, c5, mc, mce in parity_cases():
        ins = [torch.from_numpy(a).cuda() for a in flipped_inputs(*case, kf)]
        kw = dict(min_cons=mc, min_cons_euk=mce, max_shift=S, kmer_format=kf,
                  dyn_gap=dyn_gap, block_w=bw, compact5=c5)
        ref = dp_cuda.path_dp_blocked_ref(*ins, **kw)
        which = dp_cuda.variant(ins[0].shape[0])
        n0 = variant_counts(dp_cuda)
        got = dp_cuda.path_dp_blocked(*ins, **kw)
        torch.cuda.synchronize()
        n1 = variant_counts(dp_cuda)
        if n1[which] != n0[which] + 1 or sum(n1.values()) != \
                sum(n0.values()) + 1:
            raise AssertionError(f"case {name} did not launch the {which} "
                                 f"variant once: {n0} -> {n1}")
        check(max_err, name, which, got, ref)
        n_checks += 1
        if name.startswith("main-path"):
            # the block variant (cap > 32 on the main path) on the same
            # main-shape input
            got = dp_cuda._launch("block", ins, **kw)
            torch.cuda.synchronize()
            check(max_err, name, "block", got, ref)
            n_checks += 1
    return max_err, n_checks


def variant_counts(dp_cuda):
    return {"warp": dp_cuda.warp_launches, "block": dp_cuda.block_launches}


# ---------------------------------------------------------------- main path
def smoke_taxonomy(Taxonomy):
    """root(1) -> genera G1(2), G2(3) -> species 4.. (genus 2 + i % 2)."""
    parent = [0, 1, 1, 1]
    rank_idx, name_idx = [0, 0, 1, 1], [0, 0, 1, 2]
    rank_pool = ["no rank", "genus", "species"]
    name_pool = ["root", "G1", "G2"]
    int2orig = [0, 1, 101, 102]
    for i in range(N_GENOMES):
        parent.append(2 + (i % 2))
        rank_idx.append(2)
        name_pool.append(f"Species{i}")
        name_idx.append(3 + i)
        int2orig.append(1000 + i)
    return Taxonomy(np.array(parent), np.array(rank_idx), np.array(name_idx),
                    rank_pool, name_pool, np.array(int2orig))


def smoke_db_path():
    return os.path.join(os.path.expanduser("~/.cache"),
                        f"mwt_torch_smoke_db_{N_GENOMES}_{GENOME_LEN}.npz")


def build_or_load_db():
    """Syncmer DB of N_GENOMES genomes (2 random bases, 3.5% mutations
    per species), cached under ~/.cache by config key."""
    from metabuli_work_tpu_torch.index.builder import IndexBuilder
    from metabuli_work_tpu_torch.index.format import KmerIndex
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    tax = smoke_taxonomy(Taxonomy)
    cache = smoke_db_path()
    meta = {"kmer_format": 2, "syncmer": True, "smer_len": 5,
            "reduced_aa": 0, "mask_mode": 0, "mask_prob": 0.9,
            "skip_redundancy": 1}
    if os.path.exists(cache):
        with np.load(cache) as z:
            genomes = [g.decode() for g in z["genomes"]]
            return KmerIndex(z["v"], z["t"], z["s"], tax, meta), genomes, True
    rng = np.random.default_rng(0)
    builder = IndexBuilder(tax, syncmer=True, mask_mode=0)
    bases = [ACGT[rng.integers(0, 4, size=GENOME_LEN)] for _ in range(2)]
    genomes = []
    for i in range(N_GENOMES):
        g = bases[i % 2].copy()
        mut = rng.random(GENOME_LEN) < 0.035
        g[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
        genomes.append(g.tobytes().decode())
        builder.add_sequence(genomes[-1], 4 + i)
    index = builder.finalize()
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    tmp = cache + ".tmp.npz"
    np.savez(tmp, v=index.values, t=index.taxids, s=index.species,
             genomes=np.array([g.encode() for g in genomes]))
    os.replace(tmp, cache)
    return index, genomes, False


def genome_matrix(genomes):
    return np.stack([np.frombuffer(g.encode(), dtype=np.uint8)
                     for g in genomes])


def simulate_reads(G, rng, n, read_len):
    """n reads of read_len bases, 1% errors, half reverse-complemented;
    returns (reads [n, read_len] uint8, source genome [n])."""
    gi = rng.integers(0, G.shape[0], size=n)
    starts = rng.integers(0, G.shape[1] - read_len, size=n)
    reads = G[gi[:, None], starts[:, None] + np.arange(read_len)[None, :]]
    err = rng.random((n, read_len)) < 0.01
    reads[err] = ACGT[rng.integers(0, 4, size=int(err.sum()))]
    rc = rng.random(n) < 0.5
    reads[rc] = _COMP[reads[rc, ::-1]]
    return np.ascontiguousarray(reads), gi


def simulate_pairs(G, rng, n, read_len):
    """Paired fragments (insert INSERT): mate 1 = the fragment's first
    read_len bases, mate 2 = the reverse complement of its last read_len
    (the reference's paired orientation), 1% errors."""
    gi = rng.integers(0, G.shape[0], size=n)
    ins = rng.integers(INSERT[0], INSERT[1] + 1, size=n)
    starts = rng.integers(0, G.shape[1] - INSERT[1], size=n)
    frag = G[gi[:, None], starts[:, None] + np.arange(INSERT[1])[None, :]]
    err = rng.random(frag.shape) < 0.01
    frag[err] = ACGT[rng.integers(0, 4, size=int(err.sum()))]
    r1 = np.ascontiguousarray(frag[:, :read_len])
    idx = ins[:, None] - 1 - np.arange(read_len)[None, :]
    r2 = np.ascontiguousarray(_COMP[frag[np.arange(n)[:, None], idx]])
    return r1, r2, gi


def write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r.tobytes().decode()}\n")


def write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r.tobytes().decode()}\n+\n{'I' * len(r)}\n")


# ---------------------------------------------------------------- ref. DBs
def write_db_parameters(path, meta):
    """The reference's db.parameters (key<TAB>value lines) for `meta`."""
    with open(path, "w") as f:
        for key, k in (("DB_name", "db_name"), ("Reduced_alphabet",
                                                "reduced_aa"),
                       ("Accession_level", "accession_level"),
                       ("Mask_mode", "mask_mode"), ("Mask_prob", "mask_prob"),
                       ("Skip_redundancy", "skip_redundancy"),
                       ("Syncmer", "syncmer"), ("Syncmer_len", "smer_len"),
                       ("Kmer_format", "kmer_format")):
            v = meta.get(k, "smoke" if k == "db_name" else 0)
            f.write(f"{key}\t{int(v) if isinstance(v, bool) else v}\n")


def write_taxonomy_blob(path, tax):
    """A reference taxonomyDB blob of `tax` (TaxonomyWrapper::serialize,
    version 3, internalTaxIdUsed set so the internal ids are kept; node d
    holds internal id d + 1; the E/L/H/M lookup tables, which a reader
    skips, are zeros)."""
    n = len(tax.parent)
    max_nodes = n - 1
    strings, at = [], {}

    def sidx(s):
        if s not in at:
            at[s] = len(strings)
            strings.append(s)
        return at[s]

    node = np.dtype([("id", "<i4"), ("taxId", "<i4"), ("parentTaxId", "<i4"),
                     ("pad", "<i4"), ("rankIdx", "<u8"), ("nameIdx", "<u8")])
    nodes = np.zeros(max_nodes, dtype=node)
    for i in range(1, n):
        nodes[i - 1] = (i - 1, i, int(tax.parent[i]), 0,
                        sidx(tax.rank_of(i)), sidx(tax.name_of(i)))
    k = int(np.floor(np.log2(max(2 * max_nodes, 2)))) + 1
    chars = b"".join(s.encode() + b"\0" for s in strings)
    offsets = np.concatenate([[0], np.cumsum([len(s.encode()) + 1
                                              for s in strings])])
    with open(path, "wb") as f:
        for a in (np.array([3], "<i4"), np.array([1, max_nodes], "<u8"),
                  np.array([n - 1], "<i4"), nodes,
                  np.arange(-1, max_nodes, dtype="<i4"),
                  np.asarray(tax.int2orig, "<i4"),
                  np.zeros(5 * max_nodes + 2 * max_nodes * k, "<i4"),
                  np.array([len(strings), len(chars)], "<u4"),
                  offsets.astype("<u4")):
            f.write(a.tobytes())
        f.write(chars)


def write_reference_db(d, index, layout):
    """`index` as a database of the reference binary in directory d:
    diffIdx/info/split (the port's export_reference_format) or
    deltaIdx.mtbl (the 96-bit stream of its encode_metamer_deltas), with
    db.parameters and a taxonomyDB blob and no db.meta.json.  Returns the
    bytes of the delta stream."""
    from metabuli_work_tpu_torch.index.delta import encode_metamer_deltas
    from metabuli_work_tpu_torch.index.format import export_reference_format

    os.makedirs(d)
    if layout == "diffIdx":
        export_reference_format(d, index)
    else:
        encode_metamer_deltas(index.values, index.taxids).astype(
            "<u2").tofile(os.path.join(d, layout))
    write_db_parameters(os.path.join(d, "db.parameters"), index.meta)
    write_taxonomy_blob(os.path.join(d, "taxonomyDB"), index.taxonomy)
    return os.path.getsize(os.path.join(d, layout))


def tuples(results):
    return [(q.result.is_classified, q.result.classification,
             float(q.result.score)) for q in results]


def full_tuples(results):
    """tuples() plus what the two scoring flows must also agree on."""
    return [(q.result.is_classified, q.result.classification,
             float(q.result.score), dict(q.result.tax_cnt),
             int(q.result.top_species)) for q in results]


def records(results):
    """{read name: full_tuples' fields} as JSON keeps them (f32 score
    bits, tax_cnt keys as strings): what a distributed worker reports."""
    return {q.name: [bool(q.result.is_classified),
                     int(q.result.classification),
                     int(np.float32(q.result.score).view(np.int32)),
                     {str(k): v for k, v in q.result.tax_cnt.items()},
                     int(q.result.top_species)] for q in results}


def same_as(name, what, got, ref):
    n_same = sum(a == b for a, b in zip(got, ref))
    print(f"{name}: {n_same}/{len(ref)} reads identical to {what}")
    assert len(got) == len(ref) and n_same == len(ref), \
        f"{name}: results differ from {what}"


def pin_device_assign(clf):
    """Counts the batches that take the device-assign dispatch and fails
    one that leaves it."""
    n = {"full": 0}
    full = clf._dispatch_batch_full

    def counted(*a, **k):
        n["full"] += 1
        return full(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a batch left the device-assign flow")

    clf._dispatch_batch_full = counted
    clf._dispatch_batch_dp = refuse
    return n


def time_cuda(fn, reps, queue_ahead=False, warm=True):
    """Device ms per call of fn over `reps` calls between two events.
    queue_ahead keeps the device spinning while the host enqueues all the
    calls, so a kernel shorter than its Python wrapper is timed back to
    back rather than at the host's enqueue rate."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def species_lookups(sp, S):
    """Same-species predecessor lookups the reference makes on this input:
    for every live candidate, the entries of its species in the nearest
    of its S predecessor windows that holds that species (where it stops
    looking).  Counted on the card in slices of lanes."""
    cap, G, W = sp.shape
    total = 0
    step = max(1, (1 << 26) // max(1, cap * cap * W))
    for g0 in range(0, G, step):
        x = sp[:, g0:g0 + step]
        found = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for s in range(1, min(S, W - 1) + 1):
            cur, prev = x[:, :, s:], x[:, :, :-s]
            n = ((cur[:, None] == prev[None]) & (prev[None] >= 0)).sum(1)
            use = (n > 0) & (cur >= 0) & ~found[:, :, s:]
            total += int(n[use].sum())
            found[:, :, s:] |= n > 0
    return total


def kernel_bound_ms(args, kw):
    """Least time for the work, the larger of: inputs read once + outputs
    written once over the memory rate; the same-species predecessor
    lookups this input needs (8 int32 ops each: species test, shift,
    mask, compare, gap, score max, key min, select) over the 32-bit ALU
    peak.  Returns (bound ms, "bytes" or "operations", byte bound ms,
    compare bound ms, lookups)."""
    sp = args[0]
    cap, G, W = sp.shape
    bw, S = kw["block_w"], kw["max_shift"]
    n_cols = 5 if kw["compact5"] else 7
    nbytes = 5 * cap * G * W * 4 + n_cols * bw * G * 4 + bw * G + 4
    lookups = species_lookups(sp, S)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 8 * lookups / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            bytes_ms, ops_ms, lookups)


KEEP_INPUTS = 6     # launches per path whose inputs are kept for timing


def drive(dp_cuda, clf, run):
    """One main-path run: stage timer and peak-memory mark reset, every
    kernel count (the path DP's and the extraction kernel's) set to 0
    just before `run()` and read just after.  Every path_dp_blocked call is noted as (cap, W, compact5); the inputs
    of the first KEEP_INPUTS distinct ones are kept (device copies, so
    they count into the run's peak memory) for the timings.  `clf` is the
    classifier `run` uses, or a function that returns it after the run
    (a classifier that `run` makes, whose timer starts at zero)."""
    from metabuli_work_tpu_torch.ops import (encode_cuda, match_cuda,
                                             redundancy_cuda)

    calls, first = [], {}
    launch = dp_cuda.path_dp_blocked

    def capture(*args, **kw):
        key = (args[0].shape[0], args[0].shape[2], kw["compact5"])
        calls.append(key)
        if key not in first and len(first) < KEEP_INPUTS:
            first[key] = ([a.clone() for a in args], dict(kw))
        return launch(*args, **kw)

    if not callable(clf):
        clf.timer.totals.clear()
        clf.timer.counts.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dp_cuda.path_dp_blocked = capture
    dp_cuda.launches = dp_cuda.warp_launches = 0
    dp_cuda.block_launches = dp_cuda.plain_cuda_calls = 0
    encode_cuda.launches = match_cuda.launches = 0
    redundancy_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        results = run()
        torch.cuda.synchronize()
    finally:
        dp_cuda.path_dp_blocked = launch
    dt = time.perf_counter() - t0
    extract_launches = encode_cuda.launches
    probe_launches = match_cuda.launches
    redundancy_launches = redundancy_cuda.launches
    if callable(clf):
        clf = clf()
    return {"results": results, "dt": dt, "calls": calls, "first": first,
            "launches": dp_cuda.launches, "plain": dp_cuda.plain_cuda_calls,
            "counts": variant_counts(dp_cuda),
            "extract_launches": extract_launches,
            "extract_spans": clf.timer.counts["extract"],
            "probe_launches": probe_launches,
            "probe_spans": clf.timer.counts["probe"],
            "redundancy_launches": redundancy_launches,
            "redundancy_spans": clf.timer.counts["redundancy"]
            + clf.timer.counts["assign"],
            "hashed": clf.use_device_dp,
            "dispatches": clf.timer.counts["dispatch"],
            "peak": torch.cuda.max_memory_allocated(), "base": base,
            "reader": clf.reader, "timer": clf.timer}


def check_launches(name, r, dp_cuda):
    """Launches counted where the kernel launched and nowhere else, the
    plain DP never on the card, each launch at the variant its cap
    selects."""
    calls, counts = r["calls"], r["counts"]
    assert r["launches"] == len(calls), (name, r["launches"], len(calls))
    assert r["plain"] == 0, f"{name}: the plain DP ran on the card"
    n_small = sum(c[0] <= dp_cuda.WARP_MAX_CAP for c in calls)
    by_cap = {}
    for cap, W, c5 in calls:
        k = f"cap {cap} W {W} {'5' if c5 else '7'}col"
        by_cap[k] = by_cap.get(k, 0) + 1
    read = f"read with the {r['reader']} reader" if r["reader"] \
        else "reads given in memory"
    print(f"{name}: path DP launches by shape {by_cap}; warp variant "
          f"{counts['warp']}, block variant {counts['block']}; "
          f"{r['dispatches']} dispatches; {read}")
    assert counts["warp"] == n_small, \
        f"{name}: a launch at cap <= 32 did not go to the warp variant"
    assert counts["block"] == r["launches"] - n_small
    check_extract(name, r)
    check_probe(name, r)
    check_redundancy(name, r)


def check_extract(name, r):
    """The run extracted on the card through the fused kernel: at least
    one launch, and at least one for each `extract` span (a mesh span
    launches once per dp row; the long-read chunk pass launches outside
    any span)."""
    n, spans = r["extract_launches"], r["extract_spans"]
    print(f"{name}: {n} extraction kernel launches, {spans} extract spans")
    assert n > 0 and n >= spans, \
        f"{name}: {n} extraction kernel launches for {spans} extract spans"


def check_probe(name, r):
    """The run probed on the card through the probe kernel, at least once
    a `probe` span (a span probes once a range when streamed, once a cell
    on the mesh), or, on a flow that does not probe with the hash, never
    launched it."""
    n, spans = r["probe_launches"], r["probe_spans"]
    print(f"{name}: {n} probe kernel launches, {spans} probe spans"
          f"{'' if r['hashed'] else ' (no hash probe on this flow)'}")
    if r["hashed"]:
        assert n > 0 and n >= spans, \
            f"{name}: {n} probe kernel launches for {spans} probe spans"
    else:
        assert n == 0, f"{name}: the probe kernel ran on a plain-probe flow"


def check_redundancy(name, r):
    """The run's finish went through the redundancy kernel (launched in
    the `redundancy` span, or in `assign` on the device-assign flow; once
    a dp row on the mesh), or, on the host-match flow, which has no such
    step, never launched it."""
    n, spans = r["redundancy_launches"], r["redundancy_spans"]
    print(f"{name}: {n} redundancy kernel launches, {spans} redundancy or "
          f"assign spans")
    if r["hashed"]:
        assert n > 0, f"{name}: the redundancy kernel never launched"
    else:
        assert n == 0, f"{name}: the redundancy kernel ran on host-match"


def check_path(name, r, n_reads, src, dp_cuda, card, unit="reads",
               species=None, genus=None, min_right=0.95):
    """The checks every path shares: result count, check_launches, >= 95%
    of reads at source species or genus (the internal ids of the smoke
    taxonomy's unless given)."""
    results = r["results"]
    assert len(results) == n_reads, (name, len(results))
    check_launches(name, r, dp_cuda)
    cls = np.array([q.result.classification for q in results])
    if species is None:
        species, genus = 4 + src, 2 + src % 2
    right = float(np.mean((cls == species) | (cls == genus)))
    print(f"{name}: {n_reads} {unit}, {r['launches']} kernel launches, "
          f"{right * 100:.2f}% at source species or genus, "
          f"{float(np.mean(cls == species)) * 100:.2f}% at species")
    assert right >= min_right, \
        f"{name}: only {right:.4f} classified correctly"
    print(f"{name}: {n_reads / r['dt']:.1f} {unit}/s ({r['dt']:.3f} s for "
          f"{n_reads} {unit}); peak device memory "
          f"{r['peak'] / 2**30:.3f} GiB, {r['base'] / 2**30:.3f} GiB of it "
          f"held before the run (index, kept launch inputs of earlier "
          f"paths); on {card}")


def cpu_check(name, gpu_results, cpu_results):
    cpu_check_tuples(name, gpu_results, tuples(cpu_results))


def cpu_check_tuples(name, gpu_results, cpu_res):
    """cpu_check against the CPU run's tuples() (lists, from JSON)."""
    gpu_res, cpu_res = tuples(gpu_results), [tuple(t) for t in cpu_res]
    n_same = sum(a == b for a, b in zip(gpu_res, cpu_res))
    print(f"{name} CPU check: {n_same}/{len(cpu_res)} reads identical to "
          f"the CPU run")
    assert gpu_res == cpu_res, f"{name}: GPU and CPU classifications differ"


def stage_table(name, clf, card):
    print(f"{name} stage timer (host seconds) on {card}:")
    print(clf.timer.report())


def time_shapes(name, r, dp_cuda, card, max_err, reps=50, plain_reps=1):
    """Each kept launch input of a path: the kernel held against the
    plain version on it (exact, or it raises), then timed back to back
    on the device; returns {(cap, W, compact5): (ms, bound_ms, bound_by,
    plain_ms, max_abs_err)}.  plain_reps=1 times the plain version's only call."""
    timed = {}
    for key, (args, kw) in r["first"].items():
        cap, G, W = args[0].shape
        which = dp_cuda.variant(cap)
        shape = (f"cap={cap} G={G} W={W} S={kw['max_shift']} "
                 f"block_w={kw['block_w']} "
                 f"{'5' if kw['compact5'] else '7'} columns")
        ref = []

        def plain():
            ref[:] = [dp_cuda.path_dp_blocked_ref(*args, **kw)]

        plain_ms = time_cuda(plain, plain_reps, warm=plain_reps > 1)
        got = dp_cuda.path_dp_blocked(*args, **kw)
        torch.cuda.synchronize()
        err = check(max_err, f"main-path {name} {shape}", which, got,
                    ref[0])
        del ref[:], got
        ms = time_cuda(lambda: dp_cuda.path_dp_blocked(*args, **kw), reps,
                       queue_ahead=True)
        b_ms, b_by, bytes_ms, ops_ms, lookups = kernel_bound_ms(args, kw)
        timed[key] = (ms, b_ms, b_by, plain_ms, err)
        print(f"{name}: path_dp {which} kernel at {shape}: "
              f"{ms:.4f} ms/launch, bound {b_ms:.5f} ms ({b_by}), "
              f"{ms / b_ms:.1f}x bound (byte bound {bytes_ms:.5f} ms, "
              f"compare bound {ops_ms:.6f} ms for {lookups} same-species "
              f"lookups), plain version {plain_ms:.3f} ms, on {card}")
        if which == "block" and key in EARLIER_BLOCK_MS:
            old = EARLIER_BLOCK_MS[key]
            print(f"{name}: the earlier cap > 32 kernel (one block a lane) "
                  f"on this input: {old:.4f} ms/launch on NVIDIA H100 80GB "
                  f"HBM3, 700.00 W ({old / ms:.1f}x this kernel's time)")
    return timed


def profile_path(name, run, n_reads, card, n_batches=None):
    """`run()` unprofiled, then under torch.profiler: the two walls, the
    device busy time (sum of kernel and copy times), the idle share, the
    device operations per batch and the ten kernels with the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    dt = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_p = timed()

    def device_us(e):
        # renamed from *cuda* to *device* across torch versions
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device rows only: an operator's row repeats its kernels' time
    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                  reverse=True)
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{name} profile: {n_reads} reads on {card}: unprofiled wall "
          f"{dt:.3f} s; under the profiler wall {wall_p:.3f} s, device busy "
          f"{busy:.3f} s in {sum(r[1] for r in rows)} kernels and copies, "
          f"idle share {100 * (1 - busy / wall_p):.1f}%; busy / unprofiled "
          f"wall {100 * busy / dt:.1f}%"
          + (f"; {sum(r[1] for r in rows) / n_batches:.0f} device "
             f"operations a batch over {n_batches} batches"
             if n_batches else ""))
    for us, count, key in rows[:10]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    # int(tensor) and .item() end here: the host's waits for the device
    waits = [e for e in prof.key_averages()
             if e.key == "aten::_local_scalar_dense"]
    print(f"{name} profile: host time inside waits for a device value "
          f"(int(), .item()): {sum(e.cpu_time_total for e in waits) / 1e6:.3f}"
          f" s in {sum(e.count for e in waits)} calls, under the profiler")


def reader_phase(clf, fa, reads, card):
    """The single-end reads through the native reader and through the
    Python reader on one classifier, READER_TURNS runs each in turns:
    equal read for read; the input stage's ms a batch and reads/s of
    each run, with its dispatch stage's ms a call (the two readers side
    by side, free of the spread between runs of the whole script)."""
    from metabuli_work_tpu_torch.io import native_reader

    assert native_reader.available(), \
        "the native reader's library did not build"
    got = {}
    available = native_reader.available
    for rd in ("native", "python") * READER_TURNS:
        clf.timer.totals.clear()
        clf.timer.counts.clear()
        # the Python reader runs when the native library is missing
        native_reader.available = available if rd == "native" \
            else (lambda: False)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = clf.classify_file(fa("reads.fna"))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            native_reader.available = available
        assert clf.reader == rd
        tm = clf.timer
        got.setdefault(rd, []).append(
            (full_tuples(res), 1e3 * tm.totals["input"] / tm.counts["input"],
             len(reads) / dt,
             1e3 * tm.totals["dispatch"] / tm.counts["dispatch"]))
    same_as("reader", "the Python reader's run (tax_cnt and top_species "
            "included)", got["native"][0][0], got["python"][0][0])
    for rd, runs_ in got.items():
        print(f"reader: {rd} reader, {len(reads)} reads in batches of "
              f"{clf.params.batch_size}: input "
              f"{', '.join(f'{r[1]:.2f}' for r in runs_)} ms a batch, "
              f"dispatch {', '.join(f'{r[3]:.1f}' for r in runs_)} ms a "
              f"call, {', '.join(f'{r[2]:.1f}' for r in runs_)} reads/s "
              f"({READER_TURNS} runs, in turns with the other reader); on "
              f"{card}")


def reference_phases(dp_cuda, index, classifier_at, fa, runs, src, card,
                     prep):
    """Both reference layouts of the smoke index: written (export), read
    back by load_index (the windowed decode into <dir>/.import_cache),
    then classified through Classifier(dir) on the card, which maps that
    cache; every read equal to the native-layout single-end run.  Then
    the two-process import of a cold copy of the diffIdx directory,
    whose processes `prep` starts beside the classify runs and a barrier
    releases after them.  Returns {layout: directory}."""
    from metabuli_work_tpu_torch.index.format import load_index

    se = runs["single-end"]
    dirs = {}
    for layout in ("diffIdx", "deltaIdx.mtbl"):
        name = f"reference-format ({layout})"
        d = dirs[layout] = fa(f"refdb_{layout.split('.')[0]}")
        t0 = time.perf_counter()
        n_bytes = write_reference_db(d, index, layout)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        imported = load_index(d)
        t_import = time.perf_counter() - t0
        for k in ("values", "taxids", "species"):
            assert np.array_equal(getattr(imported, k), getattr(index, k)), \
                f"{name}: imported {k} differ from the index's"
        del imported
        if layout == "diffIdx":
            alone, cold = t_import, fa("refdb_diffIdx_cold")
            shutil.copytree(d, cold, ignore=shutil.ignore_patterns(
                ".import_cache"))
            go = multiprocessing.get_context("spawn").Barrier(3)
            for i in range(2):
                prep.start((f"two-process import {i}", prep_import,
                            (cold, go)))
        t0 = time.perf_counter()
        clf = classifier_at(d)
        setup = time.perf_counter() - t0
        assert isinstance(clf.index.values, np.memmap)
        clf.classify_file(fa("warm.fna"))
        r = runs[name] = drive(dp_cuda, clf,
                               lambda: clf.classify_file(fa("reads.fna")))
        assert r["launches"] > 0, f"{name}: no path-DP launch"
        check_path(name, r, N_READS, src, dp_cuda, card)
        same_as(name, "the native-layout single-end run (tax_cnt and "
                "top_species included)", full_tuples(r["results"]),
                full_tuples(se["results"]))
        print(f"{name}: export {t_export:.2f} s ({n_bytes} bytes of "
              f"{layout}, {index.size} entries), import (windowed decode "
              f"into the memmap cache) {t_import:.2f} s, classifier setup "
              f"from the mapped cache {setup:.2f} s; "
              f"{N_READS / r['dt']:.1f} reads/s against the native "
              f"layout's {N_READS / se['dt']:.1f}; {r['counts']['warp']} "
              f"warp launches; on {card}")
        stage_table(name, clf, card)
        clf = None
        torch.cuda.empty_cache()
    go.wait(timeout=120)
    took = []
    want = index_digest(index)
    for i in range(2):
        got = prep.result(f"two-process import {i}")
        assert got["digest"] == want, \
            f"two-process import: process {i}'s index differs from the native"
        assert os.path.dirname(got["source"]) == os.path.join(
            cold, ".import_cache"), got["source"]
        took.append(got["import_s"])
    assert not glob.glob(os.path.join(cold, ".import_cache", "*.new"))
    print(f"reference-format (diffIdx) two-process import: both processes "
          f"imported a fresh copy on a cold cache at once, each index equal "
          f"to the native one ({index.size} entries, mapped from the copy's "
          f"import cache), no *.new file left; {took[0]:.2f} s and "
          f"{took[1]:.2f} s (one decodes under the cache's lock, the other "
          f"waits for it and maps the result), one process alone "
          f"{alone:.2f} s; CPU-only processes on the host of {card}")
    return dirs


def index_digest(index):
    """blake2b of the index's values, taxids and species with their
    dtypes and shapes."""
    h = hashlib.blake2b(digest_size=16)
    for k in ("values", "taxids", "species"):
        a = np.ascontiguousarray(getattr(index, k))
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def em_phase(dp_cuda, classifier, fa, runs, src, card):
    """The single-end reads with em=True on the card (made with
    METABULI_DEVICE_ASSIGN=1 set, which --em overrides: no batch may take
    the device-assign dispatch), then run_em; the species score lists of
    the first N_CPU_CHECK reads equal to the CPU run's."""
    from metabuli_work_tpu_torch.classify.em import run_em

    os.environ["METABULI_DEVICE_ASSIGN"] = "1"
    try:
        clf = classifier(seq_mode=1, batch_size=BATCH, em=True)
        cpu = classifier("cpu", seq_mode=1, batch_size=N_CPU_CHECK, em=True)
    finally:
        del os.environ["METABULI_DEVICE_ASSIGN"]
    assert not clf._device_assign and not cpu._device_assign

    def refuse(*a, **k):
        raise AssertionError("em: a batch took the device-assign dispatch")

    clf._dispatch_batch_full = refuse
    clf.classify_file(fa("warm.fna"))
    clf.taxonomer.species_list_reads = 0
    r = runs["em"] = drive(dp_cuda, clf,
                           lambda: clf.classify_file(fa("reads.fna")))
    assert r["launches"] > 0
    check_path("em", r, N_READS, src, dp_cuda, card)
    stage_table("em", clf, card)
    got_cpu = cpu.classify_file(fa("cpu.fna"))
    scores = lambda res: [(t, list(q.result.species_scores))
                          for q, t in zip(res, full_tuples(res))]
    same_as("em CPU check", "the CPU run (species score lists, tax_cnt and "
            "top_species included)", scores(r["results"][:N_CPU_CHECK]),
            scores(got_cpu))
    out = fa("em_out")
    os.makedirs(out)
    t0 = time.perf_counter()
    st = run_em(r["results"], clf, out, "em")
    t_em = time.perf_counter() - t0
    n_sc = sum(bool(q.result.species_scores) for q in r["results"])
    n_listed = clf.taxonomer.species_list_reads
    assert n_listed == n_sc, (n_listed, n_sc)
    print(f"em: {N_READS} reads, {n_sc} with species scores (the "
          f"scorer's species_list_reads {n_listed}), "
          f"{N_READS / r['dt']:.1f} reads/s (the plain single-end run "
          f"{N_READS / runs['single-end']['dt']:.1f}); no device-assign "
          f"dispatch with METABULI_DEVICE_ASSIGN=1 set; run_em "
          f"{t_em:.3f} s, {st['iterations']} iterations over "
          f"{st['species']} species, {st['mapped']} mapped reads; on {card}")


def cli_phase(fa, reads, ref_dir, em_results, taxonomy, card):
    """`python -m metabuli_work_tpu_torch.cli classify` on the first
    N_CLI reads (FASTQ) and the diffIdx reference DB, on the card, with
    --em, --validate-input, --profile-dir and the flags the JAX CLI
    accepts and ignores; its classifications equal the em phase's (the
    API run) on the same reads, the EM files and a trace exist.  Then
    convertDB, validatedb and printDeltaIdx on that directory."""
    from metabuli_work_tpu_torch.report.reporter import write_classifications

    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "metabuli_work_tpu_torch.cli"]

    def run(argv, timeout=900):
        t0 = time.perf_counter()
        p = subprocess.run(cli + argv, capture_output=True, text=True,
                           cwd=root, timeout=timeout)
        dt = time.perf_counter() - t0
        shown = argv[:1] + [os.path.basename(a) for a in argv[1:]]
        print(f"cli: {' '.join(shown)} -> exit {p.returncode} in {dt:.1f} s")
        assert p.returncode == 0, f"cli {argv[0]}:\n{p.stdout[-3000:]}" \
                                  f"{p.stderr[-3000:]}"
        return p.stdout, dt

    write_fastq(fa("cli.fq"), reads[:N_CLI])
    out, trace = fa("cli_out"), fa("cli_trace")
    stdout, dt = run(["classify", fa("cli.fq"), ref_dir, out, "job",
                      "--seq-mode", "1", "--em", "--validate-input",
                      "--profile-dir", trace, "--threads", "8", "--max-ram",
                      "64", "--hamming-margin", "0", "--match-per-kmer", "4",
                      "--batch-size", str(BATCH), "--min-score", "0.15",
                      "--min-sp-score", "0.5"])
    for line in stdout.splitlines():
        if not line.startswith("Processed read count"):
            print(f"  {line}")
    write_classifications(fa("api_classifications.tsv"),
                          em_results[:N_CLI], taxonomy)
    with open(fa("api_classifications.tsv"), "rb") as a, \
            open(os.path.join(out, "job_classifications.tsv"), "rb") as b:
        assert a.read() == b.read(), \
            "cli: the classifications differ from the API run's"
    em_files = [f"job{x}" for x in ("_mapping_results.txt", "_EM_report.tsv",
                                    "_EM+reclassify_results.tsv",
                                    "_EM+reclassify_report.tsv")]
    for f in em_files:
        assert os.path.getsize(os.path.join(out, f)) > 0, f
    traces = [os.path.join(trace, f) for f in os.listdir(trace)
              if f.endswith(".json")]
    assert traces, "cli: --profile-dir wrote no trace"
    print(f"cli: classify of {N_CLI} FASTQ reads on the reference-format DB "
          f"(with --profile-dir) took {dt:.1f} s with process start; "
          f"classifications identical to the API run's; EM files "
          f"{em_files}; trace {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0]) / 1e6:.1f} MB); on {card}")
    run(["convertDB", ref_dir])
    run(["validatedb", ref_dir])
    stdout, _ = run(["printDeltaIdx", ref_dir, "--limit", "5"])
    return stdout.split()


# ------------------------------------ ORF build, updateDB, accession level
def gene_genome(rng, length):
    """`length` bases of bacterium-like sequence (uint8): genes of
    300-1,500 bp (ATG, stop-free random codons, a stop) on either strand
    between intergenic spacers of 50-300 bp (skewed short, so about 88%
    of the sequence is coding); returns (bases, coding share)."""
    parts, n, coding = [], 0, 0
    while n < length:
        sp = 50 + int(250 * rng.random() ** 2.5)
        parts.append(ACGT[rng.integers(0, 4, size=sp)])
        body = _SENSE[rng.integers(0, len(_SENSE),
                                   size=int(rng.integers(98, 499)))]
        gene = np.concatenate([_ATG, body.reshape(-1),
                               _STOPS[rng.integers(0, 3)]])
        if rng.random() < 0.5:
            gene = _COMP[gene[::-1]]
        parts.append(gene)
        n += sp + len(gene)
        coding += len(gene)
    return np.concatenate(parts)[:length], coding / n


def write_taxdump(d, tax, extra=()):
    """nodes.dmp / names.dmp / merged.dmp of `tax` (original ids) plus
    `extra` rows (taxid, parent taxid, rank, name)."""
    os.makedirs(d, exist_ok=True)
    rows = [(int(tax.orig_of(i)), int(tax.orig_of(int(tax.parent[i]))),
             tax.rank_of(i), tax.name_of(i))
            for i in range(1, tax.num_nodes())] + list(extra)
    with open(os.path.join(d, "nodes.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r, _ in rows)
    with open(os.path.join(d, "names.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n"
                     for t, _, _, n in rows)
    open(os.path.join(d, "merged.dmp"), "w").close()


def write_build_inputs(fa, tag, seqs, taxids, tax, extra=()):
    """FASTA, FASTA list, acc2taxid and taxdump of (name, bases) records;
    returns (fasta list, acc2taxid, taxdump dir)."""
    with open(fa(f"{tag}.fna"), "w") as f:
        for name, s in seqs:
            f.write(f">{name}\n")
            f.write(s.tobytes().decode())
            f.write("\n")
    with open(fa(f"{tag}.txt"), "w") as f:
        f.write(fa(f"{tag}.fna") + "\n")
    with open(fa(f"{tag}.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for (name, _), t in zip(seqs, taxids):
            f.write(f"{name}\t{name}.1\t{t}\t0\n")
    write_taxdump(fa(f"{tag}_taxdump"), tax, extra)
    return fa(f"{tag}.txt"), fa(f"{tag}.map"), fa(f"{tag}_taxdump")


def predictor_line():
    from metabuli_work_tpu_torch.index import prodigal

    if prodigal.available():
        return "prodigal (the vendored Prodigal library built)"
    why = [ln.strip() for ln in prodigal.unavailable_reason().splitlines()
           if "error" in ln] or [prodigal.unavailable_reason()]
    return (f"heuristic (index/orf.py): libprodigal.so cannot be built "
            f"({why[0][:160]})")


def build_or_load_orf_db(fa):
    """ORF_GENOMES gene-structured genomes of GENOME_LEN in two genera
    (3.5% mutations per species), built by build_database with
    orf_prediction=True, gene_predictor="auto" (syncmer, no mask), cached
    under ~/.cache by config key; returns (db dir, genomes, cache hit,
    info: build seconds, k-mers, predictor, share of genome bases inside
    predicted blocks, coding share of the genes)."""
    from metabuli_work_tpu_torch.index.builder import build_database
    from metabuli_work_tpu_torch.index.orf import predict_orfs
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    rng = np.random.default_rng(10)
    bases = [gene_genome(rng, GENOME_LEN) for _ in range(2)]
    genomes = []
    for i in range(ORF_GENOMES):
        g = bases[i % 2][0].copy()
        mut = rng.random(GENOME_LEN) < 0.035
        g[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
        genomes.append(g)
    cache = os.path.join(os.path.expanduser("~/.cache"),
                         f"mwt_torch_smoke_orf_db_{ORF_GENOMES}_{GENOME_LEN}")
    info_p = os.path.join(cache, "smoke.json")
    if os.path.exists(info_p):
        with open(info_p) as f:
            return cache, genomes, True, json.load(f)
    lst, acc, taxdump = write_build_inputs(
        fa, "orf", [(f"ORF{i}", g) for i, g in enumerate(genomes)],
        [1000 + i for i in range(ORF_GENOMES)],
        smoke_taxonomy(Taxonomy))
    tmp = cache + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    index = build_database(tmp, lst, acc, taxdump, syncmer=True, mask_mode=0,
                           orf_prediction=True, gene_predictor="auto",
                           threads=min(ORF_GENOMES, os.cpu_count() or 1))
    info = {"build_s": time.perf_counter() - t0, "kmers": int(index.size),
            "predictor": predictor_line(),
            "coding": float(np.mean([b[1] for b in bases]))}
    covered = 0
    for g in genomes:
        inside = np.zeros(len(g) + 1, np.int32)
        for b, e, _ in predict_orfs(g.tobytes().decode()):
            inside[b] += 1
            inside[e + 1] -= 1
        covered += int((np.cumsum(inside[:-1]) > 0).sum())
    info["covered"] = covered / (ORF_GENOMES * GENOME_LEN)
    with open(os.path.join(tmp, "smoke.json"), "w") as f:
        json.dump(info, f)
    shutil.rmtree(cache, ignore_errors=True)
    os.replace(tmp, cache)
    return cache, genomes, False, info


def expected_ids(tax, species_orig, genus_orig):
    """Internal ids of original species / genus ids (arrays)."""
    to = np.vectorize(tax.to_internal, otypes=[np.int64])
    return to(species_orig), to(genus_orig)


def orf_phase(dp_cuda, classifier_at, fa, runs, n_main, card, prepped):
    """The ORF DB (`prepped`: prep_orf_db's record; it built the DB or
    found it cached), then N_READS single-end reads of its genomes
    through Classifier(db, device="cuda"), 256 held against the CPU
    run."""
    name = "orf build"
    db, genomes, _, info = build_or_load_orf_db(fa)
    print(f"{name}: gene predictor {info['predictor']}")
    print(f"{name}: {ORF_GENOMES} gene-structured genomes x {GENOME_LEN} bp "
          f"(genes {100 * info['coding']:.2f}% of the bases): "
          f"build_database(orf_prediction=True, gene_predictor='auto') "
          f"{info['build_s']:.1f} s"
          f"{' (cached)' if prepped['hit'] else ' in a preparation process'}, "
          f"{info['kmers']} k-mers (the 6-frame smoke DB of random genomes: "
          f"{n_main}); {100 * info['covered']:.2f}% of genome bases inside "
          f"predicted blocks")
    G = np.stack(genomes)
    reads, src = simulate_reads(G, np.random.default_rng(11), N_READS,
                                READ_LEN)
    write_fasta(fa("orf_reads.fna"), reads)
    write_fasta(fa("orf_warm.fna"), reads[:BATCH])
    write_fasta(fa("orf_cpu.fna"), reads[:N_CPU_CHECK])
    t0 = time.perf_counter()
    clf = classifier_at(db)
    setup = time.perf_counter() - t0
    clf.classify_file(fa("orf_warm.fna"))
    r = runs[name] = drive(dp_cuda, clf,
                           lambda: clf.classify_file(fa("orf_reads.fna")))
    assert r["launches"] > 0, f"{name}: no path-DP launch"
    sp, ge = expected_ids(clf.taxonomy, 1000 + src, 101 + src % 2)
    check_path(name, r, N_READS, src, dp_cuda, card, species=sp, genus=ge,
               min_right=ORF_MIN_RIGHT)
    print(f"{name}: classifier setup (pack + upload) {setup:.1f} s")
    stage_table(name, clf, card)
    cpu_check(name, r["results"][:N_CPU_CHECK], classifier_at(db, "cpu")
              .classify_file(fa("orf_cpu.fna")))
    clf = None
    torch.cuda.empty_cache()


NINTH_TAXA = ((103, 1, "genus", "G3"), (1008, 103, "species", "Species8"))


def ninth_genome():
    return ACGT[np.random.default_rng(20).integers(0, 4, size=NINTH_LEN)]


def make_updated_db(fa, index):
    """The smoke index saved as a native DB, then update_database adds
    the ninth genome (NINTH_LEN of random bases) under a new genus and
    species grafted by a new-taxa TSV.  Returns the updated DB's
    directory, its entries and the seconds of the save and the update."""
    from metabuli_work_tpu_torch.index.format import save_index
    from metabuli_work_tpu_torch.index.update import update_database

    ninth = ninth_genome()
    old, new = fa("main_db"), fa("updated_db")
    t0 = time.perf_counter()
    save_index(old, index)
    t_save = time.perf_counter() - t0
    with open(fa("ninth.fna"), "w") as f:
        f.write(f">NINTH\n{ninth.tobytes().decode()}\n")
    with open(fa("ninth.txt"), "w") as f:
        f.write(fa("ninth.fna") + "\n")
    with open(fa("ninth.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\nNINTH\tNINTH.1\t"
                "1008\t0\n")
    with open(fa("new_taxa.tsv"), "w") as f:
        f.writelines(f"{t}\t{p}\t{r}\t{n}\n" for t, p, r, n in NINTH_TAXA)
    t0 = time.perf_counter()
    upd = update_database(old, new, fa("ninth.txt"), fa("ninth.map"),
                          new_taxa_path=fa("new_taxa.tsv"))
    return {"db": new, "entries": int(upd.size), "save_s": t_save,
            "update_s": time.perf_counter() - t0}


def update_phase(dp_cuda, index, classifier_at, fa, reads, runs, card,
                 made):
    """The single-end reads plus N_NINTH reads of the ninth genome
    classified on the updated DB (`made`: prep_updated_db's record, which
    made it and packed its layout) on the card.  Returns the paths and
    reads the later phases use."""
    name = "updateDB"
    ninth = ninth_genome()
    nr, nstart = simulate_reads_at(ninth, np.random.default_rng(21), N_NINTH)
    new = made["db"]
    print(f"{name}: update_database added a {NINTH_LEN}-bp genome under a "
          f"new genus and species (--new-taxa) to the {index.size}-entry "
          f"smoke DB in {made['update_s']:.1f} s ({made['entries']} "
          f"entries; saving the old DB took {made['save_s']:.1f} s; both, "
          f"and packing the updated DB's layout in {made['pack_s']:.1f} s, "
          f"in a preparation process); on {card}")
    mixed = np.concatenate([reads, nr])
    write_fasta(fa("mixed.fna"), mixed)
    half = N_CPU_CHECK // 2
    write_fasta(fa("mixed_cpu.fna"), np.concatenate([reads[:half],
                                                     nr[:half]]))
    cpu_rows = list(range(half)) + list(range(N_READS, N_READS + half))
    t0 = time.perf_counter()
    clf = classifier_at(new)
    setup = time.perf_counter() - t0
    clf.classify_file(fa("warm.fna"))
    r = runs[name] = drive(dp_cuda, clf,
                           lambda: clf.classify_file(fa("mixed.fna")))
    assert r["launches"] > 0, f"{name}: no path-DP launch"
    tax = clf.taxonomy
    res = r["results"]
    on_ninth = np.array([tax.orig_of(q.result.classification) == 1008
                         for q in res[N_READS:]])
    se = runs["single-end"]["results"]
    changed = sum(a != b for a, b in zip(tuples(res[:N_READS]), tuples(se)))
    print(f"{name}: {len(res)} reads ({N_READS} single-end + {N_NINTH} of "
          f"the ninth genome), {r['launches']} kernel launches; "
          f"{100 * on_ninth.mean():.2f}% of the ninth genome's reads at its "
          f"species; {changed} of the {N_READS} single-end reads differ "
          f"from the resident run's (an observation); "
          f"{len(res) / r['dt']:.1f} reads/s; classifier setup (cached "
          f"layout + upload) {setup:.1f} s; peak device memory "
          f"{(r['peak'] - r['base']) / 2**30:.3f} GiB above the run's "
          f"start; read with the {r['reader']} reader; on {card}")
    check_launches(name, r, dp_cuda)
    assert on_ninth.mean() >= 0.95, \
        f"{name}: only {on_ninth.mean():.4f} of the ninth genome's reads " \
        f"at its species"
    stage_table(name, clf, card)
    cpu_check(name, [res[i] for i in cpu_rows],
              classifier_at(new, "cpu").classify_file(fa("mixed_cpu.fna")))
    clf = None
    torch.cuda.empty_cache()
    return {"db": new, "ninth": ninth, "starts": nstart,
            "cpu_rows": cpu_rows}


def simulate_reads_at(g, rng, n):
    """n reads of READ_LEN bases of one genome (1% errors, half reverse-
    complemented); returns (reads, the start of each in the genome)."""
    starts = rng.integers(0, len(g) - READ_LEN, size=n)
    reads = g[starts[:, None] + np.arange(READ_LEN)[None, :]]
    err = rng.random(reads.shape) < 0.01
    reads[err] = ACGT[rng.integers(0, 4, size=int(err.sum()))]
    rc = rng.random(n) < 0.5
    reads[rc] = _COMP[reads[rc, ::-1]]
    return np.ascontiguousarray(reads), starts


def accession_phase(dp_cuda, classifier_at, fa, upd, runs, card):
    """The ninth genome built alone as two accessions of NINTH_LEN / 2
    under its species with accession_level=True; the mixed reads (the
    single-end reads, then the ninth genome's) classified on it on the
    card; the share of the ninth genome's reads called at the accession
    that holds them."""
    from metabuli_work_tpu_torch.index.builder import build_database
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    name = "accession-level"
    # cut at a multiple of 3: the second accession then ends in the same
    # frame phase as the whole genome, whose frames extraction covers
    # over max_covered_length, so both accessions' k-mers are the whole
    # genome's (a cut at 2,000,000 adds a few tail windows of its own)
    half = NINTH_LEN // 2 // 3 * 3
    ninth = upd["ninth"]
    lst, acc, taxdump = write_build_inputs(
        fa, "acc", [("NINTH_A", ninth[:half]), ("NINTH_B", ninth[half:])],
        [1008, 1008], smoke_taxonomy(Taxonomy), NINTH_TAXA)
    db = fa("acc_db")
    t0 = time.perf_counter()
    index = build_database(db, lst, acc, taxdump, syncmer=True, mask_mode=0,
                           accession_level=True)
    t_build = time.perf_counter() - t0
    with open(os.path.join(db, "accession2index")) as f:
        acc_taxid = {a: int(t) for a, t in
                     (ln.split("\t") for ln in f.read().splitlines())}
    clf = classifier_at(db)
    assert clf.taxonomer.accession_level == 1
    clf.classify_file(fa("warm.fna"))
    r = runs[name] = drive(dp_cuda, clf,
                           lambda: clf.classify_file(fa("mixed.fna")))
    assert r["launches"] > 0, f"{name}: no path-DP launch"
    res = r["results"]
    tax = clf.taxonomy
    want = np.where(upd["starts"] < half, acc_taxid["NINTH_A"],
                    acc_taxid["NINTH_B"])
    got = np.array([tax.orig_of(q.result.classification)
                    for q in res[N_READS:]])
    at_species = np.mean(got == 1008)
    hits = np.mean(got == want)
    others = np.mean([q.result.is_classified for q in res[:N_READS]])
    print(f"{name}: built {index.size} entries (2 accessions of {half} bp) "
          f"in {t_build:.1f} s; {len(res)} reads, {r['launches']} kernel "
          f"launches; {100 * hits:.2f}% of the ninth genome's reads called "
          f"at the accession that holds them, {100 * at_species:.2f}% at "
          f"its species; {100 * others:.3f}% of the other reads classified; "
          f"{len(res) / r['dt']:.1f} reads/s; read with the {r['reader']} "
          f"reader; on {card}")
    check_launches(name, r, dp_cuda)
    stage_table(name, clf, card)
    cpu_check(name, [res[i] for i in upd["cpu_rows"]],
              classifier_at(db, "cpu").classify_file(fa("mixed_cpu.fna")))
    clf = None
    torch.cuda.empty_cache()
    return {"db": db, "classified": {q.name for q in res
                                     if q.result.is_classified},
            "distinct": len(np.unique(index.values))}


def filter_phase(dp_cuda, fa, acc, runs, card):
    """filter_reads of the mixed reads with the accession-level DB as the
    contaminant list, on the card: the removed reads are exactly those
    the accession-level phase classified (same parameters); >= 95% of
    the ninth genome's reads removed, <= 1% of the others; 256 reads'
    split equal to the CPU run's."""
    from metabuli_work_tpu_torch.classify import filter as filter_mod
    from metabuli_work_tpu_torch.classify.pipeline import ClassifyParams

    name = "filter"
    made = []

    class Recorded(filter_mod.Classifier):
        """filter_reads' classifier, kept for its stage timer and reader."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    params = ClassifyParams(seq_mode=1, batch_size=BATCH, **SHORT)

    def run(reads_path, out, device):
        paths = filter_mod.filter_reads(reads_path, [acc["db"]], out, "job",
                                        params, device=device)
        removed = {ln[1:].split()[0] for ln in open(paths[0][1])
                   if ln.startswith(">")}
        kept = {ln[1:].split()[0] for ln in open(paths[0][0])
                if ln.startswith(">")}
        return removed, kept

    plain = filter_mod.Classifier
    filter_mod.Classifier = Recorded
    try:
        r = runs[name] = drive(dp_cuda, lambda: made[-1], lambda: run(
            fa("mixed.fna"), fa("filter_out"), "cuda"))
        made.clear()
        cpu_removed, _ = run(fa("mixed_cpu.fna"), fa("filter_cpu"), "cpu")
    finally:
        filter_mod.Classifier = plain
    made.clear()
    removed, kept = r["results"]
    assert r["launches"] > 0, f"{name}: no path-DP launch"
    assert len(removed) + len(kept) == N_READS + N_NINTH
    assert removed == acc["classified"], \
        f"{name}: the removed reads differ from the accession-level " \
        f"phase's classified reads"
    ninth = {f"r{i}" for i in range(N_READS, N_READS + N_NINTH)}
    share_ninth = len(removed & ninth) / N_NINTH
    share_other = len(removed - ninth) / N_READS
    print(f"{name}: {N_READS + N_NINTH} reads against the accession-level "
          f"DB: removed {len(removed)} (exactly the reads the "
          f"accession-level phase classified), "
          f"{100 * share_ninth:.2f}% of the ninth genome's, "
          f"{100 * share_other:.3f}% of the others; "
          f"{(N_READS + N_NINTH) / r['dt']:.1f} reads/s with the split; "
          f"read with the {r['reader']} reader; on {card}")
    check_launches(name, r, dp_cuda)
    assert share_ninth >= 0.95 and share_other <= 0.01, (share_ninth,
                                                         share_other)
    print(f"{name} stage timer (host seconds) on {card}:")
    print(r["timer"].report())
    half = N_CPU_CHECK // 2
    rows = [f"r{i}" for i in range(half)] + \
        [f"r{i}" for i in range(N_READS, N_READS + half)]
    # the CPU file numbers its reads 0..255
    gpu_split = [name_ in removed for name_ in rows]
    cpu_split = [f"r{i}" in cpu_removed for i in range(N_CPU_CHECK)]
    same_as(f"{name} CPU check", "the CPU run's split", gpu_split,
            cpu_split)
    return removed


def cli_tools_phase(fa, src, ref_dir, upd, acc, removed, card):
    """The CLI's new subcommands as subprocesses, on the card: filter of
    N_CLI of the mixed reads (its split equal to the API filter's),
    grade of the cli phase's classifications against the simulated
    answer sheet (F1 at species and genus), taxdump of the updated DB,
    count-common-kmers of the accession-level DB against the updated DB
    (shared = the accession-level DB's distinct values: both extract with
    the same parameters)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "metabuli_work_tpu_torch.cli"]

    def run(argv, timeout=900):
        t0 = time.perf_counter()
        p = subprocess.run(cli + argv, capture_output=True, text=True,
                           cwd=root, timeout=timeout)
        dt = time.perf_counter() - t0
        shown = argv[:1] + [os.path.basename(a) for a in argv[1:]]
        print(f"cli: {' '.join(shown)} -> exit {p.returncode} in {dt:.1f} s")
        assert p.returncode == 0, f"cli {argv[0]}:\n{p.stdout[-3000:]}" \
                                  f"{p.stderr[-3000:]}"
        return p.stdout

    half = N_CLI // 2
    picked = list(range(half)) + list(range(N_READS, N_READS + half))
    with open(fa("mixed.fna")) as f:
        lines = f.read().splitlines()
    with open(fa("cli_filter.fq"), "w") as f:
        for i in picked:
            seq = lines[2 * i + 1]
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    with open(fa("contam.txt"), "w") as f:
        f.write(acc["db"] + "\n")
    out = run(["filter", fa("cli_filter.fq"), fa("cli_filter"), "job",
               "--contam-list", fa("contam.txt"), "--seq-mode", "1",
               "--batch-size", str(BATCH), "--min-score",
               str(SHORT["min_score"]), "--min-sp-score",
               str(SHORT["min_sp_score"]), "--device", "cuda"])
    print(f"  {out.strip()}")
    got = {ln[1:].split()[0] for k, ln in enumerate(
        open(os.path.join(fa("cli_filter"), "job_1_removed.fq")))
        if k % 4 == 0}
    want = {f"r{i}" for i in picked} & removed
    assert got == want, "cli filter: the split differs from the API run's"
    print(f"cli: filter of {N_CLI} FASTQ reads removed {len(got)}, the API "
          f"filter's reads among them exactly; on {card}")
    with open(fa("answers.tsv"), "w") as f:
        f.writelines(f"r{i}\t{1000 + int(s)}\n"
                     for i, s in enumerate(src[:N_CLI]))
    out = run(["grade", os.path.join(fa("cli_out"), "job_classifications.tsv"),
               fa("answers.tsv"), ref_dir])
    f1 = {}
    for ln in out.splitlines():
        parts = ln.split("\t")
        if parts[0] in ("species", "genus"):
            f1[parts[0]] = float(parts[3])
            print(f"  {ln}")
    print(f"cli: grade of the cli phase's {N_CLI} classifications: F1 "
          f"{f1['species']:.4f} at species, {f1['genus']:.4f} at genus")
    assert f1["genus"] >= 0.9, f1
    run(["taxdump", upd["db"], fa("taxdump_out")])
    with open(os.path.join(fa("taxdump_out"), "nodes.dmp")) as f:
        assert "1008\t|\t103\t|\tspecies" in f.read()
    out = run(["count-common-kmers", acc["db"], upd["db"]])
    print(f"  {out.strip()}")
    a, b, shared = (int(x.split("=")[1]) for x in out.split()[1:4])
    assert shared == a == acc["distinct"], (a, b, shared)
    print(f"cli: count-common-kmers: every one of the accession-level DB's "
          f"{a} distinct values is in the updated DB ({b} distinct); on "
          f"{card}")


# ------------- AA-only extraction, read groups, UniRef
UNIREF = (20, 10, 10)            # UniRef50 x UniRef90 x UniRef100 clusters
UNIREF_LEN = (200, 400)          # protein lengths
AA_LETTERS = np.array(list("ARNDCQEGHILKMFPSTWYV"))


def aa_extract_phase(reads, card):
    """extract_batch(aa_only=True, k=12) on the card over the single-end
    reads, with and without syncmer: exactly the port's CPU run of the
    same function, and for N_CPU_CHECK reads the per-read (k-mer,
    position) multiset of the host scanner
    encode_np.extract_query_kmers(aa_only=True)."""
    from metabuli_work_tpu_torch.ops import encode_np, encode_torch

    lens = np.full(len(reads), reads.shape[1], np.int32)
    host = (torch.from_numpy(reads), torch.from_numpy(lens))
    dev = tuple(t.cuda() for t in host)
    for syncmer in (False, True):
        kw = dict(syncmer=syncmer, k=12, aa_only=True)
        out = encode_torch.extract_batch(*dev, **kw)
        ms = time_cuda(lambda: encode_torch.extract_batch(*dev, **kw), 5)
        t0 = time.perf_counter()
        cpu = encode_torch.extract_batch(*host, **kw)
        cpu_s = time.perf_counter() - t0
        for a, b in zip(out, cpu):
            assert torch.equal(a.cpu(), b), "AA-only extraction: card != CPU"
        k, p, v = (t[:N_CPU_CHECK].cpu().numpy() for t in out)
        for b in range(N_CPU_CHECK):
            km, pos, _ = encode_np.extract_query_kmers(
                reads[b].tobytes().decode(), **kw)
            assert sorted(zip(k[b][v[b]].tolist(), p[b][v[b]].tolist())) \
                == sorted(zip(km.astype(np.int64).tolist(),
                              pos.astype(np.int64).tolist())), \
                f"AA-only extraction: read {b} differs from the host scanner"
        n = int(out[2].sum())
        print(f"aa-only extraction ({'syncmer' if syncmer else 'plain'}): "
              f"{len(reads)} reads -> {n} valid 12-mers, equal to the CPU "
              f"run ({cpu_s:.2f} s there) and, for {N_CPU_CHECK} reads, to "
              f"the host scanner; {ms:.3f} ms a call on {card}")


EXTRACT_SHAPES = (                 # the benchmark cells' extraction shapes
    ("paired", 1024, (168, 168)),    # 2 x 150 bp, bucketed to 168
    ("api", 1024, (168,)),           # 150 bp single-end
    ("long", 32, (None,)),           # log-normal median 8 kb, 1-60 kb
)


def extract_phase(card):
    """The fused extraction kernel (csrc/extract.cu) at the benchmark
    cells' shapes (syncmer, win_frac 184, as the gtdb40 cells run):
    every output equal to its plain torch version on the same CUDA
    tensors; the kernel's device ms a call (back to back) beside its
    byte bound (the reads and lengths read once, 21 bytes a flat slot
    written once) and the plain version's ms a call.  Returns the
    kernels-line entry."""
    from metabuli_work_tpu_torch.classify.pipeline import _bucket_len
    from metabuli_work_tpu_torch.models import flagship
    from metabuli_work_tpu_torch.ops import encode_cuda

    rng = np.random.default_rng(16)
    kw = dict(syncmer=True, smer_len=5, kmer_format=2, win_frac=184)
    shapes = []
    for name, B, lmaxes in EXTRACT_SHAPES:
        parts = []
        for lmax in lmaxes:
            if lmax is None:
                lens = np.clip(rng.lognormal(np.log(8000), 0.6, B), 1000,
                               60_000).astype(np.int32)
                lmax = _bucket_len(int(lens.max()))
            else:
                lens = np.full(B, READ_LEN, np.int32)
            arr = np.full((B, lmax), ord("N"), np.uint8)
            for b in range(B):
                arr[b, :lens[b]] = ACGT[rng.integers(0, 4, int(lens[b]))]
            parts += [torch.from_numpy(arr).cuda(),
                      torch.from_numpy(lens).cuda()]
        call = lambda: flagship.extract_queries_step(*parts, **kw)
        plain = lambda: flagship.extract_queries_step_ref(*parts, **kw)
        got, ref = call(), plain()
        torch.cuda.synchronize()
        for a, b in zip(got[:5], ref[:5]):
            assert torch.equal(a, b), f"extract kernel != plain ({name})"
        assert got[5] == ref[5] and int(got[6]) == int(ref[6])
        n0 = encode_cuda.launches
        ms = time_cuda(call, 50, queue_ahead=True)
        torch.cuda.synchronize()
        assert encode_cuda.launches - n0 == 51, "one launch a call"
        plain_ms = time_cuda(plain, 3)
        torch.cuda.synchronize()
        n_slots = got[0].numel()
        rows = [p.shape[1] for p in parts[::2]]
        nbytes = sum(p.numel() * p.element_size() for p in parts) \
            + 21 * n_slots
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"extract kernel {name} (B={B}, rows of {rows} bases, "
              f"{n_slots} slots, {int(got[4].sum())} valid): {ms:.4f} "
              f"ms/launch, byte bound {bound_ms:.4f} ms ({nbytes} B), "
              f"plain version {plain_ms:.3f} ms; exact on {card}")
        shapes.append({"path": name, "B": B, "rows": rows, "slots": n_slots,
                       "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
                       "plain_ms": plain_ms, "max_abs_err": 0})
    first = shapes[0]
    return {"name": "extract", "variant": None, "path": first["path"],
            "route": "cuda",
            "source": "metabuli_work_tpu_torch/csrc/extract.cu",
            "replaces": None, "launches": None,
            "max_abs_err": 0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shapes": shapes}


PROBE_CAP = 20                     # the gtdb40 cells' settled cap


def shape_reads(G, rng, name, B, lmaxes):
    """The CUDA reads of one benchmark shape, drawn from the smoke
    genomes: [reads1, lens1(, reads2, lens2)], 150-bp reads (or pairs)
    padded to 168, or log-normal long reads of 1-60 kb padded to their
    length bucket."""
    from metabuli_work_tpu_torch.classify.pipeline import _bucket_len

    if name == "paired":
        mates = simulate_pairs(G, rng, B, READ_LEN)[:2]
    elif name == "api":
        mates = simulate_reads(G, rng, B, READ_LEN)[:1]
    else:
        lens = np.clip(rng.lognormal(np.log(8000), 0.6, B), 1000,
                       60_000).astype(np.int32)
        mates = [[simulate_reads(G, rng, 1, int(n))[0][0] for n in lens]]
    parts = []
    for rows, lmax in zip(mates, lmaxes):
        lens = np.array([len(r) for r in rows], np.int32)
        lmax = lmax or _bucket_len(int(lens.max()))
        arr = np.full((B, lmax), ord("N"), np.uint8)
        for b, r in enumerate(rows):
            arr[b, :len(r)] = r
        parts += [torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()]
    return parts


def probe_inputs(G, rng, clf, name, B, lmaxes):
    """The CUDA query tensors (qk, qf, qv) of one benchmark shape
    (shape_reads), extracted on the card."""
    from metabuli_work_tpu_torch.models import flagship

    parts = shape_reads(G, rng, name, B, lmaxes)
    qk, _, qf, _, qv, _, _ = flagship.extract_queries_step(
        *parts, syncmer=clf.syncmer, smer_len=clf.smer_len,
        kmer_format=clf.kmer_format, win_frac=clf._win_frac)
    return qk, qf, qv, [p.shape[1] for p in parts[::2]]


def probe_phase(clf, G, card):
    """The probe kernel (csrc/probe.cu) at the benchmark cells' shapes
    (EXTRACT_SHAPES' batches of reads drawn from the smoke genomes, cap
    PROBE_CAP) on the resident wide index of `clf`: equal to the plain
    torch body on the same CUDA tensors (sel and overflow everywhere, the
    five fields where sel holds, 0 elsewhere); the kernel's device ms a
    call (back to back) beside its byte bound and the plain body's ms a
    call.  The bound counts a 512-byte hash row and cap 16-byte window
    entries read and cap 21-byte slots written for each valid query; the
    kernel also writes the cap slots of every other query and reads 13
    bytes a query, and the bound with those is given beside it.  Returns
    the kernels-line entry."""
    from metabuli_work_tpu_torch.ops import match_cuda, match_torch

    rng = np.random.default_rng(18)
    cap, kf, kw = PROBE_CAP, clf.kmer_format, clf._probe_kw
    assert kw["hash_table"] is not None and clf.db_quad.shape[1] == 128
    shapes = []
    for name, B, lmaxes in EXTRACT_SHAPES:
        qk, qf, qv, rows = probe_inputs(G, rng, clf, name, B, lmaxes)
        args = (qk, qf, qv, clf.db_quad, cap, kf)
        call = lambda: match_torch.match_kmers_quad(*args, **kw)
        plain = lambda: match_torch.match_kmers_quad_ref(*args, **kw)
        got, ref = call(), plain()
        torch.cuda.synchronize()
        sel = ref["sel"]
        assert torch.equal(got["sel"], sel), f"probe kernel sel ({name})"
        assert int(got["overflow"]) == int(ref["overflow"])
        for k in ("hamming", "rh", "taxid", "species", "dna_enc"):
            assert torch.equal(got[k], torch.where(sel, ref[k], 0)), \
                f"probe kernel != plain ({name}, {k})"
        n0 = match_cuda.launches
        ms = time_cuda(call, 50, queue_ahead=True)
        torch.cuda.synchronize()
        assert match_cuda.launches - n0 == 51, "one launch a call"
        plain_ms = time_cuda(plain, 3)
        torch.cuda.synchronize()
        n, valid = qk.numel(), int(qv.sum())
        valid_bytes = valid * (512 + cap * (16 + 21))
        all_bytes = valid_bytes + (n - valid) * cap * 21 + n * 13
        bound_ms = valid_bytes / HBM_BYTES_PER_S * 1e3
        all_ms = all_bytes / HBM_BYTES_PER_S * 1e3
        print(f"probe kernel {name} (B={B}, rows of {rows} bases, {n} "
              f"slots, {valid} valid, cap {cap}, {int(sel.sum())} selected, "
              f"overflow {int(ref['overflow'])}): {ms:.4f} ms/launch, byte "
              f"bound {bound_ms:.4f} ms ({valid_bytes} B of the valid "
              f"slots), {all_ms:.4f} ms with every slot's outputs "
              f"({all_bytes} B), plain body {plain_ms:.3f} ms; exact on "
              f"{card}")
        shapes.append({"path": name, "B": B, "rows": rows, "slots": n,
                       "valid": valid, "cap": cap, "ms": ms,
                       "bound_ms": bound_ms, "bound_all_ms": all_ms,
                       "bound_by": "bytes", "plain_ms": plain_ms,
                       "max_abs_err": 0})
        del got, ref, sel, qk, qf, qv
    first = shapes[0]
    return {"name": "probe", "variant": None, "path": first["path"],
            "route": "cuda",
            "source": "metabuli_work_tpu_torch/csrc/probe.cu",
            "replaces": None, "launches": None,
            "max_abs_err": 0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shapes": shapes}


def redundancy_phase(clf, G, card):
    """The redundancy kernel (csrc/redundancy.cu) at the benchmark cells'
    shapes (EXTRACT_SHAPES' batches of reads drawn from the smoke
    genomes, cap PROBE_CAP), on the resident tensors of one fused_step_dp
    of each on `clf`'s index, every read's best species the largest
    species among its candidates (none for every third read): equal to
    the plain torch body on the same CUDA tensors (the stats column and
    the first min(count, width) pairs) at the host-scoring flows' prefix
    width and at full width; the kernel's device ms a call (back to back,
    at the prefix width) beside its byte bounds and the plain body's ms
    a call.  The tight bound counts the sel byte of every candidate
    slot, 12 B of fields a selected candidate, a position a slot, the
    group minima and the pairs; the loose one 13 B a candidate slot.
    Returns the kernels-line entry."""
    from metabuli_work_tpu_torch.models import flagship
    from metabuli_work_tpu_torch.ops import redundancy_cuda

    rng = np.random.default_rng(20)
    dna_shift = int(clf.taxonomer.dna_shift)
    shapes = []
    for name, B, lmaxes in EXTRACT_SHAPES:
        parts = shape_reads(G, rng, name, B, lmaxes)
        r2, j2 = parts[2:] if len(parts) > 2 else (None, None)
        _, res = flagship.fused_step_dp(
            parts[0], parts[1], clf.db_quad, reads2=r2, lens2=j2,
            min_cons=int(clf.params.min_cons_cnt),
            min_cons_euk=int(clf.params.min_cons_cnt_euk), cap=PROBE_CAP,
            kmer_format=clf.kmer_format, syncmer=clf.syncmer,
            smer_len=clf.smer_len, path_width=clf._path_width,
            win_frac=clf._win_frac, path_block=clf._path_block,
            **clf._probe_kw)
        sel, species, qs = res[0], res[1], res[5]
        best = torch.zeros(B + 1, dtype=torch.int32, device=sel.device)
        best.scatter_reduce_(0, qs.long(), torch.where(sel, species, 0)
                             .max(0).values, reduce="amax")
        best[::3] = 0
        lm1 = parts[0].shape[1]
        lm2 = r2.shape[1] if r2 is not None else None
        kw = dict(dna_shift=dna_shift,
                  n_quot=(lm1 + (lm2 + 3 if lm2 else 0)) // dna_shift + 2,
                  part_w=flagship.part_widths(
                      lm1, clf.syncmer, clf.kmer_format, clf.smer_len,
                      clf._win_frac, lmax2=lm2))
        args = (*res, best, clf.euler, clf.lca_depth, clf.lca_lift)
        for out_w in (0, clf._pair_width):
            got = flagship.redundancy_counts(*args, out_w=out_w, **kw)
            ref = flagship.redundancy_counts_ref(*args, out_w=out_w, **kw)
            torch.cuda.synchronize()
            count = int(ref[0, 0])
            k = 1 + min(count, ref.shape[1] - 1)
            assert got.shape == ref.shape and count > 0 and \
                torch.equal(got[:, :k], ref[:, :k]), \
                f"redundancy kernel != plain ({name}, out_w {out_w})"
        call = lambda: flagship.redundancy_counts(
            *args, out_w=clf._pair_width, **kw)
        plain = lambda: flagship.redundancy_counts_ref(
            *args, out_w=clf._pair_width, **kw)
        n0 = redundancy_cuda.launches
        ms = time_cuda(call, 50, queue_ahead=True)
        torch.cuda.synchronize()
        assert redundancy_cuda.launches - n0 == 51, "one launch a call"
        plain_ms = time_cuda(plain, 3)
        torch.cuda.synchronize()
        cap, n = sel.shape
        n_groups = B * kw["n_quot"]
        n_sel = int(sel.sum())
        tight = cap * n + 12 * n_sel + 4 * n + 8 * n_groups \
            + 8 * min(count, clf._pair_width)
        loose = 13 * cap * n
        tight_ms = tight / HBM_BYTES_PER_S * 1e3
        loose_ms = loose / HBM_BYTES_PER_S * 1e3
        print(f"redundancy kernel {name} (B={B}, {n} slots, cap {cap}, "
              f"{n_sel} selected, {int(ref[1, 0])} best-species matches, "
              f"{n_groups} groups, {count} pairs): {ms:.4f} ms/launch, "
              f"byte bound {tight_ms:.4f} ms ({tight} B), {loose_ms:.4f} "
              f"ms at 13 B a candidate slot ({loose} B), plain body "
              f"{plain_ms:.3f} ms; exact on {card}")
        shapes.append({"path": name, "B": B, "slots": n, "cap": cap,
                       "selected": n_sel, "groups": n_groups,
                       "pairs": count, "ms": ms, "bound_ms": tight_ms,
                       "bound_loose_ms": loose_ms, "bound_by": "bytes",
                       "plain_ms": plain_ms, "max_abs_err": 0})
        del res, sel, species, qs, args, got, ref
    first = shapes[0]
    return {"name": "redundancy", "variant": None, "path": first["path"],
            "route": "cuda",
            "source": "metabuli_work_tpu_torch/csrc/redundancy.cu",
            "replaces": None, "launches": None,
            "max_abs_err": 0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shapes": shapes}


def readgroup_phase(fa, src, src2, se_results, card, common):
    """run_grouping of the single-end reads and of the pairs (native
    union-find) against the common-k-mer DB of the smoke genomes
    (`common`: prep_common_db's record; six frames, the >= 2-species
    filter applied); apply_groups on the single-end run's
    classifications.  Fails if a group holds reads of both genera
    (random sequence apart: no k-mer should join them)."""
    from metabuli_work_tpu_torch.readgroup.apply import apply_groups
    from metabuli_work_tpu_torch.readgroup.grouping import (GroupingParams,
                                                            run_grouping)
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    tax = smoke_taxonomy(Taxonomy)
    taxdump = common["taxdump"]
    print(f"read groups: common-k-mer DB of {common['kmers']} AA 12-mers "
          f"shared by >= 2 species over {common['genomes']} genomes in "
          f"{common['seconds']:.1f} s (in a preparation process)")
    groups_of = {}
    for name, files, s_, mode in (
            ("single-end", (fa("reads.fna"), None), src, 1),
            ("paired", (fa("pairs_1.fna"), fa("pairs_2.fna")), src2, 2)):
        out = fa(f"groups_{mode}")
        t0 = time.perf_counter()
        qg = run_grouping(files[0], common["dir"], out,
                          GroupingParams(seq_mode=mode), files[1])[1:]
        dt = time.perf_counter() - t0
        grouped = qg > 0
        gids = np.unique(qg[grouped])
        both = [g for g in gids if len(set((s_[qg == g] % 2).tolist())) > 1]
        own = 0
        for g in gids:
            members = s_[qg == g]
            own += int((members == np.bincount(members).argmax()).sum())
        print(f"read groups, {name}: {dt:.1f} s, {len(gids)} groups, "
              f"{int(grouped.sum())} of {len(qg)} reads grouped, "
              f"{100 * own / max(int(grouped.sum()), 1):.2f}% of grouped "
              f"reads in a group whose majority species is their own; "
              f"{len(both)} groups hold reads of both genera")
        assert len(gids) > 0, f"read groups, {name}: no group"
        assert not both, f"read groups, {name}: groups across genera"
        groups_of[mode] = (out, qg)
    with open(fa("se_cls.tsv"), "w") as f:
        for q in se_results:
            c = int(q.result.classification)
            f.write(f"{int(q.result.is_classified)}\t{q.name}\t"
                    f"{tax.orig_of(c) if c else 0}\t{READ_LEN}\t"
                    f"{float(q.result.score):.4f}\t"
                    f"{tax.rank_of(c) if c else '-'}\t-\n")
    out, qg = groups_of[1]
    t0 = time.perf_counter()
    path = apply_groups(os.path.join(out, "groups"),
                        os.path.join(out, "groupMap"), taxdump,
                        fa("se_cls.tsv"), fa("applied"))
    dt = time.perf_counter() - t0
    before = np.array([tax.orig_of(int(q.result.classification))
                       if q.result.classification else 0
                       for q in se_results])
    with open(path) as f:
        after = np.array([int(ln.split("\t")[2]) for ln in f
                          if not ln.startswith("#")])
    right = lambda t: np.mean((t == 1000 + src) | (t == 101 + src % 2))
    print(f"read groups, apply-group: {dt:.1f} s, {int((after != before).sum())}"
          f" labels changed; at source species or genus "
          f"{100 * right(before):.2f}% before, {100 * right(after):.2f}% "
          f"after; on {card}")


def uniref_inputs(rng, fa):
    """A UniRef XML and protein set from rng: UNIREF[0] UniRef50 clusters
    of UNIREF[1] UniRef90 clusters of UNIREF[2] UniRef100 clusters; a
    UniRef90 ancestor is a 20%-mutant of its UniRef50 ancestor, a
    UniRef100 protein a 5%-mutant of its UniRef90 ancestor.  Queries: an
    exact copy of every other protein and a 3%-mutant of the rest.
    Returns ({query name: its UniRef100 cluster}, {name: exact copy})."""
    def mutate(p, rate):
        p = p.copy()
        m = rng.random(len(p)) < rate
        p[m] = rng.choice(AA_LETTERS, size=int(m.sum()))
        return p

    prots, rows = {}, []
    for a in range(UNIREF[0]):
        anc50 = rng.choice(AA_LETTERS, size=int(rng.integers(*UNIREF_LEN)))
        for b in range(UNIREF[1]):
            anc90 = mutate(anc50, 0.2)
            for c in range(UNIREF[2]):
                u100 = f"UniRef100_S{a}_{b}_{c}"
                prots[u100] = mutate(anc90, 0.05)
                rows.append((u100, f"UniRef90_S{a}_{b}", f"UniRef50_S{a}"))
    with open(fa("uniref.xml"), "w") as f:
        f.write('<?xml version="1.0"?>\n'
                '<UniRef100 xmlns="http://uniprot.org/uniref">\n')
        f.writelines(f'<entry id="{u}">\n<property type="UniRef90 ID" '
                     f'value="{u9}"/>\n<property type="UniRef50 ID" '
                     f'value="{u5}"/>\n</entry>\n' for u, u9, u5 in rows)
        f.write("</UniRef100>\n")
    with open(fa("proteins.faa"), "w") as f:
        f.writelines(f">{n}\n{''.join(p)}\n" for n, p in prots.items())
    truth, exact = {}, {}
    with open(fa("queries.faa"), "w") as f:
        for i, (n, p) in enumerate(prots.items()):
            q = p if i % 2 == 0 else mutate(p, 0.03)
            name = f"q{i}"
            truth[name], exact[name] = n, i % 2 == 0
            f.write(f">{name}\n{''.join(q)}\n")
    with open(fa("cluster2taxid.tsv"), "w") as f:
        for k, (u, u9, u5) in enumerate(rows):
            f.write(f"{u}\t{100000 + k}\n")
            if k % UNIREF[2] == 0:
                f.write(f"{u9}\t{50000 + k // UNIREF[2]}\n")
    return truth, exact


def uniref_phase(fa, seed, card):
    """The UniRef chain as CLI subprocesses on a set made from `seed`:
    create-uniref-tree, create-uniref-db, create-unique-kmer-list,
    assign_uniref, uniref2taxonomy (seconds with process start).  Fails
    unless every query that is an exact copy of a DB protein is assigned
    to its own cluster or an ancestor of it; prints that share for the
    mutated queries."""
    from metabuli_work_tpu_torch.uniref.tree import UnirefTree

    truth, exact = uniref_inputs(np.random.default_rng(seed), fa)
    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "metabuli_work_tpu_torch.cli"]
    for argv in (["create-uniref-tree", fa("uniref.xml"), fa("tree.npz")],
                 ["create-uniref-db", fa("uniref_db"), fa("proteins.faa"),
                  fa("tree.npz")],
                 ["create-unique-kmer-list", fa("unique_db"),
                  fa("proteins.faa")],
                 ["assign_uniref", fa("queries.faa"), fa("uniref_db"),
                  fa("uniref_out")],
                 ["uniref2taxonomy",
                  os.path.join(fa("uniref_out"), "uniref_classifications.tsv"),
                  fa("cluster2taxid.tsv"), fa("uniref_tax.tsv")]):
        t0 = time.perf_counter()
        p = subprocess.run(cli + argv, capture_output=True, text=True,
                           cwd=root, timeout=900)
        dt = time.perf_counter() - t0
        print(f"uniref: {argv[0]} -> exit {p.returncode} in {dt:.1f} s: "
              f"{p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ''}")
        assert p.returncode == 0, f"uniref {argv[0]}:\n{p.stdout[-3000:]}" \
                                  f"{p.stderr[-3000:]}"
    tree = UnirefTree.load(fa("tree.npz"))
    hit = {True: [], False: []}
    with open(os.path.join(fa("uniref_out"),
                           "uniref_classifications.tsv")) as f:
        next(f)
        for ln in f:
            _, name, uid = ln.split("\t")[:3]
            hit[exact[name]].append(int(uid) > 0 and tree.is_ancestor(
                int(uid), tree.name2id[truth[name]]))
    with open(fa("uniref_tax.tsv")) as f:
        n_tax = sum(1 for _ in f) - 1
    assert n_tax == len(truth), (n_tax, len(truth))
    share = lambda h: 100 * sum(h) / len(h)
    print(f"uniref: {len(tree)} tree nodes, {len(truth)} queries; exact "
          f"copies at their own cluster or an ancestor "
          f"{share(hit[True]):.2f}%, 3%-mutants {share(hit[False]):.2f}%; "
          f"uniref2taxonomy wrote {n_tax} rows")
    assert all(hit[True]), "uniref: an exact copy left its own lineage"


# ------------------------------------------------ high-cap single-end
HIGHCAP = "high-cap single-end"
# the retry ladder's sticky knobs
KNOBS = ("cap", "_path_block", "_path_width", "_win_frac")
HC_SPECIES = (44, 4)             # species of the high-cap DB's two genera
HC_LEN = 512_000                 # bases a genome
HC_DIV = 0.01                    # each species' divergence from its genus
HC_READS = 8192
HC_CPU = 256                     # reads held against the CPU run
# the cap > 32 kernel that the warp-per-lane design replaced (one block a
# lane, a cap x cap scan a window), timed by this script's time_shapes on
# this phase's captured inputs on an NVIDIA H100 80GB HBM3, 700.00 W:
# ms a launch by (cap, W, compact5)
EARLIER_BLOCK_MS = {(84, 36, True): 3.51628173828125}


def highcap_taxonomy(Taxonomy):
    """root(1) -> genera HA(2), HB(3) -> species 4.. (HC_SPECIES[0] in
    HA, then HC_SPECIES[1] in HB)."""
    na, nb = HC_SPECIES
    n = na + nb
    return Taxonomy(np.array([0, 1, 1, 1] + [2] * na + [3] * nb),
                    np.array([0, 0, 1, 1] + [2] * n),
                    np.array([0, 0, 1, 2] + [3 + i for i in range(n)]),
                    ["no rank", "genus", "species"],
                    ["root", "HA", "HB"] + [f"HSpecies{i}" for i in range(n)],
                    np.array([0, 1, 301, 302] + [3000 + i for i in range(n)]))


def build_or_load_highcap_db():
    """Syncmer DB of a many-species genus: every species of a genus is
    its random ancestor with HC_DIV of the bases mutated, so an AA 8-mer
    of the genus occurs once in almost every species and the AA runs
    are about as long as the genus has species.  Cached under ~/.cache
    by config key."""
    from metabuli_work_tpu_torch.index.builder import IndexBuilder
    from metabuli_work_tpu_torch.index.format import KmerIndex
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    tax = highcap_taxonomy(Taxonomy)
    na, nb = HC_SPECIES
    cache = os.path.join(os.path.expanduser("~/.cache"),
                         f"mwt_torch_highcap_db_{na}_{nb}_{HC_LEN}.npz")
    meta = {"kmer_format": 2, "syncmer": True, "smer_len": 5,
            "reduced_aa": 0, "mask_mode": 0, "mask_prob": 0.9,
            "skip_redundancy": 1}
    if os.path.exists(cache):
        with np.load(cache) as z:
            genomes = [g.decode() for g in z["genomes"]]
            return KmerIndex(z["v"], z["t"], z["s"], tax, meta), genomes, True
    rng = np.random.default_rng(30)
    builder = IndexBuilder(tax, syncmer=True, mask_mode=0)
    ancestors = [ACGT[rng.integers(0, 4, size=HC_LEN)] for _ in range(2)]
    genomes = []
    for i in range(na + nb):
        g = ancestors[int(i >= na)].copy()
        mut = rng.random(HC_LEN) < HC_DIV
        g[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
        genomes.append(g.tobytes().decode())
        builder.add_sequence(genomes[-1], 4 + i)
    index = builder.finalize()
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    tmp = cache + ".tmp.npz"
    np.savez(tmp, v=index.values, t=index.taxids, s=index.species,
             genomes=np.array([g.encode() for g in genomes]))
    os.replace(tmp, cache)
    return index, genomes, False


def highcap_phase(dp_cuda, classifier_of, fa, runs, card, prepped, prep,
                  cpu_reads):
    """HC_READS single-end reads of the many-species DB (`prepped`:
    prep_highcap_db's record, which built it or found it cached) through
    Classifier(device="cuda"): the setup cap (the 99.9% AA-run quantile)
    must exceed 32, so every launch is the cap > 32 kernel; the first
    HC_CPU reads (written to `cpu_reads`) go to a CPU run in `prep`, and
    it returns the card's results of them for highcap_cpu_check.  The kernel's times, bounds and
    parity on the captured inputs come with every path's at the end."""
    na, nb = HC_SPECIES
    t0 = time.perf_counter()
    index, genomes, _ = build_or_load_highcap_db()
    t_db = time.perf_counter() - t0
    reads, src = simulate_reads(genome_matrix(genomes),
                                np.random.default_rng(31), HC_READS, READ_LEN)
    write_fasta(fa("hc_reads.fna"), reads)
    write_fasta(fa("hc_warm.fna"), reads[:BATCH])
    write_fasta(cpu_reads, reads[:HC_CPU])
    t0 = time.perf_counter()
    clf = classifier_of(index, "cuda")
    setup = time.perf_counter() - t0
    cap0 = clf.cap
    print(f"{HIGHCAP}: DB of {na} + {nb} species in 2 genera x {HC_LEN} bp "
          f"({100 * HC_DIV:g}% per species from its genus's ancestor), "
          f"{index.size} entries ("
          + ("cached" if prepped["hit"] else
             f"built in {prepped['seconds']:.1f} s in a preparation process")
          + f"; loaded in {t_db:.1f} s); AA runs: 99.9% quantile "
          f"{index.cap_aa_run()}, "
          f"longest {index.max_aa_run()}; classifier setup {setup:.1f} s, "
          f"setup cap {cap0}; on {card}")
    assert cap0 > dp_cuda.WARP_MAX_CAP, \
        f"{HIGHCAP}: setup cap {cap0} takes the warp variant"
    clf.classify_file(fa("hc_warm.fna"))
    r = runs[HIGHCAP] = drive(dp_cuda, clf,
                              lambda: clf.classify_file(fa("hc_reads.fna")))
    assert r["launches"] > 0 and r["counts"]["warp"] == 0 \
        and r["counts"]["block"] == r["launches"], \
        f"{HIGHCAP}: launches {r['counts']}, not all the cap > 32 kernel"
    check_path(HIGHCAP, r, HC_READS, src, dp_cuda, card, species=4 + src,
               genus=2 + (src >= na))
    print(f"{HIGHCAP}: every launch the cap > 32 kernel "
          f"({r['counts']['block']} of {r['launches']}); cap after the "
          f"warm-up and the run {clf.cap} (setup {cap0})")
    stage_table(HIGHCAP, clf, card)
    # the CPU run starts from the knobs the card's retry ladder settled
    # at, so it takes one dispatch a batch (its plain DP at cap 84 is
    # minutes a climb; the long-read CPU check climbs the ladder itself),
    # in a preparation process; the api phase waits for it
    prep.start((f"{HIGHCAP} cpu", prep_cpu_classify, (
        "highcap", cpu_reads, dict(seq_mode=1, batch_size=BATCH, **SHORT),
        {k: getattr(clf, k) for k in KNOBS}, 4)))
    return r["results"][:HC_CPU]


def highcap_cpu_check(prep, gpu_results):
    """The high-cap phase's CPU check, once its CPU run is done."""
    got = prep.result(f"{HIGHCAP} cpu")
    cpu_check_tuples(HIGHCAP, gpu_results, got["tuples"])
    print(f"{HIGHCAP} CPU check took {got['seconds']:.1f} s in a preparation "
          f"process (4 threads; waited {got['waited']:.1f} s for it), at cap "
          f"{got['cap']}, emission block {got['path_block']}, "
          f"{got['retries']} retries")


N_API = 4096                     # single-end reads of the api phase
N_API_PAIRS = 2048               # its pairs


def api_phase(dp_cuda, classifier, runs, reads, src, m1, m2, src2, card):
    """The in-memory API on the card.  Classifier.classify_batch of the
    first N_API single-end reads as strings, BATCH a call, then of the
    first N_API_PAIRS pairs (seqs2), each after a one-batch warm-up:
    every read equal (tax_cnt and top_species included) to drive_batches
    of the same padded batches on a second classifier warmed up alike,
    which ends at the same retry knobs; the path DP launched once per
    mate per call.  Then models/flagship.classify_step on synthetic_db /
    synthetic_reads (and on an index that holds some of the reads' own
    metamers) on the card, from the numpy arrays with no device given
    and from reads on the card, equal to the same call with
    device="cpu"."""
    from metabuli_work_tpu_torch.models import flagship

    for name, mode, n, s_, unit, mates in (
            ("api single-end", 1, N_API, src, "reads", (reads,)),
            ("api paired", 2, N_API_PAIRS, src2, "pairs", (m1, m2))):
        seqs = [[r.tobytes().decode() for r in m[:n]] for m in mates]
        names = [f"a{i}" for i in range(n)]
        calls = [(names[b:b + BATCH], *(s[b:b + BATCH] for s in seqs))
                 for b in range(0, n, BATCH)]
        clf = classifier(seq_mode=mode, batch_size=BATCH, **SHORT)
        ref_clf = classifier(seq_mode=mode, batch_size=BATCH, **SHORT)

        def padded(c):
            """The batches classify_batch pads, as drive_batches takes
            them."""
            for nm, *ss in c:
                rows = [x for s in ss for x in ref_clf._pad_batch(s)]
                yield (nm, *rows, *((None, None) if len(ss) == 1 else ()))

        clf.classify_batch(*calls[0])                     # warm-ups
        ref_clf.drive_batches(padded(calls[:1]))
        r = runs[name] = drive(dp_cuda, clf, lambda: [
            q for c in calls for q in clf.classify_batch(*c)])
        assert r["launches"] == len(mates) * r["dispatches"] > 0, \
            f"{name}: {r['launches']} launches for {r['dispatches']} " \
            f"dispatched batches"
        assert r["dispatches"] >= len(calls)
        check_path(name, r, n, s_[:n], dp_cuda, card, unit=unit)
        stage_table(name, clf, card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = ref_clf.drive_batches(padded(calls))
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        same_as(name, "drive_batches of the same batches (tax_cnt and "
                "top_species included)", full_tuples(r["results"]),
                full_tuples(ref))
        knobs = {k: getattr(clf, k) for k in KNOBS}
        assert knobs == {k: getattr(ref_clf, k) for k in KNOBS}, \
            (knobs, {k: getattr(ref_clf, k) for k in KNOBS})
        print(f"{name}: {n / r['dt']:.1f} {unit}/s through classify_batch "
              f"({len(calls)} calls of {BATCH}, strings padded on the host "
              f"in each call) against {n / t_ref:.1f} {unit}/s through "
              f"drive_batches of the padded batches; both end at knobs "
              f"{knobs}; on {card}")
        clf = ref_clf = None
        torch.cuda.empty_cache()

    reads_s, lens_s = flagship.synthetic_reads(32, 150)
    synth = flagship.synthetic_db(4096)
    dbs = (("synthetic_db", synth),
           ("an index with the reads' metamers",
            db_with_read_kmers(synth[0], reads_s, lens_s,
                               np.random.default_rng(73))))
    for (what, db), syncmer in [(d, s) for d in dbs for s in (False, True)]:
        kw = dict(cap=8, syncmer=syncmer)
        cpu = flagship.classify_step(reads_s, lens_s, *db, device="cpu",
                                     **kw)
        r_g, l_g = (torch.from_numpy(a).cuda() for a in (reads_s, lens_s))
        for how, gpu in (
                ("numpy inputs, no device given",
                 flagship.classify_step(reads_s, lens_s, *db, **kw)),
                ("reads on the card",
                 flagship.classify_step(r_g, l_g, *db, **kw))):
            assert set(gpu) == set(cpu)
            for k, v in cpu.items():
                assert v.device.type == "cpu", k
                assert gpu[k].device.type == "cuda", (how, k)
                assert torch.equal(gpu[k].cpu(), v), \
                    f"classify_step {what}, syncmer={syncmer}, {how}: " \
                    f"{k} differs"
        # the index on the card once, for the timing (u64 values as the
        # int64 of the same bits, as classify_step moves numpy inputs)
        db_g = [torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64
                                 else a).cuda() for a in db]
        ms = time_cuda(lambda: flagship.classify_step(r_g, l_g, *db_g, **kw),
                       20)
        print(f"api classify_step on {what} ({len(db[0])} entries), "
              f"syncmer={syncmer}, 32 x 150 reads, cap 8: every output on "
              f"the card, from numpy inputs with no device given and from "
              f"reads on the card, equal to the CPU run's "
              f"({int(cpu['sel'].sum())} selected "
              f"candidates); {ms:.3f} ms a call on {card}")


# ------------------------------------------------ host preparation
# Builds and layout packing are host work that only fill caches (the
# ~/.cache DBs, the packed-layout cache of index/packing.py) which a
# later phase reads.  They run in spawned processes while the card works
# on other phases; a phase waits for what it reads, and prints how long
# the preparation took where it ran.


class Prep:
    """Preparation processes.  start(tasks) runs (name, function, args)
    tasks one after another in one new process; each finished task
    leaves {"seconds": ..., **what it returned} for result(name)."""

    def __init__(self, tmp):
        self._ctx = multiprocessing.get_context("spawn")
        self._tmp = tmp
        self._procs = []

    def _out(self, name):
        return os.path.join(self._tmp, "prep_" + name.replace(" ", "_")
                            + ".json")

    def start(self, *tasks):
        p = self._ctx.Process(target=_prep_run,
                              args=([(n, f, a, self._out(n))
                                     for n, f, a in tasks],))
        p.start()
        self._procs.append((p, [t[0] for t in tasks]))

    def result(self, name, timeout=900):
        """The task's record once it is done; raises if its process
        ended without it."""
        out = self._out(name)
        proc = next(p for p, names in self._procs if name in names)
        t0 = time.perf_counter()
        while not os.path.exists(out):
            if not proc.is_alive() and not os.path.exists(out):
                raise AssertionError(f"preparation process {proc.pid} ended "
                                     f"(exit code {proc.exitcode}) before "
                                     f"{name}")
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"preparation {name}: over {timeout} s")
            time.sleep(0.2)
        with open(out) as f:
            info = json.load(f)
        info["waited"] = time.perf_counter() - t0
        return info

    def close(self, check=True):
        """Joins every process (killing it after a failure elsewhere);
        with check, each must have ended with exit code 0."""
        for p, names in self._procs:
            p.join(timeout=900 if check else 0)
            if p.is_alive():
                p.kill()
                p.join()
            if check:
                assert p.exitcode == 0, \
                    f"preparation process of {names}: exit code {p.exitcode}"
        self._procs = []


def _prep_run(tasks):
    """Body of a preparation process (CPU only, one torch thread)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""     # never a card context
    torch.set_num_threads(1)
    for name, fn, args, out in tasks:
        t0 = time.perf_counter()
        info = fn(*args) or {}
        info["seconds"] = time.perf_counter() - t0
        with open(out + ".tmp", "w") as f:
            json.dump(info, f)
        os.replace(out + ".tmp", out)


def prep_smoke_db():
    index, _, hit = build_or_load_db()
    return {"hit": hit}


def prep_layouts(layouts):
    """Packs the index layouts of classifiers made as the phases make
    them (label, ClassifyParams extras, on a 2 x 2 mesh), on the CPU:
    the packing is the same on every device, so the card's classifiers
    then map the cached layouts.  Waits for the smoke DB."""
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.parallel.sharding import make_mesh

    while not os.path.exists(smoke_db_path()):
        time.sleep(0.5)
    index, _, _ = build_or_load_db()
    took = {}
    for label, kw, on_mesh in layouts:
        t0 = time.perf_counter()
        Classifier.from_memory(
            index, ClassifyParams(seq_mode=1, batch_size=BATCH, **SHORT,
                                  **kw), device="cpu",
            mesh=make_mesh(devices=["cpu"] * 4) if on_mesh else None)
        took[label] = time.perf_counter() - t0
    return {"layouts": took}


def prep_orf_db(tmp):
    _, _, hit, info = build_or_load_orf_db(
        lambda name: os.path.join(tmp, name))
    return {"hit": hit, **info}


def prep_updated_db(tmp):
    """update_phase's database (the smoke index plus the ninth genome)
    and its wide layout, packed on the CPU."""
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)

    index, _, _ = build_or_load_db()
    info = make_updated_db(lambda name: os.path.join(tmp, name), index)
    t0 = time.perf_counter()
    Classifier(info["db"], ClassifyParams(seq_mode=1, batch_size=BATCH,
                                          **SHORT), device="cpu")
    return {**info, "pack_s": time.perf_counter() - t0}


def prep_common_db(tmp):
    """readgroup_phase's common-k-mer DB of the smoke genomes."""
    from metabuli_work_tpu_torch.index.common import build_common_kmer_db
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    fa = lambda name: os.path.join(tmp, name)
    _, genomes, _ = build_or_load_db()
    seqs = [(f"G{i}", np.frombuffer(g.encode(), np.uint8))
            for i, g in enumerate(genomes)]
    lst, amap, taxdump = write_build_inputs(
        fa, "rg", seqs, [1000 + i for i in range(len(genomes))],
        smoke_taxonomy(Taxonomy))
    common = build_common_kmer_db(fa("common"), lst, amap, taxdump,
                                  orf_prediction=False,
                                  common_filter="always")
    return {"dir": fa("common"), "kmers": len(common),
            "genomes": len(genomes), "taxdump": taxdump}


def prep_cpu_classify(db, reads, params, knobs, threads):
    """The CPU run of a CPU check: `reads` through Classifier(device=
    "cpu") on the smoke DB ("smoke") or the many-species DB ("highcap"),
    made with ClassifyParams(**params), then given `knobs` (attributes
    the card's retry ladder settled at), on `threads` torch threads.
    Returns the per-read (is_classified, classification, score), its
    retries and the knobs it ended at."""
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)

    torch.set_num_threads(threads)
    load = build_or_load_db if db == "smoke" else build_or_load_highcap_db
    cpu = Classifier.from_memory(load()[0], ClassifyParams(**params),
                                 device="cpu")
    for k, v in knobs.items():
        setattr(cpu, k, v)
    res = cpu.classify_file(reads)
    return {"tuples": [(bool(q.result.is_classified),
                        int(q.result.classification), float(q.result.score))
                       for q in res],
            "retries": cpu.timer.counts["retry"], "cap": cpu.cap,
            "path_block": cpu._path_block}


def prep_import(d, go):
    """One process of the two-process import: load_index(d) once the
    other process and the main one pass the barrier `go`.  Returns its
    seconds, the file its values are mapped from and the index's
    digest."""
    from metabuli_work_tpu_torch.index.format import load_index

    go.wait(timeout=600)
    t0 = time.perf_counter()
    index = load_index(d)
    took = time.perf_counter() - t0
    return {"import_s": took, "source": index.values.filename,
            "digest": index_digest(index)}


def prep_highcap_db():
    index, _, hit = build_or_load_highcap_db()
    return {"hit": hit, "entries": int(index.size)}


def dist_worker(argv):
    """One process of the distributed path: rank, port, reads, warm-up
    reads, output JSON (see the module docstring)."""
    import torch.distributed as dist

    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.ops import dp_cuda
    from metabuli_work_tpu_torch.parallel.distributed import (
        init_distributed, make_global_mesh)

    rank, port, reads_path, warm_path, out = argv[:5]
    rank = int(rank)
    init_distributed(f"localhost:{port}", 2, rank)
    n = torch.cuda.device_count()
    mesh = make_global_mesh(local_devices=[
        torch.device("cuda", (2 * rank + k) % n) for k in range(2)])
    mine = [d for i in mesh.local_rows for d in mesh.devices[i]]
    assert mesh.shape == {"dp": 2, "db": 2} and mesh.local_rows == [rank]
    assert all(d.type == "cuda" for d in mine), mine
    index, _, hit = build_or_load_db()
    assert hit, "the distributed worker found no cached smoke DB"
    clf = Classifier.from_memory(index, ClassifyParams(
        seq_mode=1, batch_size=BATCH, min_score=0.15, min_sp_score=0.5),
        mesh=mesh)
    clf.classify_file(warm_path)
    m0 = clf.mesh_merged_bytes
    r = drive(dp_cuda, clf, lambda: clf.classify_file(reads_path))
    assert r["launches"] == r["dispatches"] > 0     # one row, one part
    assert r["extract_launches"] == r["extract_spans"] == r["dispatches"], \
        (r["extract_launches"], r["extract_spans"], r["dispatches"])
    # one probe a cell of the process's row (2 db columns) a dispatch
    assert r["probe_launches"] == 2 * r["probe_spans"] > 0, \
        (r["probe_launches"], r["probe_spans"])
    assert r["redundancy_launches"] > 0
    max_err = {"warp": 0, "block": 0}
    for key, (args, kw) in r["first"].items():
        ref = dp_cuda.path_dp_blocked_ref(*args, **kw)
        check(max_err, f"main-path distributed process {rank} cap={key[0]} "
              f"W={key[1]}", dp_cuda.variant(key[0]),
              dp_cuda.path_dp_blocked(*args, **kw), ref)
    with open(out, "w") as f:
        json.dump({"records": records(r["results"]),
                   "launches": r["launches"], "counts": r["counts"],
                   "extract_launches": r["extract_launches"],
                   "probe_launches": r["probe_launches"],
                   "redundancy_launches": r["redundancy_launches"],
                   "dispatches": r["dispatches"], "dt": r["dt"],
                   "merged": clf.mesh_merged_bytes - m0,
                   "max_err": max_err}, f)
    print(f"distributed process {rank}: cells {[str(d) for d in mine]}, "
          f"read with the {r['reader']} reader, "
          f"{len(r['results'])} reads in {r['dt']:.3f} s, "
          f"{r['launches']} path DP launches, {len(r['first'])} launch "
          f"inputs exact against the plain version, peak device memory "
          f"{(r['peak'] - r['base']) / 2**30:.3f} GiB above its start",
          flush=True)
    print(f"distributed process {rank} stage timer (host seconds):\n"
          f"{clf.timer.report()}", flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=()):
    profiled = "--profile" in argv
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if "--dist-worker" in argv:
        return dist_worker(argv[argv.index("--dist-worker") + 1:])
    prep_dir = tempfile.mkdtemp(prefix="mwt_smoke_prep_")
    prep = Prep(prep_dir)
    try:
        return smoke(prep, prep_dir, profiled, seed)
    finally:
        prep.close(check=False)
        shutil.rmtree(prep_dir, ignore_errors=True)


def smoke(prep, prep_dir, profiled, seed):
    """The run the module docstring describes; `prep` runs the host
    preparation (in processes that write under prep_dir)."""
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.ops import dp_cuda
    from metabuli_work_tpu_torch.parallel.sharding import make_mesh

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")

    laps = [("", time.perf_counter())]

    def lap(name):
        """The seconds a section of the run took, printed at the end."""
        laps.append((name, time.perf_counter()))

    # the smoke DB and the first paths' layouts (resident wide rows, the
    # streamed path's 4 host shards, the mesh's 2) are made while the
    # kernels build and the parity cases run, all before the first path
    prep.start(("smoke db", prep_smoke_db, ()),
               ("wide layout", prep_layouts,
                ([("wide", {}, False)],)))
    prep.start(("4 shards", prep_layouts,
                ([("4 shards", {"hbm_budget_gb": STREAM_GB}, False)],)))
    prep.start(("2 shards", prep_layouts, ([("2 shards", {}, True)],)))

    t0 = time.perf_counter()
    dp_cuda.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")

    t0 = time.perf_counter()
    max_err, n_cases = parity(dp_cuda)
    print(f"parity: {n_cases} cases exact, max_abs_err {max_err} "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    extract_kernel = extract_phase(card)
    print(f"phase seconds: extract kernel {time.perf_counter() - t0:.1f}")

    made = prep.result("smoke db")
    t0 = time.perf_counter()
    index, genomes, _ = build_or_load_db()
    print(f"DB: {index.size} metamers, {N_GENOMES} genomes x {GENOME_LEN} bp "
          f"({'cached' if made['hit'] else 'built'} in "
          f"{made['seconds']:.1f} s in a preparation process while the "
          f"kernels built; waited {made['waited']:.1f} s for it; loaded in "
          f"{time.perf_counter() - t0:.1f} s)")
    G = genome_matrix(genomes)
    short = SHORT
    long_kw = dict(seq_mode=3, min_score=0.008, min_sp_score=0.0)

    def classifier(device="cuda", mesh=None, **kw):
        return Classifier.from_memory(index, ClassifyParams(**kw),
                                      device=device, mesh=mesh)

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        fa = lambda name: os.path.join(tmp, name)

        lap("kernel build, parity, DB")

        # ------------------------------------------------ single-end
        reads, src = simulate_reads(G, np.random.default_rng(1), N_READS,
                                    READ_LEN)
        packed = prep.result("wide layout")
        shards = {n: prep.result(n)["layouts"][n]
                  for n in ("4 shards", "2 shards")}
        t0 = time.perf_counter()
        clf = classifier(seq_mode=1, batch_size=BATCH, **short)
        print(f"classifier setup (cached layout + upload): "
              f"{time.perf_counter() - t0:.1f} s (the layout packed in "
              f"{packed['layouts']['wide']:.1f} s in a preparation process; "
              f"waited {packed['waited']:.1f} s for it and the host "
              f"shards), hash chain "
              f"{clf.hash_chain}, cap {clf.cap}, device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        write_fasta(fa("reads.fna"), reads)
        write_fasta(fa("warm.fna"), reads[:BATCH])
        write_fasta(fa("cpu.fna"), reads[:N_CPU_CHECK])
        clf.classify_file(fa("warm.fna"))            # first-use warm-up
        r = runs["single-end"] = drive(
            dp_cuda, clf, lambda: clf.classify_file(fa("reads.fna")))
        assert r["launches"] > 0, \
            "the single-end path never launched the path-DP kernel"
        assert clf._match_state is None, \
            "the path-DP flow uploaded the host-match arrays"
        check_path("single-end", r, N_READS, src, dp_cuda, card)
        stage_table("single-end", clf, card)
        cpu = classifier("cpu", seq_mode=1, batch_size=N_CPU_CHECK, **short)
        cpu_check("single-end", r["results"][:N_CPU_CHECK],
                  cpu.classify_file(fa("cpu.fna")))
        if profiled:
            profile_path("single-end",
                         lambda: clf.classify_file(fa("reads.fna")),
                         N_READS, card, N_READS // BATCH)
        lap("single-end")
        probe_kernel = probe_phase(clf, G, card)
        lap("probe kernel")
        redundancy_kernel = redundancy_phase(clf, G, card)
        clf = None
        torch.cuda.empty_cache()

        lap("redundancy kernel")

        # ------------------------------------------------ paired-end
        m1, m2, src2 = simulate_pairs(G, np.random.default_rng(2), N_PAIRS,
                                      READ_LEN)
        for tag, m in (("1", m1), ("2", m2)):
            write_fasta(fa(f"pairs_{tag}.fna"), m)
            write_fasta(fa(f"warm_{tag}.fna"), m[:BATCH])
            write_fasta(fa(f"cpu_{tag}.fna"), m[:N_CPU_CHECK])
        clf = classifier(seq_mode=2, batch_size=BATCH, **short)
        clf.classify_file(fa("warm_1.fna"), fa("warm_2.fna"))
        r = runs["paired"] = drive(
            dp_cuda, clf,
            lambda: clf.classify_file(fa("pairs_1.fna"), fa("pairs_2.fna")))
        assert r["launches"] == 2 * r["dispatches"] > 0, \
            f"paired: {r['launches']} launches for {r['dispatches']} " \
            f"dispatched batches (two per batch expected, one per mate)"
        assert all(q.length2 == READ_LEN for q in r["results"])
        check_path("paired", r, N_PAIRS, src2, dp_cuda, card, unit="pairs")
        stage_table("paired", clf, card)
        cpu = classifier("cpu", seq_mode=2, batch_size=N_CPU_CHECK, **short)
        cpu_check("paired", r["results"][:N_CPU_CHECK],
                  cpu.classify_file(fa("cpu_1.fna"), fa("cpu_2.fna")))
        if profiled:
            profile_path("paired", lambda: clf.classify_file(
                fa("pairs_1.fna"), fa("pairs_2.fna")), N_PAIRS, card,
                N_PAIRS // BATCH)
        clf = None
        torch.cuda.empty_cache()

        lap("paired")

        # ------------------------------------------------ long reads
        rng = np.random.default_rng(3)
        lr, src3 = simulate_reads(G, rng, N_LONG, LONG_LEN)
        long_reads = list(lr)
        src3 = list(src3)
        # a 24-kb read inside the first timed batch, a 36-kb and the
        # 150-kb read at the end
        extra = {}
        for at, n in ((5, MID_LONG[0]), (None, MID_LONG[1]),
                      (None, VERY_LONG)):
            one, g = simulate_reads(G, rng, 1, n)
            at = len(long_reads) if at is None else at
            long_reads.insert(at, one[0])
            src3.insert(at, int(g[0]))
            extra[n] = at
        src3 = np.array(src3)
        n_long = len(long_reads)
        n_bases = sum(len(x) for x in long_reads)
        write_fasta(fa("long.fna"), long_reads)
        write_fasta(fa("long_warm.fna"), lr[:LONG_BATCH])
        clf = classifier(batch_size=LONG_BATCH, **long_kw)
        clf.classify_file(fa("long_warm.fna"))
        warm_retries = clf.timer.counts["retry"]
        r = runs["long-read"] = drive(
            dp_cuda, clf, lambda: clf.classify_file(fa("long.fna")))
        retries = clf.timer.counts["retry"]
        n7 = sum(not c5 for _, _, c5 in r["calls"])
        assert n7 > 0, "long-read: no launch with the 7-column layout"
        assert any(c5 for _, _, c5 in r["calls"])
        assert clf._match_state is not None, \
            "long-read: the read beyond the row cap never reached the " \
            "host-match step"
        assert r["results"][extra[VERY_LONG]].length1 == VERY_LONG
        check_path("long-read", r, n_long, src3, dp_cuda, card)
        print(f"long-read: {n_bases / r['dt']:.1f} bases/s ({n_bases} bases, "
              f"batch {LONG_BATCH}); {n7} launches with 7 columns; emission "
              f"block settled at {clf._path_block}, cap at {clf.cap}; the "
              f"{VERY_LONG}-base read classified as "
              f"{r['results'][extra[VERY_LONG]].result.classification} "
              f"(source species {4 + src3[extra[VERY_LONG]]}); on {card}")
        t_chunk = clf.timer.totals["long_probe"] \
            + clf.timer.totals["long_score"]
        t_batch = r["dt"] - t_chunk
        print(f"long-read: the batch pass ({n_long - 1} reads up to "
              f"{MID_LONG[1]} bases) took {t_batch:.3f} s: "
              f"{(n_long - 1) / t_batch:.1f} reads/s, "
              f"{(n_bases - VERY_LONG) / t_batch:.1f} bases/s; the "
              f"{VERY_LONG}-base read's chunk pass took {t_chunk:.3f} s "
              f"(device probe {clf.timer.totals['long_probe']:.3f} s, host "
              f"scoring {clf.timer.totals['long_score']:.3f} s); on {card}")
        stage_table("long-read", clf, card)
        # The card climbed the overflow-retry ladder (a 10-kb lane ends
        # far more paths than the default emission block holds; the 24-kb
        # read in the first timed batch overflows once more).  CPU: two
        # 10-kb reads, the 24-kb read (7 columns) and the 150-kb read
        # (chunked), from the default knobs, so the CPU run climbs the
        # ladder on its own and the card's end state is held against it.
        print(f"long-read: {warm_retries} overflow retries in the warm-up "
              f"batch, {retries} in the timed run")
        assert warm_retries >= 1 and retries >= 1, \
            "long-read: the overflow-retry ladder never ran on the card"
        # The CPU run goes on in a preparation process (one thread) while
        # the card runs the next paths; it is held against the card's
        # results after the distributed path.
        sub = [0, 1, extra[MID_LONG[0]], extra[VERY_LONG]]
        long_cpu = os.path.join(prep_dir, "long_cpu.fna")
        write_fasta(long_cpu, [long_reads[i] for i in sub])
        prep.start(("long-read cpu", prep_cpu_classify,
                    ("smoke", long_cpu, dict(batch_size=len(sub), **long_kw),
                     {}, 1)))
        long_check = ([r["results"][i] for i in sub], clf._path_block,
                      clf.cap)
        if profiled:
            write_fasta(fa("long10k.fna"), lr)
            profile_path("long-read (10-kb reads)",
                         lambda: clf.classify_file(fa("long10k.fna")),
                         N_LONG, card)
        clf = None
        torch.cuda.empty_cache()

        lap("long-read")

        # ------------------------------------------------ host-match flow
        write_fasta(fa("hm.fna"), reads[:N_HOST_MATCH])
        clf = classifier(seq_mode=1, batch_size=BATCH, min_cons_cnt=1,
                         **short)
        assert not clf.use_device_dp
        clf.classify_file(fa("warm.fna"))
        r = runs["host-match"] = drive(
            dp_cuda, clf, lambda: clf.classify_file(fa("hm.fna")))
        assert r["launches"] == 0 and not r["calls"], \
            "host-match: the path-DP kernel launched on a flow without it"
        assert clf._match_state is not None
        check_path("host-match", r, N_HOST_MATCH, src[:N_HOST_MATCH],
                   dp_cuda, card)
        stage_table("host-match", clf, card)
        cpu = classifier("cpu", seq_mode=1, batch_size=N_CPU_CHECK,
                         min_cons_cnt=1, **short)
        cpu_check("host-match", r["results"][:N_CPU_CHECK],
                  cpu.classify_file(fa("cpu.fna")))
        if profiled:
            profile_path("host-match",
                         lambda: clf.classify_file(fa("hm.fna")),
                         N_HOST_MATCH, card)
        clf = None
        torch.cuda.empty_cache()

        lap("host-match")

        # ------------------------------------------------ streamed single-end
        se = runs["single-end"]
        print("host shards (4 for the streamed paths, 2 for the mesh) cut "
              "in preparation processes: " + ", ".join(
                  f"{k} {v:.1f} s" for k, v in shards.items()))
        t0 = time.perf_counter()
        clf = classifier(seq_mode=1, batch_size=BATCH,
                         hbm_budget_gb=STREAM_GB, **short)
        rs = clf._ranges
        assert clf._streaming and clf._n_ranges >= 4, \
            f"streamed: {clf._n_ranges} ranges under {STREAM_GB} GiB"
        assert not hasattr(clf, "db_quad")
        print(f"streamed: setup (cached shards) "
              f"{time.perf_counter() - t0:.1f} s; {clf._n_ranges} ranges of "
              f"{rs.range_bytes / 1e6:.1f} MB "
              f"(rows {rs.quads[0].numel() * 4 / 1e6:.1f} MB + hash "
              f"{rs.hts[0].numel() * 4 / 1e6:.1f} MB, chain "
              f"{clf.hash_chain}) under a budget of {STREAM_GB} GiB; group "
              f"size {clf._stream_group_size()} batches; device memory "
              f"after setup {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        clf.classify_file(fa("warm.fna"))
        up0 = rs.stats()
        r = runs["streamed"] = drive(
            dp_cuda, clf, lambda: clf.classify_file(fa("reads.fna")))
        up1 = rs.stats()
        assert r["launches"] > 0, \
            "the streamed path never launched the path-DP kernel"
        assert clf._match_state is None, \
            "the streamed path uploaded the host-match arrays"
        check_path("streamed", r, N_READS, src, dp_cuda, card)
        same_as("streamed", "the resident single-end run",
                tuples(r["results"]), tuples(se["results"]))
        sweeps = up1["sweeps"] - up0["sweeps"]
        up_b = up1["bytes"] - up0["bytes"]
        up_s = up1["copy_s"] - up0["copy_s"]
        assert sweeps >= 2 and up_b == sweeps * clf._n_ranges * rs.range_bytes
        print(f"streamed: {sweeps} sweeps of {clf._n_ranges} ranges for "
              f"{N_READS // BATCH} batches ({clf.timer.counts['retry']} "
              f"single-batch retry sweeps among them), {up_b / 1e6:.1f} MB "
              f"uploaded in {up_s:.3f} s of copies = {up_b / up_s / 1e9:.2f} "
              f"GB/s from pinned staging; peak device memory above "
              f"what was held before the run "
              f"{(r['peak'] - r['base']) / 2**30:.3f} GiB against the "
              f"budget's {STREAM_GB} GiB (resident run "
              f"{(se['peak'] - se['base']) / 2**30:.3f} GiB above its index "
              f"and hash table); "
              f"{N_READS / r['dt']:.1f} reads/s against the resident run's "
              f"{N_READS / se['dt']:.1f}; on {card}")
        stage_table("streamed", clf, card)
        cpu = classifier("cpu", seq_mode=1, batch_size=N_CPU_CHECK,
                         hbm_budget_gb=STREAM_GB, **short)
        assert cpu._streaming
        cpu_check("streamed", r["results"][:N_CPU_CHECK],
                  cpu.classify_file(fa("cpu.fna")))
        if profiled:
            profile_path("streamed",
                         lambda: clf.classify_file(fa("reads.fna")),
                         N_READS, card, N_READS // BATCH)
        clf = cpu = rs = None
        torch.cuda.empty_cache()

        lap("streamed")

        # ------------------------- a streamed read beyond the row cap
        one, g_over = simulate_reads(G, np.random.default_rng(4), 1,
                                     OVER_CAP)
        seq = one[0].tobytes().decode()
        over = {}
        for name, kw in (("resident", {}),
                         ("streamed", {"hbm_budget_gb": STREAM_GB})):
            clf = classifier(batch_size=LONG_BATCH, **long_kw, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            q = clf._classify_long_read("over_cap", seq)
            over[name] = (q, time.perf_counter() - t0, dict(clf.timer.totals),
                          torch.cuda.max_memory_allocated(),
                          clf._match_state is not None,
                          clf._ranges.stats() if clf._streaming else None)
            clf = None
            torch.cuda.empty_cache()
        q_r, q_s = over["resident"][0], over["streamed"][0]
        assert over["resident"][4] and not over["streamed"][4], \
            "streamed over-cap read: the host-match arrays were uploaded"
        assert q_s.length1 == OVER_CAP and q_s.result.is_classified
        assert q_s.result.classification in (4 + int(g_over[0]),
                                             2 + int(g_over[0]) % 2)
        same_as("streamed over-cap read", "the resident classifier's chunk "
                "pass", full_tuples([q_s]), full_tuples([q_r]))
        for name, (q, dt, tot, peak, _, up) in over.items():
            print(f"over-cap read ({OVER_CAP} bases), {name}: {dt:.3f} s "
                  f"(probe {tot['long_probe']:.3f} s, host scoring "
                  f"{tot['long_score']:.3f} s), peak device memory "
                  f"{peak / 2**30:.3f} GiB"
                  + (f", {up['sweeps']} sweeps, {up['bytes'] / 1e6:.1f} MB "
                     f"uploaded" if up else "") + f"; on {card}")

        lap("over-cap reads")

        # ------------------------------------------------ device-assign flow
        for name, mode, files, cpu_files, warm, ref, n, unit, s_ in (
                ("device-assign single-end", 1, (fa("reads.fna"),),
                 (fa("cpu.fna"),), (fa("warm.fna"),), runs["single-end"],
                 N_READS, "reads", src),
                ("device-assign paired", 2,
                 (fa("pairs_1.fna"), fa("pairs_2.fna")),
                 (fa("cpu_1.fna"), fa("cpu_2.fna")),
                 (fa("warm_1.fna"), fa("warm_2.fna")), runs["paired"],
                 N_PAIRS, "pairs", src2)):
            # the flow is pinned by the environment when a classifier is made
            os.environ["METABULI_DEVICE_ASSIGN"] = "1"
            try:
                clf = classifier(seq_mode=mode, batch_size=BATCH, **short)
                cpu = classifier("cpu", seq_mode=mode,
                                 batch_size=N_CPU_CHECK, **short)
            finally:
                del os.environ["METABULI_DEVICE_ASSIGN"]
            assert clf._device_assign and cpu._device_assign
            took = pin_device_assign(clf)
            clf.classify_file(*warm)
            warm_retries = dict(clf.full_retries)
            clf.full_retries.clear()
            took["full"] = 0
            r = runs[name] = drive(dp_cuda, clf,
                                   lambda: clf.classify_file(*files))
            per_batch = len(files)           # one launch per mate
            assert took["full"] == r["dispatches"] >= n // BATCH
            assert r["launches"] == per_batch * r["dispatches"] > 0, \
                f"{name}: {r['launches']} launches for {r['dispatches']} " \
                f"dispatched batches"
            check_path(name, r, n, s_, dp_cuda, card, unit=unit)
            same_as(name, "the host-scoring run (tax_cnt and top_species "
                    "included)", full_tuples(r["results"]),
                    full_tuples(ref["results"]))
            print(f"{name}: {n / r['dt']:.1f} {unit}/s against the "
                  f"host-scoring flow's {n / ref['dt']:.1f} in this run; "
                  f"retries by rung {clf.full_retries} (warm-up batch "
                  f"{warm_retries}); combine_k settled at {clf._combine_k}, "
                  f"cap {clf.cap}; on {card}")
            stage_table(name, clf, card)
            got_cpu = cpu.classify_file(*cpu_files)
            cpu_check(name, r["results"][:N_CPU_CHECK], got_cpu)
            same_as(name + " CPU check", "the CPU run (tax_cnt and "
                    "top_species included)",
                    full_tuples(r["results"][:N_CPU_CHECK]),
                    full_tuples(got_cpu))
            if profiled:
                profile_path(name, lambda: clf.classify_file(*files), n,
                             card, n // BATCH)
            clf = cpu = None
            torch.cuda.empty_cache()

        lap("device-assign")

        # ------------------------------------------------ the (dp, db) mesh
        n_cards = torch.cuda.device_count()
        cells = [torch.device("cuda", k % n_cards) for k in range(4)]
        mesh = make_mesh(devices=cells)
        assert mesh.shape == {"dp": 2, "db": 2}
        print(f"mesh: dp={mesh.shape['dp']} x db={mesh.shape['db']}, cells "
              f"{[str(d) for d in cells]} on {n_cards} card(s)")
        for name, mode, files, warm, ref, n, unit, s_, kw in (
                ("mesh single-end", 1, (fa("reads.fna"),), (fa("warm.fna"),),
                 runs["single-end"], N_READS, "reads", src, {}),
                ("mesh paired", 2, (fa("pairs_1.fna"), fa("pairs_2.fna")),
                 (fa("warm_1.fna"), fa("warm_2.fna")), runs["paired"],
                 N_PAIRS, "pairs", src2, {}),
                ("mesh streamed", 1, (fa("reads.fna"),), (fa("warm.fna"),),
                 runs["single-end"], N_READS, "reads", src,
                 {"hbm_budget_gb": STREAM_GB})):
            t0 = time.perf_counter()
            clf = classifier(mesh=mesh, seq_mode=mode, batch_size=BATCH,
                             **short, **kw)
            setup = time.perf_counter() - t0
            assert clf.mesh is mesh and clf._mesh_stream == bool(kw)
            clf.classify_file(*warm)
            m0 = clf.mesh_merged_bytes
            up0 = [rs.stats() for rs in clf._mesh_ranges.values()]
            r = runs[name] = drive(dp_cuda, clf,
                                   lambda: clf.classify_file(*files))
            # one launch per part per dp row of a dispatched batch
            assert r["launches"] == len(files) * 2 * r["dispatches"] > 0, \
                f"{name}: {r['launches']} launches for {r['dispatches']} " \
                f"dispatched batches"
            check_path(name, r, n, s_, dp_cuda, card, unit=unit)
            same_as(name, "the resident single-device run (tax_cnt and "
                    "top_species included)", full_tuples(r["results"]),
                    full_tuples(ref["results"]))
            merged = (clf.mesh_merged_bytes - m0) / r["dispatches"]
            print(f"{name}: {n / r['dt']:.1f} {unit}/s against the resident "
                  f"single-device run's {n / ref['dt']:.1f}; setup (cached "
                  f"shards + upload) {setup:.1f} s; the db merge reads "
                  f"{merged / 1e6:.2f} MB a dispatched batch from the other "
                  f"cells ({r['dispatches']} dispatches); peak device memory "
                  f"above the run's start {(r['peak'] - r['base']) / 2**30:.3f}"
                  f" GiB against the resident run's "
                  f"{(ref['peak'] - ref['base']) / 2**30:.3f} GiB; on {card}")
            if kw:
                up1 = [rs.stats() for rs in clf._mesh_ranges.values()]
                sweeps = sum(b["sweeps"] - a["sweeps"]
                             for a, b in zip(up0, up1))
                up_b = sum(b["bytes"] - a["bytes"] for a, b in zip(up0, up1))
                up_s = sum(b["copy_s"] - a["copy_s"]
                           for a, b in zip(up0, up1))
                assert clf._mesh_n_ranges >= 2 and sweeps >= r["dispatches"]
                print(f"{name}: {clf._mesh_n_ranges} ranges of 2 shards "
                      f"({clf._n_ranges} shards) swept once a dispatched "
                      f"batch: {up_b / 1e6:.1f} MB uploaded in {up_s:.3f} s "
                      f"of copies = {up_b / up_s / 1e9:.2f} GB/s; against the "
                      f"single-device streamed run's "
                      f"{N_READS / runs['streamed']['dt']:.1f} reads/s; on "
                      f"{card}")
            stage_table(name, clf, card)
            if profiled:
                profile_path(name, lambda: clf.classify_file(*files), n,
                             card, n // BATCH)
            clf = None
            torch.cuda.empty_cache()

        # the 66,000-base read through the streamed mesh's chunk pass
        clf = classifier(mesh=mesh, batch_size=LONG_BATCH,
                         hbm_budget_gb=STREAM_GB, **long_kw)
        assert clf._mesh_stream
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        q_m = clf._classify_long_read("over_cap", seq)
        dt = time.perf_counter() - t0
        same_as("mesh streamed over-cap read", "the resident classifier's "
                "chunk pass", full_tuples([q_m]), full_tuples([q_r]))
        assert clf._match_state is None
        tot = clf.timer.totals
        print(f"over-cap read ({OVER_CAP} bases), mesh streamed: {dt:.3f} s "
              f"(probe {tot['long_probe']:.3f} s over {clf._n_ranges} host "
              f"shards, host scoring {tot['long_score']:.3f} s), peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
              f"on {card}")
        clf = None
        torch.cuda.empty_cache()

        lap("mesh")

        # ------------------------------------------------ distributed
        write_fasta(fa("dist.fna"), reads[:N_DIST])
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        outs = [fa(f"dist_{k}.json") for k in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             str(k), str(port), fa("dist.fna"), fa("warm.fna"), outs[k]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for k, (p, log) in enumerate(zip(procs, logs)):
            print(log, end="")
            assert p.returncode == 0, \
                f"distributed worker {k} failed:\n{log[-3000:]}"
        dist_parts = []
        for o in outs:
            with open(o) as f:
                dist_parts.append(json.load(f))
        merged = {}
        for part in dist_parts:
            assert part["records"] and part["launches"] > 0
            assert part["extract_launches"] > 0
            assert part["probe_launches"] > 0
            assert part["redundancy_launches"] > 0
            for k, v in part["records"].items():
                assert k not in merged, f"read {k} scored by two processes"
                merged[k] = v
            for which, e in part["max_err"].items():
                max_err[which] = max(max_err[which], e)
        assert merged == records(runs["single-end"]["results"][:N_DIST]), \
            "distributed: the merged records differ from the resident run"
        dist_dt = max(part["dt"] for part in dist_parts)
        se = runs["single-end"]
        print(f"distributed: {len(merged)}/{N_DIST} reads identical to the "
              f"resident single-device run (tax_cnt and top_species "
              f"included), each scored by one process "
              f"({' + '.join(str(len(p['records'])) for p in dist_parts)}); "
              f"{N_DIST / dist_dt:.1f} reads/s over both processes (slower "
              f"process's classify wall {dist_dt:.3f} s) against the resident "
              f"run's {N_READS / se['dt']:.1f}; db merge "
              f"{sum(p['merged'] for p in dist_parts) / 1e6:.2f} MB in all; "
              f"path DP launches "
              f"{[p['launches'] for p in dist_parts]}; whole path with "
              f"process start and setup {time.perf_counter() - t0:.1f} s; "
              f"on {card}")

        lap("distributed")

        got = prep.result("long-read cpu")
        cpu_check_tuples("long-read", long_check[0], got["tuples"])
        print(f"long-read CPU check took {got['seconds']:.1f} s in a "
              f"preparation process while the card ran the paths after it "
              f"(waited {got['waited']:.1f} s): {got['retries']} retries "
              f"from the default knobs, emission block {got['path_block']} "
              f"(card {long_check[1]}), cap {got['cap']} (card "
              f"{long_check[2]})")
        assert got["retries"] >= 1

        # ------------------------------------------------ measure_scaling
        from metabuli_work_tpu_torch.parallel.scaling import measure_scaling

        t0 = time.perf_counter()
        sc = measure_scaling(device_counts=(1, 2, 4), batch=BATCH, iters=4,
                             devices=cells)
        print(f"measure_scaling on cells {[str(d) for d in cells]}: "
              f"{ {n: round(v, 1) for n, v in sc.items()} } reads/s by mesh "
              f"size ({time.perf_counter() - t0:.1f} s); cells that share a "
              f"card run one after another: the mechanism's cost, not a "
              f"speed-up; on {card}")

        lap("measure_scaling")

        # the later phases' DBs, made while the card runs the phases
        # before them
        prep.start(("orf db", prep_orf_db, (prep_dir,)),
                   ("updated db", prep_updated_db, (prep_dir,)))
        prep.start(("common db", prep_common_db, (prep_dir,)),
                   ("highcap db", prep_highcap_db, ()))

        # ------ the native reader, reference-format DBs, --em, the CLI
        # (after every earlier path, so those run as they did before)
        clf = classifier(seq_mode=1, batch_size=BATCH, **short)
        clf.classify_file(fa("warm.fna"))
        reader_phase(clf, fa, reads, card)
        clf = None
        torch.cuda.empty_cache()
        ref_dirs = reference_phases(
            dp_cuda, index, lambda d: Classifier(d, ClassifyParams(
                seq_mode=1, batch_size=BATCH, **short), device="cuda"),
            fa, runs, src, card, prep)
        em_phase(dp_cuda, lambda device="cuda", **kw: classifier(
            device, **kw, **short), fa, runs, src, card)
        head = cli_phase(fa, reads, ref_dirs["diffIdx"],
                         runs["em"]["results"], index.taxonomy, card)
        assert head == [str(v) for v in index.values[:5]], head
        torch.cuda.empty_cache()

        lap("reader, reference-format, em, cli")

        # ---- ORF build, updateDB, accession level, filter, the CLI's
        # tools (after every earlier path, so those run as they did)
        def classifier_at(d, device="cuda"):
            return Classifier(d, ClassifyParams(
                seq_mode=1, batch_size=BATCH if device == "cuda"
                else N_CPU_CHECK, **short), device=device)

        took = [time.perf_counter()]
        orf_phase(dp_cuda, classifier_at, fa, runs, index.size, card,
                  prep.result("orf db"))
        took.append(time.perf_counter())
        upd = update_phase(dp_cuda, index, classifier_at, fa, reads, runs,
                           card, prep.result("updated db"))
        took.append(time.perf_counter())
        acc = accession_phase(dp_cuda, classifier_at, fa, upd, runs, card)
        took.append(time.perf_counter())
        removed = filter_phase(dp_cuda, fa, acc, runs, card)
        took.append(time.perf_counter())
        cli_tools_phase(fa, src, ref_dirs["diffIdx"], upd, acc, removed,
                        card)
        took.append(time.perf_counter())
        print("phase seconds: " + ", ".join(
            f"{n} {b - a:.1f}" for n, a, b in zip(
                ("orf build", "updateDB", "accession-level", "filter",
                 "cli tools"), took, took[1:])))
        torch.cuda.empty_cache()

        lap("orf build to cli tools")

        # ---- AA-only extraction, read groups, UniRef (after every
        # earlier path and phase)
        took = [time.perf_counter()]
        aa_extract_phase(reads, card)
        took.append(time.perf_counter())
        readgroup_phase(fa, src, src2, runs["single-end"]["results"], card,
                        prep.result("common db"))
        took.append(time.perf_counter())
        uniref_phase(fa, seed, card)
        took.append(time.perf_counter())
        print("phase seconds: " + ", ".join(
            f"{n} {b - a:.1f}" for n, a, b in zip(
                ("aa-only extraction", "read groups", "uniref"), took,
                took[1:])))
        torch.cuda.empty_cache()

        lap("aa-only extraction to uniref")

        # ---- a many-species DB: every launch the cap > 32 kernel (after
        # every earlier path and phase)
        t0 = time.perf_counter()
        hc_check = highcap_phase(
            dp_cuda, lambda ix, device: Classifier.from_memory(
                ix, ClassifyParams(seq_mode=1, batch_size=BATCH, **short),
                device=device), fa, runs, card, prep.result("highcap db"),
            prep, os.path.join(prep_dir, "hc_cpu.fna"))
        print(f"phase seconds: {HIGHCAP} {time.perf_counter() - t0:.1f}")
        torch.cuda.empty_cache()

    lap("high-cap single-end")

    # the high-cap CPU run ends before the api phase, so that no
    # preparation process runs beside it
    highcap_cpu_check(prep, hc_check)
    lap("high-cap CPU check")

    # ---- the in-memory API: classify_batch against drive_batches, and
    # the standalone classify_step (after every earlier path and phase)
    t0 = time.perf_counter()
    api_phase(dp_cuda, classifier, runs, reads, src, m1, m2, src2, card)
    print(f"phase seconds: api {time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    lap("api")

    # ------------------------------- main-path parity and kernel timings
    # the plain version runs once per long-read shape (seconds a call)
    timed = {name: time_shapes(name, r, dp_cuda, card, max_err,
                               reps=20 if name == "long-read" else 50,
                               plain_reps=1)
             for name, r in runs.items() if r["first"]}
    n_main = sum(len(t) for t in timed.values())
    print(f"parity main-path: {n_main} captured launch inputs exact, "
          f"max_abs_err {max_err}")
    for name, r in runs.items():
        assert all(c in timed.get(name, ()) for c in r["calls"]), \
            f"a {name} launch shape was not held against the plain " \
            f"version (raise KEEP_INPUTS)"
    se = runs["single-end"]
    k_total = sum(timed["single-end"][c][0] for c in se["calls"])
    print(f"path DP share of the single-end run: {se['launches']} launches "
          f"x ms/launch = {k_total:.3f} ms of {se['dt'] * 1e3:.1f} ms wall "
          f"({100 * k_total / (se['dt'] * 1e3):.2f}%)")
    # the single-end path's first launch: the block variant beside it
    key0 = se["calls"][0]
    args, kw = se["first"][key0]
    blk_ms = time_cuda(lambda: dp_cuda._launch("block", args, **kw), 50,
                       queue_ahead=True)
    print(f"at the single-end path's first launch (cap={key0[0]}): plain "
          f"version {timed['single-end'][key0][3]:.3f} ms, block variant "
          f"{blk_ms:.4f} ms/launch, {dp_cuda.variant(key0[0])} variant "
          f"{timed['single-end'][key0][0]:.4f} ms/launch on {card}")

    kernels = []
    for which, src_file, name in (
            ("warp", "path_dp_warp.cu", "path_dp"),
            ("block", "path_dp.cu", "path_dp_block")):
        by_path = {p: r["counts"][which] for p, r in runs.items()}
        # the two processes' launches, counted by each around its run
        by_path["distributed"] = sum(p["counts"][which] for p in dist_parts)
        # the variant's first launch on any path, single-end first
        where = next(((p, k) for p, r in runs.items() for k in r["calls"]
                      if dp_cuda.variant(k[0]) == which and k in r["first"]),
                     None)
        if where is None:
            assert not any(by_path.values()), by_path
            print(f"{which} variant (csrc/{src_file}): not launched on any "
                  f"path (no launch at its caps); parity max_abs_err "
                  f"{max_err[which]}")
            continue
        path, key = where
        ms, b_ms, b_by, plain_ms, _ = timed[path][key]
        kernels.append({
            "name": name,
            "variant": which,
            "path": path,
            "cap": key[0],
            "route": "cuda",
            "source": f"metabuli_work_tpu_torch/csrc/{src_file}",
            "replaces": "metabuli_work_tpu/ops/dp_pallas.py:88",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_err[which],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "shapes": [{"path": p, "cap": k[0], "W": k[1],
                        "columns": 5 if k[2] else 7, "ms": v[0],
                        "bound_ms": v[1], "bound_by": v[2],
                        "plain_ms": v[3], "max_abs_err": v[4]}
                       for p, t in timed.items() for k, v in t.items()
                       if dp_cuda.variant(k[0]) == which],
        })
    assert kernels, "no path-DP kernel was launched on any path"
    # the main paths' own launches (each counted from 0 around its run);
    # extract_phase's synthetic and timing launches are not among them
    by_path = {p: r["extract_launches"] for p, r in runs.items()}
    by_path["distributed"] = sum(p["extract_launches"] for p in dist_parts)
    assert all(by_path.values()), f"extraction kernel not launched: {by_path}"
    kernels.append(dict(extract_kernel, launches=sum(by_path.values()),
                        launches_by_path=by_path))
    # the probe kernel's, likewise (0 on the flows without a hash probe)
    by_path = {p: r["probe_launches"] for p, r in runs.items()}
    by_path["distributed"] = sum(p["probe_launches"] for p in dist_parts)
    assert all(n > 0 for p, n in by_path.items()
               if p == "distributed" or runs[p]["hashed"]), \
        f"probe kernel not launched: {by_path}"
    kernels.append(dict(probe_kernel, launches=sum(by_path.values()),
                        launches_by_path=by_path))
    # the redundancy kernel's, likewise (0 on the host-match flow)
    by_path = {p: r["redundancy_launches"] for p, r in runs.items()}
    by_path["distributed"] = sum(p["redundancy_launches"]
                                 for p in dist_parts)
    assert all(n > 0 for p, n in by_path.items()
               if p == "distributed" or runs[p]["hashed"]), \
        f"redundancy kernel not launched: {by_path}"
    kernels.append(dict(redundancy_kernel, launches=sum(by_path.values()),
                        launches_by_path=by_path))
    prep.close()
    lap("main-path parity and timings")
    total = laps[-1][1] - laps[0][1]
    print("section seconds: " + ", ".join(
        f"{n} {t1 - t0:.1f}" for (_, t0), (n, t1) in zip(laps, laps[1:]))
        + f"; in all {total:.1f} ({100 * total / RUN_LIMIT_S:.1f}% of the "
        f"{RUN_LIMIT_S} s the run is allowed)")

    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
