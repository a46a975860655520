"""Reference-database builder (host pipeline).

Counterpart of the reference's IndexCreator::createIndex
(src/commons/IndexCreator.cpp:316-376): FASTA list -> accession->taxid
mapping -> per-sequence metamer extraction -> parallel sort ->
per-(value, species) dedup with LCA taxid assignment
(IndexCreator.h:475-629) -> sorted-array index.

Extraction indexes all six frames of every sequence by default (a
superset of the reference's Prodigal extended-ORF blocks, see
ops/encode_np.extract_target_kmers).  With ``orf_prediction`` it runs
over predicted extended ORFs instead (``gene_predictor='prodigal'``:
the vendored Prodigal 2.6.3 through index/prodigal.py; 'heuristic':
the maximal-ORF scan of index/orf.py; 'auto': Prodigal when its library
builds, else the heuristic); user CDS spans (``cds_info``) win over
prediction per accession.  ``accession_level`` labels k-mers per
accession, and ``resume`` continues an interrupted build from its
spilled runs.

Differences from the reference, by design: the index is a plain sorted
uint64 array + int32 side arrays (device-ready) instead of a 15-bit
delta stream; write_reference_format writes that stream beside it.

Out-of-core: sequences are processed in flush rounds bounded by
``max_ram_gb`` and spilled to temporary .npy runs that are k-way merged,
mirroring the reference's flush/merge protocol (IndexCreator.h:322-472).
"""

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np

from ..io.fasta import read_fasta
from ..ops.encode_np import extract_target_kmers, scan_frame
from ..ops import mask as mask_ops
from ..ops.genetic_code import KMER_LEN, seq_to_codes
from ..taxonomy import Taxonomy
from . import prodigal as prodigal_mod
from .format import KmerIndex, export_reference_format, save_index
from .minhash import minhash_similar, minhash_sketch
from .orf import predict_orfs


def extract_cds_kmers(seq: str, blocks, syncmer=False, smer_len=5,
                      k=None, aa_only=False):
    """In-frame k-mers of CDS blocks (start, end 0-based inclusive,
    strand): metamers by default, AA-only 12-mers for the common-k-mer
    DB (k=12, aa_only=True: the reference's common build runs the same
    block extraction with dna2aa scanners, IndexCreator.cpp:258-259)."""
    codes = seq_to_codes(seq)
    out = []
    kw = {} if k is None else {"k": k}
    min_nt = 3 * (k or KMER_LEN)
    for start, end, strand in blocks:
        start = max(0, int(start))
        end = min(len(codes) - 1, int(end))
        used = end - start + 1
        used -= used % 3
        if used < min_nt:
            continue
        fwd = strand >= 0
        # the block's own span (a reverse block's reverse complement, not
        # the whole sequence's): the same k-mers, in O(block) time
        b0 = start if fwd else start + (end - start + 1 - used)
        fk = scan_frame(codes[b0:b0 + used], 0, used, fwd, syncmer=syncmer,
                        smer_len=smer_len, aa_only=aa_only, **kw)
        out.append(fk.kmers)
    return np.concatenate(out) if out else np.zeros(0, np.uint64)


def load_cds_info(path):
    """CDS spans per accession: GFF3 (CDS features) or TSV
    (accession, start, end, strand) with 1-based inclusive coordinates."""
    blocks = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 8 and parts[2] == "CDS":       # GFF3
                acc, start, end, strand = parts[0], parts[3], parts[4], parts[6]
            elif len(parts) >= 4 and parts[1].isdigit():    # simple TSV
                acc, start, end, strand = parts[0], parts[1], parts[2], parts[3]
            else:
                continue
            blocks.setdefault(acc.split(".")[0], []).append(
                (int(start) - 1, int(end) - 1, 1 if strand != "-" else -1))
    return blocks


def load_acc2taxid(path):
    """accession2taxid file: TSV with accession and taxid columns.

    Accepts both NCBI 4-column (accession, accession.version, taxid, gi)
    and simple 2-column files.
    """
    mapping = {}
    with open(path) as f:
        header = f.readline()
        cols = header.rstrip("\n").split("\t")
        if "taxid" in [c.lower() for c in cols]:
            tax_col = [c.lower() for c in cols].index("taxid")
            acc_col = 0
        else:
            # no header; treat first line as data
            parts = header.rstrip("\n").split("\t")
            tax_col = 2 if len(parts) >= 3 else 1
            acc_col = 1 if len(parts) >= 3 else 0
            if len(parts) > max(acc_col, tax_col):
                mapping[parts[acc_col].split(".")[0]] = int(parts[tax_col])
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) > max(acc_col, tax_col):
                mapping[parts[acc_col].split(".")[0]] = int(parts[tax_col])
    return mapping


def _dedup_lca(values, taxids, species, taxonomy: Taxonomy):
    """Sort by (value, species, taxid); collapse duplicate (value, species)
    groups to a single entry whose taxid is the LCA of the group."""
    order = np.lexsort((taxids, species, values))
    values = values[order]
    taxids = taxids[order]
    species = species[order]

    new_group = np.ones(len(values), dtype=bool)
    if len(values) > 1:
        new_group[1:] = (values[1:] != values[:-1]) | (species[1:] != species[:-1])
    group_id = np.cumsum(new_group) - 1
    n_groups = int(group_id[-1]) + 1 if len(values) else 0

    out_values = values[new_group]
    out_species = species[new_group]
    out_taxids = taxonomy.lca_reduce(taxids, group_id, n_groups).astype(np.int32)
    return out_values, out_taxids, out_species


def _extract_worker(args):
    """Top-level worker for multiprocess target extraction (the
    reference's OpenMP batch farm, IndexCreator.cpp:1008-1030): masking,
    optional ORF prediction, and metamer extraction are all
    per-sequence-independent, so they parallelize over a process pool;
    the sequential tail (flush/sort/LCA/merge) stays in the parent."""
    seq, mask_mode, mask_prob, syncmer, smer_len, blocks, orf = args
    if mask_mode:
        seq = mask_ops.mask_low_complexity(seq, mask_prob)
    if blocks is None and orf:
        blocks = predict_orfs(seq) or None
    if blocks:
        return extract_cds_kmers(seq, blocks, syncmer=syncmer,
                                 smer_len=smer_len)
    return extract_target_kmers(seq, syncmer=syncmer, smer_len=smer_len)


class IndexBuilder:
    def __init__(
        self,
        taxonomy: Taxonomy,
        syncmer: bool = False,
        smer_len: int = 5,
        mask_mode: int = 1,
        mask_prob: float = 0.9,
        max_ram_gb: float = 32.0,
        tmpdir: str = None,
    ):
        """tmpdir: spill directory for flush runs.  None = a fresh
        tempfile dir; a fixed path makes the build resumable (runs
        adopted across processes via adopt_runs)."""
        self.taxonomy = taxonomy
        self.syncmer = syncmer
        self.smer_len = smer_len
        self.mask_mode = mask_mode
        self.mask_prob = mask_prob
        self.flush_kmers = int(max_ram_gb * (1 << 30) / 16 / 2)  # value+ids, x2 sort slack
        self._runs = []
        self._tmpdir = tmpdir
        if tmpdir:
            os.makedirs(tmpdir, exist_ok=True)
        self.on_flush = None   # callback(run_base_path) after each spill
        self._values = []
        self._taxids = []
        self._species = []
        self._count = 0
        self.observed_taxids = set()

    def add_sequence(self, seq: str, taxid_internal: int, cds_blocks=None):
        """cds_blocks: optional [(start, end, strand)] 0-based inclusive
        spans; when given, metamers are extracted in-frame per block only
        (the reference's user-CDS path, IndexCreator.cpp:1088-1121)
        instead of all six frames of the whole sequence."""
        if self.mask_mode:
            seq = mask_ops.mask_low_complexity(seq, self.mask_prob)
        if cds_blocks:
            kmers = extract_cds_kmers(seq, cds_blocks, syncmer=self.syncmer,
                                      smer_len=self.smer_len)
        else:
            kmers = extract_target_kmers(seq, syncmer=self.syncmer,
                                         smer_len=self.smer_len)
        return self.add_kmers(kmers, taxid_internal)

    def add_kmers(self, kmers: np.ndarray, taxid_internal: int):
        """Register pre-extracted metamers (the multiprocess build path
        extracts in workers and feeds results here)."""
        if len(kmers) == 0:
            return 0
        sp = int(self.taxonomy.species_of(taxid_internal))
        if sp == 0:
            sp = taxid_internal
        self._values.append(kmers)
        self._taxids.append(np.full(len(kmers), taxid_internal, dtype=np.int32))
        self._species.append(np.full(len(kmers), sp, dtype=np.int32))
        self._count += len(kmers)
        self.observed_taxids.add(taxid_internal)
        if self._count >= self.flush_kmers:
            self._flush()
        return len(kmers)

    def _flush(self):
        if not self._values:
            return
        v = np.concatenate(self._values)
        t = np.concatenate(self._taxids)
        s = np.concatenate(self._species)
        self._values, self._taxids, self._species, self._count = [], [], [], 0
        v, t, s = _dedup_lca(v, t, s, self.taxonomy)
        if self._tmpdir is None:
            self._tmpdir = tempfile.mkdtemp(prefix="mwt_build_")
        base = os.path.join(self._tmpdir, f"run{len(self._runs)}")
        np.save(base + ".v.npy", v)
        np.save(base + ".t.npy", t)
        np.save(base + ".s.npy", s)
        self._runs.append(base)
        if self.on_flush is not None:
            self.on_flush(base)

    def adopt_runs(self, run_bases):
        """Resume support: register previously spilled runs (each a base
        path with .v/.t/.s.npy files) written by an earlier process."""
        for base in run_bases:
            for ext in (".v.npy", ".t.npy", ".s.npy"):
                if not os.path.exists(base + ext):
                    raise FileNotFoundError(f"resume run missing {base}{ext}")
        self._runs = list(run_bases)

    def _merge_runs_streaming(self):
        """Bounded-memory k-way merge of the spilled runs.

        The reference merges flush files with a streaming k-way reader
        (IndexCreator.h:322-472, DeltaIdxReader::getValues); here each
        sorted run is an on-disk .npy opened memory-mapped and merged in
        VALUE BLOCKS: each round picks a boundary value no run has fully
        passed, slices every run up to it (binary search on the memmap),
        dedups/LCAs the concatenated block, and appends to raw output
        files.  Peak resident rows per round is ~chunk_rows x runs,
        independent of the total index size.
        """
        vs = [np.load(b + ".v.npy", mmap_mode="r") for b in self._runs]
        ts = [np.load(b + ".t.npy", mmap_mode="r") for b in self._runs]
        ss = [np.load(b + ".s.npy", mmap_mode="r") for b in self._runs]
        k = len(vs)
        pos = [0] * k
        chunk = max(self.flush_kmers // max(k, 1) // 2, 1 << 10)
        out_v = open(os.path.join(self._tmpdir, "merged.v.bin"), "wb")
        out_t = open(os.path.join(self._tmpdir, "merged.t.bin"), "wb")
        out_s = open(os.path.join(self._tmpdir, "merged.s.bin"), "wb")
        total = 0
        while True:
            active = [i for i in range(k) if pos[i] < len(vs[i])]
            if not active:
                break
            # boundary: the smallest "chunk-end" value among active runs —
            # every active run is consumed completely up to it, so no
            # (value, species) group ever splits across rounds
            bound = min(
                vs[i][min(pos[i] + chunk, len(vs[i])) - 1] for i in active)
            parts_v, parts_t, parts_s = [], [], []
            for i in active:
                hi = int(np.searchsorted(vs[i], bound, side="right"))
                if hi > pos[i]:
                    parts_v.append(np.asarray(vs[i][pos[i]:hi]))
                    parts_t.append(np.asarray(ts[i][pos[i]:hi]))
                    parts_s.append(np.asarray(ss[i][pos[i]:hi]))
                    pos[i] = hi
            v, t, s = _dedup_lca(np.concatenate(parts_v),
                                 np.concatenate(parts_t),
                                 np.concatenate(parts_s), self.taxonomy)
            v.tofile(out_v)
            t.astype(np.int32).tofile(out_t)
            s.astype(np.int32).tofile(out_s)
            total += len(v)
        out_v.close(), out_t.close(), out_s.close()
        for b in self._runs:
            for ext in (".v.npy", ".t.npy", ".s.npy"):
                os.unlink(b + ext)
        self._runs = []
        out = {}
        for name, dt in (("v", np.uint64), ("t", np.int32), ("s", np.int32)):
            raw = os.path.join(self._tmpdir, f"merged.{name}.bin")
            arr = np.fromfile(raw, dtype=dt, count=total)
            os.unlink(raw)
            out[name] = arr
        return out["v"], out["t"], out["s"]

    def finalize(self) -> KmerIndex:
        if self._runs:
            self._flush()
            v, t, s = self._merge_runs_streaming()
        else:
            if self._values:
                v = np.concatenate(self._values)
                t = np.concatenate(self._taxids)
                s = np.concatenate(self._species)
            else:
                v = np.zeros(0, np.uint64)
                t = np.zeros(0, np.int32)
                s = np.zeros(0, np.int32)
            v, t, s = _dedup_lca(v, t, s, self.taxonomy)
        meta = {
            "kmer_format": 2,
            "syncmer": self.syncmer,
            "smer_len": self.smer_len,
            "reduced_aa": 0,
            "mask_mode": self.mask_mode,
            "mask_prob": self.mask_prob,
            "skip_redundancy": 1,
        }
        return KmerIndex(v, t, s, self.taxonomy, meta)


def extract_records(builder, taxonomy, fasta_files, acc2taxid, *,
                    cds_info=None, acc_ids=None, orf_prediction=False,
                    gene_predictor="auto", threads=1, force_prodigal=False,
                    skip_records=0, acc_map_out=None, progress=None):
    """Feed every (accession-mapped) record of `fasta_files` into
    `builder`, with the same extraction semantics as the reference's
    fillTargetKmerBuffer (IndexCreator.cpp:1008-1234): optional user CDS
    blocks, Prodigal per-batch extended-ORF prediction, heuristic ORF
    fallback, or whole-sequence 6-frame extraction.  Shared by `build`
    and `updateDB` (the reference funnels both through IndexCreator).

    acc_map_out/progress: optional resume bookkeeping (build_database's
    manifest machinery); skip_records skips a resumed prefix.
    """
    cds_info = cds_info or {}
    acc_ids = acc_ids or {}
    if acc_map_out is None:
        acc_map_out = []
    if progress is None:
        progress = {"done": skip_records}
    use_prodigal = False
    if orf_prediction and gene_predictor in ("auto", "prodigal"):
        if prodigal_mod.available():
            use_prodigal = True
        elif gene_predictor == "prodigal":
            raise RuntimeError(
                "gene_predictor='prodigal' requested but libprodigal.so "
                "cannot be built (vendored Prodigal sources or a C++ "
                "toolchain are missing); use gene_predictor='heuristic'")
    # per-species strandness tracking vs the first (training) contig —
    # the reference's min-hash check (IndexCreator.cpp:1158-1212), which
    # there triggers reverse-complement gene re-prediction; here
    # predict_orfs scans both strands so a flipped contig only gets a
    # diagnostic (index/minhash.py docstring)
    training: dict = {}
    n_reversed = 0
    if threads == 0:
        threads = os.cpu_count() or 1

    def records():
        for fa in fasta_files:
            for rec in read_fasta(fa):
                acc = rec.name.split(".")[0]
                taxid = acc2taxid.get(acc) or acc2taxid.get(rec.name)
                if taxid is None:
                    continue
                internal = taxonomy.to_internal(taxid)
                if internal == 0:
                    continue
                if rec.name in acc_ids:
                    internal = acc_ids[rec.name]   # accession-level label
                blocks = cds_info.get(acc)
                if blocks is None and orf_prediction and not use_prodigal:
                    # prodigal mode does the real check (RC on mismatch);
                    # the heuristic path only diagnoses, since
                    # predict_orfs scans both strands anyway
                    nonlocal n_reversed
                    sp = taxonomy.species_of(internal)
                    if sp not in training:
                        training[sp] = (minhash_sketch(rec.seq),
                                        len(rec.seq))
                    else:
                        tsk, tlen = training[sp]
                        if not minhash_similar(tsk, minhash_sketch(rec.seq),
                                               tlen, len(rec.seq)):
                            n_reversed += 1
                yield rec, internal, taxid, blocks, fa

    def input_records():
        """records() minus the prefix already covered by adopted runs.
        A record whose k-mers reached a flushed run but whose manifest
        update raced a crash is re-extracted on resume; the duplicate
        (value, species, taxid) rows collapse in the LCA dedup."""
        it = records()
        for _ in range(skip_records):
            if next(it, None) is None:
                return
        yield from it

    if use_prodigal:
        # Prodigal extended-ORF path with the reference's per-BATCH
        # state (IndexCreator.cpp:1029-1057 batch caps, :1124-1145
        # per-batch training): accession batches never span a
        # (species, fasta) boundary and are capped at 300 seqs / 100 Mb
        # / (100 seqs & 50 Mb) / the k-mer buffer estimate; every batch
        # gets a FRESH ProdigalWrapper, retrains on the species' longest
        # sequence, and re-seeds the intergenic 23-mer list from its
        # gene calls (`intergenicKmers.clear()`, :1037).  Freeing the
        # runner at each batch boundary also bounds native-buffer
        # memory to one ~60 MB runner at a time, like the reference's
        # per-batch new/delete.
        # pre-pass: longest sequence per species = training sequence,
        # shared by all of the species' batches (reference
        # IndexCreator.cpp:752-756,778-780)
        longest: dict = {}
        for fa in fasta_files:
            for rec in read_fasta(fa):
                acc = rec.name.split(".")[0]
                taxid = acc2taxid.get(acc) or acc2taxid.get(rec.name)
                if taxid is None:
                    continue
                internal = taxonomy.to_internal(taxid)
                if not internal:
                    continue
                sp = int(taxonomy.species_of(internal)) or internal
                if sp not in longest or len(rec.seq) > longest[sp][1]:
                    longest[sp] = (fa, len(rec.seq), rec.name)

        meta_warned: set = set()
        batch = None   # open accession batch; None until first record

        def _open_batch(sp, fa):
            """Fresh per-batch state; training is lazy (the reference
            trains on the first sequence that actually needs Prodigal,
            `trained=false` per batch, IndexCreator.cpp:1057,1124)."""
            return {"sp": sp, "fa": fa, "runner": None, "intergenic": None,
                    "tsk": None, "tlen": 0, "fallback": False,
                    "len_sum": 0, "cnt": 0, "kmer_sum": 0.0, "full": False}

        def _train_batch(b):
            fa_t, tlen, tname = longest[b["sp"]]
            # The reference's eukaryote meta clause calls
            # IsAncestor(speciesID, eukID) with (ancestor, child)
            # argument order (IndexCreator.cpp:1137) — a species is
            # never an ancestor of Eukaryota, so the clause never
            # fires: >=100 kb eukaryotic training sequences use
            # single-genome mode.  Matched here by using only tlen.
            meta = tlen < 100_000
            if meta and not force_prodigal:
                # The vendored Prodigal snapshot lacks training.cpp's
                # metagenomic models (only training.h is vendored), so
                # meta-mode gene calls are degenerate.  Fall back to
                # 6-frame-superset extraction for this species unless
                # forced.
                if b["sp"] not in meta_warned:
                    meta_warned.add(b["sp"])
                    print(f"build: WARNING species {b['sp']} training "
                          f"sequence is {tlen} bp < 100 kb; Prodigal "
                          f"meta-mode models are unavailable in this "
                          f"vendored snapshot — using 6-frame-superset "
                          f"extraction (pass force_prodigal=True to "
                          f"override)")
                b["fallback"] = True
                return
            tseq = next(r.seq for r in read_fasta(fa_t) if r.name == tname)
            runner = prodigal_mod.ProdigalRunner()
            runner.train(tseq, meta=meta)
            gb, ge, gs = runner.predict(tseq)
            b["runner"] = runner
            b["intergenic"] = prodigal_mod.generate_intergenic_kmer_list(
                gb, ge, gs, tseq)
            b["tsk"] = minhash_sketch(tseq)
            b["tlen"] = tlen

        for rec, internal, taxid, blocks, fa in input_records():
            acc_map_out.append((rec.name, taxid))
            progress["done"] += 1
            sp = int(taxonomy.species_of(internal)) or internal
            if batch is None or batch["full"] or batch["sp"] != sp \
                    or batch["fa"] != fa:
                if batch is not None and batch["runner"] is not None:
                    del batch["runner"]   # free native buffers now
                batch = _open_batch(sp, fa)
            # batch caps mirror getAccessionBatches
            # (IndexCreator.cpp:764): the check runs AFTER adding each
            # accession, so a batch always holds >= 1 record
            batch["cnt"] += 1
            batch["len_sum"] += len(rec.seq)
            batch["kmer_sum"] += len(rec.seq) * 0.4
            if (batch["cnt"] > 300 or batch["len_sum"] > 100_000_000
                    or (batch["cnt"] > 100 and batch["len_sum"] > 50_000_000)
                    or batch["kmer_sum"] > builder.flush_kmers):
                batch["full"] = True
            if blocks is None:
                if batch["runner"] is None and not batch["fallback"]:
                    _train_batch(batch)
                if batch["fallback"]:
                    builder.add_sequence(rec.seq, internal)
                    continue
                seq = rec.seq
                if not minhash_similar(batch["tsk"], minhash_sketch(seq),
                                       batch["tlen"], len(seq)):
                    seq = prodigal_mod.reverse_complement(seq)
                    n_reversed += 1
                gb, ge, gs = batch["runner"].predict(seq)
                blocks = prodigal_mod.get_extended_orfs(
                    gb, ge, gs, len(seq), batch["intergenic"], seq)
                builder.add_sequence(seq, internal, cds_blocks=blocks)
            else:
                builder.add_sequence(rec.seq, internal, cds_blocks=blocks)
    elif threads > 1:
        # multiprocess extraction farm; the parent keeps the sequential
        # flush/sort/LCA tail and bounds in-flight work to 4x threads
        import multiprocessing as mp
        from collections import deque
        from concurrent.futures import ProcessPoolExecutor

        ctx = mp.get_context("spawn")   # fork after torch is unsafe
        with ProcessPoolExecutor(max_workers=threads,
                                 mp_context=ctx) as pool:
            pending: deque = deque()

            def _drain_one():
                f, itl, nm, tid = pending.popleft()
                kmers = f.result()
                acc_map_out.append((nm, tid))
                progress["done"] += 1
                builder.add_kmers(kmers, itl)

            for rec, internal, taxid, blocks, _fa in input_records():
                fut = pool.submit(_extract_worker,
                                  (rec.seq, builder.mask_mode,
                                   builder.mask_prob, builder.syncmer,
                                   builder.smer_len, blocks, orf_prediction))
                pending.append((fut, internal, rec.name, taxid))
                while len(pending) > 4 * threads:
                    _drain_one()
            while pending:
                _drain_one()
    else:
        for rec, internal, taxid, blocks, _fa in input_records():
            if blocks is None and orf_prediction:
                blocks = predict_orfs(rec.seq) or None
            acc_map_out.append((rec.name, taxid))
            progress["done"] += 1
            builder.add_sequence(rec.seq, internal, cds_blocks=blocks)
    if n_reversed:
        if use_prodigal:
            print(f"build: {n_reversed} contigs reverse-complemented to "
                  f"match their species training sequence strand "
                  f"(reference IndexCreator.cpp:1180-1212)")
        else:
            print(f"build: {n_reversed} contigs dissimilar/reverse-oriented "
                  f"vs their species training sequence (extraction is "
                  f"strand-complete; informational)")


def build_database(
    db_dir,
    fasta_list_path,
    acc2taxid_path,
    taxdump_dir,
    syncmer: bool = False,
    smer_len: int = 5,
    mask_mode: int = 1,
    mask_prob: float = 0.9,
    max_ram_gb: float = 32.0,
    write_reference_format: bool = False,
    db_name: str = "",
    cds_info_path: str = None,
    orf_prediction: bool = False,
    threads: int = 1,
    accession_level: bool = False,
    gene_predictor: str = "auto",
    resume: bool = False,
    force_prodigal: bool = False,
):
    """End-to-end `build` command (reference workflow/build.cpp:32-131).

    orf_prediction: restrict extraction to predicted extended ORF blocks
    instead of all six frames — the role Prodigal plays in the reference
    build (IndexCreator.cpp:1124-1212).  Explicit ``--cds-info`` blocks
    win over prediction per accession.
    gene_predictor: 'prodigal' = the vendored Prodigal 2.6.3 library
    with the reference's extended-ORF stitching (index/prodigal.py;
    bit-compatible with reference-binary DB builds), 'heuristic' = the
    dependency-free maximal-ORF approximation (index/orf.py), 'auto' =
    prodigal when its native library is buildable, else heuristic.
    threads: worker processes for masking/ORF/extraction (0 = all cores;
    the reference's OpenMP batch farm, IndexCreator.cpp:1029-1030) —
    the prodigal path is sequential (per-species trained state).
    resume: continue an interrupted build at flush granularity.  Spill
    runs live in <db_dir>/.build_runs with a manifest recording how many
    input records each flushed run covers; a resumed build adopts the
    runs and skips those records.  (The reference's flush files are
    resumable the same way but its hooks are commented out,
    workflow/build.cpp:110-113.)  Note: with gene_predictor='prodigal',
    an accession batch whose contigs straddle the resume point restarts
    as a fresh batch (retrained model + re-seeded intergenic list) at
    the resume point, which can shift extension directions for the
    remaining contigs of that batch vs an uninterrupted build.
    force_prodigal: use Prodigal meta-mode even for species whose
    training sequence is < 100 kb.  The vendored snapshot lacks the
    metagenomic training models (training.cpp), so meta-mode calls are
    degenerate; by default such species warn and use 6-frame-superset
    extraction instead."""
    taxonomy = Taxonomy.from_taxdump(taxdump_dir)
    acc2taxid = load_acc2taxid(acc2taxid_path)
    cds_info = load_cds_info(cds_info_path) if cds_info_path else {}

    with open(fasta_list_path) as f:
        fasta_files = [ln.strip() for ln in f if ln.strip()]

    acc_ids: dict = {}
    if accession_level:
        # header-only pre-pass: append one taxonomy node per accession so
        # k-mers are labeled per sequence (reference --accession-level 1,
        # IndexCreator.cpp:196-200 + accession2index)
        accs = []
        for fa in fasta_files:
            with open(fa) as f:
                for line in f:
                    if not line.startswith(">"):
                        continue
                    name = line[1:].split()[0]
                    taxid = acc2taxid.get(name.split(".")[0]) \
                        or acc2taxid.get(name)
                    if taxid is None:
                        continue
                    internal = taxonomy.to_internal(taxid)
                    if internal:
                        accs.append((name, internal))
        taxonomy, acc_ids = taxonomy.with_accessions(accs)

    # --- resumable spill state (flush-granularity checkpointing) ---
    spill_dir = os.path.join(str(db_dir), ".build_runs")
    manifest_path = os.path.join(spill_dir, "manifest.json")
    with open(fasta_list_path, "rb") as f:
        sig = hashlib.md5(f.read()).hexdigest()[:16]
    # fold each input FASTA's size+mtime into the signature: a FASTA
    # modified between crash and resume would silently misalign the
    # record-count skip and produce a wrong DB
    fstat = hashlib.md5()
    for fa in fasta_files:
        st = os.stat(fa)
        fstat.update(f"{fa}:{st.st_size}:{st.st_mtime_ns}".encode())
    sig += "|" + fstat.hexdigest()[:16]
    sig += f"|{syncmer}|{smer_len}|{mask_mode}|{mask_prob}|" \
           f"{orf_prediction}|{gene_predictor}|{accession_level}|" \
           f"{max_ram_gb}|{force_prodigal}"
    skip_records = 0
    restored_acc_map = []
    restored_observed = []
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            man = json.load(f)
        if man.get("sig") != sig:
            raise RuntimeError(
                "build --resume: manifest parameters differ from this "
                "invocation; delete "
                f"{spill_dir} to start over")
        skip_records = int(man["processed"])
        restored_acc_map = [tuple(x) for x in man["acc_map"]]
        restored_observed = man.get("observed", [])
        print(f"build: resuming after {skip_records} processed records, "
              f"{len(man['runs'])} spilled runs adopted")

    builder = IndexBuilder(taxonomy, syncmer, smer_len, mask_mode, mask_prob,
                           max_ram_gb, tmpdir=spill_dir)
    if skip_records:
        builder.adopt_runs(man["runs"])
        builder.observed_taxids.update(int(t) for t in restored_observed)
    acc_map_out = list(restored_acc_map)
    progress = {"done": skip_records}

    def _on_flush(_base):
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"sig": sig, "processed": progress["done"],
                       "runs": builder._runs,
                       "acc_map": acc_map_out,
                       "observed": sorted(builder.observed_taxids)}, f)
        os.replace(tmp, manifest_path)

    builder.on_flush = _on_flush
    extract_records(
        builder, taxonomy, fasta_files, acc2taxid,
        cds_info=cds_info, acc_ids=acc_ids,
        orf_prediction=orf_prediction, gene_predictor=gene_predictor,
        threads=threads, force_prodigal=force_prodigal,
        skip_records=skip_records, acc_map_out=acc_map_out,
        progress=progress)

    index = builder.finalize()
    index.meta["db_name"] = db_name or os.path.basename(str(db_dir))
    # recorded so updateDB extracts new sequences the same way this DB
    # was built (the reference always runs Prodigal in IndexCreator;
    # here orf settings are per-DB options)
    index.meta["orf_prediction"] = int(orf_prediction)
    index.meta["gene_predictor"] = gene_predictor
    if accession_level:
        index.meta["accession_level"] = 1
    save_index(db_dir, index)
    with open(os.path.join(db_dir, "acc2taxid.map"), "w") as f:
        for acc, tid in acc_map_out:
            f.write(f"{acc}\t{tid}\n")
    if accession_level:
        # accession2index: accession -> its new taxid (reference
        # IndexCreator.cpp:196-200 bookkeeping file)
        with open(os.path.join(db_dir, "accession2index"), "w") as f:
            for name, internal in acc_ids.items():
                f.write(f"{name}\t{int(index.taxonomy.orig_of(internal))}\n")
    if write_reference_format:
        export_reference_format(db_dir, index)
    # build complete: drop the resume checkpoint and spilled merge files
    shutil.rmtree(spill_dir, ignore_errors=True)
    return index
