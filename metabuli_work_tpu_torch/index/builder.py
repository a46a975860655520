"""Reference-database builder (host pipeline).

Counterpart of the reference's IndexCreator::createIndex
(src/commons/IndexCreator.cpp:316-376): FASTA list -> accession->taxid
mapping -> per-sequence 6-frame metamer extraction -> parallel sort ->
per-(value, species) dedup with LCA taxid assignment
(IndexCreator.h:475-629) -> sorted-array index.

This builder indexes all six frames of every sequence (a superset of
the reference's Prodigal extended-ORF blocks, see
ops/encode_np.extract_target_kmers).  ORF prediction, user CDS blocks,
accession-level labels and resumable builds are not part of this
package yet (ROADMAP.md, Queue 1 item 15).

Differences from the reference, by design: the index is a plain sorted
uint64 array + int32 side arrays (device-ready) instead of a 15-bit
delta stream; write_reference_format writes that stream beside it.

Out-of-core: sequences are processed in flush rounds bounded by
``max_ram_gb`` and spilled to temporary .npy runs that are k-way merged,
mirroring the reference's flush/merge protocol (IndexCreator.h:322-472).
"""

import os
import shutil
import tempfile

import numpy as np

from ..io.fasta import read_fasta
from ..ops.encode_np import extract_target_kmers
from ..ops import mask as mask_ops
from ..taxonomy import Taxonomy
from .format import KmerIndex, export_reference_format, save_index


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
    reference's OpenMP batch farm, IndexCreator.cpp:1008-1030): masking
    and metamer extraction are per-sequence-independent, so they
    parallelize over a process pool; the sequential tail
    (flush/sort/LCA/merge) stays in the parent."""
    seq, mask_mode, mask_prob, syncmer, smer_len = args
    if mask_mode:
        seq = mask_ops.mask_low_complexity(seq, mask_prob)
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
        """tmpdir: spill directory for flush runs (None = a fresh
        tempfile dir)."""
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
        self._values = []
        self._taxids = []
        self._species = []
        self._count = 0
        self.observed_taxids = set()

    def add_sequence(self, seq: str, taxid_internal: int):
        if self.mask_mode:
            seq = mask_ops.mask_low_complexity(seq, self.mask_prob)
        kmers = extract_target_kmers(seq, syncmer=self.syncmer, smer_len=self.smer_len)
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
                    threads=1, acc_map_out=None):
    """Feed every accession-mapped record of `fasta_files` into `builder`
    with whole-sequence 6-frame extraction (the reference's
    fillTargetKmerBuffer, IndexCreator.cpp:1008-1234, minus gene
    prediction)."""
    if acc_map_out is None:
        acc_map_out = []
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
                yield rec, internal, taxid

    if threads > 1:
        # multiprocess extraction farm; the parent keeps the sequential
        # flush/sort/LCA tail and bounds in-flight work to 4x threads
        import multiprocessing as mp
        from collections import deque
        from concurrent.futures import ProcessPoolExecutor

        ctx = mp.get_context("spawn")
        with ProcessPoolExecutor(max_workers=threads,
                                 mp_context=ctx) as pool:
            pending: deque = deque()

            def _drain_one():
                f, itl, nm, tid = pending.popleft()
                kmers = f.result()
                acc_map_out.append((nm, tid))
                builder.add_kmers(kmers, itl)

            for rec, internal, taxid in records():
                fut = pool.submit(_extract_worker,
                                  (rec.seq, builder.mask_mode,
                                   builder.mask_prob, builder.syncmer,
                                   builder.smer_len))
                pending.append((fut, internal, rec.name, taxid))
                while len(pending) > 4 * threads:
                    _drain_one()
            while pending:
                _drain_one()
    else:
        for rec, internal, taxid in records():
            acc_map_out.append((rec.name, taxid))
            builder.add_sequence(rec.seq, internal)
    return acc_map_out


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
    threads: int = 1,
):
    """End-to-end `build` command (reference workflow/build.cpp:32-131)
    with whole-sequence 6-frame extraction.

    write_reference_format: also write the reference's diffIdx/info/split
        files (index/format.export_reference_format).
    threads: worker processes for masking/extraction (0 = all cores;
    the reference's OpenMP batch farm, IndexCreator.cpp:1029-1030)."""
    taxonomy = Taxonomy.from_taxdump(taxdump_dir)
    acc2taxid = load_acc2taxid(acc2taxid_path)
    with open(fasta_list_path) as f:
        fasta_files = [ln.strip() for ln in f if ln.strip()]

    spill_dir = os.path.join(str(db_dir), ".build_runs")
    builder = IndexBuilder(taxonomy, syncmer, smer_len, mask_mode, mask_prob,
                           max_ram_gb, tmpdir=spill_dir)
    acc_map = extract_records(builder, taxonomy, fasta_files, acc2taxid,
                              threads=threads)
    index = builder.finalize()
    index.meta["db_name"] = db_name or os.path.basename(str(db_dir))
    # recorded so a later update extracts new sequences the same way
    index.meta["orf_prediction"] = 0
    index.meta["gene_predictor"] = "auto"
    save_index(db_dir, index)
    with open(os.path.join(db_dir, "acc2taxid.map"), "w") as f:
        for acc, tid in acc_map:
            f.write(f"{acc}\t{tid}\n")
    if write_reference_format:
        export_reference_format(db_dir, index)
    shutil.rmtree(spill_dir, ignore_errors=True)
    return index
