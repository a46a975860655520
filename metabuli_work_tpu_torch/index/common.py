"""Common-k-mer database: AA 12-mers shared by >= 2 species.

Reference: IndexCreator::createCommonKmerIndex (IndexCreator.cpp:231-314)
with FilterMode::COMMON_KMER (IndexCreator.h:538-565): extract dna2aa
12-mers from every reference sequence (six frames, target-style frame
ranges — KmerExtractor::extractKmer_dna2aa, KmerExtractor.cpp:388-418),
sort by (value, species), and keep values observed in more than one
species.  The resulting sorted value list feeds the read-group
pipeline's filterCommonKmers.  Output: kmers.npy (sorted u64 values) +
infos.npy (LCA taxid per value) + db.meta.json.

UPSTREAM QUIRK mirrored for parity (tests/test_golden_readgroup.py):
the binary only applies the >= 2-species COMMON_KMER selection inside
mergeTargetFiles, which runs for MULTI-flush builds — a single-flush
build returns right after writing the DB_CREATION-filtered buffer
(IndexCreator.cpp:296-299 `if (numOfFlush == 1) return`), so small
inputs produce the FULL per-(value, species)-deduped k-mer set with
per-group LCA taxids, exactly like `build`.  common_filter="auto"
reproduces that (filter only when the input would have spilled);
"always" applies the documented intent regardless.
"""

import json
import os
import time

import numpy as np

from ..ops import mask as mask_ops
from ..ops.encode_np import scan_frame
from ..ops.genetic_code import seq_to_codes
from ..taxonomy import Taxonomy
from .builder import extract_cds_kmers, extract_records, load_acc2taxid


def extract_target_aa_kmers(seq: str, k: int = 12, syncmer: bool = False,
                            smer_len: int = 5) -> np.ndarray:
    """Six-frame AA k-mers, target-style frame ranges."""
    codes = seq_to_codes(seq)
    L = len(codes)
    out = []
    for frame in range(6):
        fwd = frame < 3
        if fwd:
            begin, end = frame, L - 1
        else:
            begin, end = 0, L - 1 - (frame % 3)
        used = end - begin + 1
        if used < 3 * k:
            continue
        fk = scan_frame(codes, begin, used, fwd, syncmer=syncmer,
                        smer_len=smer_len, k=k, aa_only=True)
        out.append(fk.kmers)
    return np.concatenate(out) if out else np.zeros(0, np.uint64)


class _AAKmerCollector:
    """extract_records-compatible sink collecting AA 12-mers per
    extended-ORF block (plays IndexBuilder's role for the common DB —
    the reference runs its common build through the same
    fillTargetKmerBuffer/Prodigal machinery as `build`).  A block is
    scanned over its own span (index/builder.extract_cds_kmers), not
    over the whole sequence's reverse complement."""

    def __init__(self, taxonomy, k, syncmer, smer_len, mask_mode,
                 mask_prob):
        self.taxonomy = taxonomy
        self.k = k
        self.syncmer = syncmer
        self.smer_len = smer_len
        self.mask_mode = mask_mode
        self.mask_prob = mask_prob
        self.flush_kmers = 1 << 62          # batch-cap probe; never spills
        self.values, self.taxids, self.species = [], [], []

    def add_sequence(self, seq, taxid_internal, cds_blocks=None):
        if self.mask_mode:
            seq = mask_ops.mask_low_complexity(seq, self.mask_prob)
        if cds_blocks:
            km = extract_cds_kmers(seq, cds_blocks, syncmer=self.syncmer,
                                   smer_len=self.smer_len, k=self.k,
                                   aa_only=True)
        else:
            km = extract_target_aa_kmers(seq, self.k, self.syncmer,
                                         self.smer_len)
        if not len(km):
            return 0
        sp = int(self.taxonomy.species_of(taxid_internal)) or taxid_internal
        self.values.append(km)
        self.taxids.append(np.full(len(km), taxid_internal, dtype=np.int32))
        self.species.append(np.full(len(km), sp, dtype=np.int32))
        return len(km)


def build_common_kmer_db(
    db_dir,
    fasta_list_path,
    acc2taxid_path,
    taxdump_dir,
    k: int = 12,
    syncmer: bool = False,
    smer_len: int = 5,
    common_filter: str = "auto",
    flush_kmers: int = 1 << 30,
    mask_mode: int = 0,
    mask_prob: float = 0.9,
    orf_prediction: bool = True,
    gene_predictor: str = "auto",
):
    """orf_prediction=True extracts per Prodigal extended-ORF block
    (in-frame only) exactly like the reference's common build —
    createCommonKmerIndex funnels through fillTargetKmerBuffer unless
    --cds-info x (IndexCreator.cpp:256-260); False scans all six
    frames (a superset).

    NOTE: extraction is NON-syncmer regardless of `syncmer` — the
    binary constructs its scanners from par.kmerFormat (fixed at 3 in
    create_common_kmer_list.cpp setDefaults), so --syncmer 1 is
    recorded in db.parameters but never applied to the k-mer selection
    (verified k-mer-for-k-mer in tests/test_golden_readgroup.py)."""
    taxonomy = Taxonomy.from_taxdump(taxdump_dir)
    acc2taxid = load_acc2taxid(acc2taxid_path)
    with open(fasta_list_path) as f:
        fasta_files = [ln.strip() for ln in f if ln.strip()]

    collector = _AAKmerCollector(taxonomy, k, False, smer_len,
                                 mask_mode, mask_prob)
    extract_records(collector, taxonomy, fasta_files, acc2taxid,
                    orf_prediction=orf_prediction,
                    gene_predictor=gene_predictor)

    if collector.values:
        v = np.concatenate(collector.values)
        t = np.concatenate(collector.taxids)
        s = np.concatenate(collector.species)
    else:
        v = np.zeros(0, np.uint64)
        t = np.zeros(0, np.int32)
        s = np.zeros(0, np.int32)

    order = np.lexsort((t, s, v))
    v, t, s = v[order], t[order], s[order]
    # DB_CREATION stage: one row per (value, species), taxid = LCA of
    # the group's taxids (IndexCreator.h filterKmers<DB_CREATION>)
    first = np.ones(len(v), dtype=bool)
    first[1:] = (v[1:] != v[:-1]) | (s[1:] != s[:-1])
    gid = np.cumsum(first) - 1
    n_g = int(gid[-1]) + 1 if len(v) else 0
    vu, su = v[first], s[first]
    tu = taxonomy.lca_reduce(t, gid, n_g).astype(np.int32)

    apply_common = (common_filter == "always"
                    or (common_filter == "auto" and len(v) > flush_kmers))
    if apply_common:
        # COMMON_KMER merge stage: keep values in >= 2 species, taxid =
        # LCA of the speciesIds (IndexCreator.h:538-565,577-580)
        new_val = np.ones(len(vu), dtype=bool)
        new_val[1:] = vu[1:] != vu[:-1]
        val_id = np.cumsum(new_val) - 1
        n_vals = int(val_id[-1]) + 1 if len(vu) else 0
        sp_count = np.bincount(val_id, minlength=n_vals)
        common = sp_count >= 2
        keep = common[val_id]
        out_values = vu[new_val & keep]
        out_taxids = taxonomy.lca_reduce(
            su[keep].astype(np.int64),
            (np.cumsum(common) - 1)[val_id[keep]],
            int(common.sum()) or 0)
    else:
        out_values = vu
        out_taxids = tu

    os.makedirs(db_dir, exist_ok=True)
    np.save(os.path.join(db_dir, "kmers.npy"), out_values)
    np.save(os.path.join(db_dir, "infos.npy"), out_taxids.astype(np.int32))
    taxonomy.save(os.path.join(db_dir, "taxonomy.npz"))
    with open(os.path.join(db_dir, "db.meta.json"), "w") as f:
        json.dump({
            "db_type": "common_kmer",
            "kmer_format": 5 if syncmer else 3,
            "kmer_len": k,
            "syncmer": syncmer,
            "smer_len": smer_len,
            "kmer_count": int(len(out_values)),
            "creation_date": time.strftime("%Y-%m-%d"),
        }, f, indent=2)
    mode = "on" if apply_common else "off (single-flush semantics)"
    print(f"common-kmer DB: {len(out_values)} k-mers "
          f"(common-filter {mode}) -> {db_dir}")
    return out_values
