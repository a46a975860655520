"""On-disk database layout (native).

Native layout (directory):
  db.meta.json     build parameters & stats (the reference's db.parameters
                   handshake, common.cpp:88-133 — classify re-applies these)
  kmers.npy        uint64 sorted metamer values
  infos.npy        int32 LCA taxid per entry (internal id space)
  species.npy      int32 species ancestor per entry
  taxonomy.npz     serialized Taxonomy (replaces mmap'd taxonomyDB blob)
  taxID_list       text, one internal taxid per line (reference parity)
  acc2taxid.map    accession\toriginal-taxid

Importing and exporting the reference's diffIdx/info/split layout is not
part of this package yet.
"""

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..taxonomy import Taxonomy

DB_META_NAME = "db.meta.json"


@dataclass
class KmerIndex:
    values: np.ndarray       # uint64 sorted
    taxids: np.ndarray       # int32 internal
    species: np.ndarray      # int32 internal
    taxonomy: Taxonomy
    meta: dict = field(default_factory=dict)

    @property
    def size(self):
        return len(self.values)

    def _aa_runs(self) -> np.ndarray:
        if self.size == 0:
            return np.ones(1, dtype=np.int64)
        aa = self.values >> np.uint64(24)
        change = np.nonzero(aa[1:] != aa[:-1])[0]
        return np.diff(np.concatenate([[-1], change, [self.size - 1]]))

    def max_aa_run(self) -> int:
        """Longest run of equal amino-acid parts (caps the match cap)."""
        return int(self._aa_runs().max())

    def cap_aa_run(self, coverage: float = 0.999) -> int:
        """Smallest cap covering `coverage` of DB entries by run length.

        Sizing every probe to max_aa_run pays ~4 gather rows per slot for
        runs that occur once in a million; the classify pipeline starts at
        this quantile and doubles on overflow (the reference's
        matchPerKmer += 4 retry, Classifier.cpp:127-131, recast)."""
        runs = self._aa_runs()
        order = np.sort(runs)
        covered = np.cumsum(order)
        i = int(np.searchsorted(covered, coverage * covered[-1]))
        return int(order[min(i, len(order) - 1)])


def save_index(db_dir, index: KmerIndex, extra_meta=None):
    os.makedirs(db_dir, exist_ok=True)
    np.save(os.path.join(db_dir, "kmers.npy"), index.values)
    np.save(os.path.join(db_dir, "infos.npy"), index.taxids.astype(np.int32))
    np.save(os.path.join(db_dir, "species.npy"), index.species.astype(np.int32))
    index.taxonomy.save(os.path.join(db_dir, "taxonomy.npz"))
    with open(os.path.join(db_dir, "taxID_list"), "w") as f:
        for t in np.unique(index.taxids):
            f.write(f"{int(t)}\n")
    meta = dict(index.meta)
    meta.setdefault("creation_date", time.strftime("%Y-%m-%d"))
    meta["kmer_count"] = int(index.size)
    meta["max_aa_run"] = index.max_aa_run()
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(db_dir, DB_META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    # db.parameters for reference-tooling compatibility
    with open(os.path.join(db_dir, "db.parameters"), "w") as f:
        f.write(f"DB_name\t{meta.get('db_name', os.path.basename(str(db_dir)))}\n")
        f.write(f"Creation_date\t{meta['creation_date']}\n")
        f.write(f"Reduced_alphabet\t{meta.get('reduced_aa', 0)}\n")
        f.write(f"Accession_level\t{meta.get('accession_level', 0)}\n")
        f.write(f"Mask_mode\t{meta.get('mask_mode', 0)}\n")
        f.write(f"Mask_prob\t{meta.get('mask_prob', 0.9)}\n")
        f.write(f"Skip_redundancy\t{meta.get('skip_redundancy', 1)}\n")
        f.write(f"Syncmer\t{int(meta.get('syncmer', 0))}\n")
        f.write(f"Syncmer_len\t{meta.get('smer_len', 5)}\n")
        f.write(f"Kmer_format\t{meta.get('kmer_format', 2)}\n")


def load_index(db_dir) -> KmerIndex:
    meta_path = os.path.join(db_dir, DB_META_NAME)
    if not os.path.exists(meta_path) \
            and os.path.exists(os.path.join(db_dir, "diffIdx")):
        raise NotImplementedError(
            "reference-format databases are not supported by this package "
            "yet (ROADMAP.md, Queue 1: reference-format DB import)")
    with open(meta_path) as f:
        meta = json.load(f)
    values = np.load(os.path.join(db_dir, "kmers.npy"))
    taxids = np.load(os.path.join(db_dir, "infos.npy"))
    species = np.load(os.path.join(db_dir, "species.npy"))
    taxonomy = Taxonomy.load(os.path.join(db_dir, "taxonomy.npz"))
    return KmerIndex(values, taxids, species, taxonomy, meta)
