"""Packed index layouts and query batches for the probe tests, made with
the torch package alone (the card test, tests/test_torch_match_cuda.py,
imports no JAX): a database of 12 species in two genera, so that amino-
acid runs outrun the small caps; the wide 512-byte rows with the AA
hash, the same with a table whose rows chain (max_chain 3 in a small
byte budget), and a range cut of shard_quad_index; queries from
simulated reads, with reads of random sequence (hash misses), the
windows extraction leaves invalid, and the index's own metamers whose
home row is the table's last (their chain of rows clamps there)."""

import os

import numpy as np
import torch

from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.index.builder import build_database
from metabuli_work_tpu_torch.index.format import load_index
from metabuli_work_tpu_torch.models import flagship

from torch_port_db import simulate_reads, write_inputs


def make_db(root):
    """(index, genomes) of a syncmer database of 12 species of 4 kb built
    under root."""
    genomes, p = write_inputs(root, n_species=12)
    db = os.path.join(root, "db")
    build_database(db, p["fastas"], p["acc2taxid"], p["taxdump"],
                   syncmer=True, mask_mode=0)
    return load_index(db), genomes


LAYOUTS = ["wide", "wide-chain", "wide-range"]


def payloads(index):
    """(values, euler-first coordinate a entry, species with the euk flag
    in bit 30), as the classifier packs them."""
    tax = index.taxonomy
    n = tax.num_nodes()
    euk = tax.eukaryota_id()
    mask = (np.asarray(tax.is_ancestor(euk, np.arange(n))) if euk
            else np.zeros(n, dtype=bool))
    sp = index.species.astype(np.int64)
    sp_euk = (sp | (mask[sp].astype(np.int64) << 30)).astype(np.int32)
    ef = tax.euler_first.astype(np.int64)
    db_ef = ef[index.taxids.astype(np.int64)].astype(np.int32)
    return index.values, db_ef, sp_euk


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def layout(index, kind):
    """(rows, probe keywords) of one layout as CPU int32 tensors: the
    keywords hold hash_table, hash_log2_rows, hash_chain and db_m."""
    v, ef, sp = payloads(index)
    quad = packing.pack_db_quad(v, ef, sp)
    if kind == "wide-range":
        quads, hts, log2, chain, _ = packing.shard_quad_index(quad, 2)
        rows, ht, db_m = quads[1], hts[1], None
    else:
        rows = packing.pack_db_rows32(quad)
        # wide: the classifier's 42-slot rows; wide-chain: 5-slot rows in
        # a 4-KB budget, so that keys spill into the rows after their own
        geom = (dict(slots=packing.WIDE_SLOTS, row_u32=packing.WIDE_ROW_U32,
                     max_chain=1, max_bytes=3 << 30) if kind == "wide"
                else dict(max_chain=3, max_bytes=1 << 12))
        ht, log2, chain = packing.build_aa_hash(v, **geom)
        db_m = len(v)
    return _i32(rows), dict(hash_table=_i32(ht), hash_log2_rows=log2,
                            hash_chain=chain, db_m=db_m)


def ranges(index, n_ranges):
    """(quads, hash tables, log2_rows, chain) of shard_quad_index's range
    cut, as lists of CPU int32 tensors."""
    quads, hts, log2, chain, _ = packing.shard_quad_index(
        packing.pack_db_quad(*payloads(index)), n_ranges)
    return [_i32(q) for q in quads], [_i32(h) for h in hts], log2, chain


def queries(genomes, seed, n_reads=16, syncmer=True):
    """Flat CPU query tensors (qk, qf, qv) of simulated 150-bp reads, two
    of random sequence (hash misses)."""
    reads, _ = simulate_reads(genomes, n_reads, seed=seed)
    reads[:2] = np.random.default_rng(seed + 1).choice(
        np.frombuffer(b"ACGT", np.uint8), size=(2, reads.shape[1]))
    lens = np.full(len(reads), reads.shape[1], np.int32)
    qk, _, qf, _, qv, _, _ = flagship.extract_queries_step_ref(
        torch.from_numpy(reads), torch.from_numpy(lens), syncmer=syncmer)
    return qk, qf, qv


def last_row_queries(index, hash_table, log2_rows, n=8):
    """(qk, qf, qv) of up to n of the index's own metamers whose home row
    is the hash table's last: with a chain of rows their probe visits
    that row again in place of the rows past it."""
    v = index.values
    aa = (v >> np.uint64(24)) & np.uint64((1 << 40) - 1)
    lo32 = (aa & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi8 = (aa >> np.uint64(32)).astype(np.uint32)
    h = ((lo32 * packing._HASH_MUL1) ^ (hi8 * packing._HASH_MUL2)) \
        >> np.uint32(32 - log2_rows)
    pick = np.nonzero(h == hash_table.shape[0] - 1)[0][:n]
    qk = torch.from_numpy(v[pick].view(np.int64).copy())
    qf = torch.from_numpy((np.arange(len(pick)) % 6).astype(np.int32))
    return qk, qf, torch.ones(len(pick), dtype=torch.bool)
