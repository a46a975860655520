"""Torch wide-row hash probe vs the JAX package's match_kmers_quad, and
the port's index packing vs the JAX package's, bit-exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.index.builder import build_database
from metabuli_work_tpu.index.format import load_index
from metabuli_work_tpu.ops import encode_jax, match_jax
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.ops import match_torch

from torch_port_db import build_db, simulate_reads, write_inputs


def packed_state(index):
    """(rows, hash, log2_rows, chain, db_m, db_ef, sp_euk) of an index,
    as the classifier packs it (default single-device wide layout)."""
    tax = index.taxonomy
    n = tax.num_nodes()
    euk = tax.eukaryota_id()
    mask = (np.asarray(tax.is_ancestor(euk, np.arange(n))) if euk
            else np.zeros(n, dtype=bool))
    sp = index.species.astype(np.int64)
    sp_euk = (sp | (mask[sp].astype(np.int64) << 30)).astype(np.int32)
    ef = tax.euler_first.astype(np.int64)
    db_ef = ef[index.taxids.astype(np.int64)].astype(np.int32)
    rows = packing.pack_db_rows32(packing.pack_db_quad(index.values, db_ef,
                                                       sp_euk))
    ht, log2_rows, chain = packing.build_aa_hash(
        index.values, max_chain=1, max_bytes=3 << 30,
        slots=packing.WIDE_SLOTS, row_u32=packing.WIDE_ROW_U32)
    return rows, ht, log2_rows, chain, len(index.values), db_ef, sp_euk


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("match"))
    d = build_db(build_database, root, "db", syncmer=True)
    genomes, _ = write_inputs(root)
    return load_index(d), genomes


def test_packing_matches_jax(db):
    index, _ = db
    rows, ht, log2_rows, chain, _, db_ef, sp_euk = packed_state(index)
    q = match_jax.pack_db_quad(index.values, db_ef, sp_euk)
    np.testing.assert_array_equal(match_jax.pack_db_rows32(q), rows)
    jht, jl, jc = match_jax.build_aa_hash(index.values, max_chain=1,
                                          max_bytes=3 << 30, slots=42,
                                          row_u32=128)
    np.testing.assert_array_equal(jht, ht)
    assert (jl, jc) == (log2_rows, chain)


@pytest.mark.parametrize("cap", [4, 8])
def test_match_kmers_quad_matches_jax(db, cap):
    index, genomes = db
    rows, ht, log2_rows, chain, db_m, _, _ = packed_state(index)
    reads, _ = simulate_reads(genomes, 12, seed=cap)
    # a few reads of random sequence: hash misses
    reads[:2] = np.random.default_rng(9).choice(
        np.frombuffer(b"ACGT", np.uint8), size=(2, reads.shape[1]))
    lens = np.full(len(reads), reads.shape[1], np.int32)
    k, p, v = encode_jax.extract_batch(jnp.asarray(reads), jnp.asarray(lens),
                                       syncmer=True)
    qk, _, qf, _, qv = encode_jax.flatten_batch(
        k, p, v, jnp.arange(1, len(reads) + 1, dtype=jnp.int32))
    ref = match_jax.match_kmers_quad(
        qk, qf, qv, jnp.asarray(rows), cap=cap, kmer_format=2,
        hash_table=jnp.asarray(ht), hash_log2_rows=log2_rows,
        hash_chain=chain, db_m=db_m)
    st = packing.state_from_numpy(rows, ht, log2_rows, chain, db_m,
                                  np.zeros(1, np.int32),
                                  np.zeros((1, 1), np.int32),
                                  np.zeros(1, np.int32),
                                  np.zeros(1, np.int32), "cpu")
    got = match_torch.match_kmers_quad(
        torch.from_numpy(np.array(qk).view(np.int64)),
        torch.from_numpy(np.array(qf)), torch.from_numpy(np.array(qv)),
        st["db_quad"], cap=cap, kmer_format=2, hash_table=st["hash_table"],
        hash_log2_rows=log2_rows, hash_chain=chain, db_m=db_m)
    assert set(ref) == set(got) and len(got) == 7
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key]), got[key].numpy(),
                                      key)
    assert bool(np.asarray(ref["sel"]).any())
