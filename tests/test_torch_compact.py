"""Torch match compaction (ops/compact_torch.py) vs the JAX package's
ops/compact_jax.py on the same probe output: the packed columns' `count`
prefix (what the host ever reads; the JAX tail is a pile of dropped
rows), the count, and the decoded match records.  Tolerance 0."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.classify.taxonomer import MATCH_DTYPE
from metabuli_work_tpu.index.builder import build_database
from metabuli_work_tpu.index.format import load_index
from metabuli_work_tpu.ops import compact_jax, encode_jax, match_jax
from metabuli_work_tpu_torch.classify.taxonomer import MATCH_DTYPE as T_DTYPE
from metabuli_work_tpu_torch.ops import compact_torch

from torch_port_db import build_db, simulate_reads, write_inputs
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """JAX match_kmers output ([N, cap]) + query annotation for 10 reads,
    per cap."""
    root = str(tmp_path_factory.mktemp("compact"))
    index = load_index(build_db(build_database, root, "db", syncmer=False))
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 10, seed=6)
    lens = np.full(len(reads), reads.shape[1], np.int32)
    k, p, v = encode_jax.extract_batch(jnp.asarray(reads), jnp.asarray(lens))
    qk, qp, qf, qs, qv = encode_jax.flatten_batch(
        k, p, v, jnp.arange(1, len(reads) + 1, dtype=jnp.int32))

    def run(cap):
        out = match_jax.match_kmers(
            qk, qf, qv, jnp.asarray(index.values),
            jnp.asarray(index.taxids.astype(np.int32)),
            jnp.asarray(index.species.astype(np.int32)), cap=cap)
        return out, qp, qf, qs

    return run


def _to_torch(out, *ann):
    t = lambda a: torch.from_numpy(np.array(a))
    return ({k: t(v) for k, v in out.items()},) + tuple(t(a) for a in ann)


@pytest.mark.parametrize("cap", [2, 8])
def test_compact_and_sort_matches_jax(probe, cap):
    out, qp, qf, qs = probe(cap)
    ref, ref_n = compact_jax.compact_and_sort(out, qp, qf, qs)
    got, got_n = compact_torch.compact_and_sort(*_to_torch(out, qp, qf, qs))
    n = int(ref_n)
    assert n == int(got_n) and n > 100
    assert got.shape == ref.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref)[:, :n], got.numpy()[:, :n])
    assert not got.numpy()[:, n:].any()          # the port's tail is clean


@pytest.mark.parametrize("quantum", [1 << 15, 64])
def test_fetch_and_decode_match_jax(probe, quantum):
    out, qp, qf, qs = probe(8)
    ref_pc = compact_jax.compact_and_sort(out, qp, qf, qs)
    got_pc = compact_torch.compact_and_sort(*_to_torch(out, qp, qf, qs))
    ref = compact_jax.fetch_compacted(ref_pc, bucket_quantum=quantum)
    got = compact_torch.fetch_compacted(got_pc, bucket_quantum=quantum)
    np.testing.assert_array_equal(ref, got)
    assert T_DTYPE == MATCH_DTYPE
    rm = compact_jax.decode_matches(ref, MATCH_DTYPE)
    gm = compact_torch.decode_matches(got, T_DTYPE)
    assert len(rm) == int(ref_pc[1]) and rm.tobytes() == gm.tobytes()
    assert gm["frame"].max() == 5 and gm["rh"].any()


def test_decode_matches_reads_meta_as_unsigned():
    """frame 5 with hamming and rh bits all set: the int32 meta word's
    top bits must decode by logical shifts."""
    meta = (5 << 27) | (0xFF << 19) | (0xFFFF << 3)
    p = np.array([[7], [3], [meta], [11], [0xFFFFFF], [9]], np.int32)
    m = compact_torch.decode_matches(p, T_DTYPE)
    assert (int(m["frame"][0]), int(m["ham"][0]), int(m["rh"][0])) \
        == (5, 0xFF, 0xFFFF)
    assert m.tobytes() == compact_jax.decode_matches(p, MATCH_DTYPE).tobytes()
