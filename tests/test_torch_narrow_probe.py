"""The narrow and bisection probes in the torch package vs the JAX
package's, on the CPU, tolerance 0: align_runs4, pack_db_blocks and the
narrow shards of shard_quad_index array for array; match_kmers_quad on
64-byte block rows (run starts aligned or not), on entry-row shards and
with the bucket bisection, every output tensor equal; and a Classifier
under each probe knob (METABULI_WIDE_PROBE=0, METABULI_QUAD_ALIGN_GB=0,
METABULI_HASH_PROBE=0, METABULI_HASH_CHAIN=3) equal per read, tax_cnt
included, to the JAX Classifier under the same knob, resident, streamed
and on a 2 x 2 mesh; the hash geometry under METABULI_HASH_CHAIN=3; and
the METABULI_DEBUG_RETRY line."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.index.format import load_index
from metabuli_work_tpu.ops import encode_jax, match_jax
from metabuli_work_tpu.parallel.sharding import make_mesh as jmake_mesh
from metabuli_work_tpu.parallel.sharding import shard_quad_index as jshard
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.ops import match_torch
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

from test_torch_match import packed_state
from torch_port_db import build_db, simulate_reads, write_inputs, write_reads
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)

KNOBS = {
    "aligned": {"METABULI_WIDE_PROBE": "0"},
    "unaligned": {"METABULI_WIDE_PROBE": "0", "METABULI_QUAD_ALIGN_GB": "0"},
    "bisection": {"METABULI_HASH_PROBE": "0"},
    "chain3": {"METABULI_HASH_CHAIN": "3"},
}


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("narrow"))
    d = build_db(jbuild, root, "db", syncmer=True)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 22, seed=41)
    rnd = np.random.default_rng(42).choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=(2, reads.shape[1]))
    path = os.path.join(root, "reads.fna")
    write_reads(path, np.concatenate([reads, rnd]))
    index = load_index(d)
    _, _, _, _, _, db_ef, sp_euk = packed_state(index)
    return dict(root=root, db=d, index=index, genomes=genomes, reads=path,
                db_ef=db_ef, sp_euk=sp_euk)


def _res(q):
    r = q.result
    return (q.name, bool(r.is_classified), int(r.classification),
            np.float32(r.score).view(np.int32).item(), dict(r.tax_cnt),
            q.length1)


def test_narrow_packing_matches_jax(db):
    v, ef, sp = db["index"].values, db["db_ef"], db["sp_euk"]
    ref = match_jax.align_runs4(v, ef, sp)
    got = packing.align_runs4(v, ef, sp)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > len(v)          # some runs needed padding
    quad = packing.pack_db_quad(got[0], got[1], got[2])
    np.testing.assert_array_equal(match_jax.pack_db_blocks(quad),
                                  packing.pack_db_blocks(quad))
    jht = match_jax.build_aa_hash(v, starts_override=ref[-1])
    tht = packing.build_aa_hash(v, starts_override=got[-1])
    np.testing.assert_array_equal(jht[0], tht[0])
    assert jht[1:] == tht[1:]
    assert packing.aligned_bytes(db["index"]._aa_runs()) == len(got[0]) * 16
    full = packing.pack_db_quad(v, ef, sp)
    for n in (2, 3):
        for a, b in zip(jshard(full, n, wide=False),
                        packing.shard_quad_index(full, n, wide=False)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _queries(genomes, seed):
    reads, _ = simulate_reads(genomes, 12, seed=seed)
    reads[:2] = np.random.default_rng(9).choice(
        np.frombuffer(b"ACGT", np.uint8), size=(2, reads.shape[1]))
    lens = np.full(len(reads), reads.shape[1], np.int32)
    k, p, v = encode_jax.extract_batch(jnp.asarray(reads), jnp.asarray(lens),
                                       syncmer=True)
    qk, _, qf, _, qv = encode_jax.flatten_batch(
        k, p, v, jnp.arange(1, len(reads) + 1, dtype=jnp.int32))
    return qk, qf, qv


def _layout(db, kind):
    """(rows, JAX kwargs, torch kwargs, u32 -> int32 tensor view) of one
    narrow layout; the kwargs carry the hash or the bucket tables, db_m
    and the alignment flag."""
    v, ef, sp = db["index"].values, db["db_ef"], db["sp_euk"]
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    if kind == "entries":
        quads, hts, log2, chain, _ = packing.shard_quad_index(
            packing.pack_db_quad(v, ef, sp), 2, wide=False)
        rows, ht, db_m = quads[0], hts[0], None
        extra = {}
    else:
        aligned = kind == "aligned"
        use_hash = kind != "bisection"
        rows, ht, log2, chain, db_m = packing.load_or_pack_narrow(
            v, ef, sp, aligned=aligned, use_hash=use_hash, max_chain=1,
            max_bytes=3 << 30)
        extra = dict(aligned=aligned)
    jkw = dict(db_m=db_m, **extra)
    tkw = dict(db_m=db_m, **extra)
    if ht is not None:
        jkw.update(hash_table=jnp.asarray(ht), hash_log2_rows=log2,
                   hash_chain=chain)
        tkw.update(hash_table=i32(ht), hash_log2_rows=log2, hash_chain=chain)
    else:
        b_lo, aa_lo, shift, steps = match_jax.build_buckets(v)
        jkw.update(bucket_lo=jnp.asarray(b_lo), db_aa_lo=jnp.asarray(aa_lo),
                   bucket_shift=shift, bucket_steps=steps)
        tkw.update(packing.bucket_state_from_numpy(b_lo, aa_lo, shift, steps,
                                                   "cpu"))
    return rows, jkw, tkw, i32


@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("kind", ["aligned", "unaligned", "entries",
                                  "bisection"])
def test_match_kmers_quad_narrow_matches_jax(db, kind, cap):
    rows, jkw, tkw, i32 = _layout(db, kind)
    qk, qf, qv = _queries(db["genomes"], seed=cap)
    ref = match_jax.match_kmers_quad(qk, qf, qv, jnp.asarray(rows), cap=cap,
                                     kmer_format=2, **jkw)
    got = match_torch.match_kmers_quad(
        torch.from_numpy(np.array(qk).view(np.int64)),
        torch.from_numpy(np.array(qf)), torch.from_numpy(np.array(qv)),
        i32(rows), cap=cap, kmer_format=2, **tkw)
    assert set(ref) == set(got) and len(got) == 7
    for key in ref:
        np.testing.assert_array_equal(np.asarray(ref[key]), got[key].numpy(),
                                      key)
    assert bool(np.asarray(ref["sel"]).any())


def _run_both(db, monkeypatch, knobs, torch_kw=None, jax_kw=None, **params):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    p = {**PARAMS, **params}
    tclf = Classifier(db["db"], ClassifyParams(**p), **(torch_kw or
                                                        {"device": "cpu"}))
    got = [_res(q) for q in tclf.classify_file(db["reads"])]
    jclf = JClassifier(db["db"], JParams(**p), **(jax_kw or {}))
    ref = [_res(q) for q in jclf.classify_file(db["reads"])]
    return ref, got, tclf, jclf


@pytest.mark.parametrize("knob", list(KNOBS))
def test_resident_classifier_matches_jax_under_knob(db, monkeypatch, knob):
    ref, got, tclf, jclf = _run_both(db, monkeypatch, KNOBS[knob])
    assert got == ref
    assert sum(r[1] for r in got) >= 18
    assert tclf._wide == jclf._wide and tclf._aligned == jclf._aligned
    assert (tclf.hash_log2_rows, tclf.hash_chain, tclf.db_m) == \
        (jclf.hash_log2_rows, jclf.hash_chain, jclf.db_m)
    assert tuple(tclf.db_quad.shape) == tuple(jclf.db_quad.shape)
    if knob == "bisection":
        assert tclf.hash_table is None and jclf.hash_table is None
        assert tclf._probe_kw["bucket_steps"] == jclf.bucket_steps
    else:
        np.testing.assert_array_equal(
            tclf.hash_table.numpy().view(np.uint32),
            np.asarray(jclf.hash_table))
    if knob == "chain3":
        assert tclf._wide and tclf.hash_chain <= 3


def test_streamed_and_mesh_narrow_match_jax(db, monkeypatch):
    budget = (16 * db["index"].size / 3.5) * 2 / (1 << 30)
    ref, got, tclf, jclf = _run_both(
        db, monkeypatch, KNOBS["aligned"], hbm_budget_gb=budget)
    assert tclf._streaming and jclf._streaming
    assert tclf._n_ranges == jclf._n_ranges >= 4
    assert tclf._ranges.quads.shape[2] == 4          # entry-row shards
    assert got == ref
    mesh_ref, mesh_got, tclf, jclf = _run_both(
        db, monkeypatch, KNOBS["aligned"],
        torch_kw={"mesh": make_mesh(4, devices=["cpu"] * 4)},
        jax_kw={"mesh": jmake_mesh(4)})
    assert tclf.mesh.shape == {"dp": 2, "db": 2} and not tclf._mesh_stream
    assert tuple(tclf._cells[0][0][0].shape) == (
        jclf.db_quad_sh.shape[1], 4)
    assert mesh_got == mesh_ref == got


def test_debug_retry_line_matches_jax(db, monkeypatch, capfd):
    monkeypatch.setenv("METABULI_DEBUG_RETRY", "1")
    p = dict(PARAMS, batch_size=32)
    out = []
    for clf in (JClassifier(db["db"], JParams(**p)),
                Classifier(db["db"], ClassifyParams(**p), device="cpu")):
        clf._path_block = 2       # blocked-emission overflow: a retry
        capfd.readouterr()
        clf.classify_file(db["reads"])
        out.append([ln for ln in capfd.readouterr().err.splitlines()
                    if ln.startswith("# retry")])
    assert out[0] and out[1] == out[0]
