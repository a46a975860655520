"""The port's one probe layout (512-byte rows with the AA hash) held to
the JAX package under every layout a JAX user can pick, on the CPU,
tolerance 0: match_kmers_quad of the JAX package on 64-byte block rows
(run starts aligned or not), on entry-row shards and with the bucket
bisection against the port's wide probe of the same queries (sel, the
overflow count, and every field where sel holds); the JAX Classifier
under each probe knob (METABULI_WIDE_PROBE=0, METABULI_QUAD_ALIGN_GB=0,
METABULI_HASH_PROBE=0, METABULI_HASH_CHAIN=3) against the port's
resident Classifier, read for read, tax_cnt included; the JAX narrow
layout streamed and on a 2 x 2 mesh against the port's wide one; and
the port under each of the retired probe variables, which it no longer
reads: the same layout and results as with none set."""

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
FIELDS = ("hamming", "rh", "taxid", "species", "dna_enc")

# the JAX package's probe knobs, each set as a JAX user sets it
KNOBS = {
    "aligned": {"METABULI_WIDE_PROBE": "0"},
    "unaligned": {"METABULI_WIDE_PROBE": "0", "METABULI_QUAD_ALIGN_GB": "0"},
    "bisection": {"METABULI_HASH_PROBE": "0"},
    "chain3": {"METABULI_HASH_CHAIN": "3"},
}
# the variables the port once read to pick a layout, each at a value
# that would change the layout if read: a chain bound of 0 grows the
# table to four rows a key; a 100-KB table budget and the alignment
# budget 0 bind only where another variable or a larger index lets them
RETIRED = {"METABULI_WIDE_PROBE": "0", "METABULI_QUAD_ALIGN_GB": "0",
           "METABULI_HASH_PROBE": "0", "METABULI_HASH_CHAIN": "0",
           "METABULI_HASH_GB": "0.0001"}


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("layout"))
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


def _layout_shapes(clf):
    """The rows' shape and the probe keywords (tensors by shape) of a
    resident classifier."""
    return (tuple(clf.db_quad.shape),
            {k: tuple(v.shape) if torch.is_tensor(v) else v
             for k, v in clf._probe_kw.items()})


@pytest.fixture(scope="module")
def port_run(db):
    """The port's resident Classifier with no probe variable set: its
    results and layout."""
    for k in RETIRED:
        assert k not in os.environ, k
    clf = Classifier(db["db"], ClassifyParams(**PARAMS), device="cpu")
    return [_res(q) for q in clf.classify_file(db["reads"])], \
        _layout_shapes(clf)


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


def _jax_layout(db, kind):
    """(rows, keywords) of one of the JAX package's narrow layouts, made
    by its own functions as its Classifier makes them: block rows with
    run starts aligned or not and the 5-slot hash, the first entry-row
    shard of two, or block rows with the bucket tables."""
    v, ef, sp = db["index"].values, db["db_ef"], db["sp_euk"]
    if kind == "entries":
        quads, hts, log2, chain, _ = jshard(
            match_jax.pack_db_quad(v, ef, sp), 2, wide=False)
        return quads[0], dict(hash_table=jnp.asarray(hts[0]),
                              hash_log2_rows=log2, hash_chain=chain)
    starts = None
    if kind == "aligned":
        v_pad, ef_pad, sp_pad, starts = match_jax.align_runs4(v, ef, sp)
        rows = match_jax.pack_db_blocks(match_jax.pack_db_quad(v_pad, ef_pad,
                                                               sp_pad))
        kw = dict(db_m=len(v_pad), aligned=True)
    else:
        rows = match_jax.pack_db_blocks(match_jax.pack_db_quad(v, ef, sp))
        kw = dict(db_m=len(v), aligned=False)
    if kind == "bisection":
        b_lo, aa_lo, shift, steps = match_jax.build_buckets(v)
        kw.update(bucket_lo=jnp.asarray(b_lo), db_aa_lo=jnp.asarray(aa_lo),
                  bucket_shift=shift, bucket_steps=steps)
    else:
        ht, log2, chain = match_jax.build_aa_hash(
            v, max_chain=1, max_bytes=3 << 30, starts_override=starts)
        kw.update(hash_table=jnp.asarray(ht), hash_log2_rows=log2,
                  hash_chain=chain)
    return rows, kw


def _port_layout(db, kind):
    """(rows, keywords) of the port's wide probe as CPU int32 tensors: the
    resident rows, or for the entry-row shard the wide shard of the same
    cut."""
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    v, ef, sp = db["index"].values, db["db_ef"], db["sp_euk"]
    if kind == "entries":
        quads, hts, log2, chain, _ = packing.shard_quad_index(
            packing.pack_db_quad(v, ef, sp), 2)
        return i32(quads[0]), dict(hash_table=i32(hts[0]),
                                   hash_log2_rows=log2, hash_chain=chain)
    rows, ht, log2, chain, db_m, _, _ = packed_state(db["index"])
    return i32(rows), dict(hash_table=i32(ht), hash_log2_rows=log2,
                           hash_chain=chain, db_m=db_m)


@pytest.mark.parametrize("cap", [4, 8])
@pytest.mark.parametrize("kind", ["aligned", "unaligned", "entries",
                                  "bisection"])
def test_wide_probe_matches_jax_layouts(db, kind, cap):
    rows, jkw = _jax_layout(db, kind)
    trows, tkw = _port_layout(db, kind)
    qk, qf, qv = _queries(db["genomes"], seed=cap)
    ref = match_jax.match_kmers_quad(qk, qf, qv, jnp.asarray(rows), cap=cap,
                                     kmer_format=2, **jkw)
    got = match_torch.match_kmers_quad(
        torch.from_numpy(np.array(qk).view(np.int64)),
        torch.from_numpy(np.array(qf)), torch.from_numpy(np.array(qv)),
        trows, cap=cap, kmer_format=2, **tkw)
    sel = np.asarray(ref["sel"])
    np.testing.assert_array_equal(sel, got["sel"].numpy())
    assert int(ref["overflow"]) == int(got["overflow"])
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(ref[k])[sel],
                                      got[k].numpy()[sel], k)
    assert sel.any()


def _jax_run(db, monkeypatch, knobs, **kw):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    jclf = JClassifier(db["db"], JParams(**{**PARAMS,
                                            **kw.pop("params", {})}), **kw)
    return [_res(q) for q in jclf.classify_file(db["reads"])], jclf


@pytest.mark.parametrize("knob", list(KNOBS))
def test_resident_classifier_matches_jax_under_knob(db, monkeypatch,
                                                    port_run, knob):
    got, (rows_shape, _) = port_run
    ref, jclf = _jax_run(db, monkeypatch, KNOBS[knob])
    assert got == ref
    assert sum(r[1] for r in got) >= 18
    assert rows_shape[1] == 128                   # the port's wide rows
    # the JAX classifier took the layout the knob asks for
    assert jclf._wide == (knob == "chain3")
    assert jclf._aligned == (knob == "aligned")
    assert (jclf.hash_table is None) == (knob == "bisection")


def test_streamed_and_mesh_match_jax_narrow(db, monkeypatch):
    budget = (16 * db["index"].size / 3.5) * 2 / (1 << 30)
    p = dict(PARAMS, hbm_budget_gb=budget)
    tclf = Classifier(db["db"], ClassifyParams(**p), device="cpu")
    got = [_res(q) for q in tclf.classify_file(db["reads"])]
    ref, jclf = _jax_run(db, monkeypatch, KNOBS["aligned"],
                         params={"hbm_budget_gb": budget})
    assert tclf._streaming and jclf._streaming
    assert tclf._n_ranges == jclf._n_ranges >= 4
    assert tclf._ranges.quads.shape[2] == 128     # wide ranges
    assert not jclf._shard_wide                   # JAX: entry-row ranges
    assert got == ref
    tclf = Classifier(db["db"], ClassifyParams(**PARAMS),
                      mesh=make_mesh(4, devices=["cpu"] * 4))
    mesh_got = [_res(q) for q in tclf.classify_file(db["reads"])]
    mesh_ref, jclf = _jax_run(db, monkeypatch, KNOBS["aligned"],
                              mesh=jmake_mesh(4))
    assert tclf.mesh.shape == {"dp": 2, "db": 2} and not tclf._mesh_stream
    assert tclf._cells[0][0][0].shape[1] == 128   # wide shards
    assert jclf.db_quad_sh.shape[-1] == 4         # JAX: entry-row shards
    assert mesh_got == mesh_ref == got


@pytest.mark.parametrize("var", list(RETIRED))
def test_retired_probe_variables_change_nothing(db, monkeypatch, port_run,
                                                var):
    monkeypatch.setenv(var, RETIRED[var])
    clf = Classifier(db["db"], ClassifyParams(**PARAMS), device="cpu")
    got = [_res(q) for q in clf.classify_file(db["reads"])]
    ref, layout = port_run
    assert _layout_shapes(clf) == layout
    assert got == ref
