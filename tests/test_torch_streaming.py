"""DB-range streaming in the torch package vs the JAX package's, on the
CPU, tolerance 0: shard_quad_index byte for byte; the three streaming
device steps (query tensors, the accumulators after every range pass,
the packed paths and resident tensors); a streamed Classifier (a budget
forcing >= 4 ranges, two batches a group) equal per read, tax_cnt
included, to the port's resident run and to the JAX package's streamed
run, single-end and paired; a read beyond the row cap probed through
the ranges; the CLI's --hbm-gb."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu import cli as jcli
from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.index.format import load_index
from metabuli_work_tpu.models import flagship as jfl
from metabuli_work_tpu.ops.encode_jax import right_align
from metabuli_work_tpu.parallel.sharding import shard_quad_index as jshard
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.models import flagship as tfl

from test_torch_match import packed_state
from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(min_score=0.15, min_sp_score=0.5, batch_size=8)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "syncmer"])
def dbs(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream"))
    db = build_db(jbuild, root, "db", syncmer=request.param)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 22, seed=12)
    rnd = np.random.default_rng(13).choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=(2, reads.shape[1]))
    write_reads(os.path.join(root, "reads.fna"), np.concatenate([reads, rnd]))
    m1, m2, _ = simulate_pairs(genomes, 22, seed=14)
    write_reads(os.path.join(root, "r1.fna"), np.concatenate([m1, rnd]))
    write_reads(os.path.join(root, "r2.fna"),
                np.concatenate([m2, rnd[::-1]])[:, :141])
    index = load_index(db)
    # a budget that cuts the 16 B-a-metamer index into >= 4 ranges
    budget_gb = (16 * index.size / 3.5) * 2 / (1 << 30)
    return dict(root=root, db=db, index=index, genomes=genomes,
                syncmer=request.param, budget_gb=budget_gb)


def _res(q):
    r = q.result
    return (q.name, bool(r.is_classified), int(r.classification),
            np.float32(r.score).view(np.int32).item(), dict(r.tax_cnt),
            q.length1, q.length2)


# ---------------------------------------------------------------- packing
@pytest.mark.parametrize("n_shards", [2, 4, 5])
def test_shard_quad_index_matches_jax(dbs, n_shards):
    _, _, _, _, _, db_ef, sp_euk = packed_state(dbs["index"])
    quad = packing.pack_db_quad(dbs["index"].values, db_ef, sp_euk)
    ref = jshard(quad, n_shards, wide=True)
    got = packing.shard_quad_index(quad, n_shards)
    for a, b in zip(ref[:2], got[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (ref[2], ref[3]) == (got[2], got[3])
    np.testing.assert_array_equal(ref[4], got[4])
    assert got[0].shape[0] == n_shards and got[4].sum() == len(quad)
    # ranges are cut at AA-part boundaries
    aa = dbs["index"].values >> np.uint64(24)
    for b in np.cumsum(got[4])[:-1]:
        assert aa[b] != aa[b - 1]
    # the narrow layout (METABULI_WIDE_PROBE=0): entry-row shards
    ref = jshard(quad, n_shards, wide=False)
    got = packing.shard_quad_index(quad, n_shards, wide=False)
    for a, b in zip(ref[:2], got[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (ref[2], ref[3]) == (got[2], got[3])
    assert got[0].shape[2] == 4


def test_padded_entries_never_match(dbs):
    """Shards are padded to one row count with all-ones entries (-1 as
    int32): a probe of a range must select nothing there, and db_m
    defaults to the padded row space."""
    _, _, _, _, _, db_ef, sp_euk = packed_state(dbs["index"])
    quad = packing.pack_db_quad(dbs["index"].values, db_ef, sp_euk)
    quads, hts, log2, chain, counts = packing.shard_quad_index(quad, 5)
    assert quads.shape[1] * 32 >= counts.max() + 256
    from metabuli_work_tpu_torch.ops import match_torch

    st = packing.stream_state_from_numpy(
        quads, hts, log2, chain, np.zeros(1, np.int32),
        np.zeros((1, 1), np.int32), np.zeros(1, np.int32),
        np.zeros(1, np.int32), "cpu")
    r = int(np.argmin(counts))                   # the most padded range
    q_r = st["stream_quads"][r]
    assert q_r.dtype == torch.int32 and int(q_r[-1, -1]) == -1
    # query every metamer of the range, and an all-ones AA part
    lo = int(np.cumsum(counts)[r] - counts[r])
    v = dbs["index"].values[lo:lo + counts[r]]
    qk = np.concatenate([v, [np.uint64((1 << 64) - 1)]]).view(np.int64)
    out = match_torch.match_kmers_quad(
        torch.from_numpy(qk), torch.zeros(len(qk), dtype=torch.int32),
        torch.ones(len(qk), dtype=torch.bool), q_r, cap=4, kmer_format=2,
        hash_table=st["stream_hts"][r], hash_log2_rows=log2,
        hash_chain=chain)
    sel = out["sel"].numpy()
    assert sel[:, :-1].any(0).all() and not sel[:, -1].any()


# ------------------------------------------------------------ device steps
def _step_inputs(d, paired):
    if paired:
        m1, m2, _ = simulate_pairs(d["genomes"], 6, seed=21)
        m2 = np.ascontiguousarray(m2[:, :144])
        l1 = np.full(6, 150, np.int32)
        l2 = np.full(6, 140, np.int32)
        l1[2], l2[4] = 133, 121
        m1 = np.concatenate([m1, np.full((6, 18), ord("N"), np.uint8)], 1)
        return m1, l1, m2, l2
    reads, _ = simulate_reads(d["genomes"], 6, seed=20)
    lens = np.full(6, 150, np.int32)
    lens[3] = 131
    reads = np.concatenate([reads, np.full((6, 18), ord("N"), np.uint8)], 1)
    return reads, lens, None, None


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_stream_steps_match_jax(dbs, paired):
    d = dbs
    _, _, _, _, _, db_ef, sp_euk = packed_state(d["index"])
    quad = packing.pack_db_quad(d["index"].values, db_ef, sp_euk)
    quads, hts, log2, chain, _ = packing.shard_quad_index(quad, 4)
    r1, l1, r2, l2 = _step_inputs(d, paired)
    B, cap = len(r1), 8
    wf = 184 if d["syncmer"] else 256
    ex = dict(syncmer=d["syncmer"], smer_len=5, kmer_format=2, win_frac=wf)
    j, t = jnp.asarray, torch.from_numpy
    ra1 = right_align(r1, l1)
    ra2 = right_align(r2, l2) if paired else None
    jr2, jl2 = (j(r2), j(l2)) if paired else \
        (jnp.zeros((B, 96), jnp.uint8), jnp.zeros(B, jnp.int32))
    jq = jfl.extract_queries_step(j(r1), j(l1), jr2, jl2, j(ra1),
                                  j(ra2) if paired else None, paired=paired,
                                  **ex)
    tq = tfl.extract_queries_step(
        t(r1), t(l1), t(r2) if paired else None, t(l2) if paired else None,
        t(ra1), t(ra2) if paired else None, **ex)
    jqk, jqp, jqf, jqs, jqv, jwo = jq
    qk, qp, qf, qs, qv, shapes, win_over = tq
    np.testing.assert_array_equal(np.asarray(jqk).astype(np.uint64),
                                  qk.numpy().view(np.uint64))
    for a, b in ((jqp, qp), (jqf, qf), (jqs, qs), (jqv, qv), (jwo, win_over)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert len(shapes) == 1 + paired

    N = qk.shape[0]
    jacc = (jnp.zeros((cap, N), bool),) \
        + tuple(jnp.zeros((cap, N), jnp.int32) for _ in range(5)) \
        + (jnp.zeros((), jnp.int32),)
    acc = tfl.new_accumulators(cap, N, "cpu")
    ptrs = {k: v.data_ptr() for k, v in acc.items()}
    st = packing.stream_state_from_numpy(
        quads, hts, log2, chain, np.zeros(1, np.int32),
        np.zeros((1, 1), np.int32), np.zeros(1, np.int32),
        np.zeros(1, np.int32), "cpu")
    order = ("sel", "hamming", "rh", "taxid", "species", "dna_enc",
             "overflow")
    pk = dict(cap=cap, kmer_format=2, hash_log2_rows=log2, hash_chain=chain)
    grew = []
    for r in range(4):
        jacc = jfl.probe_range_step(jqk, jqf, jqv, j(quads[r]), j(hts[r]),
                                    *jacc, **pk)
        tfl.probe_range_step(qk, qf, qv, st["stream_quads"][r],
                             st["stream_hts"][r], acc, **pk)
        for a, k in zip(jacc, order):
            np.testing.assert_array_equal(np.asarray(a), acc[k].numpy(), k)
        grew.append(int(acc["sel"].sum()))
    assert grew[0] > 0 and grew[-1] > grew[0]     # ranges add candidates
    # the accumulators were updated in place
    assert ptrs == {k: v.data_ptr() for k, v in acc.items()}

    lm2 = r2.shape[1] if paired else None
    compact5 = tfl.compact5_fits(B, r1.shape[1], lm2)
    fk = dict(min_cons=2, min_cons_euk=9, cap=cap, path_width=64,
              path_block=16, compact5=compact5, **ex)
    jh, jres = jfl.finish_stream_step(
        *jacc, jqp, jqs, jwo, shapes=tuple(tuple(s) for s in shapes),
        dp_pallas=True, pallas_interpret=True, **fk)
    th, tres = tfl.finish_stream_step(acc, qp, qs, shapes, win_over, **fk)
    jh = np.asarray(jh)
    np.testing.assert_array_equal(jh, th.numpy())
    assert jh[1, 0] > 0
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -------------------------------------------------------------- classifier
@pytest.mark.parametrize("seq_mode", [1, 2], ids=["single", "paired"])
def test_streamed_classifier_matches_resident_and_jax(dbs, seq_mode,
                                                      monkeypatch):
    d, root = dbs, dbs["root"]
    paths = (os.path.join(root, "reads.fna"),) if seq_mode == 1 else \
        (os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna"))
    monkeypatch.setenv("METABULI_STREAM_GROUP", "2")
    kw = dict(seq_mode=seq_mode, **PARAMS)
    resident = Classifier(d["db"], ClassifyParams(**kw), device="cpu")
    assert not resident._streaming
    ref = [_res(q) for q in resident.classify_file(*paths)]
    assert sum(r[1] for r in ref) >= 18

    clf = Classifier(d["db"], ClassifyParams(hbm_budget_gb=d["budget_gb"],
                                             **kw), device="cpu")
    assert clf._streaming and clf._n_ranges >= 4
    assert not hasattr(clf, "db_quad") and not clf._device_assign
    assert clf._stream_group_size() == 2
    groups = []
    plain = clf._dispatch_group_stream

    def record(group, **k):
        groups.append(len(group))
        return plain(group, **k)

    clf._dispatch_group_stream = record
    got = [_res(q) for q in clf.classify_file(*paths)]
    assert got == ref
    # first batch solo, then a whole group; retries re-run single-batch
    assert groups[0] == 1 and 2 in groups
    assert clf._ranges.sweeps == len(groups)
    assert clf._match_state is None

    jclf = JClassifier(d["db"], JParams(hbm_budget_gb=d["budget_gb"], **kw))
    assert jclf._streaming and jclf._n_ranges == clf._n_ranges
    assert [_res(q) for q in jclf.classify_file(*paths)] == got


def test_stream_group_size_from_budget(dbs, monkeypatch):
    monkeypatch.delenv("METABULI_STREAM_GROUP", raising=False)
    d = dbs
    clf = Classifier(d["db"], ClassifyParams(
        seq_mode=1, hbm_budget_gb=d["budget_gb"], **PARAMS), device="cpu")
    # 8 reads a batch: far more than 16 batches fit the 256 MiB floor
    assert clf._stream_group_size() == 16
    clf.params.batch_size = 1 << 20
    assert clf._stream_group_size() == 1
    monkeypatch.setenv("METABULI_HBM_GB", str(d["budget_gb"]))
    env = Classifier(d["db"], ClassifyParams(seq_mode=1, **PARAMS),
                     device="cpu")
    assert env._streaming and env._n_ranges == clf._n_ranges


def test_streamed_read_beyond_row_cap(dbs):
    """A read beyond the (lowered) row cap is redone from chunks through
    _stream_probe_matches under streaming, through the host-match step
    when resident; both equal the JAX package's streamed run."""
    d = dbs
    reads, _ = simulate_long(d["genomes"], [700, 1900, 500], seed=31)
    path = os.path.join(d["root"], "long.fna")
    write_reads(path, reads)
    kw = dict(seq_mode=3, min_score=0.008, min_sp_score=0.0, batch_size=4)

    def run(cls, params_cls, **extra):
        clf = cls(d["db"], params_cls(**kw, **extra.pop("p", {})), **extra)
        clf.LONG_ROW_CAP, clf._LONG_CHUNK = 1500, 768
        return clf, [_res(q)[:4] for q in clf.classify_file(path)]

    res_clf, ref = run(Classifier, ClassifyParams, device="cpu")
    assert ref[1][1] and res_clf._match_state is not None
    clf, got = run(Classifier, ClassifyParams, device="cpu",
                   p=dict(hbm_budget_gb=d["budget_gb"]))
    assert clf._streaming and got == ref
    assert clf._match_state is None      # no 20 B-a-metamer upload
    assert clf.timer.counts["long_probe"] == 1
    _, jgot = run(JClassifier, JParams, p=dict(hbm_budget_gb=d["budget_gb"]))
    assert jgot == got


def test_streaming_needs_the_path_dp_flow(dbs):
    with pytest.raises(ValueError, match="min_cons_cnt >= 2"):
        Classifier(dbs["db"], ClassifyParams(
            seq_mode=1, min_cons_cnt=1, hbm_budget_gb=dbs["budget_gb"],
            **PARAMS), device="cpu")


def test_cli_hbm_gb_outputs_byte_identical(dbs, capsys):
    d, root = dbs, dbs["root"]
    args = [os.path.join(root, "reads.fna"), d["db"], None, "job",
            "--seq-mode", "1", "--min-score", "0.15", "--batch-size", "8"]
    hbm = ["--hbm-gb", repr(d["budget_gb"])]
    outs = {k: os.path.join(root, k) for k in ("res", "str", "jstr")}
    assert tcli.main(["classify"] + [a or outs["res"] for a in args]
                     + ["--device", "cpu"]) == 0
    assert tcli.main(["classify"] + [a or outs["str"] for a in args]
                     + ["--device", "cpu"] + hbm) == 0
    assert jcli.main(["classify"] + [a or outs["jstr"] for a in args]
                     + ["--devices", "1"] + hbm) == 0
    for name in ("job_classifications.tsv", "job_report.tsv"):
        with open(os.path.join(outs["res"], name), "rb") as f:
            ref = f.read()
        assert ref
        for k in ("str", "jstr"):
            with open(os.path.join(outs[k], name), "rb") as f:
                assert f.read() == ref, (k, name)
