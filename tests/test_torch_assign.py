"""The device-assign flow of the torch package vs the JAX package's, on
the CPU, tolerance 0: device_assign on seeded paths (records, best_sp
and over_k equal as integers, scores as f32 bit patterns) and against
the host scoring flow; fused_step_full single-end and paired; the
Classifier with the flow pinned equal to the host-scoring flow and to
the JAX package, tax_cnt and top_species included; the combine_k rung of
the retry ladder.  The JAX side runs as its own tests run it on the CPU:
the XLA path DP in the pipeline, the Pallas kernel in interpret mode in
the step."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.models import flagship as jfl
from metabuli_work_tpu.ops import assign_jax
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.models import flagship as tfl
from metabuli_work_tpu_torch.ops import assign_torch

from test_assign_device import _decode_records, _host_flow, _random_paths
from test_torch_flagship import _kw, setup  # noqa: F401  (fixture)
from tests_helpers_tax import make_flat_tax
from torch_port_db import (build_db, simulate_pairs, simulate_reads,
                           write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


# ------------------------------------------------------------ device_assign
def _both_assign(tax, p, qlens, min_score, tie_ratio, combine_k):
    """(JAX, torch) device_assign results as numpy on the same packed
    columns (paths in arbitrary order, junk past n_paths)."""
    n = len(p["qid"])
    P = 1 << int(np.ceil(np.log2(max(n, 8))))
    g = (p["qid"] - 1) * 6 + p["frame"]
    cols = np.zeros((5, P), dtype=np.int32)
    cols[0, :n] = (g << 16) | p["start"]
    cols[1, :n] = (p["end"] << 16) | p["rh_start"]
    cols[2, :n] = (p["rh_end"] << 16) | p["hamming"]
    cols[3, :n] = p["species"]
    cols[4, :n] = p["score"].view(np.int32)
    cols[:, n:] = cols[:, :1]          # unfilled slots repeat row 0
    depth, lift = tax.lca_lift_tables()
    tables = (qlens.astype(np.int32), tax.euler_first.astype(np.int32),
              tax.euler.astype(np.int32), np.asarray(depth, np.int32),
              np.asarray(lift, np.int32))
    kw = dict(min_score=min_score, tie_ratio=tie_ratio, combine_k=combine_k)
    ref = jax.jit(assign_jax.device_assign, static_argnames=tuple(kw))(
        jnp.asarray(cols), jnp.int32(n), *map(jnp.asarray, tables), **kw)
    got = assign_torch.device_assign(
        torch.from_numpy(cols), torch.tensor(n, dtype=torch.int32),
        *map(torch.from_numpy, tables), **kw)
    return ([np.asarray(a) for a in ref], [a.numpy() for a in got])


@pytest.mark.parametrize("seed,n_species,min_score,overlap", [
    (0, 2, 0.15, True),    # heavy ties + trims
    (1, 8, 0.15, True),
    (2, 8, 0.0, True),     # min_score 0 keeps zero-score runs
    (3, 4, 0.15, False),   # disjoint runs (pure-sum fast path)
])
@pytest.mark.parametrize("combine_k", [8, 16])
def test_device_assign_matches_jax_and_host(seed, n_species, min_score,
                                            overlap, combine_k):
    rng = np.random.default_rng(seed)
    B = 48
    tax = make_flat_tax(16)
    p = _random_paths(rng, B, 600, n_species, overlap=overlap)
    # hamming above 2^15 makes the (ham << 16) key negative as int32
    p["hamming"][::7] += 1 << 15
    qlens = np.zeros(B + 1, dtype=np.int64)
    qlens[1:] = 150
    ref, got = _both_assign(tax, p, qlens, min_score, 0.95, combine_k)
    for a, b, name in zip(ref, got, ("records", "best_sp", "over_k")):
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, name)
    rec, best_sp, over_k = got
    assert rec.shape == (6, B + 1) and rec[0].sum() > B // 2
    if over_k:
        return          # the host doubles combine_k and re-runs
    # and the host scoring flow, through the pipeline's record decode
    h_res, h_def = _host_flow(tax, p, qlens, B, min_score, 0.95)
    d_res, d_def = _decode_records(rec, qlens, B, min_score)
    bits = lambda d: [(r, q, np.float32(s).view(np.int32).item(), t)
                      for r, q, s, t in d]
    assert bits(h_def) == bits(d_def)
    for h, d in zip(h_res, d_res):
        assert (h.is_classified, h.classification, h.top_species,
                np.float32(h.score).view(np.int32)) == \
            (d.is_classified, d.classification, d.top_species,
             np.float32(d.score).view(np.int32))
    exp = np.zeros(B + 1, dtype=np.int32)
    for r, _, _, t in h_def:
        exp[r] = t
    np.testing.assert_array_equal(best_sp, exp)


def test_device_assign_combine_k_overflow():
    rng = np.random.default_rng(5)
    tax = make_flat_tax(4)
    B = 4
    # 12 paths in ONE (read, species) run with combine_k=8 -> overflow
    p = _random_paths(rng, 1, 12, 1)
    p["qid"][:] = 1
    p["species"][:] = 3
    qlens = np.zeros(B + 1, dtype=np.int64)
    qlens[1:] = 150
    for k, over in ((8, True), (16, False)):
        ref, got = _both_assign(tax, p, qlens, 0.15, 0.95, k)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
        assert (int(got[2]) > 0) == over


def test_device_assign_rejects_the_7_column_layout():
    z = torch.zeros((7, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="5-column"):
        assign_torch.device_assign(z, torch.tensor(0), z[0, :3], z[0], z[0],
                                   z[0], z[:1], 0.0, 0.95, 8)


# ---------------------------------------------------------- fused_step_full
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_fused_step_full_matches_jax(setup, paired):
    s = setup
    j, t = jnp.asarray, torch.from_numpy
    if paired:
        p = s["pair"]
        r1, l1, ra1, r2, l2, ra2 = (p[k] for k in
                                    ("r1", "l1", "ra1", "r2", "l2", "ra2"))
        jm2 = (j(r2), j(l2))
        lmax2 = r2.shape[1]
    else:
        r1, l1, ra1 = s["reads"], s["lens"], s["ra"]
        r2 = l2 = ra2 = lmax2 = None
        B = len(r1)
        jm2 = (jnp.zeros((B, 96), jnp.uint8), jnp.zeros(B, jnp.int32))
    wf = 184 if s["syncmer"] else 256
    dna_shift = 9 if s["syncmer"] else 3
    lmax = r1.shape[1] + (lmax2 + 3 if paired else 0)
    part_w = tfl.part_widths(r1.shape[1], s["syncmer"], 2, 5, wf, lmax2=lmax2)
    tax = s["index"].taxonomy
    depth, lift = tax.lca_lift_tables()
    # combine_k=2 leaves some runs over (over_k > 0 rides in the header)
    akw = dict(min_score=0.15, tie_ratio=0.95, combine_k=2,
               dna_shift=dna_shift, n_quot=lmax // dna_shift + 2,
               part_w=part_w)
    ref = jfl.fused_step_full(
        j(r1), j(l1), *jm2, j(s["rows"]),
        j(tax.euler_first.astype(np.int32)), j(tax.euler.astype(np.int32)),
        j(depth), j(lift), ra1=j(ra1), ra2=j(ra2) if paired else None,
        paired=paired, hash_table=j(s["ht"]), dp_pallas=True,
        pallas_interpret=True, **akw, **_kw(s, 8, 256))
    st = s["st"]
    got = tfl.fused_step_full(
        t(r1), t(l1), st["db_quad"], st["ef_node"], st["euler"],
        st["lca_depth"], st["lca_lift"],
        reads2=t(r2) if paired else None, lens2=t(l2) if paired else None,
        ra1=t(ra1), ra2=t(ra2) if paired else None,
        hash_table=st["hash_table"], **akw, **_kw(s, 8, 256))
    for a, b, name in zip(ref, got, ("records", "pairs")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
    rec, pairs = (a.numpy() for a in got)
    assert rec.shape == (6, len(r1) + 1) and rec[0, 1:].sum() >= 8
    assert rec[1, 0] > 0 and pairs[0, 0] > 0      # paths and pairs came out


# ---------------------------------------------------------------- pipeline
PARAMS = dict(min_score=0.15, min_sp_score=0.5, batch_size=8)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "syncmer"])
def dbs(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("assign"))
    db = build_db(jbuild, root, "db", syncmer=request.param)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 22, seed=41, err=0.02)
    rnd = np.random.default_rng(42).choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=(2, reads.shape[1]))
    write_reads(os.path.join(root, "reads.fna"), np.concatenate([reads, rnd]))
    m1, m2, _ = simulate_pairs(genomes, 22, seed=43)
    write_reads(os.path.join(root, "r1.fna"), np.concatenate([m1, rnd]))
    write_reads(os.path.join(root, "r2.fna"),
                np.concatenate([m2, rnd[::-1]])[:, :141])
    return root, db


def _res(q):
    r = q.result
    return (q.name, bool(r.is_classified), int(r.classification),
            np.float32(r.score).view(np.int32).item(), dict(r.tax_cnt),
            int(r.top_species))


def _paths(root, seq_mode):
    if seq_mode == 1:
        return (os.path.join(root, "reads.fna"),)
    return os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna")


@pytest.mark.parametrize("seq_mode", [1, 2], ids=["single", "paired"])
def test_pipeline_device_assign_matches_host_flow_and_jax(dbs, seq_mode,
                                                          monkeypatch):
    root, db = dbs
    paths = _paths(root, seq_mode)
    kw = dict(seq_mode=seq_mode, **PARAMS)
    monkeypatch.delenv("METABULI_DEVICE_ASSIGN", raising=False)
    host = Classifier(db, ClassifyParams(**kw), device="cpu")
    assert not host._device_assign
    ref = [_res(q) for q in host.classify_file(*paths)]
    assert sum(r[1] for r in ref) >= 18

    monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    clf = Classifier(db, ClassifyParams(**kw), device="cpu")
    assert clf._device_assign
    flows = []
    plain = clf._dispatch_batch_full
    clf._dispatch_batch_full = lambda *a, **k: (flows.append("full"),
                                                plain(*a, **k))[1]
    clf._dispatch_batch_dp = lambda *a, **k: pytest.fail(
        "a batch left the device-assign flow")
    got = [_res(q) for q in clf.classify_file(*paths)]
    assert got == ref
    assert len(flows) >= 3 and clf.timer.counts["score"] == 3
    # a sticky knob doubles from the value the dispatch ran with, not
    # once per batch already in the pipeline
    assert clf._combine_k <= 32 and clf._path_block <= 32
    jclf = JClassifier(db, JParams(**kw))
    assert jclf._device_assign
    # the JAX ladder doubles combine_k once per pipelined batch that
    # overflowed, and its combine loop unrolls combine_k slots: start it
    # where no run overflows, to keep its compile short
    jclf._combine_k = clf._combine_k
    assert [_res(q) for q in jclf.classify_file(*paths)] == got


def test_pipeline_climbs_the_combine_k_rung(dbs, monkeypatch):
    """From combine_k = 1 every run of two paths overflows: the fifth
    rung of the ladder doubles combine_k (sticky) and re-runs."""
    root, db = dbs
    paths = _paths(root, 1)
    kw = dict(seq_mode=1, **PARAMS)
    monkeypatch.delenv("METABULI_DEVICE_ASSIGN", raising=False)
    ref = [_res(q) for q in Classifier(db, ClassifyParams(**kw),
                                       device="cpu").classify_file(*paths)]
    monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    clf = Classifier(db, ClassifyParams(**kw), device="cpu")
    clf._combine_k = 1
    got = [_res(q) for q in clf.classify_file(*paths)]
    assert got == ref
    assert clf.full_retries.get("combine_k", 0) >= 1 and clf._combine_k >= 2
    assert clf.timer.counts["retry"] >= clf.full_retries["combine_k"]


def test_long_rows_leave_the_device_assign_flow(dbs, monkeypatch):
    """A batch whose rows need the 7-column path layout takes the
    host-scoring flow (device_assign reads 5 columns only)."""
    root, db = dbs
    monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    clf = Classifier(db, ClassifyParams(seq_mode=3, **PARAMS), device="cpu")
    a = np.full((2, 16512), ord("A"), np.uint8)
    assert not clf._fits_compact5(a, [16500, 100], None, None)
    assert clf._fits_compact5(a, [150, 100], None, None)
    assert not clf._fits_compact5(a[:, :9000], [9000, 9], a[:, :9000],
                                  [8000, 9])
