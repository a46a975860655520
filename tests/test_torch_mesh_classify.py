"""Multi-device classify in the torch package: a mesh of 8 virtual CPU
cells (dp 2 x db 4) against the JAX package's 8-device CPU mesh and the
port's single-device run, on the CPU, tolerance 0 (per-read
classification, f32 score bits, tax_cnt, mate lengths): single-end (23
reads at batch 8: a remainder batch of 7, padded to the dp rows),
paired, mesh x streaming, a read beyond the row cap, the retry ladder
and the pair-prefix re-run under the mesh, the per-device sharing of
the index, and the CLI's --devices."""

import os

import numpy as np
import pytest
import torch

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.parallel.sharding import make_mesh as jmake_mesh
from metabuli_work_tpu_torch import cli as tcli
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index.format import load_index
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(min_score=0.15, min_sp_score=0.5, batch_size=8)


def _mesh():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def db_of(tmp_path_factory):
    """db_of(syncmer): a plain or syncmer DB with its reads, built at
    first use (each test takes the DBs it needs, to keep the file short)."""
    made = {}

    def get(syncmer):
        if syncmer not in made:
            root = str(tmp_path_factory.mktemp("mesh"))
            db = build_db(jbuild, root, "db", syncmer=syncmer)
            genomes, _ = write_inputs(root)
            reads, _ = simulate_reads(genomes, 21, seed=52)
            rnd = np.random.default_rng(53).choice(
                np.frombuffer(b"ACGT", np.uint8), size=(2, reads.shape[1]))
            write_reads(os.path.join(root, "reads.fna"),
                        np.concatenate([reads, rnd]))
            m1, m2, _ = simulate_pairs(genomes, 10, seed=54)
            write_reads(os.path.join(root, "r1.fna"), m1)
            write_reads(os.path.join(root, "r2.fna"), m2[:, :141])
            made[syncmer] = dict(root=root, db=db, genomes=genomes,
                                 syncmer=syncmer)
        return made[syncmer]

    return get


def _res(q):
    r = q.result
    return (q.name, bool(r.is_classified), int(r.classification),
            np.float32(r.score).view(np.int32).item(), dict(r.tax_cnt),
            q.length1, q.length2)


def _files(d, seq_mode):
    root = d["root"]
    return (os.path.join(root, "reads.fna"),) if seq_mode == 1 else \
        (os.path.join(root, "r1.fna"), os.path.join(root, "r2.fna"))


def _stream_budget_gb(d):
    """A budget under which the index (16 B a metamer) takes three ranges
    of 4 shards: half of it a db column holds a twelfth of the index."""
    return 16 * load_index(d["db"]).size / (1 << 30) / 6


def _single(d, seq_mode, **kw):
    clf = Classifier(d["db"], ClassifyParams(seq_mode=seq_mode, **PARAMS,
                                             **kw), device="cpu")
    return [_res(q) for q in clf.classify_file(*_files(d, seq_mode))]


@pytest.mark.parametrize("syncmer,seq_mode,jax_too", [
    (False, 1, True), (True, 1, True), (False, 2, True), (True, 2, False)],
    ids=["plain-single", "syncmer-single", "plain-paired", "syncmer-paired"])
def test_mesh_equals_jax_mesh_and_single_device(db_of, syncmer, seq_mode,
                                               jax_too):
    """jax_too: the JAX mesh run too (its paired compile is the slowest
    part of this file, so the syncmer pairs are held against the port's
    single-device run, which test_torch_pipeline holds against JAX)."""
    d = db_of(syncmer)
    ref = _single(d, seq_mode)
    assert sum(r[1] for r in ref) >= (18 if seq_mode == 1 else 8)
    clf = Classifier(d["db"], ClassifyParams(seq_mode=seq_mode, **PARAMS),
                     mesh=_mesh())
    assert clf.mesh.shape == {"dp": 2, "db": 4} and not clf._mesh_stream
    assert clf.device == torch.device("cpu") and not clf._device_assign
    dispatches = []
    plain = clf._dispatch_batch_dp_sharded
    clf._dispatch_batch_dp_sharded = \
        lambda *a, **k: dispatches.append(a[0]) or plain(*a, **k)
    got = [_res(q) for q in clf.classify_file(*_files(d, seq_mode))]
    assert got == ref
    assert len(dispatches) >= (3 if seq_mode == 1 else 2)
    assert clf.mesh_merged_bytes > 0
    if not jax_too:
        return
    jclf = JClassifier(d["db"], JParams(seq_mode=seq_mode, **PARAMS),
                       mesh=jmake_mesh(8))
    assert jclf.mesh is not None
    assert [_res(q) for q in jclf.classify_file(*_files(d, seq_mode))] == got


def test_virtual_mesh_shares_the_index_per_device(db_of):
    clf = Classifier(db_of(False)["db"], ClassifyParams(seq_mode=1, **PARAMS),
                     mesh=_mesh())
    cells = clf._cells
    for c in range(4):
        assert cells[1][c] is cells[0][c]            # one upload a device
    assert len({id(cells[0][c][0]) for c in range(4)}) == 4
    assert list(clf._tables) == [torch.device("cpu")]


@pytest.mark.parametrize("syncmer,seq_mode", [(True, 1), (False, 2)],
                         ids=["syncmer-single", "plain-paired"])
def test_mesh_stream_equals_resident(db_of, syncmer, seq_mode):
    d = db_of(syncmer)
    ref = _single(d, seq_mode)
    clf = Classifier(d["db"], ClassifyParams(
        seq_mode=seq_mode, hbm_budget_gb=_stream_budget_gb(d), **PARAMS),
        mesh=_mesh())
    assert clf._mesh_stream and clf._mesh_n_ranges >= 2
    assert clf._n_ranges == 4 * clf._mesh_n_ranges and clf._cells is None
    assert not clf._streaming
    setup_uploads = clf.timer.counts["upload"]     # the set-up's span
    got = [_res(q) for q in clf.classify_file(*_files(d, seq_mode))]
    assert got == ref
    rs = clf._mesh_ranges[torch.device("cpu")]
    assert rs.sweeps == clf.timer.counts["dispatch"] >= 2
    # one span a shard upload: each of a range's 4 shards, one a db
    # column, goes through the one CPU device's _RangeStream
    assert clf.timer.counts["upload"] - setup_uploads == \
        rs.sweeps * clf._n_ranges


def test_mesh_read_beyond_row_cap(db_of):
    """A read beyond the (lowered) row cap is redone from chunks that
    probe the mesh's host shards one at a time (resident mesh and mesh x
    streaming), equal to the single-device run (whose chunks take the
    host-match step)."""
    d = db_of(False)
    reads, _ = simulate_long(d["genomes"], [700, 1900, 500], seed=61)
    path = os.path.join(d["root"], "long.fna")
    write_reads(path, reads)
    kw = dict(seq_mode=3, min_score=0.008, min_sp_score=0.0, batch_size=4)

    def run(clf):
        clf.LONG_ROW_CAP, clf._LONG_CHUNK = 1500, 768
        return [_res(q)[:4] for q in clf.classify_file(path)]

    ref = run(Classifier(d["db"], ClassifyParams(**kw), device="cpu"))
    assert ref[1][1]
    for stream in (False, True):
        budget = dict(hbm_budget_gb=_stream_budget_gb(d)) if stream else {}
        clf = Classifier(d["db"], ClassifyParams(**kw, **budget),
                         mesh=_mesh())
        assert clf._mesh_stream == stream
        assert run(clf) == ref
        assert clf.timer.counts["long_probe"] == 1
        assert clf._match_state is None and clf._ranges.sweeps >= 1


@pytest.mark.parametrize("syncmer,knobs", [
    (True, dict(_win_frac=100)),
    (False, dict(_path_block=2, _path_width=16))],
    ids=["syncmer-window", "plain-block-width"])
def test_mesh_retries_and_pair_rerun_equal_single_device(db_of, syncmer,
                                                        knobs):
    """Knobs forced low on the mesh: the overflow classes the stats
    header sums over the rows (window compaction on the syncmer DB,
    blocked emission and path width on the plain one) trigger the
    retries, and a pair prefix too narrow for a row re-runs the
    redundancy step wider."""
    d = db_of(syncmer)
    ref = _single(d, 1)
    clf = Classifier(d["db"], ClassifyParams(seq_mode=1, **PARAMS),
                     mesh=_mesh())
    clf._pair_width = 2
    for k, v in knobs.items():
        setattr(clf, k, v)
    got = [_res(q) for q in clf.classify_file(*_files(d, 1))]
    assert got == ref
    assert clf.timer.counts["retry"] >= 3 and clf._pair_width > 2
    for k, v in knobs.items():
        assert getattr(clf, k) > v


def test_mesh_needs_the_path_dp_flow(db_of):
    with pytest.raises(ValueError, match="min_cons_cnt >= 2"):
        Classifier(db_of(False)["db"], ClassifyParams(
            seq_mode=1, min_cons_cnt=1, **PARAMS), mesh=_mesh())


def test_cli_devices(db_of, capsys):
    """--devices on the CPU: the CLI never builds a virtual mesh, so any
    count classifies on one device, byte for byte as --devices 1."""
    d = db_of(False)
    root = d["root"]
    args = [os.path.join(root, "reads.fna"), d["db"], None, "job",
            "--seq-mode", "1", "--min-score", "0.15", "--batch-size", "8",
            "--device", "cpu"]
    outs = {}
    for n in ("1", "4", "0"):
        outs[n] = os.path.join(root, f"cli{n}")
        assert tcli.main(["classify"] + [a or outs[n] for a in args]
                         + ["--devices", n]) == 0
    assert "Multi-chip mesh" not in capsys.readouterr().out
    for name in ("job_classifications.tsv", "job_report.tsv"):
        with open(os.path.join(outs["1"], name), "rb") as f:
            ref = f.read()
        for n in ("4", "0"):
            with open(os.path.join(outs[n], name), "rb") as f:
                assert f.read() == ref, (n, name)
