"""The torch package's in-memory API vs the JAX package's, on the CPU,
tolerance 0: Classifier.classify_batch and classify_batch_arrays
(single-end, paired, a syncmer DB with window compaction and a forced
overflow retry, streamed, on a 2 x 2 mesh of CPU cells, a read beyond
the row cap), two calls on one classifier against one drive_batches,
the standalone classify_step on synthetic_db / synthetic_reads (and
the device it runs on), dp_torch.pack_paths, and init_distributed's
coordinator_address, as the JAX package names it.  Per-read tuples
hold the classification, the f32 score bits, tax_cnt and both mate
lengths."""

import os
import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.models import flagship as jfl
from metabuli_work_tpu.ops import dp_jax
from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                       ClassifyParams)
from metabuli_work_tpu_torch.index.format import load_index
from metabuli_work_tpu_torch.models import flagship as tfl
from metabuli_work_tpu_torch.ops import dp_torch
from metabuli_work_tpu_torch.parallel import distributed
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

from torch_dp_cases import db_with_read_kmers, random_case
from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=16)
PAIRED = {**PARAMS, "seq_mode": 2}
LONG = dict(seq_mode=3, min_score=0.008, min_sp_score=0.0, batch_size=16)
OVER_CAP = 70_000                # a read beyond the 65,536-base row cap


def _res(q):
    r = q.result
    return (q.name, bool(r.is_classified), int(r.classification),
            np.float32(r.score).view(np.int32).item(), dict(r.tax_cnt),
            q.length1, q.length2)


def _strs(rows):
    return [r.tobytes().decode() for r in rows]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A plain and a syncmer DB (the JAX package's build; both packages load
    them) and reads as strings: single-end (two of random sequence),
    pairs with mate 2 in another length bucket, and low-complexity reads
    that keep every syncmer window."""
    root = str(tmp_path_factory.mktemp("api"))
    dbs = {s: build_db(jbuild, os.path.join(root, str(s)), "db", syncmer=s)
           for s in (False, True)}
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 22, seed=61)
    rnd = np.random.default_rng(62).choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=(2, reads.shape[1]))
    m1, m2, _ = simulate_pairs(genomes, 12, seed=63)
    seqs = _strs(np.concatenate([reads, rnd]))
    return dict(root=root, dbs=dbs, genomes=genomes,
                names=[f"r{i}" for i in range(len(seqs))], seqs=seqs,
                m1=_strs(m1), m2=_strs(m2[:, :141]),
                low=["ACG" * 50, "A" * 150])


def _port(db, params, **kw):
    return Classifier(db, ClassifyParams(**params), device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX package's classify_batch of the single-end reads and of
    the pairs on the plain DB, run once for the cases below."""
    db = data["dbs"][False]
    names, seqs = data["names"], data["seqs"]
    pnames = names[:len(data["m1"])]
    return {
        "single": [_res(q) for q in JClassifier(db, JParams(**PARAMS))
                   .classify_batch(names, seqs)],
        "paired": [_res(q) for q in JClassifier(db, JParams(**PAIRED))
                   .classify_batch(pnames, data["m1"], data["m2"])],
    }


@pytest.mark.parametrize("mode", ["single", "paired"])
def test_classify_batch_equals_jax(data, jax_runs, mode):
    db = data["dbs"][False]
    ref = jax_runs[mode]
    assert sum(r[1] for r in ref) >= (20 if mode == "single" else 10)
    if mode == "single":
        names, s1, s2 = data["names"], data["seqs"], None
        clf = _port(db, PARAMS)
    else:
        names, s1, s2 = data["names"][:len(data["m1"])], data["m1"], \
            data["m2"]
        clf = _port(db, PAIRED)
    assert [_res(q) for q in clf.classify_batch(names, s1, s2)] == ref
    # the padded arrays straight in: the same records
    a1, l1 = clf._pad_batch(s1)
    a2, l2 = clf._pad_batch(s2) if s2 else (None, None)
    assert [_res(q) for q in clf.classify_batch_arrays(
        names, a1, l1, a2, l2)] == ref


def test_mate_two_of_nones_is_single_end(data, jax_runs):
    """seqs2 is used only when some entry is not None."""
    clf = _port(data["dbs"][False], PARAMS)
    n = len(data["seqs"])
    got = clf.classify_batch(data["names"], data["seqs"], [None] * n)
    assert [_res(q) for q in got] == jax_runs["single"]
    assert all(q.length2 == 0 for q in got)


def test_syncmer_window_compaction_and_its_retry_equal_jax(data):
    """The JAX package's window-compaction cases (its
    tests/test_window_compaction.py): the default compacted width, and a
    width far below the anchor density, so that the batch overflows and
    the ladder widens it; the low-complexity reads keep every window."""
    db = data["dbs"][True]
    names = data["names"] + ["low0", "low1"]
    seqs = data["seqs"] + data["low"]
    jclf, tclf = JClassifier(db, JParams(**PARAMS)), _port(db, PARAMS)
    assert tclf.syncmer and tclf._win_frac == jclf._win_frac == 184
    a1, l1 = tclf._pad_batch(seqs)
    ref = [_res(q) for q in jclf.classify_batch_arrays(names, a1, l1)]
    assert [_res(q) for q in tclf.classify_batch_arrays(names, a1, l1)] \
        == ref
    assert sum(r[1] for r in ref) >= 20
    forced = _port(db, PARAMS)
    forced._win_frac = 64
    retries = forced.timer.counts["retry"]
    assert [_res(q) for q in forced.classify_batch(names, seqs)] == ref
    assert forced._win_frac > 64 and forced.timer.counts["retry"] > retries


def test_streamed_equals_jax(data, jax_runs):
    """A budget that keeps the index on the host in ranges: the batch is
    a single-batch sweep of them."""
    db = data["dbs"][False]
    budget = 16 * load_index(db).size / (1 << 30) / 3
    clf = _port(db, {**PARAMS, "hbm_budget_gb": budget})
    assert clf._streaming and clf._n_ranges >= 2
    got = clf.classify_batch(data["names"], data["seqs"])
    assert [_res(q) for q in got] == jax_runs["single"]
    assert clf._ranges.stats()["sweeps"] >= 1


@pytest.mark.parametrize("mode", ["single", "paired"])
def test_mesh_of_cpu_cells_equals_jax(data, jax_runs, mode):
    """A 2 x 2 mesh of CPU cells (the batch is padded to the dp rows: 24
    reads and 12 pairs over 2 rows of 12 and 6)."""
    clf = Classifier(data["dbs"][False], ClassifyParams(
        **(PARAMS if mode == "single" else PAIRED)),
        mesh=make_mesh(4, devices=["cpu"] * 4))
    assert clf.mesh.shape == {"dp": 2, "db": 2}
    if mode == "single":
        got = clf.classify_batch(data["names"], data["seqs"])
    else:
        got = clf.classify_batch(data["names"][:len(data["m1"])],
                                 data["m1"], data["m2"])
    assert [_res(q) for q in got] == jax_runs[mode]
    assert clf.mesh_merged_bytes > 0


@pytest.mark.parametrize("mode", [1, 3], ids=["seq_mode1", "seq_mode3"])
def test_read_beyond_the_row_cap_takes_the_chunk_pass(data, mode):
    """A read of an unpaired batch beyond LONG_ROW_CAP is redone from its
    row by the chunk pass, in --seq-mode 1 as in 3: the route the JAX
    package's classify_file gives it under --seq-mode 3 (its
    classify_batch_arrays does not route it, and that batch asks for
    ~97 GB on the CPU); the other reads of the batch equal the JAX
    package's classify_batch of them."""
    params = LONG if mode == 3 else PARAMS
    db = data["dbs"][False]
    (lr,), _ = simulate_long(data["genomes"], [OVER_CAP], seed=64)
    long_seq = lr.tobytes().decode()
    names = data["names"][:6] + ["long"]
    seqs = data["seqs"][:6] + [long_seq]
    jclf = JClassifier(db, JParams(**params))
    ref = [_res(q) for q in jclf.classify_batch(names[:6], seqs[:6])]
    ref.append(_res(jclf._classify_long_read("long", long_seq)))
    clf = _port(db, params)
    got = [_res(q) for q in clf.classify_batch(names, seqs)]
    assert got == ref
    assert got[-1][1] and got[-1][5] == OVER_CAP
    assert clf._match_state is not None      # the host-match chunk step
    assert clf.timer.counts["long_probe"] == 1


def test_chunk_pass_equals_the_read_classified_whole(data):
    """With the row cap lowered on the port's classifier, a 5,000-base
    read of a --seq-mode 1 batch takes the chunk pass, and the batch
    equals the JAX package's classify_batch of it, which classifies the
    read whole in its row (as the port's classify_file does)."""
    db = data["dbs"][False]
    (lr,), _ = simulate_long(data["genomes"], [5000], seed=65)
    names = data["names"][:6] + ["long"]
    seqs = data["seqs"][:6] + [lr.tobytes().decode()]
    ref = [_res(q) for q in JClassifier(db, JParams(**PARAMS))
           .classify_batch(names, seqs)]
    clf = _port(db, PARAMS)
    clf.LONG_ROW_CAP, clf._LONG_CHUNK = 3000, 1536
    got = [_res(q) for q in clf.classify_batch(names, seqs)]
    assert got == ref
    assert got[-1][1] and got[-1][5] == 5000
    assert clf.timer.counts["long_probe"] == 1


def test_two_calls_equal_one_drive_batches(data):
    """The retry ladder's knobs are sticky across calls as across the
    batches of drive_batches: an emission block and a cap set too small
    climb on the first batch, and two classify_batch_arrays calls leave
    the same knobs and records as one drive_batches of both batches."""
    db = data["dbs"][False]
    names, seqs = data["names"], data["seqs"]
    halves = [(names[:12], seqs[:12]), (names[12:], seqs[12:])]

    def fresh():
        clf = _port(db, PARAMS)
        clf._path_block, clf.cap = 1, 4
        return clf

    knobs = lambda c: (c.cap, c._path_block, c._path_width, c._win_frac)
    calls = fresh()
    got = []
    for n, s in halves:
        got += calls.classify_batch_arrays(n, *calls._pad_batch(s))
    one = fresh()
    ref = one.drive_batches((n, *one._pad_batch(s), None, None)
                            for n, s in halves)
    assert [_res(q) for q in got] == [_res(q) for q in ref]
    assert knobs(calls) == knobs(one)
    assert calls._path_block > 1 and calls.timer.counts["retry"] >= 1


@pytest.mark.parametrize("syncmer", [False, True], ids=["plain", "syncmer"])
def test_classify_step_equals_jax(syncmer):
    """On synthetic_db (no read matches it, as in the compile check) and
    on an index that holds some of the reads' metamers."""
    reads, lengths = tfl.synthetic_reads(32, 150)
    synth = tfl.synthetic_db(4096)
    kw = dict(cap=8, syncmer=syncmer)
    for db in (synth, db_with_read_kmers(synth[0], reads, lengths,
                                          np.random.default_rng(73))):
        ref = jfl.classify_step(jnp.asarray(reads), jnp.asarray(lengths),
                                *(jnp.asarray(a) for a in db), **kw)
        got = tfl.classify_step(torch.from_numpy(reads),
                                torch.from_numpy(lengths), *db, **kw)
        assert set(got) == set(ref)
        for k in ref:
            want, have = np.asarray(ref[k]), got[k].cpu().numpy()
            assert have.dtype == want.dtype and have.shape == want.shape, k
            np.testing.assert_array_equal(have, want, err_msg=k)
    assert got["sel"].any() and (got["hamming"][got["sel"]] > 0).any()


def test_classify_step_runs_numpy_inputs_on_the_card(monkeypatch):
    """Numpy inputs (synthetic_db's and synthetic_reads', as the compile
    check passes them) run on the card unless device="cpu" is given, and
    raise where there is no card; tensors run where they lie."""
    reads, lengths = tfl.synthetic_reads(8, 150)
    db = tfl.synthetic_db(1024)
    on_cpu = tfl.classify_step(reads, lengths, *db, cap=8, device="cpu")
    where = tfl.classify_step(torch.from_numpy(reads),
                              torch.from_numpy(lengths), *db, cap=8)
    assert set(on_cpu) == set(where)
    for k, v in on_cpu.items():
        assert v.device.type == where[k].device.type == "cpu", k
        assert torch.equal(v, where[k]), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfl.classify_step(reads, lengths, *db, cap=8)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_data_equals_jax(seed):
    for t, j in ((tfl.synthetic_db(4096, seed=seed),
                  jfl.synthetic_db(4096, seed=seed)),
                 (tfl.synthetic_reads(32, 150, seed=seed + 1),
                  jfl.synthetic_reads(32, 150, seed=seed + 1))):
        for a, b in zip(t, j):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    values = tfl.synthetic_db(4096, seed=seed)[0]
    assert values.dtype == np.uint64 and (values >> np.uint64(63)).any()


def test_pack_paths_equals_jax():
    """One path_dp output of each package (the same candidates) packed
    unblocked into 7 columns and the emit flags."""
    case = random_case(np.random.default_rng(71), 4, 12, 9)
    names = ("sel", "species", "dna", "rh", "ham", "pos")

    def jax_out():
        f = dp_jax.sort_candidates(
            {k: jnp.asarray(a) for k, a in zip(names, case)},
            jnp.asarray(case[0]), jnp.asarray(case[4]), jnp.asarray(case[2]))
        md = jnp.full(f["sel"].shape, 2, jnp.int32)
        return dp_jax.path_dp(f["sel"], f["species"], f["dna"], f["rh"],
                              f["ham"], f["pos"], md, max_shift=3,
                              kmer_format=2)

    def torch_out():
        t = {k: torch.from_numpy(np.ascontiguousarray(a))
             for k, a in zip(names, case)}
        f = dp_torch.sort_candidates(t, t["sel"], t["ham"], t["dna"])
        md = torch.full(f["sel"].shape, 2, dtype=torch.int32)
        return dp_torch.path_dp(f["sel"], f["species"], f["dna"], f["rh"],
                                f["ham"], f["pos"], md, max_shift=3,
                                kmer_format=2)

    ref_cols, ref_sel = dp_jax.pack_paths(jax_out())
    cols, sel = dp_torch.pack_paths(torch_out())
    assert cols.dtype == torch.int32 and tuple(cols.shape) == ref_cols.shape
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(ref_cols))
    assert sel.any()


def test_init_distributed_takes_the_coordinator_address():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        assert distributed.init_distributed(
            coordinator_address=f"localhost:{port}", num_processes=1,
            process_id=0) == (0, 1)
    finally:
        torch.distributed.destroy_process_group()
