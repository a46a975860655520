"""Multi-process classify in the torch package: two real processes joined
by torch.distributed over gloo, each with two CPU cells (global mesh dp 2
processes x db 2 cells).  Each process classifies its own rows of the
same input through the mesh path; the merged per-read records (f32 score
bits and tax_cnt included) equal the port's single-process run and the
JAX package's, and each read is scored by exactly one process."""

import glob
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams

from torch_port_db import (build_db, simulate_reads, write_inputs, write_reads,
                           write_reference_copy)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _records(results):
    out = {}
    for q in results:
        r = q.result
        out[q.name] = [bool(r.is_classified), int(r.classification),
                       int(np.float32(r.score).view(np.int32)),
                       {str(k): v for k, v in r.tax_cnt.items()}]
    return out


def test_two_process_classify_equals_single(tmp_path):
    root = str(tmp_path)
    db = build_db(jbuild, root, "db", syncmer=True)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 21, seed=71)
    rnd = np.random.default_rng(72).choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=(2, reads.shape[1]))
    path = os.path.join(root, "reads.fna")
    write_reads(path, np.concatenate([reads, rnd]))       # 23: 8, 8, 7

    want = _records(Classifier(db, ClassifyParams(**PARAMS),
                               device="cpu").classify_file(path))
    assert sum(v[0] for v in want.values()) >= 18
    assert _records(JClassifier(db, JParams(**PARAMS)).classify_file(path)) \
        == want

    merged, _ = _two_processes(root, db, path)
    assert merged == want


def test_two_process_classify_of_a_cold_reference_db(tmp_path, monkeypatch):
    """The two processes on a reference-format (diffIdx) copy of the DB
    whose import cache is cold, with an empty pack cache: both import
    and pack it at once.  The merged records equal the single-device run
    on the native DB, and neither cache keeps a temporary file."""
    root = str(tmp_path)
    db = build_db(jbuild, root, "db", syncmer=True)
    ref = write_reference_copy(db, os.path.join(root, "ref"), "diffIdx")
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 23, seed=74)
    path = os.path.join(root, "reads.fna")
    write_reads(path, reads)
    packs = os.path.join(root, "packs")
    monkeypatch.setenv("METABULI_PACK_CACHE", packs)

    merged, _ = _two_processes(root, ref, path)
    want = _records(Classifier(db, ClassifyParams(**PARAMS),
                               device="cpu").classify_file(path))
    assert sum(v[0] for v in want.values()) >= 18
    assert merged == want
    assert not glob.glob(os.path.join(ref, ".import_cache", "*.new"))
    assert not glob.glob(os.path.join(packs, ".tmp_*"))


def _two_processes(root, db, path, seq_mode=1):
    """Run the worker in two processes over gloo; returns (the merged
    records, each process's log)."""
    port, nproc = _free_port(), 2
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(REPO, "tests", "torch_distributed_worker.py")
    outs = [os.path.join(root, f"out_{r}.json") for r in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(r), str(nproc), db, path,
         outs[r], "2", str(seq_mode)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(nproc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:        # a hang fails the test instead of waiting
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    merged = {}
    for out in outs:
        with open(out) as f:
            part = json.load(f)
        assert part, "each process owns a non-empty share of the reads"
        for k, v in part.items():
            assert k not in merged, f"read {k} scored by two processes"
            merged[k] = v
    return merged, logs


def test_two_process_long_read_beyond_row_cap(tmp_path):
    """--seq-mode 3 with a read beyond the 65,536-base row cap at place 5
    of the first batch of 8: dp row 1, so process 1 owns it.  Only
    process 1 redoes it from chunks, and it lands at its own place in
    that process's records, equal to the single-process run."""
    root = str(tmp_path)
    db = build_db(jbuild, root, "db", syncmer=True)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 11, seed=73)
    path = os.path.join(root, "reads.fna")
    long_read = genomes[1] * 17                          # 68,000 bases
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            if i == 5:
                f.write(f">long\n{long_read}\n")
            f.write(f">r{i}\n{r.tobytes().decode()}\n")
    params = ClassifyParams(**{**PARAMS, "seq_mode": 3})
    want = _records(Classifier(db, params, device="cpu").classify_file(path))
    assert len(want) == 12 and want["long"][0]

    merged, logs = _two_processes(root, db, path, seq_mode=3)
    assert merged == want
    redone = [int(re.search(r"(\d+) long reads", log).group(1))
              for log in logs]
    assert redone == [0, 1], logs
