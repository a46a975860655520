"""Multi-process classify in the torch package: two real processes joined
by torch.distributed over gloo, each with two CPU cells (global mesh dp 2
processes x db 2 cells).  Each process classifies its own rows of the
same input through the mesh path; the merged per-read records (f32 score
bits and tax_cnt included) equal the port's single-process run and the
JAX package's, and each read is scored by exactly one process."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams

from torch_port_db import build_db, simulate_reads, write_inputs, write_reads

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

    port, nproc = _free_port(), 2
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(REPO, "tests", "torch_distributed_worker.py")
    outs = [os.path.join(root, f"out_{r}.json") for r in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(r), str(nproc), db, path,
         outs[r], "2"], env=env, stdout=subprocess.PIPE,
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
    assert merged == want
