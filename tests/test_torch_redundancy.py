"""The redundancy step's dispatch on the CPU, tolerance 0.

- CPU tensors run the plain body: redundancy_counts equals
  redundancy_counts_ref on every case of tests/torch_redundancy_cases.py
  (one- and two-part broadcasts, long rows, the q_sids read index, no
  selection, reads without a best species, clamped positions, euler-first
  indices past the tour, lifting tables of 1-6 levels, full, wide and
  narrow output widths), and the kernel's launch counter stays 0.
- The kernel's wrapper refuses CPU tensors and misshapen inputs before
  any launch.
- The kernel leaves the pair columns past the count unwritten.  No
  consumer reads them: with those columns scrambled, the host-scoring
  flow's phase 2 (single-end, paired, long) and the device-assign flow
  (fused_step_full) classify every read as before, tax counts included.
"""

import numpy as np
import pytest
import torch

from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                       ClassifyParams)
from metabuli_work_tpu_torch.index.builder import build_database
from metabuli_work_tpu_torch.index.format import load_index
from metabuli_work_tpu_torch.models import flagship
from metabuli_work_tpu_torch.ops import redundancy_cuda

import torch_redundancy_cases as cases
from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("out_w", [0, 5])
@pytest.mark.parametrize("levels", [1, 4, 6])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_cpu_tensors_run_the_plain_body(kind, levels, out_w):
    args, kw = cases.case(kind, levels, out_w)
    n = redundancy_cuda.launches
    got = flagship.redundancy_counts(*args, **kw)
    ref = flagship.redundancy_counts_ref(*args, **kw)
    assert redundancy_cuda.launches == n
    assert torch.equal(got, ref)
    count, width = int(ref[0, 0]), ref.shape[1] - 1
    assert (count == 0) == (kind == "empty")
    if out_w and kind != "empty":
        assert width == out_w < count        # the count stays true


def test_kernel_wrapper_refuses_cpu_tensors():
    args, kw = cases.case("single")
    n = redundancy_cuda.launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        redundancy_cuda.redundancy(*args, **kw)
    assert redundancy_cuda.launches == n


def _misshapen(what):
    args, kw = cases.case("paired")
    args = list(args)
    if what == "sel-1d":
        args[0] = args[0][0]
    elif what == "species-shape":
        args[1] = args[1][:, 1:]
    elif what == "ham-int64":
        args[2] = args[2].long()
    elif what == "ef-strided":
        args[3] = args[3].t().contiguous().t()
    elif what == "q-pos-shape":
        args[4] = args[4][1:]
    elif what == "best-2d":
        args[6] = args[6][None]
    elif what == "lift-levels":
        args[9] = args[9][:0]
    elif what == "depth-shape":
        args[8] = args[8][1:]
    elif what == "dna-shift":
        kw["dna_shift"] = 0
    elif what == "n-quot":
        kw["n_quot"] = 0
    elif what == "out-w":
        kw["out_w"] = -1
    elif what == "parts":
        kw["part_w"] = (6,) * (redundancy_cuda.MAX_PARTS + 1)
    return args, kw


@pytest.mark.parametrize("what", [
    "sel-1d", "species-shape", "ham-int64", "ef-strided", "q-pos-shape",
    "best-2d", "lift-levels", "depth-shape", "dna-shift", "n-quot", "out-w",
    "parts"])
def test_kernel_wrapper_refuses_misshapen_inputs(what):
    args, kw = _misshapen(what)
    n = redundancy_cuda.launches
    with pytest.raises(ValueError, match="redundancy kernel: (?!unsupported)"):
        redundancy_cuda.redundancy(*args, **kw)
    assert redundancy_cuda.launches == n


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("redundancy"))
    index = load_index(build_db(build_database, root, "db", syncmer=True))
    genomes, _ = write_inputs(root)
    return index, genomes


def _batch(genomes, flow):
    """(mate-1 strings, mate-2 strings or None, classifier parameters)."""
    if flow == "paired":
        m1, m2, _ = simulate_pairs(genomes, 16, seed=6)
        return ([x.tobytes().decode() for x in m1],
                [x.tobytes().decode() for x in m2],
                dict(seq_mode=2, min_score=0.15, min_sp_score=0.5))
    if flow == "long":
        r, _ = simulate_long(genomes, [3000, 5500, 8000, 1200], seed=7)
        return ([x.tobytes().decode() for x in r], None,
                dict(seq_mode=3, min_score=0.008, min_sp_score=0.0))
    r, _ = simulate_reads(genomes, 24, seed=5)
    return ([x.tobytes().decode() for x in r], None,
            dict(seq_mode=1, min_score=0.15, min_sp_score=0.5))


def _results(clf, s1, s2):
    names = [f"r{i}" for i in range(len(s1))]
    return [(q.name, bool(q.result.is_classified),
             int(q.result.classification),
             np.float32(q.result.score).view(np.int32).item(),
             dict(q.result.tax_cnt))
            for q in clf.classify_batch(names, s1, s2)]


@pytest.mark.parametrize("flow", ["single", "paired", "long",
                                  "device-assign"])
def test_consumers_read_pairs_by_count(db, flow, monkeypatch):
    index, genomes = db
    s1, s2, params = _batch(genomes, flow)
    if flow == "device-assign":
        monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    clf = Classifier.from_memory(index, ClassifyParams(
        batch_size=len(s1), **params), device="cpu")
    assert clf._device_assign == (flow == "device-assign")
    plain = _results(clf, s1, s2)
    assert any(r[4] for r in plain), "no read has tax counts"

    real = flagship.redundancy_counts
    rng = np.random.default_rng(20)
    tails = []

    def scrambled(*a, **k):
        out = real(*a, **k).clone()
        count = int(out[0, 0])
        tail = out[:, 1 + count:]
        if tail.numel():
            tail.copy_(torch.from_numpy(rng.integers(
                1, 5, tail.shape, dtype=np.int32)))
            tails.append(tail.shape[1])
        return out

    monkeypatch.setattr(flagship, "redundancy_counts", scrambled)
    assert _results(clf, s1, s2) == plain
    assert tails, "no pair column past the count was scrambled"
