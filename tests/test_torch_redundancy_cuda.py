"""The redundancy kernel (csrc/redundancy.cu, ops/redundancy_cuda.py)
against its plain torch version on the card, bit for bit on the stats
column and the first min(count, width) pairs: every case of
tests/torch_redundancy_cases.py (single-end, two-part and long shapes,
the q_sids read index, no selection, reads without a best species,
clamped positions, euler-first indices near 2^25), lifting tables of 1-6
levels, output widths full, wide and narrower than the count (the count
still true); the cells' batch of 1,024 reads, whose groups span many
blocks; one launch a call.  Then every flow that finishes through the
path DP, on a small database, launches the kernel at least once a
`redundancy` span (once a dp row on the mesh; inside the `assign` span
on the device-assign flow), the plain version refusing CUDA tensors,
and classifies every read as the CPU run does.  No JAX import: on a
machine with a card and without JAX run it as

    python -m pytest tests/test_torch_redundancy_cuda.py -m cuda --noconftest
"""

import os

import numpy as np
import pytest
import torch

from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                       ClassifyParams)
from metabuli_work_tpu_torch.index.builder import build_database
from metabuli_work_tpu_torch.index.format import load_index
from metabuli_work_tpu_torch.models import flagship
from metabuli_work_tpu_torch.ops import redundancy_cuda
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

import torch_redundancy_cases as cases
from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(min_score=0.15, min_sp_score=0.5, batch_size=8)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card(args, kw):
    """redundancy_counts on the card, one launch; (result, reference)."""
    ref = flagship.redundancy_counts_ref(*args, **kw)
    n = redundancy_cuda.launches
    got = flagship.redundancy_counts(*(a.cuda() for a in args), **kw)
    torch.cuda.synchronize()
    assert redundancy_cuda.launches == n + 1
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("out_w", [0, 1 << 14, 5])
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_kernel_matches_plain(card, kind, levels, out_w):
    got, ref = _on_card(*cases.case(kind, levels, out_w))
    count = cases.same_prefix(got, ref)
    assert (count == 0) == (kind == "empty")
    if out_w == 5 and kind != "empty":
        assert ref.shape[1] - 1 == 5 < count


@pytest.mark.cuda
@pytest.mark.parametrize("out_w", [0, 4096])
@pytest.mark.parametrize("kind", ["single", "paired", "sids", "clamp"])
def test_kernel_matches_plain_at_the_cells_batch(card, kind, out_w):
    """1,024 reads: tens of thousands of groups over many blocks, and a
    prefix narrower than the count."""
    got, ref = _on_card(*cases.case(kind, 4, out_w, seed=3, reads=1024))
    count = cases.same_prefix(got, ref)
    assert count > 4096


@pytest.mark.cuda
def test_kernel_refuses_before_launch(card):
    args, kw = cases.case("single")
    args = [a.cuda() for a in args]
    n = redundancy_cuda.launches
    with pytest.raises(ValueError, match="redundancy kernel"):
        redundancy_cuda.redundancy(*args[:3], args[3].t().contiguous().t(),
                                   *args[4:], **kw)
    with pytest.raises(ValueError, match="redundancy kernel"):
        redundancy_cuda.redundancy(*args, **dict(kw, n_quot=0))
    assert redundancy_cuda.launches == n


@pytest.fixture(scope="module")
def data(card, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("redundancy_flows"))
    db = build_db(build_database, root, "db", syncmer=True)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 40, seed=41)
    path = os.path.join(root, "reads.fna")
    write_reads(path, reads)
    m1, m2, _ = simulate_pairs(genomes, 24, seed=42)
    write_reads(os.path.join(root, "r1.fna"), m1)
    write_reads(os.path.join(root, "r2.fna"), m2)
    long, _ = simulate_long(genomes, [3000, 9000, 5000, 12000], seed=43)
    write_reads(os.path.join(root, "long.fna"), long)
    return dict(db=db, path=path, long=os.path.join(root, "long.fna"),
                pairs=(os.path.join(root, "r1.fna"),
                       os.path.join(root, "r2.fna")))


def _res(results):
    return [(q.name, bool(q.result.is_classified),
             int(q.result.classification),
             np.float32(q.result.score).view(np.int32).item(),
             dict(q.result.tax_cnt))
            for q in results]


@pytest.fixture
def no_plain_on_card(monkeypatch):
    """The plain body refuses CUDA tensors for the test."""
    plain = flagship.redundancy_counts_ref

    def refuse(sel, *a, **k):
        assert not sel.is_cuda, "a CUDA tensor reached the plain body"
        return plain(sel, *a, **k)

    monkeypatch.setattr(flagship, "redundancy_counts_ref", refuse)


FLOWS = ["resident", "paired", "long", "streamed", "device-assign", "mesh"]


def _classifier(data, flow, device, monkeypatch):
    """(classifier, classify_file arguments) of a flow."""
    kw = dict(PARAMS, seq_mode={"paired": 2, "long": 3}.get(flow, 1))
    if flow == "long":
        kw.update(min_score=0.008, min_sp_score=0.0)
    if flow == "streamed":
        kw["hbm_budget_gb"] = 16 * load_index(data["db"]).size / 3.5 * 2 \
            / (1 << 30)
        monkeypatch.setenv("METABULI_STREAM_GROUP", "2")
    mesh = None
    if device == "cuda" and flow == "mesh":
        mesh = make_mesh(4, devices=["cuda"] * 4)
    if flow == "device-assign":
        monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    clf = Classifier(data["db"], ClassifyParams(**kw), mesh=mesh,
                     device=None if mesh is not None else device)
    monkeypatch.delenv("METABULI_DEVICE_ASSIGN", raising=False)
    args = {"paired": data["pairs"], "long": (data["long"],)}.get(
        flow, (data["path"],))
    return clf, args


@pytest.mark.cuda
@pytest.mark.parametrize("flow", FLOWS)
def test_card_flows_go_through_the_kernel(data, flow, monkeypatch,
                                          no_plain_on_card):
    """Each finish runs the kernel: once a `redundancy` span (a launch a
    dp row on the mesh; the device-assign flow's in its `assign` span),
    and every read is classified as on the CPU, tax counts included."""
    clf, args = _classifier(data, flow, "cuda", monkeypatch)
    assert clf._streaming == (flow == "streamed")
    assert clf._device_assign == (flow == "device-assign")
    assert (clf.mesh is not None) == (flow == "mesh")
    n = redundancy_cuda.launches
    got = _res(clf.classify_file(*args))
    torch.cuda.synchronize()
    span = "assign" if flow == "device-assign" else "redundancy"
    spans = clf.timer.counts[span]
    rows = clf.mesh.shape["dp"] if clf.mesh is not None else 1
    assert redundancy_cuda.launches - n >= rows * spans > 0
    cpu, _ = _classifier(data, flow, "cpu", monkeypatch)
    assert got == _res(cpu.classify_file(*args))
