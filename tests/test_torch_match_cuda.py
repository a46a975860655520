"""The probe kernel (csrc/probe.cu, ops/match_cuda.py) against its plain
torch version on the card: sel and the overflow count everywhere, the
five value fields wherever sel holds and 0 elsewhere, over every layout
of tests/torch_probe_cases.py (wide rows, a hash whose rows chain and
clamp at the last row, a range cut), caps 4, 12, 20 and 40 (runs longer
than the small ones), both k-mer layouts and all six frames, with hash
misses and invalid queries; the fold mode of the streamed range passes
over disjoint ranges equal to the plain fold; each call one launch.
Then every flow that probes the packed index on the card, on a small
database, launches the kernel at least once a `probe` span (the plain
version refuses CUDA tensors for the test) and classifies every read as
the CPU run does.  No JAX import: on a machine with a card and without JAX run it as

    python -m pytest tests/test_torch_match_cuda.py -m cuda --noconftest
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
from metabuli_work_tpu_torch.ops import match_cuda, match_torch
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

import torch_probe_cases as cases
from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("hamming", "rh", "taxid", "species", "dna_enc")
PARAMS = dict(min_score=0.15, min_sp_score=0.5, batch_size=8)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def cdb(card, tmp_path_factory):
    """The 12-species database and its queries (two batches of reads,
    plus the metamers whose home row is last in the chained table)."""
    index, genomes = cases.make_db(str(tmp_path_factory.mktemp("probe")))
    q = [torch.cat(parts) for parts in zip(cases.queries(genomes, 3),
                                           cases.queries(genomes, 7))]
    rows, kw = cases.layout(index, "wide-chain")
    last = cases.last_row_queries(index, kw["hash_table"],
                                  kw["hash_log2_rows"])
    assert last[0].numel() > 0
    return index, [torch.cat(p) for p in zip(q, last)]


def _same_where_selected(got, ref):
    """got (the kernel's) equal to ref (the plain body's) on sel and
    overflow, on the five fields where sel holds, and 0 elsewhere."""
    sel = ref["sel"]
    assert torch.equal(got["sel"].cpu(), sel)
    assert int(got["overflow"]) == int(ref["overflow"])
    for k in FIELDS:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert torch.equal(got[k].cpu(), torch.where(sel, ref[k], 0)), k


@pytest.mark.cuda
@pytest.mark.parametrize("kmer_format", [1, 2])
@pytest.mark.parametrize("cap", [4, 12, 20, 40])
@pytest.mark.parametrize("kind", cases.LAYOUTS)
def test_probe_kernel_matches_plain(cdb, kind, cap, kmer_format):
    index, (qk, qf, qv) = cdb
    rows, kw = cases.layout(index, kind)
    ref = match_torch.match_kmers_quad_ref(qk, qf, qv, rows, cap,
                                           kmer_format, **kw)
    dkw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
    n = match_cuda.launches
    got = match_torch.match_kmers_quad(qk.cuda(), qf.cuda(), qv.cuda(),
                                       rows.cuda(), cap, kmer_format, **dkw)
    torch.cuda.synchronize()
    assert match_cuda.launches == n + 1
    _same_where_selected(got, ref)
    assert bool(ref["sel"].any()) and bool((~qv).any())
    assert set(qf[qv].tolist()) == set(range(6))
    if kind == "wide-chain":
        assert kw["hash_chain"] > 1
    if cap == 4:
        assert int(ref["overflow"]) > 0          # runs longer than cap


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [4, 20])
def test_probe_kernel_fold_matches_plain_fold(cdb, cap):
    """The streamed range passes: the kernel folds each of 3 disjoint
    ranges into the accumulators, in one launch a range, to what the
    plain probe and fold give on the CPU, field for field."""
    index, (qk, qf, qv) = cdb
    quads, hts, log2, chain = cases.ranges(index, 3)
    kw = dict(cap=cap, kmer_format=2, hash_log2_rows=log2, hash_chain=chain)
    ref = flagship.new_accumulators(cap, qk.shape[0], "cpu")
    got = flagship.new_accumulators(cap, qk.shape[0], "cuda")
    dq = (qk.cuda(), qf.cuda(), qv.cuda())
    n = match_cuda.launches
    for quad, ht in zip(quads, hts):
        flagship.probe_range_step(qk, qf, qv, quad, ht, ref, **kw)
        flagship.probe_range_step(*dq, quad.cuda(), ht.cuda(), got, **kw)
    torch.cuda.synchronize()
    assert match_cuda.launches == n + len(quads)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k]), k
    assert bool(ref["sel"].any())
    if cap == 4:
        assert int(ref["overflow"]) > 0


@pytest.mark.cuda
def test_probe_kernel_empty_and_refused(cdb):
    """No queries: no launch, empty fields, overflow 0.  An index whose
    entries do not start at a 16-byte boundary is refused before any
    launch (no fall-back to the plain version)."""
    index, _ = cdb
    rows, kw = cases.layout(index, "wide-range")
    dkw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
    rows = rows.cuda()
    e = torch.zeros(0, dtype=torch.int64, device="cuda")
    n = match_cuda.launches
    got = match_torch.match_kmers_quad(
        e, e.int(), e.bool(), rows, 12, 2, **dkw)
    assert match_cuda.launches == n
    assert got["sel"].shape == (12, 0) and int(got["overflow"]) == 0
    q = (torch.zeros(4, dtype=torch.int64, device="cuda"),
         torch.zeros(4, dtype=torch.int32, device="cuda"),
         torch.ones(4, dtype=torch.bool, device="cuda"))
    skewed = rows.view(-1)[1:-3].view(-1, 4)
    with pytest.raises(ValueError, match="16-byte"):
        match_torch.match_kmers_quad(*q, skewed, 12, 2, **dkw)
    assert match_cuda.launches == n


@pytest.fixture(scope="module")
def data(card, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("probe_flows"))
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
    chunked, _ = simulate_long(genomes, [70_000], seed=44)
    return dict(db=db, path=path, long=os.path.join(root, "long.fna"),
                chunked=chunked[0].tobytes().decode(),
                pairs=(os.path.join(root, "r1.fna"),
                       os.path.join(root, "r2.fna")))


def _res(results):
    return [(q.name, bool(q.result.is_classified),
             int(q.result.classification),
             np.float32(q.result.score).view(np.int32).item())
            for q in results]


@pytest.fixture
def no_plain_on_card(monkeypatch):
    """The plain body refuses CUDA tensors for the test."""
    plain = match_torch.match_kmers_quad_ref

    def refuse(q_kmers, *a, **k):
        assert not q_kmers.is_cuda, "a CUDA tensor reached the plain probe"
        return plain(q_kmers, *a, **k)

    monkeypatch.setattr(match_torch, "match_kmers_quad_ref", refuse)


def _budget_gb(db, flow):
    """A card budget under which the index streams: in 4 ranges on one
    device, in 3 ranges of the 2 x 2 mesh's 2 db columns."""
    nbytes = 16 * load_index(db).size
    return (nbytes / 3.5 * 2 if flow == "streamed" else nbytes / 6) \
        / (1 << 30)


FLOWS = ["resident", "paired", "long", "streamed", "device-assign", "mesh",
         "mesh-streamed"]
KNOBS = {"device-assign": {"METABULI_DEVICE_ASSIGN": "1"}}


def _classifier(data, flow, device, monkeypatch):
    """(classifier, classify_file arguments) of a flow."""
    kw = dict(PARAMS, seq_mode={"paired": 2, "long": 3}.get(flow, 1))
    if flow == "long":
        kw.update(min_score=0.008, min_sp_score=0.0)
    if flow in ("streamed", "mesh-streamed"):
        kw["hbm_budget_gb"] = _budget_gb(data["db"], flow)
        monkeypatch.setenv("METABULI_STREAM_GROUP", "2")
    mesh = None
    if device == "cuda" and flow.startswith("mesh"):
        mesh = make_mesh(4, devices=["cuda"] * 4)
    for k, v in KNOBS.get(flow, {}).items():
        monkeypatch.setenv(k, v)
    clf = Classifier(data["db"], ClassifyParams(**kw), mesh=mesh,
                     device=None if mesh is not None else device)
    for k in KNOBS.get(flow, {}):
        monkeypatch.delenv(k)
    args = {"paired": data["pairs"], "long": (data["long"],)}.get(
        flow, (data["path"],))
    return clf, args


@pytest.mark.cuda
@pytest.mark.parametrize("flow", FLOWS)
def test_card_flows_go_through_the_kernel(data, flow, monkeypatch,
                                          no_plain_on_card):
    """Each dispatch probes with the kernel, at least once a `probe` span
    (once a range of a sweep, once a cell of the mesh), and every read
    is classified as on the CPU."""
    clf, args = _classifier(data, flow, "cuda", monkeypatch)
    assert clf._streaming == (flow == "streamed")
    assert clf._device_assign == (flow == "device-assign")
    assert (clf.mesh is not None) == flow.startswith("mesh")
    if clf.mesh is not None:
        assert clf._mesh_stream == (flow == "mesh-streamed")
    n = match_cuda.launches
    got = _res(clf.classify_file(*args))
    torch.cuda.synchronize()
    spans = clf.timer.counts["probe"]
    assert match_cuda.launches - n >= spans > 0
    cpu, _ = _classifier(data, flow, "cpu", monkeypatch)
    assert got == _res(cpu.classify_file(*args))


@pytest.mark.cuda
def test_chunk_pass_goes_through_the_kernel(data, monkeypatch,
                                            no_plain_on_card):
    """A read beyond the row cap, redone from chunks through the streamed
    classifier's range passes: kernel launches only, the result the
    resident classifier's."""
    clf, _ = _classifier(data, "streamed", "cuda", monkeypatch)
    n = match_cuda.launches
    res = clf.classify_batch(["long"], [data["chunked"]])
    torch.cuda.synchronize()
    assert len(res) == 1 and match_cuda.launches > n
    resident = Classifier(data["db"], ClassifyParams(seq_mode=1, **PARAMS),
                          device="cuda")
    assert _res(res) == _res(resident.classify_batch(["long"],
                                                     [data["chunked"]]))
