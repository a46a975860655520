"""The fused extraction kernel (csrc/extract.cu, ops/encode_cuda.py)
against its plain torch version on the card, bit-exact: mixed-length
batches with N's (every length remainder mod 3, reads shorter than one
window, rows of 65,536 bases), both k-mer layouts, syncmer on and off,
AA-only k-mers at k 8 and 12, window compaction at win_frac 184, 208 and
256 and at a width small enough to overflow, and paired parts with the
mate-2 offset; each call one launch.  Then every flow that extracts on
the card, on a small database, goes through the kernel (the plain
versions refuse CUDA tensors for the test) and classifies every read as
the CPU run does.
No JAX import: on a machine with a card and without JAX run it as

    python -m pytest tests/test_torch_encode_cuda.py -m cuda --noconftest
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
from metabuli_work_tpu_torch.ops import encode_cuda, encode_torch
from metabuli_work_tpu_torch.parallel.sharding import make_mesh

from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs, write_reads)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(min_score=0.15, min_sp_score=0.5, batch_size=8)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _batch(seed, B, L):
    """B rows of L bases with N's and lower case; the lengths cover every
    remainder mod 3, reads shorter than one window and the full row."""
    rng = np.random.default_rng(seed)
    arr = rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), size=(B, L),
                     p=[.235] * 4 + [.01] * 4 + [.015, .005])
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    fixed = [L, L - 1, L - 2, 0, 1, 2, 3, 5, 23, 24, 25, 26, 27]
    lens[:min(B, len(fixed))] = fixed[:B]
    return arr, lens


def _same(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


SHAPES = [(64, 168), (48, 200), (2, 65536)]
EXTRACT = ([dict(k=8, kmer_format=f, syncmer=s)
            for f in (1, 2) for s in (False, True)]
           + [dict(k=k, kmer_format=f, syncmer=s, aa_only=True)
              for k in (8, 12) for f in (1, 2) for s in (False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", SHAPES)
def test_extract_batch_kernel_matches_plain(card, B, L):
    arr, lens = _batch(B + L, B, L)
    t = (torch.from_numpy(arr), torch.from_numpy(lens))
    d = tuple(a.cuda() for a in t)
    for kw in EXTRACT:
        kw = dict(kw, smer_len=5 if kw["k"] == 8 else 6)
        n = encode_cuda.launches
        got = encode_torch.extract_batch(*d, **kw)
        torch.cuda.synchronize()
        assert encode_cuda.launches == n + 1
        assert got[0].is_cuda
        _same(got, encode_torch.extract_batch_ref(*t, **kw))


@pytest.mark.cuda
def test_extract_batch_kernel_refuses_unknown_k(card):
    """k 12 is AA-only on the card, and k 10 is not taken at all: both
    raise before any launch (no fall-back to the plain version)."""
    arr, lens = _batch(3, 4, 168)
    d = (torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda())
    n = encode_cuda.launches
    for k, aa_only in ((12, False), (10, True)):
        with pytest.raises(ValueError, match=f"k {k}"):
            encode_torch.extract_batch(*d, k=k, aa_only=aa_only)
    assert encode_cuda.launches == n


QUERIES = [(f, s, w) for f in (1, 2) for s in (False, True)
           for w in (0, 16, 184, 208, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True], ids=["one", "two"])
def test_extract_queries_kernel_matches_plain(card, paired):
    """One launch a call for one or two parts; the compaction's overflow
    (win_frac 16) counted as the plain version counts it; a given
    right-aligned copy changes nothing on the card."""
    a1, l1 = _batch(1, 64, 168)
    a2, l2 = _batch(2, 64, 150)
    t = [torch.from_numpy(a) for a in (a1, l1, a2, l2)]
    d = [a.cuda() for a in t]
    if not paired:
        t[2:] = d[2:] = [None, None]
    overflowed = None
    for kmer_format, syncmer, win_frac in QUERIES:
        kw = dict(syncmer=syncmer, kmer_format=kmer_format,
                  win_frac=win_frac)
        n = encode_cuda.launches
        got = flagship.extract_queries_step(*d, **kw)
        torch.cuda.synchronize()
        assert encode_cuda.launches == n + 1
        ref = flagship.extract_queries_step_ref(*t, **kw)
        _same(got[:5], ref[:5])
        assert got[5] == ref[5]
        assert int(got[6]) == int(ref[6])
        if win_frac == 16 and syncmer and kmer_format == 2:
            overflowed = int(got[6])
    assert overflowed > 0             # w_c 4 of 49 windows a frame
    ra = torch.from_numpy(encode_torch.right_align(a1, l1)).cuda()
    kw = dict(syncmer=True, win_frac=184)
    _same(flagship.extract_queries_step(d[0], d[1], ra1=ra, **kw)[:5],
          flagship.extract_queries_step(d[0], d[1], **kw)[:5])


@pytest.mark.cuda
def test_extract_queries_long_rows(card):
    a, l = _batch(3, 2, 65536)
    t = [torch.from_numpy(x) for x in (a, l)]
    d = [x.cuda() for x in t]
    for kw in (dict(syncmer=True, win_frac=184), dict(syncmer=False),
               dict(syncmer=True, kmer_format=1)):
        got = flagship.extract_queries_step(*d, *d, **kw)
        ref = flagship.extract_queries_step_ref(*t, *t, **kw)
        _same(got[:5], ref[:5])
        assert int(got[6]) == int(ref[6])


@pytest.fixture(scope="module")
def data(card, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("encode_cuda"))
    db = build_db(build_database, root, "db", syncmer=True)
    genomes, _ = write_inputs(root)
    reads, _ = simulate_reads(genomes, 40, seed=41)
    path = os.path.join(root, "reads.fna")
    write_reads(path, reads)
    m1, m2, _ = simulate_pairs(genomes, 24, seed=42)
    write_reads(os.path.join(root, "r1.fna"), m1)
    write_reads(os.path.join(root, "r2.fna"), m2)
    long, _ = simulate_long(genomes, [70_000], seed=43)
    return dict(db=db, path=path, long=long[0].tobytes().decode(),
                pairs=(os.path.join(root, "r1.fna"),
                       os.path.join(root, "r2.fna")))


def _res(results):
    return [(q.name, bool(q.result.is_classified),
             int(q.result.classification),
             np.float32(q.result.score).view(np.int32).item())
            for q in results]


@pytest.fixture
def no_plain_on_card(monkeypatch):
    """The plain versions refuse CUDA tensors for the test."""
    for mod, name in ((encode_torch, "extract_batch_ref"),
                      (flagship, "extract_queries_step_ref")):
        plain = getattr(mod, name)

        def refuse(reads, *a, _plain=plain, **k):
            assert not reads.is_cuda, "a CUDA tensor reached the plain version"
            return _plain(reads, *a, **k)

        monkeypatch.setattr(mod, name, refuse)


FLOWS = ["resident", "paired", "streamed", "mesh", "device-assign",
         "host-match"]


@pytest.mark.cuda
@pytest.mark.parametrize("flow", FLOWS)
def test_card_flows_go_through_the_kernel(data, flow, monkeypatch,
                                          no_plain_on_card):
    """Each dispatch extracts with the kernel: one launch an `extract`
    span (one a dp row on the mesh), and every read as on the CPU."""
    kw = dict(PARAMS, seq_mode=2 if flow == "paired" else 1)
    mesh = None
    if flow == "streamed":
        kw["hbm_budget_gb"] = (16 * load_index(data["db"]).size / 3.5) * 2 \
            / (1 << 30)
        monkeypatch.setenv("METABULI_STREAM_GROUP", "2")
    elif flow == "mesh":
        mesh = make_mesh(4, devices=["cuda"] * 4)
    elif flow == "device-assign":
        monkeypatch.setenv("METABULI_DEVICE_ASSIGN", "1")
    elif flow == "host-match":
        kw["min_cons_cnt"] = 1
    args = data["pairs"] if flow == "paired" else (data["path"],)
    clf = Classifier(data["db"], ClassifyParams(**kw), mesh=mesh,
                     device=None if mesh is not None else "cuda")
    assert clf._streaming == (flow == "streamed")
    assert clf._device_assign == (flow == "device-assign")
    n = encode_cuda.launches
    got = _res(clf.classify_file(*args))
    torch.cuda.synchronize()
    rows = clf.mesh.shape["dp"] if mesh is not None else 1
    assert encode_cuda.launches - n == clf.timer.counts["extract"] * rows > 0
    monkeypatch.delenv("METABULI_DEVICE_ASSIGN", raising=False)
    cpu = Classifier(data["db"], ClassifyParams(**kw), device="cpu")
    assert got == _res(cpu.classify_file(*args))


@pytest.mark.cuda
def test_chunk_pass_and_classify_step_go_through_the_kernel(
        data, no_plain_on_card):
    """A read beyond the row cap, redone from chunks on the card, and the
    standalone classify_step: kernel launches only."""
    clf = Classifier(data["db"], ClassifyParams(seq_mode=1, **PARAMS),
                     device="cuda")
    n = encode_cuda.launches
    res = clf.classify_batch(["long"], [data["long"]])
    torch.cuda.synchronize()
    assert len(res) == 1 and encode_cuda.launches > n
    index = load_index(data["db"])
    reads, lens = flagship.synthetic_reads(32, 150, seed=5)
    n = encode_cuda.launches
    out = flagship.classify_step(reads, lens, index.values, index.taxids,
                                 index.species, syncmer=True, device="cuda")
    torch.cuda.synchronize()
    assert encode_cuda.launches == n + 1
    ref = flagship.classify_step(reads, lens, index.values, index.taxids,
                                 index.species, syncmer=True, device="cpu")
    assert set(out) == set(ref)
    for k in out:
        assert torch.equal(out[k].cpu(), ref[k]), k
