"""The probe's dispatch and the probe kernel's zero convention, on the
CPU, tolerance 0.

- CPU tensors run the plain body: match_kmers_quad equals
  match_kmers_quad_ref on every field of every layout of
  tests/torch_probe_cases.py, probe_range_step folds as the plain fold
  does, and the kernel's launch counter stays 0; the kernel's wrapper
  refuses a CPU tensor.
- On the card the kernel writes 0 in the five value fields wherever sel
  is false, where the plain body leaves the unselected window entry's
  values.  Every consumer of a probe gives the same result with either:
  finish_stream_step (its paths and stats header, through fused_step_dp),
  redundancy_counts, and device-assign's fused_step_full, on single-end,
  paired and long reads against a database in each k-mer layout (the
  legacy layout 1 index is made here from the same genomes).
"""

import numpy as np
import pytest
import torch

from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                       ClassifyParams)
from metabuli_work_tpu_torch.index.builder import build_database
from metabuli_work_tpu_torch.index.format import KmerIndex, load_index
from metabuli_work_tpu_torch.models import flagship
from metabuli_work_tpu_torch.ops import encode_torch, match_cuda, match_torch

import torch_probe_cases as cases
from torch_port_db import (build_db, simulate_long, simulate_pairs,
                           simulate_reads, write_inputs)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("hamming", "rh", "taxid", "species", "dna_enc")


@pytest.fixture(scope="module")
def cdb(tmp_path_factory):
    index, genomes = cases.make_db(str(tmp_path_factory.mktemp("probe")))
    return index, cases.queries(genomes, 3)


@pytest.mark.parametrize("kmer_format", [1, 2])
@pytest.mark.parametrize("kind", cases.LAYOUTS)
def test_cpu_tensors_run_the_plain_body(cdb, kind, kmer_format):
    index, (qk, qf, qv) = cdb
    rows, kw = cases.layout(index, kind)
    n = match_cuda.launches
    got = match_torch.match_kmers_quad(qk, qf, qv, rows, 12, kmer_format,
                                       **kw)
    ref = match_torch.match_kmers_quad_ref(qk, qf, qv, rows, 12, kmer_format,
                                           **kw)
    assert match_cuda.launches == n
    assert list(got) == list(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert bool(ref["sel"].any())


@pytest.mark.parametrize("cap", [4, 12])
def test_cpu_range_fold_is_the_plain_fold(cdb, cap):
    """probe_range_step on CPU tensors: the plain probe of each range,
    added where sel holds, equal to one resident probe of the whole
    index where sel holds (the ranges are disjoint), with no launch;
    the overflow count too, at a cap that runs outrun."""
    index, (qk, qf, qv) = cdb
    quads, hts, log2, chain = cases.ranges(index, 3)
    acc = flagship.new_accumulators(cap, qk.shape[0], "cpu")
    n = match_cuda.launches
    for quad, ht in zip(quads, hts):
        flagship.probe_range_step(qk, qf, qv, quad, ht, acc, cap=cap,
                                  kmer_format=2, hash_log2_rows=log2,
                                  hash_chain=chain)
    assert match_cuda.launches == n
    rows, kw = cases.layout(index, "wide")
    ref = match_torch.match_kmers_quad_ref(qk, qf, qv, rows, cap, 2, **kw)
    assert torch.equal(acc["sel"], ref["sel"])
    assert int(acc["overflow"]) == int(ref["overflow"])
    for k in FIELDS:
        assert torch.equal(acc[k], torch.where(ref["sel"], ref[k], 0)), k
    if cap == 4:
        assert int(ref["overflow"]) > 0


def test_kernel_wrapper_refuses_cpu_tensors(cdb):
    index, (qk, qf, qv) = cdb
    rows, kw = cases.layout(index, "wide")
    n = match_cuda.launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        match_cuda.probe(qk, qf, qv, rows, kw["hash_table"], cap=12,
                         kmer_format=2, log2_rows=kw["hash_log2_rows"],
                         chain=kw["hash_chain"], m=kw["db_m"])
    assert match_cuda.launches == n


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """{kmer_format: (index, genomes)}: the syncmer database that
    build_database writes (layout 2), and an index of the same genomes'
    every layout-1 metamer."""
    root = str(tmp_path_factory.mktemp("zeros"))
    index = load_index(build_db(build_database, root, "db", syncmer=True))
    genomes, _ = write_inputs(root)
    tax = index.taxonomy
    values, taxids = [], []
    for i, g in enumerate(genomes):
        arr = torch.from_numpy(np.frombuffer(g.encode(), np.uint8)[None].copy())
        km, _, ok = encode_torch.extract_batch_ref(
            arr, torch.tensor([len(g)], dtype=torch.int32), kmer_format=1)
        v = np.unique(km[ok].numpy().view(np.uint64))
        values.append(v)
        taxids.append(np.full(len(v), tax.to_internal(10 + i), np.int32))
    v, t = np.concatenate(values), np.concatenate(taxids)
    order = np.lexsort((t, v))
    v, t = v[order], t[order]
    keep = np.ones(len(v), bool)
    keep[1:] = (v[1:] != v[:-1]) | (t[1:] != t[:-1])
    legacy = KmerIndex(v[keep], t[keep], t[keep], tax,
                       {"kmer_format": 1, "syncmer": False, "smer_len": 5})
    return {2: (index, genomes), 1: (legacy, genomes)}


def _batch(genomes, shape):
    """(mate-1 strings, mate-2 strings or None, seq_mode, score limits)."""
    if shape == "single":
        r, _ = simulate_reads(genomes, 24, seed=5)
        return [x.tobytes().decode() for x in r], None, 1, (0.15, 0.5)
    if shape == "paired":
        m1, m2, _ = simulate_pairs(genomes, 16, seed=6)
        return ([x.tobytes().decode() for x in m1],
                [x.tobytes().decode() for x in m2], 2, (0.15, 0.5))
    r, _ = simulate_long(genomes, [3000, 5500, 8000, 1200], seed=7)
    return [x.tobytes().decode() for x in r], None, 3, (0.008, 0.0)


def _best_species(resident, n_reads):
    """A best species a read, as host scoring hands it back: the species
    of the read's first selected candidate, none for every third read."""
    sel, species, qs = (resident[0].numpy(), resident[1].numpy(),
                        resident[5].numpy())
    best = np.zeros(n_reads + 1, np.int32)
    for n in np.nonzero(sel.any(0))[0]:
        r = int(qs[n])
        if best[r] == 0 and r % 3:
            best[r] = species[int(np.argmax(sel[:, n])), n]
    assert (best > 0).any()
    return torch.from_numpy(best)


@pytest.mark.parametrize("kmer_format", [1, 2])
@pytest.mark.parametrize("shape", ["single", "paired", "long"])
def test_consumers_ignore_unselected_fields(dbs, shape, kmer_format,
                                            monkeypatch):
    index, genomes = dbs[kmer_format]
    s1, s2, seq_mode, (min_score, min_sp) = _batch(genomes, shape)
    clf = Classifier.from_memory(index, ClassifyParams(
        seq_mode=seq_mode, min_score=min_score, min_sp_score=min_sp,
        batch_size=len(s1)), device="cpu")
    assert clf.kmer_format == kmer_format
    B = len(s1)
    a1, l1 = clf._pad_batch(s1)
    a2, l2 = clf._pad_batch(s2) if s2 is not None else (None, None)
    r1, j1, _, r2, j2, _ = clf._prep_mates(a1, l1, a2, l2, B)
    lmax2 = r2.shape[1] if r2 is not None else None
    step_kw = dict(
        min_cons=int(clf.params.min_cons_cnt),
        min_cons_euk=int(clf.params.min_cons_cnt_euk), cap=clf.cap,
        kmer_format=clf.kmer_format, syncmer=clf.syncmer,
        smer_len=clf.smer_len, path_width=clf._path_width,
        win_frac=clf._win_frac, path_block=clf._path_block,
        **clf._probe_kw)
    dna_shift = int(clf.taxonomer.dna_shift)
    lmax = r1.shape[1] + (lmax2 + 3 if lmax2 is not None else 0)
    red_kw = dict(dna_shift=dna_shift, n_quot=lmax // dna_shift + 2,
                  part_w=flagship.part_widths(
                      r1.shape[1], clf.syncmer, clf.kmer_format,
                      clf.smer_len, clf._win_frac, lmax2=lmax2))
    tables = (clf.euler, clf.lca_depth, clf.lca_lift)

    def run():
        hdr, resident = flagship.fused_step_dp(
            r1, j1, clf.db_quad, reads2=r2, lens2=j2, **step_kw)
        return hdr, resident

    plain_hdr, plain_res = run()
    best = _best_species(plain_res, B)
    plain_red = flagship.redundancy_counts(*plain_res, best, *tables,
                                           **red_kw)
    plain_full = flagship.fused_step_full(
        r1, j1, clf.db_quad, clf.ef_node, *tables, reads2=r2, lens2=j2,
        min_score=min_score, combine_k=clf._combine_k, **red_kw,
        **step_kw)

    zeroed = []

    def zeroing(*a, **k):
        out = match_torch.match_kmers_quad_ref(*a, **k)
        for f in FIELDS:
            z = torch.where(out["sel"], out[f], 0)
            zeroed.append(not torch.equal(z, out[f]))
            out[f] = z
        return out

    monkeypatch.setattr(match_torch, "match_kmers_quad", zeroing)
    hdr, res = run()
    assert any(zeroed), "the plain body left no value to zero"
    assert bool(plain_res[0].any())
    assert torch.equal(hdr, plain_hdr)
    assert torch.equal(flagship.redundancy_counts(*res, best, *tables,
                                                  **red_kw), plain_red)
    full = flagship.fused_step_full(
        r1, j1, clf.db_quad, clf.ef_node, *tables, reads2=r2, lens2=j2,
        min_score=min_score, combine_k=clf._combine_k, **red_kw,
        **step_kw)
    for a, b in zip(full, plain_full):
        assert torch.equal(a, b)
