"""Torch device steps (fused_step_dp single-end and paired, the
host-match fused_step) and redundancy step vs the JAX package's
flagship, bit-exact (tolerance 0): packed paths + stats header, every
resident tensor, (rid, lca) pairs, and the host-match step's compacted
match prefix.  The JAX step runs its accelerator flow, the Pallas
path-DP kernel, in interpret mode (its empty path slots are 0, as the
port's are; the XLA twin leaves the lane id there)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.index.builder import build_database
from metabuli_work_tpu.index.format import load_index
from metabuli_work_tpu.models import flagship as jfl
from metabuli_work_tpu.ops.encode_jax import right_align
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.models import flagship as tfl

from test_torch_match import packed_state
from torch_port_db import (build_db, simulate_pairs, simulate_reads,
                           write_inputs)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "syncmer"])
def setup(request, tmp_path_factory):
    syncmer = request.param
    root = str(tmp_path_factory.mktemp("flag"))
    index = load_index(build_db(build_database, root, "db", syncmer=syncmer))
    genomes, _ = write_inputs(root)
    rows, ht, log2_rows, chain, db_m, _, _ = packed_state(index)
    tax = index.taxonomy
    depth, lift = tax.lca_lift_tables()
    st = packing.state_from_numpy(rows, ht, log2_rows, chain, db_m, depth,
                                  lift, tax.euler.astype(np.int32),
                                  tax.euler_first.astype(np.int32), "cpu")
    reads, _ = simulate_reads(genomes, 10, seed=4)
    lens = np.full(len(reads), reads.shape[1], np.int32)
    lens[3] = 131                    # one short read: ragged windows
    reads = np.concatenate([reads, np.full((len(reads), 18), ord("N"),
                                           np.uint8)], 1)   # 168 = bucket
    # pairs: mate 2 is shorter (another length bucket, so the two parts
    # have different W), one mate 1 is ragged
    m1, m2, _ = simulate_pairs(genomes, 10, seed=5)
    m2 = np.ascontiguousarray(m2[:, :144])
    pl1 = np.full(len(m1), m1.shape[1], np.int32)
    pl2 = np.full(len(m2), 140, np.int32)
    pl1[6], pl2[1] = 133, 121
    m1 = np.concatenate([m1, np.full((len(m1), 18), ord("N"), np.uint8)], 1)
    pair = dict(r1=m1, l1=pl1, ra1=right_align(m1, pl1),
                r2=m2, l2=pl2, ra2=right_align(m2, pl2))
    return dict(syncmer=syncmer, index=index, rows=rows, ht=ht,
                log2_rows=log2_rows, chain=chain, db_m=db_m, st=st,
                reads=reads, lens=lens, ra=right_align(reads, lens),
                pair=pair)


def _kw(s, cap, path_width):
    return dict(min_cons=2, min_cons_euk=9, cap=cap, kmer_format=2,
                syncmer=s["syncmer"], smer_len=5, path_width=path_width,
                win_frac=184 if s["syncmer"] else 256, path_block=16,
                hash_log2_rows=s["log2_rows"], hash_chain=s["chain"],
                db_m=s["db_m"])


def _jax_step(s, cap, path_width):
    B = len(s["reads"])
    return jfl.fused_step_dp(
        jnp.asarray(s["reads"]), jnp.asarray(s["lens"]),
        jnp.zeros((B, 96), jnp.uint8), jnp.zeros(B, jnp.int32),
        jnp.asarray(s["rows"]), ra1=jnp.asarray(s["ra"]),
        hash_table=jnp.asarray(s["ht"]), dp_pallas=True,
        pallas_interpret=True, **_kw(s, cap, path_width))


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX fused step of setup's reads (pairs when paired), computed
    once a (paired, cap, path_width) for the cases that compare with it."""
    memo = {}

    def get(paired, cap, path_width):
        key = (paired, cap, path_width)
        if key not in memo:
            step = _jax_step_paired if paired else _jax_step
            memo[key] = step(setup, cap, path_width)
        return memo[key]
    return get


def _torch_step(s, cap, path_width):
    return tfl.fused_step_dp(
        torch.from_numpy(s["reads"]), torch.from_numpy(s["lens"]),
        s["st"]["db_quad"], ra1=torch.from_numpy(s["ra"]),
        hash_table=s["st"]["hash_table"], **_kw(s, cap, path_width))


@pytest.mark.parametrize("cap,path_width", [(4, 0), (8, 64)])
def test_fused_step_dp_matches_jax(setup, jax_step, cap, path_width):
    jh, jres = jax_step(False, cap, path_width)
    th, tres = _torch_step(setup, cap, path_width)
    jh = np.asarray(jh)
    np.testing.assert_array_equal(jh, th.numpy())
    assert jh[1, 0] > 0                       # paths were emitted
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("out_w", [0, 4])
def test_redundancy_counts_matches_jax(setup, jax_step, out_w):
    s = setup
    _, jres = jax_step(False, 8, 0)
    _, tres = _torch_step(s, 8, 0)
    B = len(s["reads"])
    rng = np.random.default_rng(out_w)
    species = np.unique(s["index"].species)
    best = np.zeros(B + 1, np.int32)
    best[1:] = rng.choice(species, size=B)
    best[2] = 0                               # a read with no best species
    lmax = s["reads"].shape[1]
    dna_shift = 9 if s["syncmer"] else 3
    n_quot = lmax // dna_shift + 2
    wf = 184 if s["syncmer"] else 256
    part_w = jfl.part_widths(lmax, 96, False, s["syncmer"], 2, 5, wf)
    assert part_w == tfl.part_widths(lmax, s["syncmer"], 2, 5, wf)
    tax = s["index"].taxonomy
    depth, lift = tax.lca_lift_tables()
    ref = jfl.redundancy_counts(
        *jres, jnp.asarray(best), jnp.asarray(tax.euler.astype(np.int32)),
        jnp.asarray(depth), jnp.asarray(lift), dna_shift=dna_shift,
        n_quot=n_quot, part_w=part_w, out_w=out_w)
    got = tfl.redundancy_counts_ref(
        *tres, torch.from_numpy(best), s["st"]["euler"], s["st"]["lca_depth"],
        s["st"]["lca_lift"], dna_shift=dna_shift, n_quot=n_quot,
        part_w=part_w, out_w=out_w)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ref, got.numpy())
    assert ref[0, 0] > 0


def _jax_step_paired(s, cap, path_width):
    p = s["pair"]
    j = jnp.asarray
    return jfl.fused_step_dp(
        j(p["r1"]), j(p["l1"]), j(p["r2"]), j(p["l2"]), j(s["rows"]),
        ra1=j(p["ra1"]), ra2=j(p["ra2"]), paired=True,
        hash_table=j(s["ht"]), dp_pallas=True, pallas_interpret=True,
        **_kw(s, cap, path_width))


def _torch_step_paired(s, cap, path_width):
    p = s["pair"]
    t = torch.from_numpy
    return tfl.fused_step_dp(
        t(p["r1"]), t(p["l1"]), s["st"]["db_quad"], reads2=t(p["r2"]),
        lens2=t(p["l2"]), ra1=t(p["ra1"]), ra2=t(p["ra2"]),
        hash_table=s["st"]["hash_table"], **_kw(s, cap, path_width))


@pytest.mark.parametrize("cap,path_width", [(4, 0), (8, 64)])
def test_fused_step_dp_paired_matches_jax(setup, jax_step, cap, path_width):
    """Two parts (mate 1, mate 2) with different W: header, paths and
    all six resident tensors, which span both parts concatenated."""
    jh, jres = jax_step(True, cap, path_width)
    th, tres = _torch_step_paired(setup, cap, path_width)
    jh = np.asarray(jh)
    np.testing.assert_array_equal(jh, th.numpy())
    assert jh[1, 0] > 0
    assert len(jres) == len(tres) == 6
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # mate-2 positions carry the maxCovered(len1) + 3 offset
    q_pos, p = tres[4].numpy(), setup["pair"]
    assert q_pos.max() > p["r1"].shape[1]


@pytest.mark.parametrize("out_w", [0, 4])
def test_redundancy_counts_two_parts_matches_jax(setup, jax_step, out_w):
    s, p = setup, setup["pair"]
    _, jres = jax_step(True, 8, 0)
    _, tres = _torch_step_paired(s, 8, 0)
    B = len(p["r1"])
    species = np.unique(s["index"].species)
    best = np.zeros(B + 1, np.int32)
    best[1:] = np.random.default_rng(out_w).choice(species, size=B)
    best[4] = 0
    lmax1, lmax2 = p["r1"].shape[1], p["r2"].shape[1]
    dna_shift = 9 if s["syncmer"] else 3
    n_quot = (lmax1 + lmax2 + 3) // dna_shift + 2
    wf = 184 if s["syncmer"] else 256
    part_w = jfl.part_widths(lmax1, lmax2, True, s["syncmer"], 2, 5, wf)
    assert part_w == tfl.part_widths(lmax1, s["syncmer"], 2, 5, wf,
                                     lmax2=lmax2)
    assert len(part_w) == 2 and part_w[0] != part_w[1]
    tax = s["index"].taxonomy
    depth, lift = tax.lca_lift_tables()
    kw = dict(dna_shift=dna_shift, n_quot=n_quot, out_w=out_w)
    ref = np.asarray(jfl.redundancy_counts(
        *jres, jnp.asarray(best), jnp.asarray(tax.euler.astype(np.int32)),
        jnp.asarray(depth), jnp.asarray(lift), part_w=part_w, **kw))
    args = (*tres, torch.from_numpy(best), s["st"]["euler"],
            s["st"]["lca_depth"], s["st"]["lca_lift"])
    got = tfl.redundancy_counts_ref(*args, part_w=part_w, **kw)
    np.testing.assert_array_equal(ref, got.numpy())
    assert ref[0, 0] > 0
    # a part_w that does not cover N falls back to the q_sids gather
    got = tfl.redundancy_counts_ref(*args, part_w=(part_w[0],), **kw)
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("buckets", [True, False], ids=["buckets", "search"])
def test_fused_step_matches_jax(setup, paired, buckets):
    """Host-match step: count, overflow and the count prefix of the
    packed match columns (the rest is never read)."""
    from metabuli_work_tpu_torch.ops import match_torch

    s, p, index = setup, setup["pair"], setup["index"]
    taxids = index.taxids.astype(np.int32)
    species = index.species.astype(np.int32)
    B = len(p["r1"])
    kw = dict(cap=4, kmer_format=2, syncmer=s["syncmer"], smer_len=5)
    jkw, tkw = {}, {}
    if buckets:
        b_lo, aa_lo, shift, steps = match_torch.build_buckets(index.values)
        jkw = dict(bucket_lo=jnp.asarray(b_lo), db_aa_lo=jnp.asarray(aa_lo),
                   bucket_shift=shift, bucket_steps=steps)
        ms = packing.match_state_from_numpy(index.values, taxids, species,
                                            b_lo, aa_lo, shift, steps, "cpu")
        tkw = {k: ms[k] for k in ("bucket_lo", "db_aa_lo", "bucket_shift",
                                  "bucket_steps")}
    j, t = jnp.asarray, torch.from_numpy
    jr2, jl2 = (j(p["r2"]), j(p["l2"])) if paired else \
        (jnp.zeros((B, 96), jnp.uint8), jnp.zeros(B, jnp.int32))
    rp, rn, ro = jfl.fused_step(
        j(p["r1"]), j(p["l1"]), jr2, jl2, j(index.values), j(taxids),
        j(species), paired=paired, **kw, **jkw)
    gp, gn, go = tfl.fused_step(
        t(p["r1"]), t(p["l1"]), t(p["r2"]) if paired else None,
        t(p["l2"]) if paired else None,
        t(index.values.view(np.int64).copy()), t(taxids), t(species),
        **kw, **tkw)
    n = int(rn)
    assert n == int(gn) and n > 50
    assert int(ro) == int(go)
    assert gp.shape == rp.shape
    np.testing.assert_array_equal(np.asarray(rp)[:, :n], gp.numpy()[:, :n])
