"""Torch device step (fused_step_dp) and redundancy step vs the JAX
package's flagship, bit-exact: packed paths + stats header, resident
tensors and (rid, lca) pairs.  The JAX step runs its accelerator flow,
the Pallas path-DP kernel, in interpret mode (its empty path slots are
0, as the port's are; the XLA twin leaves the lane id there)."""

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
from torch_port_db import build_db, simulate_reads, write_inputs


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
    return dict(syncmer=syncmer, index=index, rows=rows, ht=ht,
                log2_rows=log2_rows, chain=chain, db_m=db_m, st=st,
                reads=reads, lens=lens, ra=right_align(reads, lens))


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


def _torch_step(s, cap, path_width):
    return tfl.fused_step_dp(
        torch.from_numpy(s["reads"]), torch.from_numpy(s["lens"]),
        s["st"]["db_quad"], ra1=torch.from_numpy(s["ra"]),
        hash_table=s["st"]["hash_table"], **_kw(s, cap, path_width))


@pytest.mark.parametrize("cap,path_width", [(4, 0), (8, 64)])
def test_fused_step_dp_matches_jax(setup, cap, path_width):
    jh, jres = _jax_step(setup, cap, path_width)
    th, tres = _torch_step(setup, cap, path_width)
    jh = np.asarray(jh)
    np.testing.assert_array_equal(jh, th.numpy())
    assert jh[1, 0] > 0                       # paths were emitted
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("out_w", [0, 4])
def test_redundancy_counts_matches_jax(setup, out_w):
    s = setup
    _, jres = _jax_step(s, 8, 0)
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
    got = tfl.redundancy_counts(
        *tres, torch.from_numpy(best), s["st"]["euler"], s["st"]["lca_depth"],
        s["st"]["lca_lift"], dna_shift=dna_shift, n_quot=n_quot,
        part_w=part_w, out_w=out_w)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ref, got.numpy())
    assert ref[0, 0] > 0
