"""Torch path DP (plain version + CUDA kernel wrapper) vs the JAX
package's dp_jax flow and Pallas kernel (interpret mode), bit-exact.
The kernels against the plain version on the card are in
test_torch_dp_cuda.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.ops import dp_jax, dp_pallas
from metabuli_work_tpu_torch.ops import dp_cuda, dp_torch

from torch_dp_cases import (EDGES, GRID, HIGH_CAP, I32, edge_case,
                            flipped_inputs, high_cap_case, overflow_case,
                            random_case, torch_blocked)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PALLAS_MAX_CAP = 80      # interpret mode: 40 s at cap 128, minutes at 384


def _pallas(case, min_cons, min_cons_euk, S, kf, dyn_gap, block_w, compact5):
    ins = flipped_inputs(*case, kf)
    cols, valid, over = dp_pallas.path_dp_blocked(
        *(jnp.asarray(a) for a in ins), min_cons=min_cons,
        min_cons_euk=min_cons_euk, max_shift=S, kmer_format=kf,
        dyn_gap=dyn_gap, block_w=block_w, compact5=compact5, interpret=True)
    return np.asarray(cols), np.asarray(valid), int(over)


@pytest.mark.parametrize("dyn_gap,max_shift,kmer_format", GRID)
@pytest.mark.parametrize("compact5", [True, False])
def test_blocked_ref_matches_pallas(dyn_gap, max_shift, kmer_format,
                                    compact5):
    rng = np.random.default_rng(42 + max_shift + kmer_format)
    case = random_case(rng, 4, 12, 9, dyn_gap=dyn_gap)
    ref = _pallas(case, 2, 3, max_shift, kmer_format, dyn_gap, 8, compact5)
    got = torch_blocked(case, 2, 3, max_shift, kmer_format, dyn_gap, 8,
                         compact5)
    assert ref[2] == got[2]
    np.testing.assert_array_equal(ref[1], got[1])
    # the Pallas kernel leaves empty slots 0, as the port does
    np.testing.assert_array_equal(ref[0], got[0])


@pytest.mark.parametrize("name,cap,G,W,S,kf,dyn_gap,block_w,density", EDGES,
                         ids=[e[0] for e in EDGES])
def test_blocked_ref_matches_pallas_at_kernel_edges(name, cap, G, W, S, kf,
                                                    dyn_gap, block_w,
                                                    density):
    case = edge_case(name, cap, G, W, density, dyn_gap)
    ref = _pallas(case, 2, 3, S, kf, dyn_gap, block_w, True)
    got = torch_blocked(case, 2, 3, S, kf, dyn_gap, block_w, True)
    assert ref[2] == got[2]
    if name.startswith("overflow"):
        assert got[2] > 0
    np.testing.assert_array_equal(ref[1], got[1])
    np.testing.assert_array_equal(ref[0], got[0])


def _dp_jax_blocked(case, min_cons, min_cons_euk, S, kf, dyn_gap, block_w):
    """The JAX package's unfused flow sort_candidates -> path_dp ->
    pack_paths_blocked (its own tests hold it equal to the Pallas
    kernel), empty slots 0 in every column as the kernel leaves them."""
    names = ("sel", "species", "dna", "rh", "ham", "pos")
    f = dp_jax.sort_candidates({k: jnp.asarray(a) for k, a in
                                zip(names, case)}, jnp.asarray(case[0]),
                               jnp.asarray(case[4]), jnp.asarray(case[2]))
    md = jnp.where((f["species"] >> 30) & 1 != 0, min_cons_euk,
                   min_cons).astype(jnp.int32)
    out = dp_jax.path_dp(f["sel"], f["species"], f["dna"], f["rh"], f["ham"],
                         f["pos"], md, max_shift=S, kmer_format=kf,
                         dyn_gap=dyn_gap)
    cols, valid, over = dp_jax.pack_paths_blocked(out, block_w, compact5=True)
    valid = np.asarray(valid)
    return np.where(valid[None], np.asarray(cols), 0), valid, int(over)


@pytest.mark.parametrize("name,cap,G,W,S,kf,dyn_gap,block_w,density,mode",
                         HIGH_CAP, ids=[e[0] for e in HIGH_CAP])
def test_blocked_ref_matches_jax_at_high_caps(name, cap, G, W, S, kf,
                                              dyn_gap, block_w, density,
                                              mode):
    """Caps above 32 as a many-species database gives them, where the
    block variant branches: against the Pallas kernel in interpret mode
    up to PALLAS_MAX_CAP, above it against the JAX package's unfused
    dp_jax flow."""
    case = high_cap_case(name, cap, G, W, density, dyn_gap, mode)
    if cap <= PALLAS_MAX_CAP:
        ref = _pallas(case, 2, 3, S, kf, dyn_gap, block_w, True)
    else:
        ref = _dp_jax_blocked(case, 2, 3, S, kf, dyn_gap, block_w)
    got = torch_blocked(case, 2, 3, S, kf, dyn_gap, block_w, True)
    assert ref[2] == got[2]
    assert (got[2] > 0) == name.startswith(("overflow", "cap64"))
    assert got[1].any() or W == 1
    np.testing.assert_array_equal(ref[1], got[1])
    np.testing.assert_array_equal(ref[0], got[0])


@pytest.mark.parametrize("cap,which", [(1, "warp"), (8, "warp"),
                                       (32, "warp"), (33, "block"),
                                       (4096, "block")])
def test_kernel_variant_by_cap(cap, which):
    """The variant depends on cap alone; CPU tensors launch neither."""
    assert dp_cuda.variant(cap) == which
    n = (dp_cuda.launches, dp_cuda.warp_launches, dp_cuda.block_launches)
    case = random_case(np.random.default_rng(cap), min(cap, 40), 6, 4)
    torch_blocked(case, 2, 3, 1, 2, False, 4, True)
    assert (dp_cuda.launches, dp_cuda.warp_launches,
            dp_cuda.block_launches) == n


def test_blocked_ref_overflow_and_empty():
    case = overflow_case()
    ref = _pallas(case, 2, 2, 1, 2, False, 2, True)
    got = torch_blocked(case, 2, 2, 1, 2, False, 2, True)
    assert got[2] == ref[2] > 0
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])

    z = np.zeros((4, 12, 6), dtype=I32)
    empty = (np.zeros((4, 12, 6), dtype=bool), z, z, z, z, z)
    got = torch_blocked(empty, 2, 3, 1, 2, False, 4, True)
    assert got[2] == 0 and not got[1].any() and not got[0].any()


@pytest.mark.parametrize("dyn_gap,max_shift,kmer_format", GRID)
def test_unfused_flow_matches_dp_jax(dyn_gap, max_shift, kmer_format):
    """sort_candidates -> path_dp -> pack_paths_blocked (both layouts)."""
    rng = np.random.default_rng(5 + max_shift + kmer_format)
    sel, species, dna, rh, ham, pos = random_case(rng, 4, 12, 9,
                                                   dyn_gap=dyn_gap)
    names = ("sel", "species", "dna", "rh", "ham", "pos")
    arrs = (sel, species, dna, rh, ham, pos)
    jf = dp_jax.sort_candidates({k: jnp.asarray(a) for k, a in
                                 zip(names, arrs)},
                                jnp.asarray(sel), jnp.asarray(ham),
                                jnp.asarray(dna))
    tf = dp_torch.sort_candidates({k: torch.from_numpy(a) for k, a in
                                   zip(names, arrs)},
                                  torch.from_numpy(sel), torch.from_numpy(ham),
                                  torch.from_numpy(dna))
    for k in names:
        np.testing.assert_array_equal(np.asarray(jf[k]), tf[k].numpy(), k)
    jmd = jnp.where((jf["species"] >> 30) & 1 != 0, 3, 2).astype(jnp.int32)
    tmd = torch.where((tf["species"] >> 30) & 1 != 0, 3, 2).to(torch.int32)
    jdp = dp_jax.path_dp(jf["sel"], jf["species"], jf["dna"], jf["rh"],
                         jf["ham"], jf["pos"], jmd, max_shift=max_shift,
                         kmer_format=kmer_format, dyn_gap=dyn_gap)
    tdp = dp_torch.path_dp(tf["sel"], tf["species"], tf["dna"], tf["rh"],
                           tf["ham"], tf["pos"], tmd, max_shift=max_shift,
                           kmer_format=kmer_format, dyn_gap=dyn_gap)
    for k in jdp:
        a, b = np.asarray(jdp[k]), tdp[k].numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, k)
    for compact5 in (True, False):
        jc, jv, jo = dp_jax.pack_paths_blocked(jdp, 8, compact5=compact5)
        tc, tv, to = dp_torch.pack_paths_blocked(tdp, 8, compact5=compact5)
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        assert int(jo) == int(to)


@pytest.mark.parametrize("out_width,density", [(0, 0.3), (16, 0.3),
                                               (200, 0.3), (0, 1.0)])
def test_compact_columns_matches_dp_jax(out_width, density):
    rng = np.random.default_rng(out_width + int(10 * density))
    cols = rng.integers(-(1 << 31), 1 << 31, size=(5, 64)).astype(I32)
    sel = rng.random(64) < density
    jp, jn = dp_jax.compact_columns(jnp.asarray(cols), jnp.asarray(sel),
                                    out_width=out_width)
    tp, tn = dp_torch.compact_columns(torch.from_numpy(cols),
                                      torch.from_numpy(sel),
                                      out_width=out_width)
    assert int(jn) == int(tn)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_decode_paths_layouts():
    rng = np.random.default_rng(1)
    for C in (5, 7):
        arr = rng.integers(0, 1 << 30, size=(C, 10)).astype(I32)
        a, b = dp_jax.decode_paths(arr), dp_torch.decode_paths(arr)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
