"""Torch path DP (plain version + CUDA kernel wrapper) vs the JAX
package's dp_jax flow and Pallas kernel (interpret mode), bit-exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.ops import dp_jax, dp_pallas
from metabuli_work_tpu_torch.ops import dp_cuda, dp_torch

from test_dp_pallas import _random_case

I32 = np.int32
GRID = [(False, 1, 2), (False, 3, 2), (True, 3, 2), (False, 1, 1)]


def _flip(a, kmer_format):
    G = a.shape[1]
    frame = np.arange(G) % 6
    rev = (frame >= 3) if kmer_format != 1 else (frame < 3)
    return np.where(rev[None, :, None], a[:, :, ::-1], a)


def _flipped_inputs(sel, species, dna, rh, ham, pos, kmer_format):
    fl = lambda a: np.ascontiguousarray(_flip(a, kmer_format)).astype(I32)
    sp_m = np.where(_flip(sel, kmer_format), _flip(species, kmer_format), -1)
    return (sp_m.astype(I32), fl(dna), fl(rh), fl(ham), fl(pos))


def _pallas(case, min_cons, min_cons_euk, S, kf, dyn_gap, block_w, compact5):
    ins = _flipped_inputs(*case, kf)
    cols, valid, over = dp_pallas.path_dp_blocked(
        *(jnp.asarray(a) for a in ins), min_cons=min_cons,
        min_cons_euk=min_cons_euk, max_shift=S, kmer_format=kf,
        dyn_gap=dyn_gap, block_w=block_w, compact5=compact5, interpret=True)
    return np.asarray(cols), np.asarray(valid), int(over)


def _torch_blocked(case, min_cons, min_cons_euk, S, kf, dyn_gap, block_w,
                   compact5, device="cpu", fn=dp_cuda.path_dp_blocked):
    ins = [torch.from_numpy(a).to(device)
           for a in _flipped_inputs(*case, kf)]
    cols, valid, over = fn(
        *ins, min_cons=min_cons, min_cons_euk=min_cons_euk, max_shift=S,
        kmer_format=kf, dyn_gap=dyn_gap, block_w=block_w, compact5=compact5)
    return cols.cpu().numpy(), valid.cpu().numpy(), int(over)


@pytest.mark.parametrize("dyn_gap,max_shift,kmer_format", GRID)
@pytest.mark.parametrize("compact5", [True, False])
def test_blocked_ref_matches_pallas(dyn_gap, max_shift, kmer_format,
                                    compact5):
    rng = np.random.default_rng(42 + max_shift + kmer_format)
    case = _random_case(rng, 4, 12, 9, dyn_gap=dyn_gap)
    ref = _pallas(case, 2, 3, max_shift, kmer_format, dyn_gap, 8, compact5)
    got = _torch_blocked(case, 2, 3, max_shift, kmer_format, dyn_gap, 8,
                         compact5)
    assert ref[2] == got[2]
    np.testing.assert_array_equal(ref[1], got[1])
    # the Pallas kernel leaves empty slots 0, as the port does
    np.testing.assert_array_equal(ref[0], got[0])


def _overflow_case():
    rng = np.random.default_rng(7)
    cap, G, W = 4, 12, 12
    sel, species, dna, rh, ham, pos = _random_case(rng, cap, G, W,
                                                   n_species=2, density=0.95)
    dna = rng.integers(0, 1 << 24, size=(cap, G, W)).astype(I32)
    for w in range(1, W, 2):
        new3 = rng.integers(0, 8, size=(cap, G))
        fwd_next = (((dna[:, :, w - 1] << 3) & 0xFFFFFF) | new3)
        rev_next = ((dna[:, :, w - 1] >> 3) | (new3 << 21))
        fwd_lane = (np.arange(G, dtype=I32) % 6 < 3)[None, :]
        dna[:, :, w] = np.where(fwd_lane, fwd_next, rev_next).astype(I32)
    return (sel, species, dna, rh, ham, pos)


def test_blocked_ref_overflow_and_empty():
    case = _overflow_case()
    ref = _pallas(case, 2, 2, 1, 2, False, 2, True)
    got = _torch_blocked(case, 2, 2, 1, 2, False, 2, True)
    assert got[2] == ref[2] > 0
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])

    z = np.zeros((4, 12, 6), dtype=I32)
    empty = (np.zeros((4, 12, 6), dtype=bool), z, z, z, z, z)
    got = _torch_blocked(empty, 2, 3, 1, 2, False, 4, True)
    assert got[2] == 0 and not got[1].any() and not got[0].any()


@pytest.mark.parametrize("dyn_gap,max_shift,kmer_format", GRID)
def test_unfused_flow_matches_dp_jax(dyn_gap, max_shift, kmer_format):
    """sort_candidates -> path_dp -> pack_paths_blocked (both layouts)."""
    rng = np.random.default_rng(5 + max_shift + kmer_format)
    sel, species, dna, rh, ham, pos = _random_case(rng, 4, 12, 9,
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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(_random_case(np.random.default_rng(42 + s + kf), 4, 12, 9,
                           dyn_gap=dg), s, kf, dg, 8)
             for dg, s, kf in GRID]
    cases.append((_overflow_case(), 1, 2, False, 2))
    for case, S, kf, dg, bw in cases:
        for compact5 in (True, False):
            ref = _torch_blocked(case, 2, 3, S, kf, dg, bw, compact5, "cuda",
                                 fn=dp_cuda.path_dp_blocked_ref)
            n0 = dp_cuda.launches
            got = _torch_blocked(case, 2, 3, S, kf, dg, bw, compact5, "cuda")
            assert dp_cuda.launches == n0 + 1
            assert ref[2] == got[2]
            np.testing.assert_array_equal(ref[0], got[0])
            np.testing.assert_array_equal(ref[1], got[1])
