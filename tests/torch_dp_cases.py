"""Path-DP test inputs and runner shared by the CPU tests
(tests/test_torch_dp.py) and the card test (tests/test_torch_dp_cuda.py);
no JAX import, so the card test runs where JAX is not installed."""

import numpy as np
import torch

from metabuli_work_tpu_torch.ops import dp_cuda

I32 = np.int32
# (dyn_gap, max_shift, kmer_format): the JAX package's parity grid
GRID = [(False, 1, 2), (False, 3, 2), (True, 3, 2), (False, 1, 1)]
# shapes where the CUDA kernels branch: (id, cap, G, W, max_shift,
# kmer_format, dyn_gap, block_w, density).  cap 32 | 33 straddles the
# warp | block variant switch; the warp variant packs 32 / P lanes of
# next-pow2 width P >= cap per warp and 4 warps per block, so G = 18 and
# G = 12 at cap 4 leave a block partial; it stages windows in tiles of
# 8, so W = 1, 13 and 17 end inside a tile; dense cases overflow block_w.
EDGES = [
    ("cap32", 32, 12, 9, 3, 2, True, 8, 0.4),
    ("cap33", 33, 12, 9, 3, 2, True, 8, 0.4),
    ("G18-S1", 8, 18, 9, 1, 2, False, 8, 0.4),
    ("W1-S1", 4, 12, 1, 1, 2, False, 4, 0.6),
    ("W1-S3", 4, 12, 1, 3, 2, True, 4, 0.6),
    ("W13-S3", 12, 18, 13, 3, 2, True, 16, 0.5),
    ("W17-S2-kf1", 5, 18, 17, 2, 1, False, 8, 0.5),
    ("overflow-cap12", 12, 18, 16, 1, 2, False, 2, 0.9),
]


def random_case(rng, cap, G, W, n_species=5, density=0.4, dyn_gap=False):
    """(sel, species, dna, rh, ham, pos) [cap, G, W] candidate arrays
    biased toward consecutive chains in both lane directions (the cases
    of tests/test_dp_pallas.py)."""
    sel = rng.random((cap, G, W)) < density
    species = rng.integers(1, n_species + 1, size=(cap, G, W)).astype(I32)
    # sprinkle euk flags (bit 30)
    species = species | (rng.integers(0, 2, size=species.shape)
                         << 30).astype(I32)
    dna = rng.integers(0, 1 << 24, size=(cap, G, W)).astype(I32)
    # forward lanes need next = (prev<<3)|new (isConsecutive2 fwd), reverse
    # lanes the mirrored form: make some windows satisfy each
    for w in range(1, W):
        m = rng.random((cap, G))
        new3 = rng.integers(0, 8, size=(cap, G))
        fwd_next = (((dna[:, :, w - 1] << 3) & 0xFFFFFF) | new3)
        rev_next = ((dna[:, :, w - 1] >> 3) | (new3 << 21))
        dna[:, :, w] = np.where(m < 0.35, fwd_next,
                                np.where(m < 0.7, rev_next,
                                         dna[:, :, w])).astype(I32)
    rh = rng.integers(0, 1 << 16, size=(cap, G, W)).astype(I32)
    ham = rng.integers(0, 8, size=(cap, G, W)).astype(I32)
    if dyn_gap:
        # compacted windows: strictly increasing positions with gaps
        gaps = rng.integers(1, 4, size=(G, W)).astype(I32)
        base = np.cumsum(gaps, axis=1) * 3
        pos = np.broadcast_to(base[None], (cap, G, W)).astype(I32)
    else:
        pos = np.broadcast_to(
            (np.arange(W, dtype=I32) * 3)[None, None, :], (cap, G, W)
        ).astype(I32).copy()
    return sel, species, dna, rh, ham, pos


def edge_case(name, cap, G, W, density, dyn_gap):
    """The EDGES entry's random inputs."""
    rng = np.random.default_rng(len(name) + cap + G + W)
    return random_case(rng, cap, G, W, n_species=3, density=density,
                       dyn_gap=dyn_gap)


def overflow_case():
    """Dense chains in every lane: more emitted paths than block_w 2."""
    rng = np.random.default_rng(7)
    cap, G, W = 4, 12, 12
    sel, species, dna, rh, ham, pos = random_case(rng, cap, G, W,
                                                  n_species=2, density=0.95)
    dna = rng.integers(0, 1 << 24, size=(cap, G, W)).astype(I32)
    for w in range(1, W, 2):
        new3 = rng.integers(0, 8, size=(cap, G))
        fwd_next = (((dna[:, :, w - 1] << 3) & 0xFFFFFF) | new3)
        rev_next = ((dna[:, :, w - 1] >> 3) | (new3 << 21))
        fwd_lane = (np.arange(G, dtype=I32) % 6 < 3)[None, :]
        dna[:, :, w] = np.where(fwd_lane, fwd_next, rev_next).astype(I32)
    return (sel, species, dna, rh, ham, pos)


def _flip(a, kmer_format):
    G = a.shape[1]
    frame = np.arange(G) % 6
    rev = (frame >= 3) if kmer_format != 1 else (frame < 3)
    return np.where(rev[None, :, None], a[:, :, ::-1], a)


def flipped_inputs(sel, species, dna, rh, ham, pos, kmer_format):
    """(sp_m, dna, rh, ham, pos) int32 arrays flipped so positions ascend
    in every lane, as path_dp_blocked takes them."""
    fl = lambda a: np.ascontiguousarray(_flip(a, kmer_format)).astype(I32)
    sp_m = np.where(_flip(sel, kmer_format), _flip(species, kmer_format), -1)
    return (sp_m.astype(I32), fl(dna), fl(rh), fl(ham), fl(pos))


def torch_blocked(case, min_cons, min_cons_euk, S, kf, dyn_gap, block_w,
                  compact5, device="cpu", fn=dp_cuda.path_dp_blocked):
    """Runs fn (the wrapper, or its plain version) on the case's flipped
    inputs on `device`; returns (cols, valid, blk_over) on the host."""
    ins = [torch.from_numpy(a).to(device)
           for a in flipped_inputs(*case, kf)]
    cols, valid, over = fn(
        *ins, min_cons=min_cons, min_cons_euk=min_cons_euk, max_shift=S,
        kmer_format=kf, dyn_gap=dyn_gap, block_w=block_w, compact5=compact5)
    return cols.cpu().numpy(), valid.cpu().numpy(), int(over)
