"""Seeded inputs of the redundancy step (flagship.redundancy_counts) for
the CPU and card tests: random trees of a chosen lifting depth and
candidate tensors in the layouts the flows give the step.

case(kind, levels, out_w) -> (args, kw): args the ten tensors (CPU,
int32, sel bool) in redundancy_counts' order, kw its keywords.  Kinds:
- "single": one part of 6 x W slots a read (the part_w broadcast);
- "paired": two parts of different widths (mate 1, mate 2);
- "long": a few reads of thousands of windows, many groups a read;
- "sids": a part_w that does not cover N, so read ids come from q_sids
  (0 among them: a slot of no read);
- "empty": no candidate selected;
- "want0": every other read without a best species;
- "clamp": query positions below 0 and beyond the last group, clamped
  to the first and last group of the read;
- "ef-high": euler-first indices near 2^25, clamped to the tour's end.
Every kind holds hamming values up to 40 (keys whose top bits are set)
and ties of hamming within a group."""

import numpy as np
import torch

KINDS = ("single", "paired", "long", "sids", "empty", "want0", "clamp",
         "ef-high")
EFM = (1 << 25) - 1


def tables(levels, seed=0, n=40):
    """(euler, depth, lift) int32 numpy of a random tree whose lifting
    table has `levels` rows (the rule of Taxonomy.lca_lift_tables: the
    least levels with 2^(levels - 1) > max depth); levels 1 is a lone
    root."""
    rng = np.random.default_rng(seed)
    max_d = 0 if levels == 1 else (1 << (levels - 2))
    n = 1 if levels == 1 else max(n, max_d + 1)
    parent = np.zeros(n, np.int64)
    depth = np.zeros(n, np.int64)
    for v in range(1, n):
        if v <= max_d:                    # a spine reaching max_d
            parent[v] = v - 1
        else:
            parent[v] = rng.integers(0, v)
            while depth[parent[v]] >= max_d:
                parent[v] = parent[parent[v]]
        depth[v] = depth[parent[v]] + 1
    assert depth.max() == max_d
    lv = max(int(np.ceil(np.log2(max_d + 1))) + 1, 1)
    assert lv == levels, (lv, levels)
    lift = np.zeros((levels, n), np.int64)
    lift[0] = parent
    for k in range(1, levels):
        lift[k] = lift[k - 1][lift[k - 1]]
    children = [[] for _ in range(n)]
    for v in range(1, n):
        children[parent[v]].append(v)
    euler, stack = [], [(0, 0)]
    while stack:                          # iterative Euler tour
        v, i = stack.pop()
        euler.append(v)
        if i < len(children[v]):
            stack.append((v, i + 1))
            stack.append((children[v][i], 0))
    return (np.array(euler, np.int32), depth.astype(np.int32),
            lift.astype(np.int32))


def case(kind, levels=4, out_w=0, seed=0, reads=None):
    """(args, kw) of one case (module docstring); `reads` sets the batch
    size of the kind (the cells' 1,024 on the card)."""
    rng = np.random.default_rng([seed, KINDS.index(kind), levels])
    euler, depth, lift = tables(levels, seed)
    cap, dna_shift = 6, 9
    if kind == "long":
        B, lmax = 3, (2400,)
        cap = 8
    elif kind == "paired":
        B, lmax = 10, (60, 48)
    else:
        B, lmax = 12, (60,)
    B = reads or B
    W = [lm // 3 for lm in lmax]
    part_w = tuple(6 * w for w in W)
    N = B * sum(part_w)
    n_quot = (sum(lmax) + 3 * (len(lmax) - 1)) // dna_shift + 2
    # positions: window w of a read's part at 3w (+ mate 1's offset)
    pos, sids = [], []
    off = 0
    for w, lm in zip(W, lmax):
        p = np.tile(np.repeat(np.arange(w) * 3, 6), B) + off
        pos.append(p)
        sids.append(np.repeat(np.arange(1, B + 1), 6 * w))
        off += lm + 3
    q_pos = np.concatenate(pos)
    q_sids = np.concatenate(sids)
    if kind == "clamp":
        q_pos = q_pos + rng.integers(-40, 40, N)
        q_pos[rng.random(N) < 0.1] = n_quot * dna_shift + 50
    species_pool = np.array([3, 5, 7, 11], np.int32)
    sel = rng.random((cap, N)) < (0 if kind == "empty" else 0.35)
    species = rng.choice(species_pool, (cap, N)).astype(np.int32)
    ham = rng.integers(0, 4, (cap, N))
    ham[rng.random((cap, N)) < 0.05] = 40     # keys past bit 31
    ef = rng.integers(0, len(euler), (cap, N))
    if kind == "ef-high":
        hi = rng.random((cap, N)) < 0.3
        ef[hi] = EFM - rng.integers(0, 4, int(hi.sum()))
    best = np.zeros(B + 1, np.int32)
    best[1:] = rng.choice(species_pool, B)
    if kind == "want0":
        best[1::2] = 0
    kw = dict(dna_shift=dna_shift, n_quot=n_quot, part_w=part_w,
              out_w=out_w)
    if kind == "sids":
        q_sids = rng.integers(0, B + 1, N)
        kw["part_w"] = part_w[:1] if len(part_w) > 1 else (part_w[0] + 6,)
    def t(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt)

    args = (t(sel, torch.bool), t(species), t(ham), t(ef), t(q_pos),
            t(q_sids), t(best), t(euler), t(depth), t(lift))
    return args, kw


def same_prefix(got, ref):
    """got equal to ref (a redundancy_counts_ref result) on the stats
    column and the first min(count, width) pairs; returns the count."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    count = int(ref[0, 0])
    k = 1 + min(count, ref.shape[1] - 1)
    assert torch.equal(got[:, :k].cpu(), ref[:, :k])
    return count
