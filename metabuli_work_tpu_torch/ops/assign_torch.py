"""Device-side species scoring + tie/LCA assignment (torch operators).

On-device counterpart of the host scoring flow (classify/taxonomer_vec.py
score_paths + _combine_paths_batch), i.e. the reference's
combineMatchPaths + the species-selection part of chooseBestTaxon
(src/commons/Taxonomer.cpp:410-468 and :130-202).  With it the emitted
paths stay on the device and one [6, B+1] int32 record table goes home
beside the redundancy pair list.

Bit-identity contract with the host flow (tests/test_torch_assign.py):
* per-(read, species) run order = the host's packed-key stable argsort
  by (qid, species, frame, end) — reproduced by stable sorts over keys
  packed into int64, last key first, so that the flat compaction index
  (the host argsort's stability tiebreak) decides last;
* within-run combine order = stable sort by (-score, hamming, -start)
  (float(p.score) is an exact f32->f64 cast, so descending f32 bit
  order is identical);
* greedy accept/trim replay accumulates f32 scores in acceptance order
  (reference Taxonomer.cpp:417-468, trimMatchPath :475-485);
* the per-read tie total accumulates tied run scores in run order with
  sequential f32 adds;
* tie threshold = f32(f64(best) * tie_ratio) (host: float(best) *
  self.tie_ratio then f32 compare), and the min_score compares are f64.

Every scatter writes each kept destination once (rows to drop go to one
cut-off slot), integer sums use index_add_, and no float sum is left to
unordered atomics, so the result is deterministic on CUDA.
"""

import torch

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64
BIGI = 0x7FFFFFFF


def _part_score_prefix(rh, left: bool):
    """[..., 9] f32 for `rh` of any shape: entry r = the score of the
    first r codons of the 16-bit packed per-codon hamming field (right
    part), or of the last r (left part) — taxonomer._right/_left_part_score, reference
    Match.h:46-79.  Per-codon scores are multiples of 0.5 and a part sums
    to at most 24, so every partial sum is exact in f32 in any order: the
    sum runs in integer half-units (6, 3, 2, 1 by hamming code)."""
    i = torch.arange(8, device=rh.device, dtype=I32)
    sh = (14 - 2 * i) if left else 2 * i
    h = (rh[..., None] >> sh) & 3
    halves = torch.where(h == 0, 6, 4 - h)     # 3.0, 1.5, 1.0, 0.5
    pre = torch.zeros((*rh.shape, 9), dtype=I32, device=rh.device)
    pre[..., 1:] = torch.cumsum(halves, -1, dtype=I32)
    return pre.to(F32) * 0.5


def _combine_runs(cs0, ce0, sc0, rhs0, rhe0, vrk, K: int, n_ranks: int):
    """Greedy best-score-first path combination with <24 nt overlap
    trimming, vectorized over [R] runs x [K] sorted slots (mirrors
    taxonomer_vec._combine_hard; reference Taxonomer.cpp:410-485).

    Inputs are already in combine order (slot 0 = best path).  Returns
    the f32 score totals in acceptance order.

    Only the first n_ranks <= K candidate ranks run (the longest run of
    the batch; a rank with no valid path would change nothing), and rank
    k walks the at most k slots kept before it: every (rank, slot) pair
    is some 40 operators to enqueue, so the loop costs n_ranks^2 / 2 of
    them whatever the row count.
    """
    R = cs0.shape[0]
    dev = cs0.device
    slot_i = torch.arange(K, dtype=I32, device=dev)[None, :]
    kept_s = torch.zeros((R, K), dtype=I32, device=dev)
    kept_e = torch.zeros((R, K), dtype=I32, device=dev)
    kept_n = torch.zeros(R, dtype=I32, device=dev)
    total = torch.zeros(R, dtype=F32, device=dev)
    pre_r_all = _part_score_prefix(rhe0, left=False)      # [R, K, 9]
    pre_l_all = _part_score_prefix(rhs0, left=True)
    for k in range(n_ranks):
        cs_k, ce_k, sc_k = cs0[:, k], ce0[:, k], sc0[:, k]
        alive = vrk[:, k]
        pre_r, pre_l = pre_r_all[:, k], pre_l_all[:, k]
        for j in range(k):
            cs, ce = kept_s[:, j], kept_e[:, j]
            inter = alive & (kept_n > j) & (ce_k >= cs) & (ce >= cs_k)
            ov = torch.minimum(ce_k, ce) - torch.maximum(cs_k, cs) + 1
            # full cover or >= 24 nt of overlap drops the candidate, a
            # shorter overlap trims it on the side it sticks out
            trim = inter & (ov != ce_k - cs_k + 1) & (ov < 24)
            alive = alive & ~(inter & ~trim)
            left_side = cs_k < cs
            rng = torch.div(ov.clamp(min=0), 3, rounding_mode="floor")
            part = torch.where(left_side[:, None], pre_r, pre_l).gather(
                1, rng.clamp(max=8).to(I64)[:, None])[:, 0]
            sc_k = torch.where(trim, (sc_k - part) - (ov - 3 * rng).to(F32),
                               sc_k)
            trim_l = trim & left_side
            ce_k = torch.where(trim_l, cs - 1, ce_k)
            cs_k = torch.where(trim ^ trim_l, ce + 1, cs_k)
        oh = (slot_i == kept_n[:, None]) & alive[:, None]
        kept_s = torch.where(oh, cs_k[:, None], kept_s)
        kept_e = torch.where(oh, ce_k[:, None], kept_e)
        kept_n = kept_n + alive.to(I32)
        total = torch.where(alive, total + sc_k, total)
    return total


def _scatter_drop(size: int, dest, src, fill=0):
    """zeros(size).at[dest].set(src, mode="drop"): destinations equal to
    `size` fall into a cut-off slot."""
    out = torch.full((size + 1,), fill, dtype=src.dtype, device=src.device)
    out[dest.to(I64)] = src
    return out[:size]


def device_assign(paths_packed, n_paths, qlens, ef_node, euler, depth, lift,
                  min_score: float, tie_ratio: float, combine_k: int):
    """Score species and pick per-read classifications on the device.

    paths_packed: [5, P] int32 compact5 path columns (g<<16|start,
    end<<16|rh_start, rh_end<<16|ham, species, score_bits); rows past
    ``n_paths`` (a 0-d tensor) are junk (masked here).
    qlens: [B+1] int32 total read length per 1-based read id.
    ef_node: [n_nodes] int32 euler-first coordinate per taxid;
    euler/depth/lift: the LCA tables redundancy_counts uses.

    Returns (records [6, B+1] int32, best_sp [B+1] int32, over_k int32):
      row 0 live, 1 tie_cnt, 2 total f32 bits, 3 tied-set LCA,
      4 first tied species, 5 top (first kept) species.
    best_sp = first_tied for single-tie reads passing min_score — the
    redundancy step's input.  over_k counts paths beyond combine_k in
    their run (the host doubles combine_k and re-runs).

    Waits for the device twice, for the two loops whose trip count is a
    device value: the longest (read, species) run bounds the combine
    ranks, the most tied runs of any read the tie-total rounds.
    """
    from ..models.flagship import _lca_pair_lift

    if paths_packed.shape[0] != 5:
        raise ValueError("device_assign reads the 5-column path layout, got "
                         f"{paths_packed.shape[0]} columns")
    dev = paths_packed.device
    P = paths_packed.shape[1]
    B1 = qlens.shape[0]
    K = combine_k

    # int32 right shifts are arithmetic: mask every unpacked field
    u0, u1, u2 = paths_packed[0], paths_packed[1], paths_packed[2]
    g = (u0 >> 16) & 0xFFFF
    start = u0 & 0xFFFF
    end = (u1 >> 16) & 0xFFFF
    rhs = u1 & 0xFFFF
    rhe = (u2 >> 16) & 0xFFFF
    ham = u2 & 0xFFFF
    sp = paths_packed[3]
    sb = paths_packed[4]                       # f32 bits, non-negative
    qid = torch.div(g, 6, rounding_mode="floor") + 1
    frame = g % 6
    iota = torch.arange(P, dtype=I32, device=dev)
    valid = iota < n_paths

    # ---- the 6-key sort (qid, species, -score, ham|-start, frame|end,
    # index) = host (qid, species, frame, end) argsort + per-run stable
    # (-score, ham, -start) combine sort: three stable sorts over int64
    # keys, last key first.  The keys are int32 compares in the host
    # flow; k_hs = (ham << 16) | (0xFFFF - start) is signed there, so it
    # is biased by 2^31 before it rides in the low word.
    k_qid = torch.where(valid, qid, BIGI)
    k_sc = BIGI - sb                           # descending f32 bit order
    k_hs = (ham << 16) | (0xFFFF - start)      # ham asc, start desc
    k_fe = (frame << 16) | end                 # host insertion tiebreak
    perm = torch.sort(k_fe, stable=True).indices
    key2 = (k_sc.to(I64) << 32) | (k_hs.to(I64) + (1 << 31))
    perm = perm[torch.sort(key2[perm], stable=True).indices]
    key1 = (k_qid.to(I64) << 31) | sp.to(I64)
    perm = perm[torch.sort(key1[perm], stable=True).indices]
    qid_s, sp_s, cs_s, ce_s, sb_s, rhs_s, rhe_s, kq_s = (
        a[perm] for a in (qid, sp, start, end, sb, rhs, rhe, k_qid))
    valid_s = valid                            # invalids sort to the end

    # run boundary: (qid, species) change
    new_run = valid_s & ((iota == 0) | (kq_s != torch.roll(kq_s, 1))
                         | (sp_s != torch.roll(sp_s, 1)))
    run_id = torch.cumsum(new_run.to(I32), 0).to(I32) - 1
    seg_start = torch.cummax(torch.where(new_run, iota, 0), 0).values
    k_in = iota - seg_start
    over_k = (valid_s & (k_in >= K)).sum().to(I32)

    # ---- run-space arrays (indexed by run_id, width P) --------------- #
    dest0 = torch.where(new_run, run_id, P)
    sp_run = _scatter_drop(P, dest0, sp_s)
    qid_run = _scatter_drop(P, dest0, qid_s)
    pos_run = _scatter_drop(P, dest0, iota)
    sc1_run = _scatter_drop(P, dest0, sb_s)
    v_run = _scatter_drop(P, dest0, torch.ones_like(iota)) != 0

    # ---- multi-path runs only go through the combine loop ------------ #
    # single-path runs (the vast majority) need no greedy: total = score.
    # Multi-path runs are compacted into an R2 = P // 2 row space (every
    # such run holds >= 2 paths, so their count can never exceed P // 2),
    # shrinking every [rows, K] tensor the combine loop touches.
    R2 = max(P // 2, 1)
    ge2_run = _scatter_drop(P, torch.where(valid_s & (k_in == 1), run_id, P),
                            torch.ones_like(iota))
    multi_id_run = torch.cumsum(ge2_run, 0).to(I32) - 1   # run -> R2 space
    run_c = run_id.clamp(0, P - 1).to(I64)
    row_multi = ge2_run[run_c] != 0
    dest = torch.where(valid_s & row_multi & (k_in < K),
                       multi_id_run[run_c] * K + k_in, R2 * K)

    def pack(a):
        return _scatter_drop(R2 * K, dest, a).reshape(R2, K)

    n_ranks = min(int(torch.where(valid_s, k_in, 0).max()) + 1, K)
    total_multi = _combine_runs(pack(cs_s), pack(ce_s),
                                pack(sb_s.view(F32)), pack(rhs_s),
                                pack(rhe_s), pack(valid_s), K, n_ranks)
    total_run = torch.where(
        ge2_run != 0,
        total_multi[multi_id_run.clamp(0, R2 - 1).to(I64)],
        sc1_run.view(F32))
    qr = qid_run.clamp(0, B1 - 1).to(I64)
    qlen_f = qlens[qr].to(F32)
    sc = torch.clamp(total_run / torch.clamp(qlen_f, min=1.0), max=1.0)

    # ---- per-read selection (host _score_paths_vec semantics) ------- #
    # min_score compares happen in f64 (host: f32 array vs Python float
    # promotes to f64); a f32-cast threshold would flip edge cases
    keep = v_run & ~(sc.to(F64) < min_score)

    def count(mask):
        return torch.zeros(B1, dtype=I32, device=dev).index_add_(
            0, qr, mask.to(I32))

    def reduce(fill, src, how):
        return torch.full((B1,), fill, dtype=src.dtype, device=dev) \
            .scatter_reduce_(0, qr, src, how)

    meaningful = count(keep & (sc > 0))
    kept_cnt = count(keep)
    ninf = float("-inf")
    best = reduce(ninf, torch.where(keep, sc, ninf), "amax")
    thr = (best.to(F64) * tie_ratio).to(F32)
    tied = keep & (sc >= thr[qr])
    tie_cnt = count(tied)

    # ordered f32 tie total: round k adds each read's k-th tied run (at
    # most one non-zero score per read a round, so the adds of one round
    # commute and the rounds keep run order)
    c = torch.cumsum(tied.to(I32), 0).to(I32)
    read_base = reduce(BIGI, torch.where(v_run, c - tied.to(I32), BIGI),
                       "amin")
    rank = torch.where(tied, c - 1 - read_base[qr], -1)
    total = torch.zeros(B1, dtype=F32, device=dev)
    for k in range(max(int(rank.max()) + 1, 0)):    # the second wait
        total.index_add_(0, qr, torch.where(rank == k, sc, 0.0))

    # tied-set LCA via extremal euler-first coords (set-LCA = pairwise
    # LCA of the min/max members, as in redundancy_counts)
    ef = ef_node[sp_run.clamp(0, ef_node.shape[0] - 1).to(I64)]
    emin = reduce(BIGI, torch.where(tied, ef, BIGI), "amin")
    emax = reduce(-1, torch.where(tied, ef, -1), "amax")
    ne = euler.shape[0]
    lca = _lca_pair_lift(euler[emin.clamp(0, ne - 1).to(I64)],
                         euler[emax.clamp(0, ne - 1).to(I64)],
                         depth, lift).to(I32)

    # first tied / first kept species (min flat position)
    ft_pos = reduce(BIGI, torch.where(tied, pos_run, BIGI), "amin")
    top_pos = reduce(BIGI, torch.where(keep, pos_run, BIGI), "amin")
    first_tied = torch.where(ft_pos < BIGI,
                             sp_s[ft_pos.clamp(0, P - 1).to(I64)], 0)
    top_sp = torch.where(top_pos < BIGI,
                         sp_s[top_pos.clamp(0, P - 1).to(I64)], 0)

    live = (kept_cnt > 0) & (meaningful > 0)
    deferred = live & (tie_cnt == 1) & (total != 0) \
        & ~(total.to(F64) < min_score)
    best_sp = torch.where(deferred, first_tied, 0)

    records = torch.stack([
        live.to(I32), tie_cnt, total.view(I32),
        torch.where(live & (tie_cnt > 1), lca, 0),
        first_tied, top_sp,
    ])
    return records, best_sp, over_k
