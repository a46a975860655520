"""Consecutive-match path DP (the scoring hot loop) in plain torch.

Taxonomer::getMatchPaths (reference src/commons/Taxonomer.cpp:487-648)
over the probe's [cap, G, W] candidate tensors: G = read*frame lanes
(g % 6 = frame; chains never cross lanes), W = windows, cap =
candidates per window.  Window index maps linearly to query position,
so "consecutive pos groups" becomes a ring of the last max_shift
windows scanned in order.  Per window, every candidate finds its
species' nearest predecessor window, checks the shifted DNA-encoding
consecutiveness rule (isConsecutive2 / isConsecutive,
Taxonomer.cpp:671-699), takes the best-score predecessor (first strict
max in the reference's (hamming, dnaEncoding) candidate order) and
extends score/depth/hamming in the reference's f32 accumulation order.
A candidate is emitted as a MatchPath when it retires from the ring
unconnected with depth >= minConsCnt.

Validity domain: minConsCnt >= 2 (then the reference's emission
preconditions are implied).

This is the plain version of the fused CUDA kernel (ops/dp_cuda.py);
path_dp_blocked_ref there is sort_candidates -> path_dp ->
pack_paths_blocked on lane-flipped inputs.  Every f32 add happens one at
a time in the reference order; sorts are stable.
"""

import numpy as np
import torch

_BIGK = 0x7FFFFFFF
_NO_SPECIES = -1


def _codon_score(h):
    """Match::getScore per codon: 3.0 for h == 0, else 2.0 - 0.5 h."""
    return torch.where(h == 0, 3.0, 2.0 - 0.5 * h.to(torch.float32))


def _match_scores(rh):
    """Match::getScore over the 8 codons, reference f32 order."""
    score = torch.zeros(rh.shape, dtype=torch.float32, device=rh.device)
    for cnt in range(8):
        score = score + _codon_score((rh >> (cnt * 2)) & 3)
    return score


def _increments(rh, shift, codon):
    """(score, hamming) added by extending a path by `shift` codons of a
    match's rh: the first `shift` codons' Match::getScore terms added one
    at a time in codon order (f32), and their hamming distances.  codon
    is arange(max_shift) as a [max_shift, 1, 1] tensor."""
    h = (rh[None] >> (2 * codon)) & 3                 # [max_shift, cap, G]
    on = codon < shift[None]
    terms = torch.where(on, _codon_score(h), 0.0)
    s = terms[0]
    for i in range(1, codon.shape[0]):
        s = s + terms[i]            # + 0.0 past `shift` leaves s as it is
    return s, torch.where(on, h, 0).sum(0).to(torch.int32)


def sort_candidates(fields, sel, ham, dna):
    """Stable sort of the leading cap axis by (hamming, dnaEncoding),
    invalid last.

    The reference iterates a pos group's matches in compareMatches order;
    within one (species, frame, pos) that is (hamming, dna) — the
    best-predecessor tie-break depends on it.  "sel"/"ham"/"dna" are
    unpacked from the sorted key, so on unselected lanes they read
    False/127/0xFFFFFF (path_dp never reads them there).
    """
    key = torch.where(sel, (ham << 24) | dna, _BIGK).to(torch.int32)
    key_s, order = torch.sort(key, dim=0, stable=True)
    out = {}
    for name, v in fields.items():
        if name == "sel":
            out[name] = key_s != _BIGK
        elif name == "ham":
            out[name] = key_s >> 24
        elif name == "dna":
            out[name] = key_s & 0xFFFFFF
        else:
            out[name] = torch.gather(v, 0, order)
    return out


def flip_lanes(a, kmer_format: int):
    """Flip the window axis of the lanes whose positions descend with
    window index, so positions ascend everywhere.  Format 2: reverse
    frames descend; legacy format 1 swaps the pos formulas, so forward
    frames descend instead."""
    G = a.shape[1]
    frame = torch.arange(G, device=a.device) % 6
    rev = (frame >= 3) if kmer_format != 1 else (frame < 3)
    return torch.where(rev[None, :, None], a.flip(2), a)


def path_dp(sel, species, dna, rh, ham, pos, min_depth, max_shift: int,
            kmer_format: int, dyn_gap: bool = False):
    """Path DP over [cap, G, W] tensors, cap pre-sorted by (ham, dna).

    min_depth: per-candidate [cap, G, W] (the euk rule is per species).
    dyn_gap=True: the W axis holds COMPACTED windows (syncmer anchors
    only), so the codon shift to lookback state s is recomputed from the
    stored positions ((pos - p_pos) / 3, connectable iff
    1 <= gap <= max_shift).

    Returns a dict of [W+max_shift, cap, G] tensors: emit flag + path
    fields.  Row t >= max_shift corresponds to window t - max_shift.
    """
    fl = lambda a: flip_lanes(a, kmer_format)
    return _path_dp_ascending(fl(sel), fl(species), fl(dna), fl(rh), fl(ham),
                              fl(pos), fl(min_depth), max_shift, kmer_format,
                              dyn_gap)


def _path_dp_ascending(sel, species, dna, rh, ham, pos, min_depth,
                       max_shift: int, kmer_format: int, dyn_gap: bool):
    """path_dp on lanes already flipped so positions ascend.

    One step a window, in window order.  The ring of the last S windows'
    states is held as [S, cap, G] tensors, newest first (ring row s is
    the window s + 1 back), so a step looks into all S at once: a
    candidate connects only within the nearest ring window that holds
    its species, which is the reference's scan of the ring in order.
    The inputs are padded with S empty windows on each side: the ring's
    initial states before the first window, the flush after the last."""
    cap, G, W = sel.shape
    S = max_shift
    dev = sel.device
    i32 = torch.int32

    def padded(a, fill):
        """[W + 2S, cap, G], window-major, S windows of `fill` each side."""
        e = torch.full((S, cap, G), fill, device=dev,
                       dtype=a.dtype if a.dtype in (torch.bool,
                                                    torch.float32) else i32)
        return torch.cat([e, a.permute(2, 0, 1), e])

    sp_p = padded(torch.where(sel, species, _NO_SPECIES).to(i32), _NO_SPECIES)
    sel_p = padded(sel, False)
    dna_p, rh_p, ham_p, pos_p, md_p = (padded(a, 0) for a in
                                       (dna, rh, ham, pos, min_depth))
    score_p = padded(_match_scores(rh), 0.0)
    # the same windows newest first: rows L - t .. L - t + S - 1 of these
    # are windows t - 1 .. t - S, the ring of the step at window t
    L = W + 2 * S
    sp_q, dna_q = sp_p.flip(0), dna_p.flip(0)
    live_q = sp_q >= 0
    pos_q = pos_p[:, 0].flip(0)     # every row of a window holds its pos
    fwd = (torch.arange(G, device=dev) % 6 < 3)[None, None, :, None]
    codon = torch.arange(S, device=dev)[:, None, None]
    if not dyn_gap:
        shv = (codon + 1).to(i32)                        # [S, 1, 1]
        sh3 = (3 * shv)[..., None]                       # [S, 1, 1, 1]
        mask24 = (1 << (24 - sh3)) - 1

    def ring0(dt=i32):
        return torch.zeros((S, cap, G), dtype=dt, device=dev)

    # [S, cap, G] -> [S, 1, G, cap]: the ring's candidates on the
    # innermost axis, which every reduction over them runs along
    ring = lambda a: a.transpose(1, 2)[:, None]
    push = lambda r, new: torch.cat([new[None], r[:-1]])

    # the DP fields of the ring's states (the rest are the padded inputs)
    r_score, r_conn = ring0(torch.float32), ring0(torch.bool)
    r_depth, r_ham, r_start, r_rhs = ring0(), ring0(), ring0(), ring0()
    retired = []
    for t in range(S, S + W + S):
        sel_w, sp_w, dna_w, rh_w, pos_w = (sel_p[t], sp_p[t], dna_p[t],
                                           rh_p[t], pos_p[t])
        q = slice(L - t, L - t + S)
        # [S, cap (this window's candidate), G, cap (ring candidate)]
        same_sp = (ring(sp_q[q]) == sp_w[None, :, :, None]) \
            & ring(live_q[q])
        has_sp = same_sp.any(-1)                         # [S, cap, G]
        use = has_sp & (torch.cumsum(has_sp, 0) == 1) & sel_w[None]
        if dyn_gap:
            gapv = torch.div(pos_w[None] - pos_q[q][:, None, :], 3,
                             rounding_mode="floor")
            ok_gap = (gapv >= 1) & (gapv <= S)
            shv = torch.clamp(gapv, 1, S).to(i32)       # [S, cap, G]
            sh3 = (3 * shv)[..., None]
            mask24 = (1 << (24 - sh3)) - 1
        cd, nd = ring(dna_q[q]), dna_w[None, :, :, None]
        if kmer_format == 2:
            ok_f = (cd & mask24) == (nd >> sh3)
            ok_r = (nd & mask24) == (cd >> sh3)
        else:
            ok_f = (cd >> sh3) == (nd & mask24)
            ok_r = (nd >> sh3) == (cd & mask24)
        ok = torch.where(fwd, ok_f, ok_r) & same_sp & use[..., None]
        if dyn_gap:
            ok = ok & ok_gap[..., None]
        aok = ok.any(-1)                                 # [S, cap, G]
        cand = torch.where(ok, ring(r_score), -1.0)
        best = cand.max(-1).values
        # first strict max in the pre-sorted (hamming, dna) cap order
        first = (ok & (cand >= best[..., None])).to(i32).argmax(-1)
        r_conn = r_conn | ok.any(1).transpose(1, 2)
        # at most one ring row connects a candidate: the nearest
        any_ok = aok.any(0)
        s_of = aok.to(i32).argmax(0)                     # [cap, G]
        flat = s_of * cap + torch.gather(first, 0, s_of[None])[0]

        def pick(r):
            return torch.gather(r.reshape(S * cap, G), 0, flat)

        shift = torch.gather(shv.expand(S, cap, G), 0, s_of[None])[0]
        inc, hinc = _increments(rh_w, shift, codon)
        n_score = torch.where(any_ok, pick(r_score) + inc, score_p[t])
        n_depth = torch.where(any_ok, pick(r_depth) + shift, 1).to(i32)
        n_ham = torch.where(any_ok, pick(r_ham) + hinc, ham_p[t]).to(i32)
        n_start = torch.where(any_ok, pick(r_start), pos_w)
        n_rhs = torch.where(any_ok, pick(r_rhs), rh_w)

        # retire the oldest, then push this window's states
        retired.append((r_score[S - 1], r_depth[S - 1], r_ham[S - 1],
                        r_start[S - 1], r_rhs[S - 1], r_conn[S - 1]))
        r_score, r_depth, r_ham = (push(r_score, n_score),
                                   push(r_depth, n_depth),
                                   push(r_ham, n_ham))
        r_start, r_rhs = push(r_start, n_start), push(r_rhs, n_rhs)
        r_conn = push(r_conn, torch.zeros_like(sel_w))
    # step t retired window t - 2S: padded row t - S
    score, depth, ham, start, rhs, conn = (torch.stack(f)
                                           for f in zip(*retired))
    T = W + S
    return {
        "emit": (sp_p[:T] >= 0) & ~conn & (depth >= md_p[:T]),
        # strip the euk flag (species bit 30) at emission
        "species": sp_p[:T] & 0x3FFFFFFF,
        "start": start,
        "end": pos_p[:T] + 23,
        "score": score,
        "hamming": ham,
        "depth": depth,
        "rh_start": rhs,
        "rh_end": rh_p[:T],
    }


def pack_paths(out):
    """Flatten path_dp output into 7 int32 columns [7, T*cap*G] and the
    emit flags [T*cap*G], unblocked: (cols, sel).

    Columns: 0 g (read*6+frame), 1 species, 2 start, 3 end, 4 score (f32
    bits), 5 hamming<<16 | rh_start, 6 rh_end; flat order (t, j, g), as
    the reference emits paths after the host's (qid, species, frame,
    end) sort (within a tie class only the candidate lane j varies)."""
    T, cap, G = out["emit"].shape
    flat = lambda a: a.reshape(T * cap * G).to(torch.int32)
    g_ids = torch.arange(G, dtype=torch.int32,
                         device=out["emit"].device).expand(T, cap, G)
    cols = torch.stack([
        flat(g_ids), flat(out["species"]), flat(out["start"]),
        flat(out["end"]),
        flat(out["score"].to(torch.float32).view(torch.int32)),
        flat((out["hamming"].to(torch.int32) << 16)
             | out["rh_start"].to(torch.int32)),
        flat(out["rh_end"])])
    return cols, out["emit"].reshape(T * cap * G)


def pack_paths_blocked(out, block_w: int, compact5: bool = False):
    """Per-lane block compaction of path_dp output: [T, cap, G] ->
    (cols [C, block_w*G], valid [block_w*G], blk_over).

    Output flat order is (slot, g) slot-major; within one g, slot order
    equals (t, j) ascending, so downstream tie-breaking follows the
    emission order.  Slots a lane leaves empty hold 0 in every column
    except compact5's column 0, which keeps the lane id (g << 16).

    compact5 packs the 7 logical fields into FIVE int32 columns
    (g|start, end|rh_start, rh_end|hamming 16-bit halves, species,
    score); callers guarantee g < 2^16, positions+26 < 2^16 and path
    hamming < 2^16.  blk_over counts emitted paths dropped because a
    lane had more than block_w; the caller re-runs with a doubled block_w.
    """
    T, cap, G = out["emit"].shape
    dev = out["emit"].device
    R = T * cap
    block_w = min(block_w, R)
    emit = out["emit"].reshape(R, G)
    rank = torch.cumsum(emit.to(torch.int32), 0) - 1
    cnt = rank[-1] + 1
    blk_over = torch.clamp(cnt - block_w, min=0).sum().to(torch.int32)
    # each kept path has a unique (slot, g); the rest land in the extra
    # slot row block_w, which is cut off
    dest = torch.where(emit & (rank < block_w), rank, block_w).to(torch.int64)

    def take(a):
        a = a.reshape(R, G).to(torch.int32)
        buf = torch.zeros((block_w + 1, G), dtype=torch.int32, device=dev)
        buf.scatter_(0, dest, torch.where(dest < block_w, a, 0))
        return buf[:block_w].reshape(block_w * G)

    g_ids = torch.arange(G, dtype=torch.int32,
                         device=dev)[None, :].expand(block_w, G).reshape(-1)
    score_bits = out["score"].to(torch.float32).view(torch.int32)
    start, end = out["start"].to(torch.int32), out["end"].to(torch.int32)
    ham, rhs = out["hamming"].to(torch.int32), out["rh_start"].to(torch.int32)
    rhe = out["rh_end"].to(torch.int32)
    if compact5:
        cols = torch.stack([
            (g_ids << 16) | take(start & 0xFFFF),
            take(((end & 0xFFFF) << 16) | rhs),
            take((rhe << 16) | (ham & 0xFFFF)),
            take(out["species"]),
            take(score_bits),
        ])
    else:
        cols = torch.stack([g_ids, take(out["species"]), take(start),
                            take(end), take(score_bits),
                            take((ham << 16) | rhs), take(rhe)])
    slots = torch.arange(block_w, device=dev)
    valid = (slots[:, None] < cnt[None, :]).reshape(block_w * G)
    return cols, valid, blk_over


def compact_columns(cols, sel, out_width: int = 0):
    """Compact valid rows of [C, N] int32 columns to the front.

    out_width == 0 (or >= N): full-width result [C, N]; rows past the
    valid count hold 0, except the last column, which holds the last
    invalid row (the scatter that routes every invalid row to the last
    column keeps the final one).
    out_width > 0: two-stage compaction — the source row index of every
    kept row is scattered into a width-out_width index column, then each
    payload column is gathered at those indices (unfilled entries read
    row 0).  Rows past out_width are dropped; count still reports the
    true total so callers can detect overflow and re-run wider.
    """
    total = sel.shape[0]
    dev = cols.device
    count = sel.sum().to(torch.int32)
    dest = torch.cumsum(sel.to(torch.int64), 0) - 1
    idx = torch.arange(total, device=dev)
    if out_width and out_width < total:
        Wd = out_width
        d = torch.where(sel & (dest < Wd), dest, Wd)
        src = torch.zeros(Wd + 1, dtype=torch.int64, device=dev)
        src.scatter_(0, d, torch.where(d < Wd, idx, 0))
        return cols[:, src[:Wd]], count
    if not total:
        return torch.zeros_like(cols), count
    # kept rows go to their rank, the rest to a cut-off slot: every
    # destination is written once, and nothing waits for the device
    packed = torch.zeros((cols.shape[0], total + 1), dtype=cols.dtype,
                         device=dev)
    packed[:, torch.where(sel, dest, total)] = cols
    packed = packed[:, :total]
    to_last = ~sel | (dest == total - 1)
    last = torch.where(to_last, idx, -1).max()
    packed[:, total - 1] = torch.where(last >= 0, cols[:, last.clamp(min=0)],
                                       packed[:, total - 1])
    return packed, count


def decode_paths(arr):
    """numpy decode of fetched path columns -> dict of arrays.

    Accepts either the 7-column layout or the compact 5-column layout
    (pack_paths_blocked compact5), distinguished by row count.
    """
    p = np.asarray(arr)
    if p.shape[0] == 5:
        u = p.view(np.uint32) if p.dtype == np.int32 else \
            p.astype(np.int32).view(np.uint32)
        return {
            "g": (u[0] >> 16).astype(np.int64),
            "species": p[3].astype(np.int64),
            "start": (u[0] & 0xFFFF).astype(np.int64),
            "end": (u[1] >> 16).astype(np.int64),
            "score": p[4].view(np.float32) if p[4].dtype == np.int32
            else p[4].astype(np.int32).view(np.float32),
            "hamming": (u[2] & 0xFFFF).astype(np.int64),
            "rh_start": (u[1] & 0xFFFF).astype(np.int64),
            "rh_end": (u[2] >> 16).astype(np.int64),
        }
    return {
        "g": p[0],
        "species": p[1].astype(np.int64),
        "start": p[2].astype(np.int64),
        "end": p[3].astype(np.int64),
        "score": p[4].view(np.float32) if p[4].dtype == np.int32
        else p[4].astype(np.int32).view(np.float32),
        "hamming": (p[5] >> 16).astype(np.int64),
        "rh_start": (p[5] & 0xFFFF).astype(np.int64),
        "rh_end": p[6].astype(np.int64),
    }
