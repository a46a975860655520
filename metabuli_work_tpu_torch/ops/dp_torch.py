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


def _score_increment(rh, shift, max_shift: int):
    s = torch.zeros(rh.shape, dtype=torch.float32, device=rh.device)
    for i in range(max_shift):
        inc = _codon_score((rh >> (i * 2)) & 3)
        s = torch.where(i < shift, s + inc, s)
    return s


def _ham_increment(rh, shift, max_shift: int):
    s = torch.zeros(rh.shape, dtype=torch.int32, device=rh.device)
    for i in range(max_shift):
        s = s + torch.where(i < shift, (rh >> (i * 2)) & 3, 0).to(torch.int32)
    return s


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
    """path_dp on lanes already flipped so positions ascend."""
    cap, G, W = sel.shape
    S = max_shift
    dev = sel.device
    i32 = torch.int32
    score0 = _match_scores(rh)
    sp_m = torch.where(sel, species, _NO_SPECIES)
    fwd_g = (torch.arange(G, device=dev) % 6 < 3)[None, None, :]

    def zeros(dt=i32):
        return torch.zeros((cap, G), dtype=dt, device=dev)

    # ring: S states, newest first; each a dict of [cap, G] tensors
    states = [dict(sp=zeros() - 1, dna=zeros(),
                   score=zeros(torch.float32), depth=zeros(), ham=zeros(),
                   start=zeros(), rhs=zeros(), rhe=zeros(),
                   conn=zeros(torch.bool), pos=zeros(), md=zeros())
              for _ in range(S)]
    emitted = []

    def step(sel_w, sp_w, dna_w, rh_w, ham_w, pos_w, score_w, md_w):
        cur_sp = sp_w[None]
        nd = dna_w[None]
        found = zeros(torch.bool)
        any_ok = zeros(torch.bool)
        shift_sel = zeros()
        b_score = zeros(torch.float32)
        b_depth, b_ham, b_start, b_rhs = zeros(), zeros(), zeros(), zeros()
        for s, st in enumerate(states):
            p_sp = st["sp"]
            # the predecessor window is the NEAREST one containing the
            # candidate's species; consecutiveness is checked there only
            same_sp = (p_sp[:, None] == cur_sp) & (p_sp[:, None] >= 0)
            has_sp = same_sp.any(0)
            use_s = has_sp & ~found & sel_w
            found = found | has_sp
            cd = st["dna"][:, None]
            if dyn_gap:
                # every state row holds the same window pos: row 0 is
                # representative
                gapv = torch.div(pos_w - st["pos"][0][None, :], 3,
                                 rounding_mode="floor")
                ok_gap = (gapv >= 1) & (gapv <= S)
                shv = torch.clamp(gapv, 1, S).to(i32)
                sh3 = (3 * shv)[None]
                mask24 = (1 << (24 - sh3)) - 1
            else:
                shv = s + 1
                ok_gap = None
                sh3 = 3 * (s + 1)
                mask24 = (1 << (24 - sh3)) - 1
            if kmer_format == 2:
                ok_f = (cd & mask24) == (nd >> sh3)
                ok_r = (nd & mask24) == (cd >> sh3)
            else:
                ok_f = (cd >> sh3) == (nd & mask24)
                ok_r = (nd >> sh3) == (cd & mask24)
            ok = torch.where(fwd_g, ok_f, ok_r) & same_sp & use_s[None]
            if ok_gap is not None:
                ok = ok & ok_gap[None]

            aok = ok.any(0)
            cand = torch.where(ok, st["score"][:, None], -1.0)
            best = cand.max(0).values
            # first strict max in the pre-sorted (hamming, dna) cap order
            oh = ok & (cand >= best[None])
            first = oh.to(i32).argmax(0)                    # [cap, G]
            pick = lambda a: torch.gather(a, 0, first)
            any_ok = any_ok | aok
            shift_sel = torch.where(aok, shv, shift_sel)
            b_score = torch.where(aok, best, b_score)
            b_depth = torch.where(aok, pick(st["depth"]), b_depth)
            b_ham = torch.where(aok, pick(st["ham"]), b_ham)
            b_start = torch.where(aok, pick(st["start"]), b_start)
            b_rhs = torch.where(aok, pick(st["rhs"]), b_rhs)
            st["conn"] = st["conn"] | ok.any(1)

        inc = _score_increment(rh_w, shift_sel, S)
        hinc = _ham_increment(rh_w, shift_sel, S)
        n_score = torch.where(any_ok, b_score + inc, score_w)
        n_depth = torch.where(any_ok, b_depth + shift_sel, 1).to(i32)
        n_ham = torch.where(any_ok, b_ham + hinc, ham_w).to(i32)
        n_start = torch.where(any_ok, b_start, pos_w)
        n_rhs = torch.where(any_ok, b_rhs, rh_w)

        r = states[S - 1]                           # retire the oldest
        emitted.append({
            "emit": (r["sp"] >= 0) & ~r["conn"] & (r["depth"] >= r["md"]),
            # strip the euk flag (species bit 30) at emission
            "species": r["sp"] & 0x3FFFFFFF,
            "start": r["start"],
            "end": r["pos"] + 23,
            "score": r["score"],
            "hamming": r["ham"],
            "depth": r["depth"],
            "rh_start": r["rhs"],
            "rh_end": r["rhe"],
        })
        new = dict(sp=torch.where(sel_w, sp_w, _NO_SPECIES).to(i32),
                   dna=dna_w, score=n_score, depth=n_depth, ham=n_ham,
                   start=n_start, rhs=n_rhs, rhe=rh_w, conn=zeros(torch.bool),
                   pos=pos_w, md=md_w)
        states.insert(0, new)
        states.pop()

    for w in range(W):
        step(sel[:, :, w], sp_m[:, :, w], dna[:, :, w], rh[:, :, w],
             ham[:, :, w], pos[:, :, w], score0[:, :, w], min_depth[:, :, w])
    # flush S empty windows to retire the rest
    zb, zi = zeros(torch.bool), zeros()
    for _ in range(S):
        step(zb, zi - 1, zi, zi, zi, zi, zeros(torch.float32), zi)
    return {k: torch.stack([e[k] for e in emitted]) for k in emitted[0]}


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
    packed = torch.zeros_like(cols)
    packed[:, dest[sel]] = cols[:, sel]
    to_last = ~sel | (dest == total - 1)
    if total and bool(to_last.any()):
        last = int(torch.where(to_last, idx, -1).max())
        packed[:, total - 1] = cols[:, last]
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
