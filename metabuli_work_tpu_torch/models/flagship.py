"""The device step: fused extract + probe + path DP for one read batch,
and the best-species redundancy step that follows host scoring.

fused_step_dp is everything the device does per batch of single-end
reads on the host-scoring flow; the host then scores species from the
emitted paths and hands the best species per read back to
redundancy_counts.
"""

import torch

from ..ops import dp_cuda, dp_torch, encode_torch, match_torch


def _dyn_gap(syncmer, kmer_format, win_frac):
    return bool(syncmer and kmer_format == 2 and 0 < win_frac < 256)


def _extract_all(reads1, lens1, ra1, *, syncmer, smer_len, kmer_format,
                 win_frac):
    """Query extraction: 6-frame metamer encode + optional syncmer window
    compaction.

    Returns flat (qk, qp, qf, qs, qv) query tensors, the [B, 6, W]
    shape, and the window-compaction overflow count."""
    # syncmer window compaction: only ~half the windows pass the anchor
    # rule — shrink the W axis to win_frac/256 of its static size before
    # probing (the dyn_gap path DP chains compacted slots by real
    # position gaps).  win_frac == 0 or >= 256 disables compaction.
    dyn_gap = _dyn_gap(syncmer, kmer_format, win_frac)
    kk, pp, vv = encode_torch.extract_batch(reads1, lens1, syncmer=syncmer,
                                            smer_len=smer_len,
                                            kmer_format=kmer_format,
                                            reads_ra=ra1)
    win_over = torch.zeros((), dtype=torch.int32, device=reads1.device)
    if dyn_gap:
        W = kk.shape[2]
        w_c = max(min((W * win_frac + 255) // 256, W), 1)
        kk, pp, vv, win_over = encode_torch.compact_windows(kk, pp, vv, w_c)
    b = reads1.shape[0]
    sids = torch.arange(1, b + 1, dtype=torch.int32, device=reads1.device)
    qk, qp, qf, qs, qv = encode_torch.flatten_batch(kk, pp, vv, sids)
    return qk, qp, qf, qs, qv, tuple(kk.shape), win_over


def _dp_from_probe(out, qp, qs, shape, win_over, *, cap, kmer_format,
                   syncmer, smer_len, min_cons, min_cons_euk, path_width,
                   path_block, win_frac, compact5):
    """Post-probe half of the fused step: lane flip + fused path DP (the
    CUDA kernel on the card, its plain version on the CPU) + static-width
    compaction of the emitted paths."""
    B, F, W = shape
    resh = lambda a: a.reshape(cap, B * F, W)
    fl = lambda a: dp_torch.flip_lanes(a, kmer_format).contiguous()
    # the euk flag rides in species bit 30 straight through the DP's
    # species-equality compares (the bit is constant per species); the
    # DP strips it at emission
    sp_m = torch.where(resh(out["sel"]), resh(out["species"]), -1)
    pos = qp.reshape(1, B * F, W).expand(cap, B * F, W)
    cols, psel, blk_over = dp_cuda.path_dp_blocked(
        fl(sp_m), fl(resh(out["dna_enc"])), fl(resh(out["rh"])),
        fl(resh(out["hamming"])), fl(pos),
        min_cons=min_cons, min_cons_euk=min_cons_euk,
        max_shift=(8 - smer_len) if syncmer else 1, kmer_format=kmer_format,
        dyn_gap=_dyn_gap(syncmer, kmer_format, win_frac),
        block_w=path_block, compact5=compact5)
    paths_packed, paths_count = dp_torch.compact_columns(
        cols, psel, out_width=path_width)
    resident = (out["sel"], out["species"] & 0x3FFFFFFF, out["hamming"],
                out["taxid"], qp, qs)
    stats = torch.stack([out["overflow"], paths_count, win_over, blk_over])
    return stats, paths_packed, resident


def fused_step_dp(reads1, lens1, db_quad, *, min_cons: int = 4,
                  min_cons_euk: int = 9, cap: int = 16, kmer_format: int = 2,
                  syncmer: bool = False, smer_len: int = 5,
                  path_width: int = 0, win_frac: int = 0,
                  path_block: int = 16, ra1=None, hash_table=None,
                  hash_log2_rows: int = 0, hash_chain: int = 0,
                  db_m: int = None):
    """extract -> probe -> path DP -> compaction for one single-end batch.

    Returns (packed_hdr [C, 1+P] int32, resident): column 0 of packed_hdr
    is a stats header (rows 0-3 = candidate-cap overflow, path count,
    window-compaction overflow, blocked-packer lane overflow), columns
    1..P the compacted path columns; resident = (sel, species, ham, ef,
    q_pos, q_sids) stays on the device for redundancy_counts.  The header
    rides in the path array so one device->host copy brings both home.
    """
    qk, qp, qf, qs, qv, shape, win_over = _extract_all(
        reads1, lens1, ra1, syncmer=syncmer, smer_len=smer_len,
        kmer_format=kmer_format, win_frac=win_frac)
    out = match_torch.match_kmers_quad(
        qk, qf, qv, db_quad, cap=cap, kmer_format=kmer_format,
        hash_table=hash_table, hash_log2_rows=hash_log2_rows,
        hash_chain=hash_chain, db_m=db_m)
    # compact 5-column path layout when every 16-bit field provably
    # fits (g < 2^16, end+26 < 2^16, path hamming < 2^16)
    b = reads1.shape[0]
    compact5 = (b * 6 < (1 << 16)) and (reads1.shape[1] < (1 << 14))
    stats, paths_packed, resident = _dp_from_probe(
        out, qp, qs, shape, win_over, cap=cap, kmer_format=kmer_format,
        syncmer=syncmer, smer_len=smer_len, min_cons=min_cons,
        min_cons_euk=min_cons_euk, path_width=path_width,
        path_block=path_block, win_frac=win_frac, compact5=compact5)
    hdr = torch.zeros((paths_packed.shape[0], 1), dtype=torch.int32,
                      device=paths_packed.device)
    hdr[:4, 0] = stats.to(torch.int32)
    return torch.cat([hdr, paths_packed], 1), resident


def part_widths(lmax1, syncmer, kmer_format, smer_len, win_frac):
    """Per-read flat slot count (6 frames x compacted windows); the
    redundancy step rebuilds read ids from it by broadcast."""
    W = encode_torch.max_windows(lmax1)
    if _dyn_gap(syncmer, kmer_format, win_frac):
        W = max(min((W * win_frac + 255) // 256, W), 1)
    return (6 * W,)


def _lca_pair_lift(a, b, depth, lift):
    """Vectorized pairwise LCA via binary lifting (~2*levels gathers)."""
    levels = lift.shape[0]
    a, b = a.to(torch.int64), b.to(torch.int64)
    da, db = depth[a], depth[b]
    swap = db > da
    x = torch.where(swap, b, a)            # deeper node
    y = torch.where(swap, a, b)
    diff = (da - db).abs()
    for k in range(levels):
        x = torch.where((diff >> k) & 1 == 1, lift[k][x].to(torch.int64), x)
    eq = x == y
    for k in range(levels - 1, -1, -1):
        lx, ly = lift[k][x].to(torch.int64), lift[k][y].to(torch.int64)
        go = lx != ly
        x = torch.where(go, lx, x)
        y = torch.where(go, ly, y)
    return torch.where(eq, x, lift[0][x].to(torch.int64))


def redundancy_counts(sel, species, ham, ef, q_pos, q_sids,
                      best_sp_per_read, euler, depth, lift, *,
                      dna_shift: int, n_quot: int, part_w: tuple = (),
                      out_w: int = 0):
    """Best-species redundancy filter + grouped LCA on the device.

    Groups each read's best-species matches by query pos // dna_shift,
    keeps the min-hamming rows per group, and reduces each group to one
    LCA taxid — the pairwise LCA of the group's two extremal euler-first
    members, by binary lifting (reference
    Taxonomer::filterRedundantMatches + per-group LCA,
    src/commons/Taxonomer.cpp:219-243).

    out_w > 0 compacts the (rid, lca) pairs into a [2, out_w] prefix;
    the true pair count rides in the stats column, so count > out_w
    tells the caller to re-run wider.  Returns [2, 1+width] int32:
    column 0 = (pair_count, best-species match count), then the pairs.
    """
    i32 = torch.int32
    dev = sel.device
    cap, N = sel.shape
    B = best_sp_per_read.shape[0] - 1
    n_groups = B * n_quot
    BIG = 0x7FFFFFFF

    if part_w and sum(part_w) * B == N:
        # per-slot read index and best species rebuilt by broadcast
        best1 = best_sp_per_read[1:]
        r0 = torch.cat([torch.arange(B, dtype=i32, device=dev)[:, None]
                        .expand(B, w).reshape(B * w) for w in part_w])
        want = torch.cat([best1[:, None].expand(B, w).reshape(B * w)
                          for w in part_w])
    else:
        r0 = q_sids - 1
        want = best_sp_per_read[q_sids.to(torch.int64)]
    sel2 = sel & (species == want[None, :]) & (want[None, :] > 0)

    quot = torch.clamp(torch.div(q_pos, dna_shift, rounding_mode="floor"),
                       0, n_quot - 1)
    gidx = (r0.to(torch.int64) * n_quot + quot.to(torch.int64))

    # packed-key reduction: (hamming, euler_first) lexicographic mins in
    # ONE int32 key — ham <= 32 (6 bits) rides above a 25-bit ef, so one
    # scatter-min yields the group's min hamming AND the min ef among
    # min-hamming rows; a second key with ef complemented yields the
    # max ef.  ef < 2^25 holds for every supported taxonomy.
    EFM = (1 << 25) - 1
    hk = ham.to(i32) << 25
    k1 = torch.where(sel2, hk | ef, BIG).to(i32)
    k2 = torch.where(sel2, hk | (EFM - ef), BIG).to(i32)
    s1 = k1.min(0).values
    s2 = k2.min(0).values
    # out-of-range group ids are dropped (mode="drop" of the scatter-min)
    keep = (gidx >= 0) & (gidx < n_groups)
    gd = torch.where(keep, gidx, n_groups)
    g1 = torch.full((n_groups + 1,), BIG, dtype=i32, device=dev)
    g2 = torch.full((n_groups + 1,), BIG, dtype=i32, device=dev)
    g1 = g1.scatter_reduce(0, gd, s1, reduce="amin")[:n_groups]
    g2 = g2.scatter_reduce(0, gd, s2, reduce="amin")[:n_groups]
    fmin = g1 & EFM
    fmax = EFM - (g2 & EFM)

    gvalid = g1 < BIG
    ne = euler.shape[0]
    a = euler[torch.clamp(fmin, 0, ne - 1).to(torch.int64)]
    b = euler[torch.clamp(fmax, 0, ne - 1).to(torch.int64)]
    lca = _lca_pair_lift(a, b, depth, lift)

    rid = torch.div(torch.arange(n_groups, device=dev), n_quot,
                    rounding_mode="floor") + 1
    cols = torch.stack([rid.to(i32), lca.to(i32)])
    packed, count = dp_torch.compact_columns(cols, gvalid, out_width=out_w)
    stats = torch.stack([count, sel2.sum().to(i32)])
    return torch.cat([stats[:, None], packed], 1)
