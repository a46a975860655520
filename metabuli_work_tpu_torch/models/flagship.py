"""The device steps: fused extract + probe + path DP for one read batch
(single-end, or paired with mate 2 as a second part), the best-species
redundancy step that follows host scoring, and the host-match step
(extract + raw-array probe + match compaction).

fused_step_dp is everything the device does per batch on the
host-scoring flow; the host then scores species from the emitted paths
and hands the best species per read back to redundancy_counts.  It is
three pieces in a row — extract_queries_step, the probe,
finish_stream_step — and DB-range streaming runs the same pieces with
probe_range_step once per index range in the middle, folding each
range's candidates into accumulators.  fused_step_full is the
device-assign flow: fused_step_dp, then species scoring and tie/LCA
assignment (ops/assign_torch) and the redundancy step on the device, so
that only a [6, B+1] record table and the pair list go home.
fused_step is the device half of the host-match flow (min_cons_cnt < 2,
and the chunks of reads beyond the long-read row cap): it returns the
compacted raw matches and the host runs the whole scorer on them.
reads2=None means unpaired everywhere.

classify_step is the standalone step of the compile checks and dry runs
(extract, flatten and the raw-array probe, returning the per-k-mer match
tensors), and synthetic_db / synthetic_reads make its seeded inputs.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops import (assign_torch, compact_torch, dp_cuda, dp_torch,
                   encode_torch, match_torch)


def _dyn_gap(syncmer, kmer_format, win_frac):
    return bool(syncmer and kmer_format == 2 and 0 < win_frac < 256)


def _max_covered_dev(lens):
    """getMaxCoveredLength on the device: len - (3, 4, 2)[len % 3]."""
    r = lens % 3
    sub = torch.where(r == 0, 3, torch.where(r == 1, 4, 2))
    return torch.clamp(lens - sub, min=0)


def _mate2_offset(lens1):
    """Mate-2 positions are offset by maxCoveredLength(len1) + 3
    (KmerExtractor.cpp:341-346: queryLength is getMaxCoveredLength)."""
    return (_max_covered_dev(lens1) + 3).to(torch.int32)[:, None, None]


def fused_step(reads1, lens1, reads2, lens2, db_values, db_taxids,
               db_species, cap: int = 16, kmer_format: int = 2,
               syncmer: bool = False, smer_len: int = 5, bucket_lo=None,
               db_aa_lo=None, bucket_shift: int = 0, bucket_steps: int = 0):
    """Host-match device step: extract (+mate 2) -> raw-array probe ->
    match compaction.

    Returns (packed int32 [6, N*cap], count, overflow); see
    ops/compact_torch.py for the packed columns."""
    dev = reads1.device
    b = reads1.shape[0]
    sids = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    kw = dict(syncmer=syncmer, smer_len=smer_len, kmer_format=kmer_format)
    kmers, pos, valid = encode_torch.extract_batch(reads1, lens1, **kw)
    parts = [encode_torch.flatten_batch(kmers, pos, valid, sids)]
    if reads2 is not None:
        k2, p2, v2 = encode_torch.extract_batch(reads2, lens2, **kw)
        parts.append(encode_torch.flatten_batch(
            k2, p2 + _mate2_offset(lens1), v2, sids))
    qk, qp, qf, qs, qv = (torch.cat(c) for c in zip(*parts))
    out = match_torch.match_kmers(qk, qf, qv, db_values, db_taxids,
                                  db_species, cap=cap,
                                  kmer_format=kmer_format,
                                  bucket_lo=bucket_lo, db_aa_lo=db_aa_lo,
                                  bucket_shift=bucket_shift,
                                  bucket_steps=bucket_steps)
    packed, count = compact_torch.compact_and_sort(out, qp, qf, qs)
    return packed, count, out["overflow"]


def _tensor_on(a, device):
    """A tensor on `device`: tensors move, numpy arrays are wrapped
    (uint64 metamers as the int64 of the same bits)."""
    if torch.is_tensor(a):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).to(device)


def classify_step(reads, lengths, db_values, db_taxids, db_species,
                  cap: int = 16, kmer_format: int = 2,
                  syncmer: bool = False, smer_len: int = 5, *,
                  device=None):
    """reads uint8 [B, L], lengths int32 [B] -> match tensors: 6-frame
    extraction, flatten, and the raw-array probe of the sorted DB arrays
    (db_values u64 metamer bits, db_taxids / db_species int32).

    Returns match_torch.match_kmers' query-major dict plus the flat
    query annotation pos, frame and seq_id (1-based read number).  Runs
    on `device` when it is given, else on the device of `reads` when
    that is a tensor, else (numpy inputs, as synthetic_db's and
    synthetic_reads' are) on the card, raising without one unless
    device="cpu"; every input is moved there first."""
    dev = reads.device if device is None and torch.is_tensor(reads) \
        else resolve_device(device)
    reads, lengths, db_values, db_taxids, db_species = (
        _tensor_on(a, dev)
        for a in (reads, lengths, db_values, db_taxids, db_species))
    kmers, pos, valid = encode_torch.extract_batch(
        reads, lengths, syncmer=syncmer, smer_len=smer_len)
    b = reads.shape[0]
    sids = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    qk, qp, qf, qs, qv = encode_torch.flatten_batch(kmers, pos, valid, sids)
    out = match_torch.match_kmers(qk, qf, qv, db_values, db_taxids,
                                  db_species, cap=cap,
                                  kmer_format=kmer_format)
    out["pos"] = qp
    out["frame"] = qf
    out["seq_id"] = qs
    return out


def extract_queries_step(reads1, lens1, reads2=None, lens2=None, ra1=None,
                         ra2=None, *, syncmer: bool = False,
                         smer_len: int = 5, kmer_format: int = 2,
                         win_frac: int = 0):
    """Query extraction: 6-frame metamer encode (+ mate 2 as a second part
    with the len1+3 position offset) + optional syncmer window compaction
    per part.

    Returns flat (qk, qp, qf, qs, qv) query tensors (parts concatenated),
    the per-part (B, 6, W) shapes, and the window-compaction overflow
    count summed over parts.  A streamed run extracts once and keeps
    these resident across all its range passes."""
    # syncmer window compaction: only ~half the windows pass the anchor
    # rule — shrink the W axis to win_frac/256 of its static size before
    # probing (the dyn_gap path DP chains compacted slots by real
    # position gaps).  win_frac == 0 or >= 256 disables compaction.
    dyn_gap = _dyn_gap(syncmer, kmer_format, win_frac)
    dev = reads1.device
    win_over = torch.zeros((), dtype=torch.int32, device=dev)

    def extract_part(reads, lens, ra):
        nonlocal win_over
        kk, pp, vv = encode_torch.extract_batch(reads, lens, syncmer=syncmer,
                                                smer_len=smer_len,
                                                kmer_format=kmer_format,
                                                reads_ra=ra)
        if dyn_gap:
            W = kk.shape[2]
            w_c = max(min((W * win_frac + 255) // 256, W), 1)
            kk, pp, vv, over = encode_torch.compact_windows(kk, pp, vv, w_c)
            win_over = win_over + over
        return kk, pp, vv

    b = reads1.shape[0]
    sids = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    k1, p1, v1 = extract_part(reads1, lens1, ra1)
    parts = [encode_torch.flatten_batch(k1, p1, v1, sids)]
    shapes = [tuple(k1.shape)]
    if reads2 is not None:
        k2, p2, v2 = extract_part(reads2, lens2, ra2)
        parts.append(encode_torch.flatten_batch(
            k2, p2 + _mate2_offset(lens1), v2, sids))
        shapes.append(tuple(k2.shape))
    qk, qp, qf, qs, qv = (torch.cat(c) for c in zip(*parts))
    return qk, qp, qf, qs, qv, shapes, win_over


def _dp_from_probe(out, qp, qs, shapes, win_over, *, cap, kmer_format,
                   syncmer, smer_len, min_cons, min_cons_euk, path_width,
                   path_block, win_frac, compact5):
    """Post-probe half of the fused step, per part: lane flip + fused
    path DP (the CUDA kernel on the card, its plain version on the CPU);
    then one static-width compaction of all parts' emitted paths.  Each
    part's lanes restart at 0 in read order, so a lane id maps to its
    read the same way in every part."""
    fl = lambda a: dp_torch.flip_lanes(a, kmer_format).contiguous()
    dyn_gap = _dyn_gap(syncmer, kmer_format, win_frac)
    blk_over = torch.zeros((), dtype=torch.int32, device=qp.device)
    col_parts, sel_parts = [], []
    offset = 0
    for B, F, W in shapes:
        sl = slice(offset, offset + B * F * W)
        offset += B * F * W
        resh = lambda a: a[:, sl].reshape(cap, B * F, W)
        # the euk flag rides in species bit 30 straight through the DP's
        # species-equality compares (the bit is constant per species);
        # the DP strips it at emission
        sp_m = torch.where(resh(out["sel"]), resh(out["species"]), -1)
        pos = qp[sl].reshape(1, B * F, W).expand(cap, B * F, W)
        cols, psel, b_over = dp_cuda.path_dp_blocked(
            fl(sp_m), fl(resh(out["dna_enc"])), fl(resh(out["rh"])),
            fl(resh(out["hamming"])), fl(pos),
            min_cons=min_cons, min_cons_euk=min_cons_euk,
            max_shift=(8 - smer_len) if syncmer else 1,
            kmer_format=kmer_format, dyn_gap=dyn_gap, block_w=path_block,
            compact5=compact5)
        blk_over = blk_over + b_over
        col_parts.append(cols)
        sel_parts.append(psel)
    paths_packed, paths_count = dp_torch.compact_columns(
        torch.cat(col_parts, 1), torch.cat(sel_parts), out_width=path_width)
    resident = (out["sel"], out["species"] & 0x3FFFFFFF, out["hamming"],
                out["taxid"], qp, qs)
    stats = torch.stack([out["overflow"], paths_count, win_over, blk_over])
    return stats, paths_packed, resident


def compact5_fits(b: int, lmax1: int, lmax2=None) -> bool:
    """The compact 5-column path layout holds when every 16-bit field
    provably fits (g < 2^16, end+26 < 2^16, path hamming < 2^16); long
    reads beyond 16 kb keep the 7-column layout."""
    lmax_all = lmax1 + (lmax2 + 3 if lmax2 is not None else 0)
    return (b * 6 < (1 << 16)) and (lmax_all < (1 << 14))


# ---------------------------------------------------------------------- #
# DB-range streaming: an index too large to keep resident stays on the
# host, cut into metamer ranges at AA-part boundaries, so each query's
# whole candidate run lives in exactly ONE range — the per-range
# [cap, N] contributions are disjoint and merge by masked accumulation,
# and the min(2*minHamming, 7) cutoff computed inside the owning range
# equals the global cutoff.

def new_accumulators(cap: int, n: int, device):
    """Zeroed candidate accumulators of one batch, in the layout of a
    match_kmers_quad result: one set lives across a whole range sweep."""
    z = lambda dt: torch.zeros((cap, n), dtype=dt, device=device)
    return {"sel": z(torch.bool), "hamming": z(torch.int32),
            "rh": z(torch.int32), "taxid": z(torch.int32),
            "species": z(torch.int32), "dna_enc": z(torch.int32),
            "overflow": torch.zeros((), dtype=torch.int32, device=device)}


def probe_range_step(qk, qf, qv, quad_r, hash_r, acc, *, cap: int,
                     kmer_format: int, hash_log2_rows: int, hash_chain: int):
    """One range pass: probe one index range (wide rows or narrow entry
    rows, packing.shard_quad_index; both carry the hash) and fold its
    candidates into `acc` IN PLACE (a fresh set per pass would multiply
    the peak by the number of live temporaries).  Returns acc."""
    out = match_torch.match_kmers_quad(
        qk, qf, qv, quad_r, cap=cap, kmer_format=kmer_format,
        hash_table=hash_r, hash_log2_rows=hash_log2_rows,
        hash_chain=hash_chain)
    sel = out["sel"]
    acc["sel"] |= sel
    for k in ("hamming", "rh", "taxid", "species", "dna_enc"):
        acc[k] += torch.where(sel, out[k], 0)
    acc["overflow"] += out["overflow"]
    return acc


def finish_stream_step(out, qp, qs, shapes, win_over, *, min_cons: int = 4,
                       min_cons_euk: int = 9, cap: int = 16,
                       kmer_format: int = 2, syncmer: bool = False,
                       smer_len: int = 5, path_width: int = 0,
                       win_frac: int = 0, path_block: int = 16,
                       compact5: bool = False):
    """Path DP per part + compaction over the candidates of one probe
    (`out`: a match_kmers_quad result, or the accumulators of a range
    sweep).

    Returns (packed_hdr [C, 1+P] int32, resident): column 0 of packed_hdr
    is a stats header (rows 0-3 = candidate-cap overflow, path count,
    window-compaction overflow, blocked-packer lane overflow), columns
    1..P the compacted path columns; resident = (sel, species, ham, ef,
    q_pos, q_sids) stays on the device for redundancy_counts.  The header
    rides in the path array so one device->host copy brings both home.
    """
    stats, paths_packed, resident = _dp_from_probe(
        out, qp, qs, shapes, win_over, cap=cap, kmer_format=kmer_format,
        syncmer=syncmer, smer_len=smer_len, min_cons=min_cons,
        min_cons_euk=min_cons_euk, path_width=path_width,
        path_block=path_block, win_frac=win_frac, compact5=compact5)
    hdr = torch.zeros((paths_packed.shape[0], 1), dtype=torch.int32,
                      device=paths_packed.device)
    hdr[:4, 0] = stats.to(torch.int32)
    return torch.cat([hdr, paths_packed], 1), resident


def fused_step_dp(reads1, lens1, db_quad, *, reads2=None, lens2=None,
                  min_cons: int = 4, min_cons_euk: int = 9, cap: int = 16,
                  kmer_format: int = 2, syncmer: bool = False,
                  smer_len: int = 5, path_width: int = 0, win_frac: int = 0,
                  path_block: int = 16, ra1=None, ra2=None, hash_table=None,
                  hash_log2_rows: int = 0, hash_chain: int = 0,
                  db_m: int = None, aligned: bool = False, bucket_lo=None,
                  db_aa_lo=None, bucket_shift: int = 0,
                  bucket_steps: int = 0):
    """extract (+mate 2) -> probe of the resident index -> path DP per
    part -> compaction for one batch; returns finish_stream_step's
    (packed_hdr, resident).  The index is any layout match_kmers_quad
    probes: wide rows with the hash, narrow block rows (`aligned` run
    starts or not) with the hash, or narrow block rows without it
    (hash_table None: the bucket bisection over bucket_lo / db_aa_lo)."""
    qk, qp, qf, qs, qv, shapes, win_over = extract_queries_step(
        reads1, lens1, reads2, lens2, ra1, ra2, syncmer=syncmer,
        smer_len=smer_len, kmer_format=kmer_format, win_frac=win_frac)
    out = match_torch.match_kmers_quad(
        qk, qf, qv, db_quad, cap=cap, kmer_format=kmer_format,
        hash_table=hash_table, hash_log2_rows=hash_log2_rows,
        hash_chain=hash_chain, db_m=db_m, aligned=aligned,
        bucket_lo=bucket_lo, db_aa_lo=db_aa_lo, bucket_shift=bucket_shift,
        bucket_steps=bucket_steps)
    compact5 = compact5_fits(reads1.shape[0], reads1.shape[1],
                             reads2.shape[1] if reads2 is not None else None)
    return finish_stream_step(
        out, qp, qs, shapes, win_over, min_cons=min_cons,
        min_cons_euk=min_cons_euk, cap=cap, kmer_format=kmer_format,
        syncmer=syncmer, smer_len=smer_len, path_width=path_width,
        win_frac=win_frac, path_block=path_block, compact5=compact5)


def fused_step_full(reads1, lens1, db_quad, ef_node, euler, depth, lift, *,
                    reads2=None, lens2=None, min_score: float = 0.0,
                    tie_ratio: float = 0.95, combine_k: int = 8,
                    dna_shift: int = 0, n_quot: int = 0, part_w: tuple = (),
                    **step_kw):
    """Whole-batch device chain of the device-assign flow: fused_step_dp
    (step_kw are its keywords) + species assign + redundancy.  The batch
    must fit the 5-column path layout (compact5_fits).

    Returns (records, packed2): records rows = (live, tie_cnt, total f32
    bits, tied LCA, first tied species, top species) per 1-based read
    column; column 0 rows 0-4 hold the stats header (candidate-cap
    overflow, path count, window overflow, block overflow, combine_k
    overflow).  packed2 = redundancy_counts' (rid, lca) pair columns at
    full width, with its own stats column 0.
    """
    packed_hdr, resident = fused_step_dp(reads1, lens1, db_quad,
                                         reads2=reads2, lens2=lens2,
                                         **step_kw)
    stats = packed_hdr[:4, 0]
    B = reads1.shape[0]
    qlens = torch.zeros(B + 1, dtype=torch.int32, device=reads1.device)
    qlens[1:] = _max_covered_dev(lens1)
    if reads2 is not None:
        qlens[1:] += _max_covered_dev(lens2)
    records, best_sp, over_k = assign_torch.device_assign(
        packed_hdr[:, 1:], stats[1], qlens, ef_node, euler, depth, lift,
        min_score=min_score, tie_ratio=tie_ratio, combine_k=combine_k)
    records[:4, 0] = stats
    records[4, 0] = over_k
    packed2 = redundancy_counts(*resident, best_sp, euler, depth, lift,
                                dna_shift=dna_shift, n_quot=n_quot,
                                part_w=part_w)
    return records, packed2


def part_widths(lmax1, syncmer, kmer_format, smer_len, win_frac, lmax2=None):
    """Per-read flat slot count (6 frames x compacted windows) per part
    (two parts when lmax2 is given: paired); the redundancy step rebuilds
    read ids from it by broadcast."""
    def one(lmax):
        W = encode_torch.max_windows(lmax)
        if _dyn_gap(syncmer, kmer_format, win_frac):
            W = max(min((W * win_frac + 255) // 256, W), 1)
        return 6 * W

    return (one(lmax1),) if lmax2 is None else (one(lmax1), one(lmax2))


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


def synthetic_db(n_kmers=4096, n_species=8, seed=0):
    """Small synthetic sorted index for compile checks and dry runs:
    (values uint64, taxids int32, species int32) numpy arrays, the JAX
    package's for the same arguments."""
    rng = np.random.default_rng(seed)
    aa = rng.integers(0, 2**40, size=n_kmers, dtype=np.uint64)
    dna = rng.integers(0, 2**24, size=n_kmers, dtype=np.uint64)
    values = np.unique((aa << np.uint64(24)) | dna)
    taxids = rng.integers(2, 2 + n_species * 4,
                          size=len(values)).astype(np.int32)
    species = (2 + (taxids - 2) % n_species).astype(np.int32)
    return values, taxids, species


def synthetic_reads(batch=32, length=150, seed=1):
    """Random ACGT reads for classify_step: (reads uint8 [batch, length],
    lengths int32 [batch]) numpy arrays, the JAX package's for the same
    arguments."""
    rng = np.random.default_rng(seed)
    reads = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                       size=(batch, length))
    lengths = np.full(batch, length, dtype=np.int32)
    return reads, lengths
