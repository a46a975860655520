"""Device-ready index layout: packed 512-byte rows + the AA-part hash.

Host-side numpy packing of the sorted index (pack_db_quad,
pack_db_rows32, build_aa_hash), a disk cache of the packed layout and of
its shards (load_or_pack_wide, load_or_shard), the narrow layouts that
METABULI_WIDE_PROBE=0 / METABULI_HASH_PROBE=0 select (pack_db_blocks:
64-byte rows of 4 entries, run starts block-aligned by align_runs4 or
not; load_or_pack_narrow; entry-row shards), state_from_numpy, which
turns the packed index and LCA tables into the tensors the path-DP
device step reads, match_state_from_numpy, the raw sorted arrays plus
bucket tables that the host-match step probes instead, and for an index
larger than the device-memory budget or cut over a mesh shard_quad_index
(contiguous metamer ranges cut at AA-part boundaries, one hash geometry)
with stream_state_from_numpy (the ranges kept on the host, the LCA
tables on the device) and sharded_state_from_numpy (the shards on the
mesh's devices, once per device).

Every u32 array is carried on the device as int32 holding the same
bits (torch has no usable uint32 arithmetic on every backend); the
probe (ops/match_torch.py) masks after each right shift accordingly.
"""

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

DNA_BITS = 24
EF_BITS = 25                 # euler_first coordinate width in the quad payload

# Hash probe geometry: each 512-byte row holds 42 slots of
# (aa_lo32, aa_hi8 | occupied | run_len << 9, run start).
HASH_SLOTS = 5
HASH_ROW_U32 = 16
_HASH_MUL1 = np.uint32(0x9E3779B1)
_HASH_MUL2 = np.uint32(0x85EBCA6B)
WIDE_SLOTS = 42
WIDE_ROW_U32 = 128


def build_aa_hash(values: np.ndarray, load: float = 2.5,
                  max_chain: int = 3, min_log2_rows: int = 0,
                  max_bytes: int = 0, starts_override=None,
                  slots: int = HASH_SLOTS, row_u32: int = HASH_ROW_U32):
    """Host-side bucketized hash of unique AA parts -> run starts.

    Returns (table uint32 [R, row_u32], log2_rows, chain): bucketized
    open addressing with `slots` slots per row and linear ROW chaining on
    overflow; ``chain`` is the measured maximum chain length (rows a
    probe must visit), kept <= max_chain by doubling R.  The reference's
    analogue is the `split` checkpoint table + two-pointer merge
    (IndexCreator.cpp:811-866, KmerMatcher.cpp:251-466); here point
    lookup wins because queries arrive unsorted.

    Each slot also stores the run LENGTH (23 bits, saturating) above
    the occupancy flag, so probes learn candidate-cap overflow from the
    lookup itself.
    """
    aa = (values >> np.uint64(DNA_BITS)).astype(np.uint64)
    uniq, starts = np.unique(aa, return_index=True)  # values sorted -> left edges
    n = len(uniq)
    run_len = np.diff(starts, append=len(values)).astype(np.uint32)
    run_len = np.minimum(run_len, np.uint32((1 << 23) - 1))
    if starts_override is not None:
        assert len(starts_override) == n
        starts = np.asarray(starts_override)
    lo32 = (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi8 = (uniq >> np.uint64(32)).astype(np.uint32)
    assert 3 * slots <= row_u32
    log2_rows = max(8, int(np.ceil(np.log2(
        max(n / (load * slots / HASH_SLOTS), 1)))), min_log2_rows)
    # termination guard: never grow the table past 4 rows per unique key
    max_log2_rows = max(log2_rows, int(np.ceil(np.log2(max(n, 2)))) + 2)
    while True:
        R = 1 << log2_rows
        h = (((lo32 * _HASH_MUL1) ^ (hi8 * _HASH_MUL2))
             >> np.uint32(32 - log2_rows)).astype(np.int64)
        # vectorized linear probing over the flattened slot space: keys
        # sorted by home row fill slots in order, spilling forward when a
        # row is full — the landing slot of sorted key k is
        #   q_k = max_{j<=k}(f_j + (k - j)) = k + running_max(f_j - j)
        order = np.argsort(h, kind="stable")
        f = h[order] * slots
        k = np.arange(n, dtype=np.int64)
        q = np.maximum.accumulate(f - k) + k
        row_of = q // slots
        slot_of = q % slots
        chain = int((row_of - h[order]).max(initial=0)) + 1
        fits = n == 0 or int(row_of[-1]) < R
        # max_bytes: stop chasing a shorter chain once the NEXT doubling
        # would blow the byte budget — accept the chain reached instead
        over_budget = bool(max_bytes) and \
            ((R << 1) * row_u32 * 4 > max_bytes)
        if (chain <= max_chain and fits) \
                or (fits and log2_rows >= max_log2_rows) \
                or (fits and over_budget):
            break
        log2_rows += 1
    table = np.zeros((R, row_u32), dtype=np.uint32)
    cols = 3 * slot_of
    table[row_of, cols] = lo32[order]
    table[row_of, cols + 1] = (hi8[order] | np.uint32(0x100)
                               | (run_len[order] << np.uint32(9)))
    table[row_of, cols + 2] = starts[order].astype(np.uint32)
    return table, log2_rows, chain


def pack_db_quad(values: np.ndarray, euler_first: np.ndarray,
                 species_euk: np.ndarray) -> np.ndarray:
    """Pack the DB into a u32-quad row per entry: [M, 4] uint32.

    Columns: (value_lo32, value_hi32, payload_lo, payload_hi) where the
    payload carries euler_first (25 bits) and species+euk-flag (31 bits),
    so one row gather yields the metamer and both payloads.
    """
    v = values.astype(np.uint64)
    ef = euler_first.astype(np.uint32)
    sp = species_euk.astype(np.uint32)
    assert int(ef.max(initial=0)) < (1 << EF_BITS)
    quad = np.empty((len(v), 4), dtype=np.uint32)
    quad[:, 0] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    quad[:, 1] = (v >> np.uint64(32)).astype(np.uint32)
    quad[:, 2] = ef | ((sp & np.uint32(0x7F)) << np.uint32(EF_BITS))
    quad[:, 3] = sp >> np.uint32(7)
    return quad


def pack_db_rows32(quad: np.ndarray, pad_entries: int = 256) -> np.ndarray:
    """Reshape a [M, 4] u32 quad DB into 512-byte rows [R, 128]
    (32 entries per row), padded with all-ones sentinel entries (their
    AA part can never equal a query's)."""
    m = len(quad)
    total = ((m + pad_entries + 31) // 32) * 32
    blk = np.full((total, 4), 0xFFFFFFFF, dtype=np.uint32)
    blk[:m] = quad
    return blk.reshape(total // 32, 128)


def pack_db_blocks(quad: np.ndarray, pad_entries: int = 256) -> np.ndarray:
    """Reshape a [M, 4] u32 quad DB into 64-byte block rows [R, 16]
    (4 entries per row), padded with all-ones sentinel entries (their
    AA part never equals a query's): the narrow layout, whose candidate
    window is a few block gathers (ops/match_torch._gather_blocks)."""
    m = len(quad)
    total = ((m + pad_entries + 3) // 4) * 4
    blk = np.full((total, 4), 0xFFFFFFFF, dtype=np.uint32)
    blk[:m] = quad
    return blk.reshape(total // 4, 16)


def align_runs4(values: np.ndarray, *payloads):
    """Pad the sorted entry arrays so every AA run starts on a 4-entry
    (64-byte block) boundary: with run lengths known from the hash, the
    candidate window then reads exactly ceil(cap/4) block rows and needs
    no shuffle.

    Padding entries have all-ones values (their AA part never matches a
    query) and zero payloads.  Returns (values_p, *payloads_p,
    starts_padded) where starts_padded are the per-unique-AA run starts
    in the padded coordinate space (build_aa_hash's starts_override)."""
    aa = (np.asarray(values) >> np.uint64(DNA_BITS))
    _, starts = np.unique(aa, return_index=True)
    m = len(values)
    lens = np.diff(starts, append=m)
    new_lens = ((lens + 3) // 4) * 4
    new_starts = np.zeros(len(starts), dtype=np.int64)
    np.cumsum(new_lens[:-1], out=new_starts[1:])
    total = int(new_lens.sum())
    run_of = np.repeat(np.arange(len(starts)), lens)
    idx = np.arange(m) - starts[run_of] + new_starts[run_of]
    values_p = np.full(total, np.uint64(0xFFFFFFFFFFFFFFFF),
                       dtype=np.uint64)
    values_p[idx] = values
    outs = [values_p]
    for p in payloads:
        p = np.asarray(p)
        pp = np.zeros(total, dtype=p.dtype)
        pp[idx] = p
        outs.append(pp)
    outs.append(new_starts)
    return tuple(outs)


def aligned_bytes(runs: np.ndarray) -> int:
    """Bytes of the block-aligned narrow layout of an index whose AA runs
    have the lengths `runs` (16 B an entry, every run padded to 4)."""
    return int((((runs + 3) // 4) * 4).sum()) * 16


def shard_quad_index(quad: np.ndarray, n_shards: int, wide: bool = True):
    """Cut a pack_db_quad [M, 4] uint32 array into n_shards contiguous
    metamer ranges at AA-part boundaries, each packed into 512-byte rows
    (pack_db_rows32) and padded to one row count, plus per-shard AA hash
    tables with ONE uniform geometry (row count and chain length are
    arguments of the probe, so every shard must share them).

    Pad entries carry an all-ones value (AA part 0xFF_FFFFFFFF) which no
    real metamer can equal (AA symbols are 5-bit codes < 21, so an
    all-ones 40-bit AA part never occurs) — a padded entry can never pass
    the probe's AA-equality mask.  Hash lookups of foreign queries miss
    and resolve to a zero run length.  match_kmers_quad takes db_m as
    the padded row space when it is given none.

    wide=False (METABULI_WIDE_PROBE=0): each shard is S entry rows
    [S, 4] (S the largest shard's entry count, the rest all-ones pads)
    with 16-u32 hash rows of 5 slots; a hash miss resolves to lo = S.

    Returns (quads [n, R32, 128] uint32 — [n, S, 4] narrow, hash_tables
    [n, R, 128] uint32 — [n, R, 16] narrow, log2_rows, chain, counts
    int32 [n]).
    """
    M = quad.shape[0]
    v = quad[:, 0].astype(np.uint64) | (quad[:, 1].astype(np.uint64) << 32)
    aa = v >> np.uint64(DNA_BITS)
    bounds = [0]
    for k in range(1, n_shards):
        t = k * M // n_shards
        while 0 < t < M and aa[t] == aa[t - 1]:
            t += 1
        bounds.append(min(t, M))
    bounds.append(M)
    counts = np.diff(bounds).astype(np.int32)
    S = max(int(counts.max(initial=0)), 1)
    if wide:
        hash_kw = dict(slots=WIDE_SLOTS, row_u32=WIDE_ROW_U32)
        quads = np.stack([
            pack_db_rows32(quad[bounds[i]:bounds[i + 1]],
                           pad_entries=S - (bounds[i + 1] - bounds[i]) + 256)
            for i in range(n_shards)])
    else:
        hash_kw = {}
        quads = np.full((n_shards, S, 4), np.uint32(0xFFFFFFFF),
                        dtype=np.uint32)
        for i in range(n_shards):
            quads[i, :counts[i]] = quad[bounds[i]:bounds[i + 1]]
    shard_values = [v[bounds[i]:bounds[i + 1]] for i in range(n_shards)]
    builds = [build_aa_hash(sv, **hash_kw) for sv in shard_values]
    # uniform hash geometry: size every table for the largest shard and
    # rebuild until all shards agree on one row count (min_log2_rows only
    # sets the start point — a pathological collision cluster can still
    # double past it, in which case every other shard re-pads up).  The
    # chain is the max observed chain; extra chain gathers on smaller
    # shards are harmless (they just re-miss).
    log2 = max(b[1] for b in builds)
    while True:
        builds = [b if b[1] == log2
                  else build_aa_hash(sv, min_log2_rows=log2, **hash_kw)
                  for sv, b in zip(shard_values, builds)]
        got = max(b[1] for b in builds)
        if got == log2:
            break
        log2 = got
    chain = max(b[2] for b in builds)
    return quads, np.stack([b[0] for b in builds]), log2, chain, counts


# ---------------------------------------------------------------------- #
# Persistent cache of the packed layout: packing is a deterministic
# function of the sorted entry arrays and the geometry but costs minutes
# of single-core numpy at the 100M-kmer scale, so it is done once per DB
# and memory-mapped after (the reference writes its diffIdx/split files
# once at build time, IndexCreator.cpp:782-866).  Entries live under
# METABULI_PACK_CACHE (default ~/.cache/mwt_torch_packed; "0" turns the
# cache off).

LAYOUT_VERSION = 3


def cache_root():
    """The cache directory, or None when METABULI_PACK_CACHE is "0"."""
    env = os.environ.get("METABULI_PACK_CACHE")
    if env == "0":
        return None
    return env or os.path.join(os.path.expanduser("~/.cache"),
                               "mwt_torch_packed")


def _key(parts, geom: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{LAYOUT_VERSION}:{geom}".encode())
    for a in parts:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(memoryview(a))
    return h.hexdigest()


def _cached(parts, geom, make):
    """(arrays, meta) of the cache entry for (parts, geom): a dict of
    numpy arrays, mapped copy-on-write from the entry's .npy files, and a
    JSON-able dict — or make()'s, saved as that entry first.  The entry
    is written into a .tmp_* directory and published by a rename; an
    entry that exists but cannot be read is moved aside, replaced and
    deleted.  A process that loses the race to publish (the entry is
    there by then: the same bytes) or fails to write keeps make()'s
    arrays for this run and deletes its copy, so nothing is left
    behind."""
    root = cache_root()
    if root is None:
        return make()
    entry = os.path.join(root, _key(parts, geom))
    try:
        with open(os.path.join(entry, "meta.json")) as f:
            meta = json.load(f)
        arrays = {k: np.load(os.path.join(entry, f"{k}.npy"),
                             mmap_mode="c") for k in meta.pop("arrays")}
        return arrays, meta
    except (OSError, ValueError, KeyError):
        damaged = os.path.lexists(entry)    # there but unreadable

    arrays, meta = make()
    tmp = aside = None
    try:
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_")
        for k, a in arrays.items():
            np.save(os.path.join(tmp, f"{k}.npy"), a)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({**meta, "arrays": list(arrays)}, f)
        if damaged:
            aside = tempfile.mkdtemp(dir=root, prefix=".tmp_")
            os.replace(entry, aside)
        os.replace(tmp, entry)   # fails when another process published
    except OSError:
        pass
    finally:
        for d in (tmp, aside):   # tmp is gone once published
            if d is not None:
                shutil.rmtree(d, ignore_errors=True)
    return arrays, meta


def load_or_pack_wide(values, db_ef, sp_euk, *, max_chain, max_bytes,
                      slots=WIDE_SLOTS, row_u32=WIDE_ROW_U32):
    """Wide layout: (rows [R,128] u32, hash_table, log2_rows, chain,
    db_m) — from the cache when the same DB + geometry was packed
    before, else packed fresh and cached."""
    def make():
        ht, log2_rows, chain = build_aa_hash(
            values, max_chain=max_chain, max_bytes=max_bytes,
            slots=slots, row_u32=row_u32)
        return ({"rows": pack_db_rows32(pack_db_quad(values, db_ef, sp_euk)),
                 "hash": ht},
                {"log2_rows": log2_rows, "chain": chain,
                 "db_m": len(values)})

    arrays, meta = _cached((values, db_ef, sp_euk),
                           f"wide:{max_chain}:{max_bytes}:{slots}:{row_u32}",
                           make)
    return (arrays["rows"], arrays["hash"], int(meta["log2_rows"]),
            int(meta["chain"]), int(meta["db_m"]))


def load_or_pack_narrow(values, db_ef, sp_euk, *, aligned, use_hash,
                        max_chain, max_bytes):
    """Narrow layout: (blocks [R,16] u32, hash_table [R',16] u32 or None
    without the hash, log2_rows, chain, db_m).  aligned: run starts
    padded to block boundaries (align_runs4; the hash then points into
    the padded space and db_m counts the padding).  From the cache when
    the same DB + geometry was packed before, else packed and cached."""
    def make():
        starts = None
        v, ef, sp = values, db_ef, sp_euk
        if aligned:
            v, ef, sp, starts = align_runs4(values, db_ef, sp_euk)
        arrays = {"rows": pack_db_blocks(pack_db_quad(v, ef, sp))}
        log2_rows = chain = 0
        if use_hash:
            arrays["hash"], log2_rows, chain = build_aa_hash(
                values, max_chain=max_chain, max_bytes=max_bytes,
                starts_override=starts)
        return arrays, {"log2_rows": log2_rows, "chain": chain,
                        "db_m": len(v)}

    arrays, meta = _cached(
        (values, db_ef, sp_euk),
        f"narrow:{int(aligned)}:{int(use_hash)}:{max_chain}:{max_bytes}",
        make)
    return (arrays["rows"], arrays.get("hash"), int(meta["log2_rows"]),
            int(meta["chain"]), int(meta["db_m"]))


def load_or_shard(values, db_ef, sp_euk, n_shards, wide=True):
    """shard_quad_index of the packed DB into n_shards — from the cache
    when the same DB was cut into as many shards of the same layout
    before (a streamed or mesh classifier of another process or sequence
    mode), else cut fresh and cached."""
    def make():
        quads, hts, log2, chain, counts = shard_quad_index(
            pack_db_quad(values, db_ef, sp_euk), n_shards, wide=wide)
        return ({"quads": quads, "hts": hts, "counts": counts},
                {"log2_rows": log2, "chain": chain})

    arrays, meta = _cached((values, db_ef, sp_euk),
                           f"shards:{n_shards}" + ("" if wide else ":narrow"),
                           make)
    return (arrays["quads"], arrays["hts"], int(meta["log2_rows"]),
            int(meta["chain"]), arrays["counts"])


def _as_i32(a, device):
    """u32/i32 numpy -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = a.astype(np.int32, copy=False)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def state_from_numpy(rows, hash_table, hash_log2_rows, hash_chain, db_m,
                     depth, lift, euler, ef_node, device):
    """Device state of a resident index: the packed rows and hash table
    (uint32 bits carried as int32; no hash table for the bisection
    probe), their geometry, and the LCA tables (int32).  Values are
    unchanged; only their dtype label is."""
    return {
        "db_quad": _as_i32(rows, device),
        "hash_table": (None if hash_table is None
                       else _as_i32(hash_table, device)),
        "hash_log2_rows": int(hash_log2_rows),
        "hash_chain": int(hash_chain),
        "db_m": int(db_m),
        "lca_depth": _as_i32(depth, device),
        "lca_lift": _as_i32(lift, device),
        "euler": _as_i32(euler, device),
        "ef_node": _as_i32(ef_node, device),
    }


def stream_state_from_numpy(quads, hash_tables, hash_log2_rows, hash_chain,
                            depth, lift, euler, ef_node, device):
    """State of a streamed index (the output of shard_quad_index): the
    ranges stay on the HOST as int32 views of the u32 rows (no copy;
    `stream_quads[r]`, `stream_hts[r]` are what one range pass uploads),
    the LCA tables go to the device as in state_from_numpy."""
    host = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))
    return {
        "stream_quads": host(quads),
        "stream_hts": host(hash_tables),
        "hash_log2_rows": int(hash_log2_rows),
        "hash_chain": int(hash_chain),
        "lca_depth": _as_i32(depth, device),
        "lca_lift": _as_i32(lift, device),
        "euler": _as_i32(euler, device),
        "ef_node": _as_i32(ef_node, device),
    }


def sharded_state_from_numpy(quads, hash_tables, hash_log2_rows, hash_chain,
                             depth, lift, euler, ef_node, mesh,
                             resident=True):
    """State of an index cut into shards over a (dp, db) mesh
    (parallel/sharding.Mesh): the shards on the HOST as in
    stream_state_from_numpy (what a streamed mesh uploads range by range
    and what a read beyond the row cap probes); with resident, "cells":
    cells[i][c] = (quad, hash) of shard c on the device of cell (i, c);
    "tables": {device: (euler, lca_depth, lca_lift)}.  Shards and tables
    are uploaded once per distinct device: cells that share a device
    share the tensors, so device memory does not grow with dp."""
    st = stream_state_from_numpy(quads, hash_tables, hash_log2_rows,
                                 hash_chain, depth, lift, euler, ef_node,
                                 "cpu")
    st["tables"] = {d: (_as_i32(euler, d), _as_i32(depth, d),
                        _as_i32(lift, d)) for d in mesh.local_devices()}
    if resident:
        st["cells"] = mesh.place(lambda c, d: (
            st["stream_quads"][c].to(d), st["stream_hts"][c].to(d)))
    return st


def match_state_from_numpy(values, taxids, species, bucket_pair, aa_lo,
                           bucket_shift, bucket_steps, device):
    """Device state of the host-match probe (ops/match_torch.match_kmers):
    the raw sorted arrays — metamers as int64 holding the u64 bits,
    taxids and species as int32 — and the bucket tables of
    match_torch.build_buckets (the u32 low AA halves as int32 bits).
    20 B per metamer beside the wide rows, so a classifier uploads it
    only when it first needs the host-match step."""
    v = np.ascontiguousarray(values, dtype=np.uint64).view(np.int64)
    if not v.flags.writeable:
        v = v.copy()
    return {
        "db_values": torch.from_numpy(v).to(device),
        "db_taxids": _as_i32(taxids, device),
        "db_species": _as_i32(species, device),
        **bucket_state_from_numpy(bucket_pair, aa_lo, bucket_shift,
                                  bucket_steps, device),
    }


def bucket_state_from_numpy(bucket_pair, aa_lo, bucket_shift, bucket_steps,
                            device):
    """The bucket tables of match_torch.build_buckets on the device (the
    u32 low AA halves as int32 bits), keyed as the probes take them."""
    return {
        "bucket_lo": _as_i32(bucket_pair, device),
        "db_aa_lo": _as_i32(aa_lo, device),
        "bucket_shift": int(bucket_shift),
        "bucket_steps": int(bucket_steps),
    }
