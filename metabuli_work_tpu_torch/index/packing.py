"""Device-ready index layout: packed 512-byte rows + the AA-part hash.

Host-side numpy packing of the sorted index (pack_db_quad,
pack_db_rows32, build_aa_hash), a disk cache of the packed layout
(load_or_pack_wide), and state_from_numpy, which turns the packed
index and LCA tables into the tensors the device step reads.

Every u32 array is carried on the device as int32 holding the same
bits (torch has no usable uint32 arithmetic on every backend); the
probe (ops/match_torch.py) masks after each right shift accordingly.
"""

import hashlib
import json
import os
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


# ---------------------------------------------------------------------- #
# Persistent cache of the packed layout: packing is a deterministic
# function of the sorted entry arrays and the geometry but costs minutes
# of single-core numpy at the 100M-kmer scale, so it is done once per DB
# and memory-mapped after (the reference writes its diffIdx/split files
# once at build time, IndexCreator.cpp:782-866).

LAYOUT_VERSION = 2


def cache_root():
    return os.path.join(os.path.expanduser("~/.cache"), "mwt_torch_packed")


def _key(parts, geom: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{LAYOUT_VERSION}:{geom}".encode())
    for a in parts:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(memoryview(a))
    return h.hexdigest()


def load_or_pack_wide(values, db_ef, sp_euk, *, max_chain, max_bytes,
                      slots=WIDE_SLOTS, row_u32=WIDE_ROW_U32):
    """Wide layout: (rows [R,128] u32, hash_table, log2_rows, chain,
    db_m) — from the cache when the same DB + geometry was packed
    before, else packed fresh and cached.  Cached arrays are read-only
    mmaps."""
    geom = f"wide:{max_chain}:{max_bytes}:{slots}:{row_u32}"
    root = cache_root()
    key = _key((values, db_ef, sp_euk), geom)
    entry = os.path.join(root, key)
    meta_p = os.path.join(entry, "meta.json")
    if os.path.exists(meta_p):
        try:
            with open(meta_p) as f:
                meta = json.load(f)
            rows = np.load(os.path.join(entry, "rows.npy"), mmap_mode="r")
            ht = np.load(os.path.join(entry, "hash.npy"), mmap_mode="r")
            return (rows, ht, int(meta["log2_rows"]), int(meta["chain"]),
                    int(meta["db_m"]))
        except (OSError, ValueError, KeyError):
            pass    # unreadable entry: fall through and re-pack

    rows = pack_db_rows32(pack_db_quad(values, db_ef, sp_euk))
    ht, log2_rows, chain = build_aa_hash(
        values, max_chain=max_chain, max_bytes=max_bytes,
        slots=slots, row_u32=row_u32)
    db_m = len(values)
    try:
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_")
        np.save(os.path.join(tmp, "rows.npy"), rows)
        np.save(os.path.join(tmp, "hash.npy"), ht)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"log2_rows": log2_rows, "chain": chain,
                       "db_m": db_m}, f)
        os.replace(tmp, entry)   # atomic publish; loser of a race loses
    except OSError:
        pass
    return rows, ht, log2_rows, chain, db_m


def _as_i32(a, device):
    """u32/i32 numpy -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = a.astype(np.int32, copy=False)
    if not a.flags.writeable:      # cached mmaps are read-only
        a = a.copy()
    return torch.from_numpy(a).to(device)


def state_from_numpy(rows, hash_table, hash_log2_rows, hash_chain, db_m,
                     depth, lift, euler, ef_node, device):
    """Device state of a resident index: the packed rows and hash table
    (uint32 bits carried as int32), their geometry, and the LCA tables
    (int32).  Values are unchanged; only their dtype label is."""
    return {
        "db_quad": _as_i32(rows, device),
        "hash_table": _as_i32(hash_table, device),
        "hash_log2_rows": int(hash_log2_rows),
        "hash_chain": int(hash_chain),
        "db_m": int(db_m),
        "lca_depth": _as_i32(depth, device),
        "lca_lift": _as_i32(lift, device),
        "euler": _as_i32(euler, device),
        "ef_node": _as_i32(ef_node, device),
    }
