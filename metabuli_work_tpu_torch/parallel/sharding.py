"""Classify over a (dp, db) mesh of devices.

The reference's OpenMP thread parallelism over query ranges and its
single-node database become two mesh axes:

  * 'dp' cuts each batch of reads into rows; extraction, the path DP,
    the scoring and the redundancy filter run on each row's reads alone;
  * 'db' cuts the sorted index into contiguous metamer ranges at
    amino-acid-part boundaries, so every AA run lives in exactly one
    shard and a probe never straddles two: each (dp, db) cell probes its
    own shard with its row's queries into its own zeroed accumulators;
  * the db merge: a shard that does not own a query's run contributes
    zeros (a foreign query misses the shard's hash and resolves to a
    zero run length; pad entries are all-ones and never match), so a
    row's cells reduce onto the row's device by OR (sel) and integer add
    (the five payload fields and the candidate-cap overflow), exactly.

The phase boundaries are explicit here, where the JAX package's
shard_map lets XLA insert the collectives.  Per batch: each dp row
extracts its reads on the row's device (cell (row, 0)); each cell
probes its shard (flagship.probe_range_step into
flagship.new_accumulators); the db merge brings the row's cells onto the
row's device with non-blocking copies (the host never waits inside it);
each row runs flagship.finish_stream_step, which launches the path-DP
CUDA kernel once per part; the stats header is reduced over 'dp' on the
host after the header fetch the host waits for anyway (reduce_header:
rows 0, 2, 3 summed, row 4 the largest row 1, row 1 local).

No NCCL is needed: the db merge never crosses a process, because a
global mesh puts 'db' within a process and 'dp' across processes
(parallel/distributed.make_global_mesh), and the only data that crosses
processes is that small header, one all-reduce of a CPU int64 tensor
over gloo.  That also lets two processes share one card, which NCCL
refuses.  A mesh whose cells share a device (a virtual mesh: an
explicit device list that repeats a device) runs the same code: every
cell keeps its own accumulators, and the index tensors are uploaded
once per distinct device.

The older make_sharded_classify_step and make_sharded_fused_dp_step
(plain sorted-array probe, the plain dp_torch chain) stay for the tests
that pin them; classify runs make_sharded_fused_dp_prod and
make_sharded_stream_steps.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..index.packing import DNA_BITS, shard_quad_index  # noqa: F401
from ..models import flagship
from ..ops import dp_torch
from ..ops.match_torch import _hamming_filter

_M40 = (1 << 40) - 1
_DNA_MASK = (1 << DNA_BITS) - 1
_ADD_FIELDS = ("hamming", "rh", "taxid", "species", "dna_enc", "overflow")
# bytes of one accumulator slot a cell hands to the db merge: bool sel +
# five int32 payload fields
ACC_SLOT_BYTES = 21


class Mesh:
    """A (dp, db) grid of torch devices.

    devices: object array [dp, db] of torch.device; rows of other
    processes hold None.  local_rows: the global dp rows this process
    owns (all of them in a single process).  shape is {"dp": .., "db":
    ..}, as the JAX package's Mesh reads."""

    def __init__(self, devices, local_rows=None):
        self.devices = np.asarray(devices, dtype=object)
        dp = self.devices.shape[0]
        self.local_rows = list(range(dp)) if local_rows is None \
            else list(local_rows)

    @property
    def shape(self):
        dp, db = self.devices.shape
        return {"dp": dp, "db": db}

    @property
    def size(self):
        return self.devices.size

    @property
    def multi_process(self):
        return len(self.local_rows) < self.devices.shape[0]

    def row_device(self, i):
        return self.devices[i, 0]

    def local_devices(self):
        """The distinct devices of this process's cells, in cell order."""
        out = []
        for i in self.local_rows:
            for d in self.devices[i]:
                if d not in out:
                    out.append(d)
        return out

    def place(self, column):
        """cells[i][c] = column(c, device of cell (i, c)) for the local
        rows (None for other processes' rows), calling column once per
        distinct (column, device): cells of one column on one device
        share the result, so a virtual mesh holds one copy per device."""
        made = {}
        cells = [None] * self.devices.shape[0]
        for i in self.local_rows:
            row = []
            for c, d in enumerate(self.devices[i]):
                if (c, d) not in made:
                    made[(c, d)] = column(c, d)
                row.append(made[(c, d)])
            cells[i] = row
        return cells

    def __repr__(self):
        return (f"Mesh(dp={self.shape['dp']}, db={self.shape['db']}, "
                f"local_rows={self.local_rows})")


def visible_cards():
    """The CUDA cards this process sees; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass an explicit "
                           "device list (e.g. ['cpu'] * 8) for a mesh on "
                           "the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices=None, dp=None, devices=None):
    """Factor devices into a (dp, db) mesh; db gets the larger factor
    (dp is the largest factor <= sqrt(n): 8 -> 2 x 4, 4 -> 2 x 2).

    devices defaults to the visible CUDA cards (raises without one); an
    explicit list may repeat a device, which makes a virtual mesh.
    n_devices takes the first n of them."""
    devs = visible_cards() if devices is None \
        else [resolve_device(d) for d in devices]
    if n_devices:
        devs = devs[:n_devices]
    n = len(devs)
    if dp is None:
        dp = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                dp = f
                break
    db = n // dp
    grid = np.empty((dp, db), dtype=object)
    for k in range(dp * db):
        grid[k // db, k % db] = devs[k]
    return Mesh(grid)


def shard_index(values, taxids, species, n_shards):
    """Cut the sorted index into n_shards ranges at AA-part boundaries.

    Returns padded [n_shards, S] arrays + per-shard entry counts.  Padding
    uses the max uint64 value so searchsorted never selects it.
    """
    m = len(values)
    aa = values >> np.uint64(24)
    bounds = [0]
    for k in range(1, n_shards):
        t = k * m // n_shards
        # advance to the next AA boundary so runs stay intact
        while t < m and t > 0 and aa[t] == aa[t - 1]:
            t += 1
        bounds.append(min(t, m))
    bounds.append(m)
    counts = np.diff(bounds)
    S = int(counts.max()) if m else 1
    pv = np.full((n_shards, S), np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
    pt = np.zeros((n_shards, S), dtype=np.int32)
    ps = np.zeros((n_shards, S), dtype=np.int32)
    for i in range(n_shards):
        lo, hi = bounds[i], bounds[i + 1]
        pv[i, : hi - lo] = values[lo:hi]
        pt[i, : hi - lo] = taxids[lo:hi]
        ps[i, : hi - lo] = species[lo:hi]
    return pv, pt, ps, counts.astype(np.int32)


def device_put_sharded_index(mesh, pv, pt, ps, counts):
    """shard_index's arrays on the mesh: cells[i][c] = (values int64
    holding the u64 bits, taxids, species, count) of shard c, uploaded
    once per distinct device."""
    def column(c, d):
        v = torch.from_numpy(np.ascontiguousarray(pv[c]).view(np.int64))
        return (v.to(d), torch.from_numpy(np.ascontiguousarray(pt[c])).to(d),
                torch.from_numpy(np.ascontiguousarray(ps[c])).to(d),
                int(counts[c]))

    return mesh.place(column)


def _probe_local(q_kmers, q_frames, q_valid, db_values, db_count, db_taxids,
                 db_species, cap, kmer_format):
    """Single-shard probe of the plain sorted arrays; queries owned by
    other shards yield zero rows.  Returns [N, cap] tensors (sel bool,
    the rest int32, zero where not selected)."""
    S = db_values.shape[0]
    db_aa = (db_values >> DNA_BITS) & _M40
    q_aa = (q_kmers >> DNA_BITS) & _M40
    lo = torch.searchsorted(db_aa, q_aa, side="left").clamp(max=db_count)
    hi = torch.searchsorted(db_aa, q_aa, side="right").clamp(max=db_count)
    offs = torch.arange(cap, device=q_kmers.device)[:, None]
    idx = (lo[None, :] + offs).clamp(0, S - 1)
    cmask = (offs < (hi - lo)[None, :]) & q_valid[None, :]
    t_dna = (db_values[idx] & _DNA_MASK).to(torch.int32)
    q_dna = (q_kmers & _DNA_MASK).to(torch.int32)[None, :]
    sel, hsum, rh = _hamming_filter(t_dna, q_dna, cmask, q_frames,
                                    kmer_format)
    z = lambda a: torch.where(sel, a, 0).T.contiguous()
    return {"sel": sel.T.contiguous(), "hamming": z(hsum), "rh": z(rh),
            "taxid": z(db_taxids[idx]), "species": z(db_species[idx]),
            "dna_enc": z(t_dna)}


def _rows(mesh, reads, lengths):
    """Each local dp row's slice of a [B, L] batch, on the row's device
    (B a multiple of dp)."""
    Bl = reads.shape[0] // mesh.shape["dp"]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    return {i: (t(reads[i * Bl:(i + 1) * Bl]).to(mesh.row_device(i)),
                t(lengths[i * Bl:(i + 1) * Bl]).to(mesh.row_device(i)))
            for i in mesh.local_rows}


def _probe_row_merged(mesh, i, reads, lens, index, cap, kmer_format,
                      syncmer, smer_len):
    """Row i: extract, probe every cell's plain shard, merge onto the
    row's device (all fields summed as int32, sel included)."""
    qk, qp, qf, qs, qv, shapes, _ = flagship.extract_queries_step(
        reads, lens, syncmer=syncmer, smer_len=smer_len,
        kmer_format=kmer_format)
    dev = mesh.row_device(i)
    merged = None
    for c, d in enumerate(mesh.devices[i]):
        dbv, dbt, dbs, cnt = index[i][c]
        out = _probe_local(qk.to(d), qf.to(d), qv.to(d), dbv, cnt, dbt, dbs,
                           cap, kmer_format)
        out = {k: v.to(dev, non_blocking=True).to(torch.int32)
               for k, v in out.items()}
        merged = out if merged is None else \
            {k: merged[k] + out[k] for k in merged}
    return merged, (shapes[0], qp, qf, qs)


def make_sharded_classify_step(mesh, cap: int = 16, kmer_format: int = 2,
                               syncmer: bool = False, smer_len: int = 5):
    """A classify step over `mesh`: step(reads [B, L] uint8, lengths [B],
    index) with index from device_put_sharded_index and B a multiple of
    dp.  Returns a dict of per-local-row lists of [N_row, cap] int32
    match tensors (merged over 'db'; read ids local to the row) plus
    pos / frame / seq_id per row, and match_count (selected candidates
    over the local rows)."""
    def step(reads, lengths, index):
        out = {k: [] for k in ("sel", "hamming", "rh", "taxid", "species",
                               "dna_enc", "pos", "frame", "seq_id")}
        count = 0
        for i, (r, l) in _rows(mesh, reads, lengths).items():
            merged, (_, qp, qf, qs) = _probe_row_merged(
                mesh, i, r, l, index, cap, kmer_format, syncmer, smer_len)
            for k, v in merged.items():
                out[k].append(v)
            out["pos"].append(qp)
            out["frame"].append(qf)
            out["seq_id"].append(qs)
            count += int((merged["sel"] > 0).sum())
        out["match_count"] = count
        return out

    return step


def make_sharded_fused_dp_step(mesh, cap: int = 16, kmer_format: int = 2,
                               syncmer: bool = False, smer_len: int = 5,
                               min_cons: int = 4, min_cons_euk: int = 9,
                               path_block: int = 16, path_width: int = 4096):
    """The plain-probe step above followed, per dp row, by the plain
    dp_torch chain (sort_candidates -> path_dp -> pack_paths_blocked ->
    compact_columns).  step(reads, lengths, index) returns per local row
    (packed int32 [7, path_width], path count); g ids are LOCAL to the
    row (add B_row * 6 * row for the batch's)."""
    def step(reads, lengths, index):
        out = {}
        for i, (r, l) in _rows(mesh, reads, lengths).items():
            merged, (shape, qp, _, _) = _probe_row_merged(
                mesh, i, r, l, index, cap, kmer_format, syncmer, smer_len)
            b, F, W = shape
            resh = lambda a: a.T.reshape(cap, b * F, W)
            fields = {"sel": resh(merged["sel"]) > 0,
                      "species": resh(merged["species"]),
                      "dna": resh(merged["dna_enc"]),
                      "rh": resh(merged["rh"]),
                      "ham": resh(merged["hamming"])}
            fields = dp_torch.sort_candidates(fields, fields["sel"],
                                              fields["ham"], fields["dna"])
            # constant along cap, so the sort does not move it
            pos = qp.reshape(1, b * F, W).expand(cap, b * F, W)
            md = torch.where((fields["species"] >> 30) & 1 != 0,
                             min_cons_euk, min_cons).to(torch.int32)
            dp = dp_torch.path_dp(
                fields["sel"], fields["species"], fields["dna"],
                fields["rh"], fields["ham"], pos, md,
                max_shift=(8 - smer_len) if syncmer else 1,
                kmer_format=kmer_format)
            cols, psel, _ = dp_torch.pack_paths_blocked(dp, path_block)
            out[i] = dp_torch.compact_columns(cols, psel,
                                              out_width=path_width)
        return out

    return step


# ---------------------------------------------------------------------- #
# the production steps: hash probe of the wide shards, db merge, the
# fused finish (path-DP kernel) per dp row

def merge_db(accs, device):
    """The db merge of one dp row: OR of the cells' sel, integer add of
    the five payload fields and of overflow, onto `device` — into the
    first cell's accumulators, which live there.  Exact, because a cell
    that does not own a query's AA run contributes zeros.  The copies
    from other devices are non-blocking."""
    out = accs[0]
    for a in accs[1:]:
        out["sel"] |= a["sel"].to(device, non_blocking=True)
        for k in _ADD_FIELDS:
            out[k] += a[k].to(device, non_blocking=True)
    return out


def make_sharded_stream_steps(mesh, *, cap: int, kmer_format: int = 2,
                              syncmer: bool = False, smer_len: int = 5,
                              min_cons: int = 4, min_cons_euk: int = 9,
                              path_width: int = 4096, win_frac: int = 256,
                              path_block: int = 16, hash_log2_rows: int = 8,
                              hash_chain: int = 1):
    """The three stages of a mesh batch: (extract, probe, finish).

    extract(rows) with rows = {dp row: (r1, j1, r2, j2)} on the row's
    device (r2 = j2 = None unpaired) returns the batch state:
    per row the query tensors (copied once to each other device of the
    row's cells) and one zeroed accumulator set per cell.
    probe(state, shards) folds one index range into every cell's
    accumulators, shards[i][c] = (quad, hash) of cell (i, c) — once for a
    resident index, once per range for a streamed one (mesh x streaming:
    AA runs never straddle a range or shard cut, so the accumulated
    cells equal a single probe).
    finish(state) runs the db merge and flagship.finish_stream_step per
    row and returns ({row: (packed_hdr, resident)}, the bytes the merge
    read from other cells); column 0 of packed_hdr holds the row's LOCAL
    stats (reduce_header makes them global).
    """
    ex_kw = dict(syncmer=syncmer, smer_len=smer_len, kmer_format=kmer_format,
                 win_frac=win_frac)
    n_db = mesh.shape["db"]

    def extract(rows):
        state = {}
        for i, (r1, j1, r2, j2) in rows.items():
            qk, qp, qf, qs, qv, shapes, win_over = \
                flagship.extract_queries_step(r1, j1, r2, j2, **ex_kw)
            q_on = {}
            for d in mesh.devices[i]:
                if d not in q_on:
                    q_on[d] = tuple(a.to(d, non_blocking=True)
                                    for a in (qk, qf, qv))
            state[i] = dict(
                qp=qp, qs=qs, shapes=shapes, win_over=win_over, q_on=q_on,
                compact5=flagship.compact5_fits(
                    r1.shape[0], r1.shape[1],
                    r2.shape[1] if r2 is not None else None),
                acc=[flagship.new_accumulators(cap, qk.shape[0], d)
                     for d in mesh.devices[i]])
        return state

    def probe(state, shards):
        for i, s in state.items():
            for c, d in enumerate(mesh.devices[i]):
                qk, qf, qv = s["q_on"][d]
                flagship.probe_range_step(
                    qk, qf, qv, *shards[i][c], s["acc"][c], cap=cap,
                    kmer_format=kmer_format, hash_log2_rows=hash_log2_rows,
                    hash_chain=hash_chain)

    def finish(state):
        out = {}
        merged = 0
        for i, s in state.items():
            merged += (n_db - 1) * (cap * s["qp"].shape[0] * ACC_SLOT_BYTES
                                    + 4)
            acc = merge_db(s.pop("acc"), mesh.row_device(i))
            out[i] = flagship.finish_stream_step(
                acc, s["qp"], s["qs"], s["shapes"], s["win_over"],
                min_cons=min_cons, min_cons_euk=min_cons_euk, cap=cap,
                path_width=path_width, path_block=path_block,
                compact5=s["compact5"], **ex_kw)
        return out, merged

    return extract, probe, finish


def make_sharded_fused_dp_prod(mesh, **kw):
    """The production mesh step over a resident index: step(rows, cells)
    = extract, one probe of every cell's shard (cells from
    packing.sharded_state_from_numpy), the db merge and the fused finish;
    keywords and result as make_sharded_stream_steps."""
    extract, probe, finish = make_sharded_stream_steps(mesh, **kw)

    def step(rows, cells):
        state = extract(rows)
        probe(state, cells)
        return finish(state)

    return step


def make_sharded_redundancy(mesh, *, dna_shift: int, n_quot: int,
                            part_w: tuple):
    """The redundancy filter over 'dp': red(residents, best_sp, tables,
    out_w=0) runs flagship.redundancy_counts on each local row's resident
    tensors with its row of best_sp ([dp, B_row + 1] int32, host) and the
    taxonomy tables of the row's device (tables[device] = (euler,
    lca_depth, lca_lift)); returns {row: packed2}.  On a card the row's
    best_sp goes up from a pinned copy without blocking, the row's first
    device operation (the kernel follows it on the stream).  The caching
    host allocator that hands out the pinned buffer reuses it only once
    the copy has landed, so a batch in flight never reads a later
    batch's values."""
    def red(residents, best_sp, tables, out_w=0):
        out = {}
        for i, res in residents.items():
            dev = mesh.row_device(i)
            bsp = torch.from_numpy(np.ascontiguousarray(best_sp[i]))
            if dev.type == "cuda":
                bsp = bsp.pin_memory()
            out[i] = flagship.redundancy_counts(
                *res, bsp.to(dev, non_blocking=True), *tables[dev],
                dna_shift=dna_shift, n_quot=n_quot, part_w=part_w,
                out_w=out_w)
        return out

    return red


def reduce_header(local, n_dp, across_processes=False):
    """The stats header over 'dp', on the host: local = {row: int [4]
    (candidate-cap overflow, path count, window-compaction overflow,
    blocked-emission overflow)} of this process's rows.  Returns {row:
    int64 [5]} in the layout of the JAX package's mesh header
    (parallel/sharding.py:401-414 there): rows 0, 2, 3 summed over all dp
    rows, row 1 the row's own path count, row 4 the largest row 1.  With
    across_processes the other processes' rows come in through one gloo
    all-reduce; every process must then call this for every header fetch
    in the same order (a retry one process takes and another does not
    would deadlock it)."""
    g = np.zeros((n_dp, 4), np.int64)
    for i, s in local.items():
        g[i] = s
    if across_processes:
        from .distributed import sum_over_processes

        g = sum_over_processes(g)
    tot = g.sum(0)
    wmax = g[:, 1].max()
    return {i: np.array([tot[0], g[i, 1], tot[2], tot[3], wmax], np.int64)
            for i in local}
