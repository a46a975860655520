"""End-to-end classification of single-end, paired-end and long reads
(host orchestration + device step).

Mirrors Classifier::startClassify (reference src/commons/Classifier.cpp:
44-164) with the stage boundaries moved to host<->device transfers:

  host:   FASTA/FASTQ decode -> padded uint8 batches
  device: 6-frame metamer extraction, index probe, path DP
          (models/flagship.fused_step_dp)
  host:   species scoring from the emitted paths (classify/taxonomer_vec)
  device: best-species redundancy filter (flagship.redundancy_counts)
  host:   per-read assignment + reporting

Batches run through a software pipeline: device work of later batches
is queued while the host scores earlier ones, and every device->host
copy is a non-blocking copy into pinned memory behind a CUDA event.

The reference's match-buffer-overflow retry (matchPerKmer += 4 and
re-run, Classifier.cpp:127-131) becomes the per-batch overflow-retry
ladder of the path-DP finishes (_climb_ladder).

With min_cons_cnt < 2 the path DP's validity domain ends, and the
host-match flow runs instead: the device extracts, probes the raw
sorted arrays and compacts the matches (flagship.fused_step), the host
runs the whole scorer on them (_dispatch_batch_host /
_finish_batch_host).  Paired reads (--seq-mode 2) ride either flow with
mate 2 as a second part.  Long reads (--seq-mode 3) ride the same
batches up to LONG_ROW_CAP bases; longer ones are redone whole from
overlapping chunks through the host-match step (_classify_long_read),
and so are those of an unpaired batch of classify_batch_arrays.

With a device-memory budget (--hbm-gb) smaller than twice the packed
index, the index stays on the host, cut into ranges at AA boundaries,
and every GROUP of batches sweeps the ranges through the device
(_dispatch_group_stream, _drive_batches_stream); a read beyond the row
cap then probes the same ranges (_stream_probe_matches).

METABULI_DEVICE_ASSIGN=1 selects the device-assign flow on a resident
index: species scoring and tie/LCA assignment run on the device too
(flagship.fused_step_full), and the host decodes one [6, B+1] record
table per batch (_dispatch_batch_full, _finish_full_phase1).

Given a (dp, db) mesh (parallel/sharding.Mesh), the index is cut over
'db' and every batch over 'dp': each dp row extracts its reads, each
cell probes its shard, the db merge sums a row's cells and each row runs
the path-DP finish (parallel/sharding.make_sharded_stream_steps,
_dispatch_batch_dp_sharded); with --hbm-gb smaller than twice the index
over the 'db' axis, every batch sweeps host ranges of n_db shards
through the mesh (mesh x streaming).  The host finish is the same for
one device and a mesh: a single device is a mesh of one row here, and a
mesh's stats header is reduced over its rows (across processes too)
before the retry ladder reads it.

Under --em every read keeps its top species scores (ReadResult.
species_scores) for classify/em.run_em, so the device-assign flow, which
carries none, stays off.

The path-DP flows probe one layout of the index, resident, streamed and
on a mesh alike: 512-byte rows with the AA hash (index/packing.py).
METABULI_DEBUG_RETRY prints each overflow retry of the host-scoring
ladder to stderr.

classify_file reads with the native C++ batch reader
(io/native_reader.py) when its library builds, else with the Python
reader (io/fasta.py); Classifier.reader names the one that ran.

Tracing: every span is opened through the classifier's current
`timer.stage(name)` (utils/timing.StageTimer, which lists the spans),
looked up when the span opens, so a timer put in its place after
construction sees them all.  Set-up: `db_load`, `layout`, `upload`
(their seconds also kept in Classifier.setup_times).  Streamed, every
range upload is one more `upload` span (_RangeStream.upload), holding
`range_wait` and `range_stage` on the card.  A batch:
`input` or `pad`, then `dispatch` with `prep`, `extract`, `probe`,
`paths` (and `assign` on the device-assign flow) nested in it, on the
resident, streamed, mesh and device-assign flows alike (the host-match
flow has `prep`, `extract` and `probe`); then the finish's stages.
A hook on Python's garbage collector, registered when the classifier is
made and removed when it is freed, opens a `gc` span around each
collection.  While a torch profiler runs, each span is also a
record_function range "stage:<name>".
"""

import gc
import math
import os
import sys
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch

from ..device import resolve_device
from ..index.format import KmerIndex, load_index
from ..index.packing import (load_or_pack_wide, load_or_shard,
                             match_state_from_numpy,
                             sharded_state_from_numpy, state_from_numpy,
                             stream_state_from_numpy)
from ..io.fasta import read_seq_file
from ..ops import compact_torch
from ..ops import mask as mask_ops
from ..ops.dp_torch import decode_paths
from ..parallel.sharding import (Mesh, make_sharded_redundancy,
                                 make_sharded_stream_steps, reduce_header)
from ..utils.timing import StageTimer
from .taxonomer import MATCH_DTYPE, ReadResult, sort_matches
from .taxonomer_vec import VectorTaxonomer


@dataclass
class ClassifyParams:
    seq_mode: int = 2              # 1 single, 2 paired, 3 long
    min_score: float = 0.0
    min_sp_score: float = 0.0
    min_cons_cnt: int = 4
    min_cons_cnt_euk: int = 9
    tie_ratio: float = 0.95
    mask_mode: int = 0
    mask_prob: float = 0.9
    accession_level: int = 0
    em: bool = False
    batch_size: int = 512
    max_cap: int = 4096
    hbm_budget_gb: float = 0.0     # device-memory budget; 0 = resident


class QueryRecord:
    """__slots__ on purpose — one per read per batch (see ReadResult)."""

    __slots__ = ("name", "length1", "length2", "result")

    def __init__(self, name, length1, length2=0, result=None):
        self.name = name
        self.length1 = length1
        self.length2 = length2
        self.result = result

    @property
    def total_length(self):
        return self.length1 + self.length2

    @property
    def covered_length(self):
        """The length the reference REPORTS and scores against:
        getMaxCoveredLength per mate (Reporter.cpp:56, queryLength)."""
        out = int(_max_covered(np.array([self.length1]))[0])
        if self.length2:
            out += int(_max_covered(np.array([self.length2]))[0])
        return out


def _max_covered(lens):
    """Reference LocalUtil::getMaxCoveredLength (LocalUtil.h:45-59): the
    read length rounded down to a multiple of 3 minus 3."""
    lens = np.asarray(lens)
    return np.maximum(lens - np.choose(lens % 3, [3, 4, 2]), 0)


def _bucket_len(n: int, quantum: int = 24) -> int:
    """Pad read length to a bucket of 24 nt (8 codons): every probe/DP
    tensor scales with lmax//3-7 windows."""
    return max(quantum, quantum * math.ceil(n / quantum))


def _pow2_bucket(n: int, floor: int = 4096) -> int:
    return max(floor, 1 << max(0, (int(n) - 1)).bit_length())


def _step_bucket(n: int, step: int, floor: int) -> int:
    return max(floor, step * ((int(n) + step - 1) // step))


def _est_update(cur: int, n: int, step: int, floor: int) -> int:
    """Prefix-estimate update with hysteresis: grow immediately, shrink
    only when the need sits >= 2 steps below the current estimate."""
    want = _step_bucket(n, step, floor)
    if want > cur or want <= cur - 2 * step:
        return want
    return cur


class _HostCopy:
    """Device->host copy of a tensor that lands asynchronously: a
    non-blocking copy into pinned memory plus a CUDA event (on the CPU
    the tensor is simply kept)."""

    def __init__(self, t):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host, self.event = t, None

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _RangeStream:
    """The host-resident ranges of a streamed index and their way to the
    device.  Ranges are pageable host memory (pinning them all would
    double the host memory of a database that already needs streaming);
    a range is copied into one of two pinned staging buffers of one
    range's size and goes to the device from there without blocking, an
    event guarding each staging buffer until its copy has landed.  On
    the CPU a range is used where it lies."""

    def __init__(self, quads, hts, device):
        self.quads, self.hts = quads, hts        # int32 [n, rows, 128]
        self.device = device
        self.range_bytes = (quads[0].numel() + hts[0].numel()) * 4
        self.sweeps = 0             # counted by the callers, one per sweep
        self.bytes_uploaded = 0
        self.copy_ms = 0.0          # device time of the settled uploads
        self._pinned = self._pending = None
        if device.type == "cuda":
            self._pinned = [tuple(torch.empty(a.shape[1:], dtype=a.dtype,
                                              pin_memory=True)
                                  for a in (quads, hts)) for _ in range(2)]
            self._pending = [None, None]

    def _settle(self, s):
        """Wait until staging buffer `s` has been read by its copy."""
        if self._pending[s] is not None:
            t0, t1 = self._pending[s]
            t1.synchronize()
            self.copy_ms += t0.elapsed_time(t1)
            self._pending[s] = None

    def upload(self, r, stage):
        """(quad_r, hash_r) of range r on the device, inside one `upload`
        span of `stage` (the classifier's timer.stage).  On the card the
        span holds `range_wait` (the wait for the staging buffer's
        previous copy) and `range_stage` (the range's copy into it), and
        then launches the host-to-device copies.  The caller drops both
        tensors before it asks for the next range: all ranges have one
        shape, so the allocator hands the same block out again and one
        range at a time lives on the device."""
        with stage("upload"):
            if self._pinned is None:
                return self.quads[r], self.hts[r]
            s = r % 2
            with stage("range_wait"):
                self._settle(s)
            pinned = self._pinned[s]
            with stage("range_stage"):
                pinned[0].copy_(self.quads[r])
                pinned[1].copy_(self.hts[r])
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(self.device)
            t0.record(stream)
            out = tuple(a.to(self.device, non_blocking=True) for a in pinned)
            t1.record(stream)
            self._pending[s] = (t0, t1)
            self.bytes_uploaded += self.range_bytes
            return out

    def stats(self):
        """Sweeps, bytes uploaded and the device seconds their copies
        took, so far (waits for the copies in flight), and the ranges
        held and the bytes of one."""
        if self._pinned is not None:
            for s in range(2):
                self._settle(s)
        return {"sweeps": self.sweeps, "bytes": self.bytes_uploaded,
                "copy_s": self.copy_ms / 1e3,
                "range_bytes": self.range_bytes,
                "n_ranges": int(self.quads.shape[0])}


class _FullReads:
    """Whole reads of a file by index, in increasing order, from the
    Python reader: one pass over the file however many are asked for."""

    def __init__(self, path):
        self._path, self._it, self._at, self._seq = path, None, -1, None

    def get(self, i):
        if self._it is None:
            self._it = read_seq_file(self._path)
        while self._at < i:
            self._seq = next(self._it).seq
            self._at += 1
        return self._seq


def _drop_gc_hook(hook):
    """Takes a freed classifier's hook off Python's garbage collector."""
    try:
        gc.callbacks.remove(hook)
    except ValueError:
        pass


class Classifier:
    # the set-up spans, whose seconds Classifier.setup_times keeps
    SETUP_STAGES = ("db_load", "layout", "upload")

    def __init__(self, db_dir, params: ClassifyParams, mesh=None,
                 device=None):
        self.db_dir = db_dir
        self._start_tracing()
        with self.timer.stage("db_load"):
            index = load_index(db_dir)
        self._init_from_index(index, params, mesh=mesh, device=device)

    @classmethod
    def from_memory(cls, index: KmerIndex, params: ClassifyParams,
                    mesh=None, device=None):
        """Wire a Classifier around an in-memory index (no disk round-trip)."""
        self = cls.__new__(cls)
        self.db_dir = None
        self._start_tracing()
        self._init_from_index(index, params, mesh=mesh, device=device)
        return self

    def _start_tracing(self):
        """A fresh StageTimer, and one hook on Python's garbage collector
        that opens a `gc` span on the classifier's current timer when a
        collection starts and closes it when the collection stops.  The
        hook holds the classifier weakly and is taken off gc.callbacks
        when the classifier is freed."""
        self.timer = StageTimer()
        ref = weakref.ref(self)
        open_spans = []

        def hook(phase, info):
            if phase == "start":
                clf = ref()
                if clf is not None:
                    span = clf.timer.stage("gc")
                    span.__enter__()
                    open_spans.append(span)
            elif open_spans:
                open_spans.pop().__exit__(None, None, None)

        gc.callbacks.append(hook)
        weakref.finalize(self, _drop_gc_hook, hook)

    def _init_from_index(self, index: KmerIndex, params: ClassifyParams,
                         mesh=None, device=None):
        # multi-device: a (dp, db) parallel.sharding.Mesh; its first
        # local row's device is the classifier's device.  _grid is the
        # dp-row layout the host finish walks: the mesh, or one row of
        # one cell
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(device) if mesh is None \
            else mesh.row_device(mesh.local_rows[0])
        self._grid = self.mesh or Mesh([[self.device]])
        self.params = params
        self.index = index
        # DB-range streaming: when the packed index (16 B per metamer)
        # takes more than half the device-memory budget, keep it on the
        # host and probe it in range passes
        budget_gb = float(params.hbm_budget_gb or 0) \
            or float(os.environ.get("METABULI_HBM_GB", "0") or 0)
        self._hbm_budget_gb = budget_gb
        self._shard_bytes = len(index.values) * 16
        self._streaming = (self.mesh is None and budget_gb > 0
                           and self._shard_bytes > budget_gb * (1 << 30) * 0.5)
        self.taxonomy = index.taxonomy
        meta = index.meta
        self.kmer_format = int(meta.get("kmer_format", 2))
        self.syncmer = bool(meta.get("syncmer", False))
        self.smer_len = int(meta.get("smer_len", 5))
        # caps round UP to multiples of 4, starting at the run length that
        # covers 99.9% of entries; the retry ladder doubles up to the
        # longest run
        self._cap_ceiling = -(-index.max_aa_run() // 4) * 4
        self.cap = int(min(max(-(-index.cap_aa_run() // 4) * 4, 4),
                           params.max_cap))
        self.taxonomer = VectorTaxonomer(
            self.taxonomy,
            kmer_format=self.kmer_format,
            syncmer=self.syncmer,
            smer_len=self.smer_len,
            seq_mode=params.seq_mode,
            min_score=params.min_score,
            min_sp_score=params.min_sp_score,
            min_cons_cnt=params.min_cons_cnt,
            min_cons_cnt_euk=params.min_cons_cnt_euk,
            tie_ratio=params.tie_ratio,
            # DB-sticky handshake: an accession-level DB re-applies its
            # Accession_level at classify unless the user overrides
            accession_level=(params.accession_level
                             or int(meta.get("accession_level", 0))),
            em=params.em,
        )
        self.total_match_cnt = 0
        self._match_state = None        # host-match arrays, at first use
        self.reader = None              # "native" | "python", last file
        self.full_retries = {}          # device-assign retries by rung
        self._fetch_estimate = 1 << 17  # match rows fetched eagerly
        self._path_estimate = 1 << 14   # emitted-path rows fetched eagerly
        # redundancy pair prefix compacted on the device (sticky pow2;
        # phase 2 re-runs wider on overflow)
        self._pair_width = 1 << 13
        # static path-compaction width: grows on overflow (sticky),
        # shrinks one power of two after _WIDTH_SHRINK_AFTER consecutive
        # batches needing < 1/3 of it
        self._path_width = 1 << 16
        self._width_lo_streak = 0
        # per-lane slot count of the path DP's blocked emission; lanes
        # with more emitted paths trigger a sticky doubled re-run
        self._path_block = 16
        # syncmer window-compaction width, in 256ths of W (~62% of windows
        # pass the anchor rule on random sequence)
        self._win_frac = 184 if self.syncmer else 256
        self._init_device_dp()
        self.setup_times = {n: self.timer.totals[n]
                            for n in self.SETUP_STAGES if self.timer.counts[n]}

    def _init_device_dp(self):
        """Index (resident on self.device, or host ranges when streaming)
        + LCA tables on self.device, for the path-DP flow: valid when
        minConsCnt >= 2 (see ops/dp_torch); below that every batch takes
        the host-match flow and the wide index is never packed."""
        p = self.params
        self.use_device_dp = p.min_cons_cnt >= 2 and p.min_cons_cnt_euk >= 2
        # device-assign flow: score species + pick classifications on
        # the device so only [6, B+1] records come home.  Off unless
        # pinned: it adds operators to enqueue, and the host enqueue is
        # what bounds a batch (PERF.md section 5).  Streaming keeps the
        # host-scoring flow, and so does --em: the flow carries no
        # per-read species scores.
        self._device_assign = (
            os.environ.get("METABULI_DEVICE_ASSIGN") == "1"
            and self.use_device_dp and not self._streaming
            and self.mesh is None and not p.em)
        # paths of one (read, species) run the device-assign step
        # combines; a longer run triggers a sticky doubled re-run
        self._combine_k = 8
        self._ranges = None
        if not self.use_device_dp:
            if self.mesh is not None:
                raise ValueError(
                    "multi-device classify requires min_cons_cnt >= 2 "
                    "(the device path-DP flow)")
            if self._streaming:
                raise ValueError(
                    "DB-range streaming requires min_cons_cnt >= 2 "
                    "(the device path-DP flow)")
            return
        stage = self.timer.stage
        with stage("layout"):
            n = self.taxonomy.num_nodes()
            euk = self.taxonomy.eukaryota_id()
            if euk:
                mask = np.asarray(self.taxonomy.is_ancestor(euk,
                                                            np.arange(n)))
            else:
                mask = np.zeros(n, dtype=bool)
            # euk-ness rides in bit 30 of the species payload
            sp = self.index.species.astype(np.int64)
            assert int(sp.max(initial=0)) < (1 << 30)
            sp_euk = (sp | (mask[sp].astype(np.int64) << 30)).astype(np.int32)
            depth, lift = self.taxonomy.lca_lift_tables()
            ef = self.taxonomy.euler_first.astype(np.int64)
            # the redundancy step packs (hamming, euler_first) into one
            # i32 key: 6 bits hamming above a 25-bit euler coordinate
            assert len(self.taxonomy.euler) < (1 << 25), \
                "taxonomy too large for packed-key redundancy kernel"
            db_ef = ef[self.index.taxids.astype(np.int64)].astype(np.int32)
        if self.mesh is not None:
            self._init_mesh(db_ef, sp_euk, depth, lift, ef.astype(np.int32))
            return
        if self._streaming:
            # the index stays on the HOST, cut into AA-boundary ranges of
            # at most half the budget; classify loops range passes per
            # group of batches
            budget = self._hbm_budget_gb * (1 << 30) * 0.5
            n_ranges = max(2, int(np.ceil(self._shard_bytes / budget)))
            with stage("layout"):
                quads, hts, log2_rows, chain, _ = load_or_shard(
                    self.index.values, db_ef, sp_euk, n_ranges)
            with stage("upload"):
                st = stream_state_from_numpy(
                    quads, hts, log2_rows, chain, depth, lift,
                    self.taxonomy.euler.astype(np.int32),
                    ef.astype(np.int32), self.device)
                self._ranges = _RangeStream(st.pop("stream_quads"),
                                            st.pop("stream_hts"), self.device)
            self._n_ranges = n_ranges
            for k, v in st.items():
                setattr(self, k, v)
            self._tables = {self.device: (self.euler, self.lca_depth,
                                          self.lca_lift)}
            return
        with stage("layout"):
            rows, ht, log2_rows, chain, db_m = load_or_pack_wide(
                self.index.values, db_ef, sp_euk)
        with stage("upload"):
            st = state_from_numpy(rows, ht, log2_rows, chain, db_m, depth,
                                  lift, self.taxonomy.euler.astype(np.int32),
                                  ef.astype(np.int32), self.device)
        for k, v in st.items():
            setattr(self, k, v)
        self._tables = {self.device: (self.euler, self.lca_depth,
                                      self.lca_lift)}
        # what every resident dispatch hands the probe
        self._probe_kw = dict(hash_table=self.hash_table,
                              hash_log2_rows=self.hash_log2_rows,
                              hash_chain=self.hash_chain, db_m=self.db_m)

    def _init_mesh(self, db_ef, sp_euk, depth, lift, ef):
        """The index cut over the mesh's 'db' axis at AA-part boundaries,
        one hash geometry for all shards.  Resident: shard c on the device
        of every cell of column c, once per device.  Mesh x streaming:
        when the index exceeds the budget summed over the 'db' axis, it
        stays on the host cut into n_ranges x n_db shards; every batch
        sweeps the ranges, range r's shards r*n_db .. r*n_db+n_db-1 one to
        each db column, through a _RangeStream per distinct device.  The
        host shards are also the range set a read beyond the row cap
        probes (_stream_probe_matches)."""
        n_db = self.mesh.shape["db"]
        budget = self._hbm_budget_gb * (1 << 30) * 0.5
        self._mesh_stream = bool(budget > 0
                                 and self._shard_bytes > budget * n_db)
        n_ranges = max(2, int(np.ceil(self._shard_bytes / (budget * n_db)))) \
            if self._mesh_stream else 1
        with self.timer.stage("layout"):
            quads, hts, log2_rows, chain, _ = load_or_shard(
                self.index.values, db_ef, sp_euk, n_ranges * n_db)
        with self.timer.stage("upload"):
            st = sharded_state_from_numpy(
                quads, hts, log2_rows, chain, depth, lift,
                self.taxonomy.euler.astype(np.int32), ef, self.mesh,
                resident=not self._mesh_stream)
        self.hash_log2_rows, self.hash_chain = log2_rows, chain
        self._host_shards = (st["stream_quads"], st["stream_hts"])
        self._n_ranges = n_ranges * n_db
        self._mesh_n_ranges = n_ranges
        self._cells = st.get("cells")
        self._tables = st["tables"]
        self.euler, self.lca_depth, self.lca_lift = self._tables[self.device]
        self._mesh_ranges = {d: _RangeStream(*self._host_shards, d)
                             for d in self.mesh.local_devices()} \
            if self._mesh_stream else {}
        self._ranges = self._mesh_ranges.get(self.device)
        self.mesh_merged_bytes = 0      # read by the db merges so far

    def _host_match_state(self):
        """The raw sorted arrays + bucket tables the host-match step
        probes, uploaded at first use: runs that stay on the path-DP flow
        never pay their 20 B per metamer of device memory."""
        if self._match_state is None:
            from ..ops.match_torch import build_buckets

            b_lo, aa_lo, shift, steps = build_buckets(self.index.values)
            self._match_state = match_state_from_numpy(
                self.index.values, self.index.taxids, self.index.species,
                b_lo, aa_lo, shift, steps, self.device)
        return self._match_state

    # ------------------------------------------------------------------ #
    def _read_batches(self, path1, path2=None) -> Iterator[tuple]:
        """Yield (names, seqs1, seqs2) lists of batch_size reads; seqs2
        holds None per read without a second file (the two files are read
        in lock-step)."""
        it1 = read_seq_file(path1)
        it2 = read_seq_file(path2) if path2 else None
        B = self.params.batch_size
        names, s1, s2 = [], [], []
        n_seen = 0
        for rec1 in it1:
            rec2 = next(it2, None) if it2 else None
            if it2 and rec2 is None:
                raise ValueError(
                    f"paired read files differ in length: {path2} ends "
                    f"after {n_seen} reads, {path1} has more")
            n_seen += 1
            names.append(rec1.name)
            s1.append(rec1.seq)
            s2.append(rec2.seq if rec2 else None)
            if len(names) == B:
                yield names, s1, s2
                names, s1, s2 = [], [], []
        if it2 and next(it2, None) is not None:
            raise ValueError(
                f"paired read files differ in length: {path1} ends after "
                f"{n_seen} reads, {path2} has more")
        if names:
            yield names, s1, s2

    def _pad_batch(self, seqs: List[str]):
        lmax = _bucket_len(max((len(s) for s in seqs), default=1))
        B = len(seqs)
        arr = np.full((B, lmax), ord("N"), dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        for i, s in enumerate(seqs):
            if self.params.mask_mode:
                s = mask_ops.mask_low_complexity(s, self.params.mask_prob)
            b = s.encode("ascii", "replace")[:lmax]
            arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lens[i] = len(b)
        return arr, lens

    def _crop(self, a, l, B):
        """One mate cropped to its own length bucket (bounds the device
        shapes): (host rows, clipped host lengths)."""
        l = np.minimum(np.asarray(l, dtype=np.int32), a.shape[1])
        lmax = _bucket_len(int(l.max()) if B else 1)
        return np.ascontiguousarray(a[:, :lmax]), l

    def _up(self, a):
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _prep_mates(self, a1, l1, a2, l2, B):
        """Each mate cropped to its length bucket, its reads and lengths
        moved to the device: (r1, j1, l1, r2, j2, l2), the reads and
        lengths on the device and the clipped host lengths of each mate,
        mate 2's three None unpaired."""
        out = ()
        for a, l in ((a1, l1), (a2, l2)):
            if a is None:
                out += (None, None, None)
            else:
                h, l = self._crop(a, l, B)
                out += (self._up(h), self._up(l), l)
        return out

    def _knobs(self, cap, path_width, win_frac, path_block):
        """A dispatch's (cap, path_width, win_frac, path_block): each
        value given, else the classifier's sticky one."""
        return (cap or self.cap, path_width or self._path_width,
                win_frac or self._win_frac, path_block or self._path_block)

    _WIDTH_SHRINK_AFTER = 4
    _WIDTH_FLOOR = 1 << 13

    def _update_path_width(self, n_paths: int):
        if n_paths * 3 < self._path_width \
                and self._path_width > self._WIDTH_FLOOR:
            self._width_lo_streak += 1
            if self._width_lo_streak >= self._WIDTH_SHRINK_AFTER:
                self._path_width = max(self._path_width >> 1,
                                       self._WIDTH_FLOOR)
                self._width_lo_streak = 0
        else:
            self._width_lo_streak = 0

    def range_stats(self):
        """The streamed index's _RangeStream.stats() on this process's
        device (sweeps, bytes uploaded, the device seconds of their
        copies, the ranges and the bytes of one), or None while no range
        is held on the host."""
        return None if self._ranges is None else self._ranges.stats()

    def classify_batch(self, names, seqs1, seqs2=None):
        """Classify one batch of string reads: pads (and masks) them as
        the Python reader's batches are, then classify_batch_arrays.
        Mate 2 is used only when some entry of seqs2 is not None."""
        with self.timer.stage("pad"):
            a1, l1 = self._pad_batch(seqs1)
            a2 = l2 = None
            if seqs2 is not None and any(s is not None for s in seqs2):
                a2, l2 = self._pad_batch(seqs2)
        return self.classify_batch_arrays(names, a1, l1, a2, l2)

    def classify_batch_arrays(self, names, a1, l1, a2=None, l2=None):
        """One batch of padded uint8 rows (a2/l2 None unpaired) through the
        halves drive_batches runs, so the flow, the retry ladder and its
        sticky knobs, streaming and the mesh behave as for a batch of
        drive_batches.  Returns the QueryRecords of the reads this
        process reports (all of them in one process), in input order.

        A read of an unpaired batch beyond LONG_ROW_CAP, in --seq-mode 1
        as in 3, leaves the batch (its length zeroed) and is redone from
        its row by the chunk pass, as classify_file does under
        --seq-mode 3: the batch pass is not widened to it, and the chunk
        pass gives what the read classified whole gives.  Pairs are
        classified whole in their rows, as classify_file does."""
        l1 = np.asarray(l1)
        over = [] if a2 is not None else \
            np.nonzero(l1 > self.LONG_ROW_CAP)[0].tolist()
        if over:
            rows = {i: a1[i, :l1[i]] for i in over}
            l1 = l1.copy()
            l1[over] = 0
        results = self._finish_complete(self._finish_partial(
            self._dispatch_batch(names, a1, l1, a2, l2)))
        if over:
            at = {r: k for k, r in enumerate(self._local_reads(len(names)))}
            for i in over:
                if i in at:
                    results[at[i]] = self._classify_long_row(names[i],
                                                             rows[i])
        return results

    # -- async halves: dispatch launches device work, finish pulls + scores
    def _dispatch_batch(self, names, a1, l1, a2=None, l2=None, cap=None):
        if self.use_device_dp:
            if self._device_assign and self._fits_compact5(a1, l1, a2, l2):
                return self._dispatch_batch_full(names, a1, l1, a2, l2, cap)
            return self._dispatch_batch_dp(names, a1, l1, a2, l2, cap)
        return self._dispatch_batch_host(names, a1, l1, a2, l2, cap)

    @staticmethod
    def _fits_compact5(a1, l1, a2, l2):
        """The device-assign step reads the 5-column path layout only; a
        batch with rows too long for it (long reads beyond 16 kb) takes
        the host-scoring flow, which gives the same results."""
        from ..models.flagship import compact5_fits

        def lmax(a, l):
            n = int(np.minimum(np.asarray(l), a.shape[1]).max(initial=1))
            return _bucket_len(n)

        return compact5_fits(len(l1), lmax(a1, l1),
                             lmax(a2, l2) if a2 is not None else None)

    def _dispatch_batch_dp(self, names, a1, l1, a2=None, l2=None, cap=None,
                           path_width=None, win_frac=None, path_block=None):
        cap, path_width, win_frac, path_block = self._knobs(
            cap, path_width, win_frac, path_block)
        if self._streaming:
            # every retry of the ladder re-runs as a single-batch sweep
            return self._dispatch_group_stream(
                [(names, a1, l1, a2, l2)], cap=cap, path_width=path_width,
                win_frac=win_frac, path_block=path_block)[0]
        if self.mesh is not None:
            return self._dispatch_batch_dp_sharded(
                names, a1, l1, a2, l2, cap, path_width, win_frac, path_block)
        from ..models.flagship import fused_step_dp, part_widths

        B = len(names)
        with self.timer.stage("dispatch"):
            with self.timer.stage("prep"):
                r1, j1, l1, r2, j2, l2_c = self._prep_mates(a1, l1, a2, l2, B)
            packed_hdr, resident = fused_step_dp(
                r1, j1, self.db_quad, reads2=r2, lens2=j2,
                min_cons=int(self.params.min_cons_cnt),
                min_cons_euk=int(self.params.min_cons_cnt_euk),
                cap=cap, kmer_format=self.kmer_format,
                syncmer=self.syncmer, smer_len=self.smer_len,
                path_width=path_width, win_frac=win_frac,
                path_block=path_block, stage=self.timer.stage,
                **self._probe_kw)
            lmax2 = r2.shape[1] if r2 is not None else None
            part_w = part_widths(r1.shape[1], self.syncmer, self.kmer_format,
                                 self.smer_len, win_frac, lmax2=lmax2)
            return self._dp_ctx(names, a1, a2, l1, l2_c, cap,
                                {0: (packed_hdr, resident)}, B,
                                r1.shape[1], lmax2, part_w, path_block)

    def _dp_ctx(self, names, a1, a2, l1, l2, cap, outs, Bl, lmax1, lmax2,
                part_w, path_block):
        """What _finish_dp_phase1 needs of a dispatched batch: per dp row
        (outs = {row: (packed_hdr, resident)}, Bl reads a row) the paths,
        the resident tensors and the copy that carries the stats header
        (column 0) and the estimated path prefix home together; and the
        emission block the batch was dispatched with."""
        width = next(iter(outs.values()))[0].shape[1] - 1
        est = min(self._path_estimate, width)
        rows = {i: {"paths": ph, "prefix": _HostCopy(ph[:, :est + 1]),
                    "resident": res} for i, (ph, res) in outs.items()}
        lmax = lmax1 + (lmax2 + 3 if lmax2 is not None else 0)
        n_quot = lmax // int(self.taxonomer.dna_shift) + 2
        return {"dp": True, "names": names, "l1": l1, "l2": l2, "cap": cap,
                "a1": a1, "a2": a2, "rows": rows, "Bl": Bl,
                "path_width": width, "est": est, "n_quot": n_quot,
                "part_w": part_w, "path_block": path_block}

    # ------------------------------------------------------------------ #
    # multi-device: the (dp, db) mesh
    def _prep_arrays_sharded(self, a1, l1, a2, l2, B):
        """Pad the batch to a multiple of dp with zero-length reads, crop
        each mate to its length bucket, and upload each local dp row's
        slice (reads, lengths) to the row's device; a process uploads only
        its own rows.  Returns ({row: (r1, j1, r2, j2)}, host lengths of
        mate 1 and 2 (None unpaired), B_pad, lmax1, lmax2)."""
        dp = self.mesh.shape["dp"]
        B_pad = -(-max(B, 1) // dp) * dp
        Bl = B_pad // dp

        def pad(a):
            out = np.zeros((B_pad,) + a.shape[1:], dtype=a.dtype)
            out[:B] = a
            return out

        # per mate: padded rows, padded lengths
        h1, l1 = self._crop(a1, l1, B)
        host = [(pad(h1), pad(l1))]
        if a2 is not None:
            h2, l2 = self._crop(a2, l2, B)
            host.append((pad(h2), pad(l2)))
        rows = {}
        for i in self.mesh.local_rows:
            dev = self.mesh.row_device(i)
            up = lambda a: torch.from_numpy(np.ascontiguousarray(
                a[i * Bl:(i + 1) * Bl])).to(dev, non_blocking=True)
            r1, j1 = (up(a) for a in host[0])
            r2, j2 = (up(a) for a in host[1]) if a2 is not None \
                else (None, None)
            rows[i] = (r1, j1, r2, j2)
        return (rows, l1, l2 if a2 is not None else None, B_pad,
                h1.shape[1], h2.shape[1] if a2 is not None else None)

    def _dispatch_batch_dp_sharded(self, names, a1, l1, a2, l2, cap,
                                   path_width, win_frac, path_block):
        """A batch over the mesh: extract per dp row, probe per cell (the
        resident shards, or every host range in turn under mesh x
        streaming), the db merge and the path-DP finish per row.  Same
        ctx contract as the single-device dispatch, one entry a row."""
        from ..models.flagship import part_widths

        B = len(names)
        n_db = self.mesh.shape["db"]
        stage = self.timer.stage
        with stage("dispatch"):
            with stage("prep"):
                rows, l1, l2_c, B_pad, lm1, lm2 = self._prep_arrays_sharded(
                    a1, l1, a2, l2, B)
            extract, probe, finish = make_sharded_stream_steps(
                self.mesh, cap=cap, kmer_format=self.kmer_format,
                syncmer=self.syncmer, smer_len=self.smer_len,
                min_cons=int(self.params.min_cons_cnt),
                min_cons_euk=int(self.params.min_cons_cnt_euk),
                path_width=path_width, win_frac=win_frac,
                path_block=path_block, hash_log2_rows=self.hash_log2_rows,
                hash_chain=self.hash_chain)
            with stage("extract"):
                state = extract(rows)
            with stage("probe"):
                if self._mesh_stream:
                    for rs in self._mesh_ranges.values():
                        rs.sweeps += 1
                    for r in range(self._mesh_n_ranges):
                        shards = self.mesh.place(
                            lambda c, d: self._mesh_ranges[d].upload(
                                r * n_db + c, stage))
                        probe(state, shards)
                        del shards      # one range at a time on the devices
                else:
                    probe(state, self._cells)
            with stage("paths"):
                outs, merged = finish(state)
            self.mesh_merged_bytes += merged
            part_w = part_widths(lm1, self.syncmer, self.kmer_format,
                                 self.smer_len, win_frac, lmax2=lm2)
            return self._dp_ctx(names, a1, a2, l1, l2_c, cap, outs,
                                B_pad // self.mesh.shape["dp"], lm1, lm2,
                                part_w, path_block)

    # ------------------------------------------------------------------ #
    # DB-range streaming
    def _dispatch_group_stream(self, group, cap=None, path_width=None,
                               win_frac=None, path_block=None):
        """DB-range streaming dispatch over a GROUP of read batches.

        Extract every batch once, then loop range passes: each host
        range is uploaded ONCE per sweep and probed against ALL batches
        before it is dropped — the dominant cost (re-uploading the
        index) is divided by len(group).  The device holds one range +
        len(group) accumulator sets.  Returns one ctx per batch with the
        same contract as _dispatch_batch_dp, so the two-phase finish and
        all overflow-retry protocols apply unchanged (retries re-run
        single-batch).

        Reference analog: the --max-ram query-split x DB-stream loop
        (QueryIndexer.cpp:24-147, DeltaIdxReader.h:214-229) with the
        roles flipped — queries stay resident, the index streams."""
        from ..models.flagship import (compact5_fits, extract_queries_step,
                                       finish_stream_step, new_accumulators,
                                       part_widths, probe_range_step)

        cap, path_width, win_frac, path_block = self._knobs(
            cap, path_width, win_frac, path_block)
        ex_kw = dict(syncmer=self.syncmer, smer_len=self.smer_len,
                     kmer_format=self.kmer_format, win_frac=win_frac)
        stage = self.timer.stage
        with stage("dispatch"):
            per = []
            for names, a1, l1, a2, l2 in group:
                B = len(names)
                with stage("prep"):
                    r1, j1, l1, r2, j2, l2_c = self._prep_mates(a1, l1, a2,
                                                                l2, B)
                with stage("extract"):
                    qk, qp, qf, qs, qv, shapes, win_over = \
                        extract_queries_step(r1, j1, r2, j2, **ex_kw)
                per.append(dict(
                    names=names, a1=a1, a2=a2, l1=l1, l2=l2_c, B=B,
                    lm1=r1.shape[1],
                    lm2=r2.shape[1] if r2 is not None else None,
                    qk=qk, qp=qp, qf=qf, qs=qs, qv=qv, shapes=shapes,
                    win_over=win_over,
                    acc=new_accumulators(cap, qk.shape[0], self.device)))
            self._ranges.sweeps += 1
            with stage("probe"):
                for r in range(self._n_ranges):
                    quad_r, hash_r = self._ranges.upload(r, stage)
                    for p in per:
                        probe_range_step(
                            p["qk"], p["qf"], p["qv"], quad_r, hash_r,
                            p["acc"], cap=cap, kmer_format=self.kmer_format,
                            hash_log2_rows=self.hash_log2_rows,
                            hash_chain=self.hash_chain)
                    del quad_r, hash_r  # one range at a time on the device

            ctxs = []
            for p in per:
                with stage("paths"):
                    packed_hdr, resident = finish_stream_step(
                        p["acc"], p["qp"], p["qs"], p["shapes"],
                        p["win_over"],
                        min_cons=int(self.params.min_cons_cnt),
                        min_cons_euk=int(self.params.min_cons_cnt_euk),
                        cap=cap, path_width=path_width,
                        path_block=path_block,
                        compact5=compact5_fits(p["B"], p["lm1"], p["lm2"]),
                        **ex_kw)
                part_w = part_widths(p["lm1"], self.syncmer,
                                     self.kmer_format, self.smer_len,
                                     win_frac, lmax2=p["lm2"])
                ctxs.append(self._dp_ctx(
                    p["names"], p["a1"], p["a2"], p["l1"], p["l2"], cap,
                    {0: (packed_hdr, resident)}, p["B"], p["lm1"], p["lm2"],
                    part_w, path_block))
        return ctxs

    def _stream_group_size(self) -> int:
        """Batches per streaming range sweep: bounded by the device
        memory left after one resident range.  Each flat query slot of a
        batch holds 21 B of query tensors (int64 metamer, int32 position,
        frame and read id, bool valid) and cap x 21 B of accumulators
        (bool sel + five int32 fields).  Results do not depend on the
        group size.  METABULI_STREAM_GROUP overrides."""
        env = os.environ.get("METABULI_STREAM_GROUP")
        if env:
            return max(1, int(env))
        from ..models.flagship import part_widths

        budget = self._hbm_budget_gb * (1 << 30)
        # the range occupies <= budget/2; size the accumulators into the
        # remainder with a margin (N estimated from batch_size at 150 bp
        # single-end; long or paired batches are simply a smaller
        # effective group — the estimate only sets the default)
        part_w = part_widths(168, self.syncmer, self.kmer_format,
                             self.smer_len, self._win_frac)
        n_est = sum(part_w) * self.params.batch_size
        per_batch = n_est * (self.cap * 21 + 21)
        spare = max(budget * 0.3, 256 << 20)
        return int(min(16, max(1, spare // max(per_batch, 1))))

    # ------------------------------------------------------------------ #
    # device-assign flow (fused step + species assign + redundancy in one
    # device chain; the host only decodes per-read records)
    def _dispatch_batch_full(self, names, a1, l1, a2=None, l2=None, cap=None,
                             win_frac=None):
        from ..models.flagship import fused_step_full, part_widths

        B = len(names)
        cap, path_width, win_frac, path_block = self._knobs(
            cap, None, win_frac, None)
        combine_k = self._combine_k
        with self.timer.stage("dispatch"):
            with self.timer.stage("prep"):
                r1, j1, l1, r2, j2, l2_c = self._prep_mates(a1, l1, a2, l2, B)
            lmax2 = r2.shape[1] if r2 is not None else None
            lmax = r1.shape[1] + (lmax2 + 3 if r2 is not None else 0)
            records, packed2 = fused_step_full(
                r1, j1, self.db_quad, self.ef_node, self.euler,
                self.lca_depth, self.lca_lift, reads2=r2, lens2=j2,
                min_score=float(self.params.min_score),
                tie_ratio=float(self.params.tie_ratio),
                combine_k=combine_k,
                dna_shift=int(self.taxonomer.dna_shift),
                n_quot=lmax // int(self.taxonomer.dna_shift) + 2,
                part_w=part_widths(r1.shape[1], self.syncmer,
                                   self.kmer_format, self.smer_len, win_frac,
                                   lmax2=lmax2),
                min_cons=int(self.params.min_cons_cnt),
                min_cons_euk=int(self.params.min_cons_cnt_euk),
                cap=cap, kmer_format=self.kmer_format,
                syncmer=self.syncmer, smer_len=self.smer_len,
                path_width=path_width, win_frac=win_frac,
                path_block=path_block, stage=self.timer.stage,
                **self._probe_kw)
            return {"full": True, "names": names, "l1": l1, "l2": l2_c,
                    "cap": cap, "a1": a1, "a2": a2, "path_width": path_width,
                    "path_block": path_block, "combine_k": combine_k,
                    "records": _HostCopy(records),
                    "pairs": _HostCopy(packed2)}

    def _finish_full_phase1(self, ctx):
        """Fetch + decode the per-read record table, after the overflow
        retry ladder (_climb_ladder: the host-scoring flow's four rungs,
        then the combine_k run overflow)."""
        with self.timer.stage("hdr_sync"):
            rec = ctx["records"].numpy()         # ONE blocking fetch
            st = rec[:5, 0]
        eff = (ctx["cap"], None)
        while (eff := self._climb_ladder(st, ctx, *eff)) is not None:
            with self.timer.stage("retry"):
                ctx = self._dispatch_batch_full(
                    ctx["names"], ctx["a1"], ctx["l1"], ctx["a2"], ctx["l2"],
                    cap=eff[0], win_frac=eff[1])
                rec = ctx["records"].numpy()
                st = rec[:5, 0]

        self._update_path_width(int(st[1]))
        names = ctx["names"]
        B = len(names)
        lens1, lens2, qlens = self._query_lengths(ctx["l1"], ctx["l2"], B)
        with self.timer.stage("score"):
            live, tie = rec[0, 1:], rec[1, 1:]
            tot = np.ascontiguousarray(rec[2, 1:]).view(np.float32)
            lca, ft, top = rec[3, 1:], rec[4, 1:], rec[5, 1:]
            ms = float(self.params.min_score)    # f64 compare, like the
            results = [ReadResult() for _ in range(B)]  # host-scoring flow
            deferred = []
            for i in np.nonzero(live)[0]:
                res = results[i]
                res.species_scores = ()
                res.top_species = int(top[i])
                if tie[i] > 1:
                    sc_avg = tot[i] / np.float32(int(tie[i]))
                    res.score = float(sc_avg)
                    if sc_avg == 0 or sc_avg < ms:
                        continue
                    res.is_classified = True
                    res.classification = int(lca[i])
                    continue
                score = tot[i]
                if score == 0 or score < ms:
                    res.score = float(score)
                    continue
                deferred.append((int(i + 1), int(qlens[i + 1]), score,
                                 int(ft[i])))
        # the pairs came at full width: phase 2 never needs a re-run
        return {"names": names, "lens1": lens1, "lens2": lens2,
                "results": results, "deferred": deferred, "qlens": qlens,
                "pairs": {0: ctx["pairs"]}, "Bl": B,
                "est2": ctx["pairs"].host.shape[1] - 1}

    def _header(self, ctx):
        """ONE blocking fetch per local dp row (its stats column and the
        estimated path prefix), and the stats the retry ladder reads:
        candidate-cap overflow, path count, window-compaction overflow,
        blocked-emission overflow — over all dp rows of the batch
        (reduce_header: counts summed, the path count the largest row's),
        across processes too, so every process takes the same retries."""
        hdr = {i: r["prefix"].numpy() for i, r in ctx["rows"].items()}
        g = reduce_header({i: h[:4, 0] for i, h in hdr.items()},
                          self._grid.shape["dp"], self._grid.multi_process)
        return hdr, next(iter(g.values()))[[0, 4, 2, 3]]

    def _double_cap(self, cap):
        """The candidate cap after an overflow at `cap`: doubled, up to
        the longest run, and kept for later batches."""
        cap = min(cap * 2, self._cap_ceiling)
        self.cap = max(self.cap, cap)
        return cap

    def _climb_ladder(self, st, ctx, cap, win_frac):
        """One step of the overflow retry ladder of the path-DP finishes.
        st: a batch's stats header (candidate-cap overflow, path count,
        window-compaction overflow, blocked-emission overflow and, on the
        device-assign flow, a fifth row: combine_k run overflow); ctx:
        the batch as dispatched; (cap, win_frac): the effective values of
        the retries taken for it so far (win_frac None: the sticky one).
        Takes the first rung that overflowed, applies its sticky update
        and returns the (cap, win_frac) to re-dispatch with, or None when
        no rung overflowed.  Every re-dispatch rechecks every rung.  The
        emission block and combine_k double from the value the batch was
        dispatched with: the batches queued behind it ran with the same
        one, and doubling the sticky knob once per such batch would
        square the work for nothing."""
        if int(st[2]) > 0:
            # window-compaction overflow: widen permanently, re-run
            # uncompacted for this batch
            self._win_frac = min(self._win_frac + 24, 256)
            win_frac, rung = 256, "window"
        elif int(st[0]) > 0 and cap < self._cap_ceiling:
            cap, rung = self._double_cap(cap), "cap"
        elif int(st[3]) > 0:                     # blocked-emission lanes
            self._path_block = max(self._path_block, ctx["path_block"] * 2)
            rung = "block"
        elif int(st[1]) > ctx["path_width"]:     # path compaction width
            self._path_width = max(self._path_width, ctx["path_width"]) * 2
            rung = "width"
        elif len(st) > 4 and int(st[4]) > 0:     # combine_k run overflow
            self._combine_k = max(self._combine_k, ctx["combine_k"] * 2)
            rung = "combine_k"
        else:
            return None
        if len(st) > 4:
            self.full_retries[rung] = self.full_retries.get(rung, 0) + 1
        elif os.environ.get("METABULI_DEBUG_RETRY"):
            print(f"# retry st={st.tolist()} -> cap={cap} "
                  f"wf={win_frac} pw={self._path_width} "
                  f"pb={self._path_block} wfrac={self._win_frac}",
                  file=sys.stderr)
        return cap, win_frac

    def _finish_dp_phase1(self, ctx):
        """Fetch emitted paths, score species, enqueue the redundancy step
        — but do NOT wait for it (phase 2 does), so its device work sits
        behind the next batch's fused step."""
        with self.timer.stage("hdr_sync"):
            hdr, st = self._header(ctx)
        eff = (ctx["cap"], None)
        while (eff := self._climb_ladder(st, ctx, *eff)) is not None:
            with self.timer.stage("retry"):
                ctx = self._dispatch_batch_dp(
                    ctx["names"], ctx["a1"], ctx["l1"], ctx["a2"], ctx["l2"],
                    cap=eff[0], win_frac=eff[1])
                hdr, st = self._header(ctx)

        names, l1, l2, Bl = ctx["names"], ctx["l1"], ctx["l2"], ctx["Bl"]
        B = len(names)
        B_pad = Bl * self._grid.shape["dp"]
        with self.timer.stage("fetch"):
            arrs = {}
            for i, h in hdr.items():
                n = int(h[1, 0])
                arrs[i] = h[:, 1:n + 1] if n <= ctx["est"] else \
                    ctx["rows"][i]["paths"][:, 1:n + 1].cpu().numpy()
            n_max = max(a.shape[1] for a in arrs.values())
            self._path_estimate = _est_update(self._path_estimate,
                                              int(n_max * 1.15), step=4096,
                                              floor=2048)
            self._update_path_width(int(st[1]))

        with self.timer.stage("score"):
            parts = []
            for i, a in arrs.items():
                d = decode_paths(a)
                g = d.pop("g")
                # read ids are local to the row: row i holds reads
                # i*Bl+1 .. (i+1)*Bl of the batch
                d["qid"] = (g // 6 + 1 + i * Bl).astype(np.int64)
                d["frame"] = (g % 6).astype(np.int64)
                parts.append(d)
            paths = {k: np.concatenate([p[k] for p in parts])
                     for k in parts[0]}
            qid, frame = paths["qid"], paths["frame"]
            # reference emission order per (read, species): frame asc,
            # pos asc — one packed-key stable argsort when it fits 63 bits
            if len(qid) and (int(paths["end"].max()) < (1 << 16)
                             and B_pad < (1 << 19)):
                key = (((qid << 25) | paths["species"]) << 19) \
                    | (frame << 16) | paths["end"]
                order = np.argsort(key, kind="stable")
            else:
                order = np.lexsort((np.arange(len(qid)), paths["end"], frame,
                                    paths["species"], qid))
            pa = {k: paths[k][order] for k in (
                "qid", "species", "start", "end", "score", "hamming",
                "rh_start", "rh_end")}
            # the rows' pad reads (beyond B) have no length and no paths
            results = [ReadResult() for _ in range(B_pad)]
            lens1, lens2, qlens = self._query_lengths(l1, l2, B)
            qlens = np.pad(qlens, (0, B_pad - B))
            deferred = self.taxonomer.score_paths(pa, qlens, results)

        local = self._local_reads(B)
        out_ctx = {"names": names, "lens1": lens1, "lens2": lens2,
                   "results": results, "deferred": deferred, "qlens": qlens,
                   "Bl": Bl, "local_reads": local}
        with self.timer.stage("redundancy"):
            if deferred:
                best_sp = np.zeros((self._grid.shape["dp"], Bl + 1),
                                   dtype=np.int32)
                rid, _, _, taxid = zip(*deferred)
                r = np.array(rid) - 1
                best_sp[r // Bl, r % Bl + 1] = taxid
                red = make_sharded_redundancy(
                    self._grid, dna_shift=int(self.taxonomer.dna_shift),
                    n_quot=ctx["n_quot"], part_w=ctx["part_w"])
                residents = {i: r["resident"]
                             for i, r in ctx["rows"].items()}

                def rerun(w):
                    return red(residents, best_sp, self._tables, out_w=w)

                out_w = self._pair_width
                out_ctx.update(pairs={i: _HostCopy(p)
                                      for i, p in rerun(out_w).items()},
                               est2=out_w, red_rerun=rerun)
        return out_ctx

    def _finish_dp_phase2(self, ctx):
        results = ctx["results"]
        if ctx["deferred"]:
            with self.timer.stage("redundancy_sync"):
                # ONE blocking fetch per dp row
                hdr2 = {i: p.numpy() for i, p in ctx["pairs"].items()}
                n2 = max(int(h[0, 0]) for h in hdr2.values())
                if n2 > ctx["est2"]:
                    # prefix overflow: re-run at the next pow2 >= n2
                    # (sticky for later batches) and fetch the wider prefix
                    w = ctx["est2"]
                    while w < n2:
                        w *= 2
                    self._pair_width = max(self._pair_width, w)
                    hdr2 = {i: p.cpu().numpy()
                            for i, p in ctx["red_rerun"](w).items()}
                parts = []
                for i, h in hdr2.items():
                    self.total_match_cnt += int(h[1, 0])
                    part = h[:, 1:int(h[0, 0]) + 1].copy()
                    part[0] += i * ctx["Bl"]        # row-local read ids
                    parts.append(part)
                m2 = np.concatenate(parts, 1)
                # per-(read, lca) group counts -> tax_cnt dicts
                tax_cnts: dict = {}
                from .native_score import available, count_pairs

                if available():
                    u_rid, u_tax, u_cnt = count_pairs(m2[0], m2[1])
                    for r, t, c in zip(u_rid.tolist(), u_tax.tolist(),
                                       u_cnt.tolist()):
                        tax_cnts.setdefault(r, {})[t] = c
                else:
                    key = (m2[0].astype(np.int64) << 32) \
                        | m2[1].astype(np.int64)
                    uniq, cnts = np.unique(key, return_counts=True)
                    for k, c in zip(uniq.tolist(), cnts.tolist()):
                        tax_cnts.setdefault(k >> 32, {})[k & 0xFFFFFFFF] = \
                            int(c)
                self.taxonomer.finish_with_taxcnt(ctx["deferred"], tax_cnts,
                                                  ctx["qlens"], results)
        return self._records(ctx["names"], ctx["lens1"], ctx["lens2"],
                             results, ctx.get("local_reads"))

    @staticmethod
    def _query_lengths(l1, l2, B):
        """(lens1, lens2, qlens): host mate lengths (lens2 all 0 when
        unpaired) and the 1-based per-read scoring length, the sum of
        both mates' covered lengths."""
        lens1 = np.asarray(l1)
        lens2 = np.asarray(l2) if l2 is not None \
            else np.zeros(B, dtype=np.int32)
        qlens = np.zeros(B + 1, dtype=np.int64)
        qlens[1:] = _max_covered(lens1) + np.where(
            lens2 > 0, _max_covered(lens2), 0)
        return lens1, lens2, qlens

    @staticmethod
    def _records(names, lens1, lens2, read_results, reads=None):
        """QueryRecords of the batch's reads (of `reads` only, when
        given: a process of a global mesh reports its own)."""
        out = []
        for i in range(len(names)) if reads is None else reads:
            qr = QueryRecord(names[i], int(lens1[i]), int(lens2[i]))
            qr.result = read_results[i]
            out.append(qr)
        return out

    # ------------------------------------------------------------------ #
    # host-match flow: the device extracts, probes the raw arrays and
    # compacts the matches; the host sorts them into compareMatches order
    # and runs the whole scorer
    def _fused_step_host(self, r1, j1, r2, j2, cap, **step_kw):
        from ..models.flagship import fused_step

        ms = self._host_match_state()
        return fused_step(
            r1, j1, r2, j2, ms["db_values"], ms["db_taxids"],
            ms["db_species"], cap=cap, kmer_format=self.kmer_format,
            syncmer=self.syncmer, smer_len=self.smer_len,
            bucket_lo=ms["bucket_lo"], db_aa_lo=ms["db_aa_lo"],
            bucket_shift=ms["bucket_shift"], bucket_steps=ms["bucket_steps"],
            **step_kw)

    def _dispatch_batch_host(self, names, a1, l1, a2=None, l2=None, cap=None):
        B = len(names)
        cap = cap or self.cap
        with self.timer.stage("dispatch"):
            with self.timer.stage("prep"):
                r1, j1, l1, r2, j2, l2_c = self._prep_mates(a1, l1, a2, l2, B)
            packed, count, overflow = self._fused_step_host(
                r1, j1, r2, j2, cap, stage=self.timer.stage)
            # the (count, overflow) pair and an estimated match prefix
            # start their device->host copies NOW, so the transfers
            # overlap the host scoring of earlier batches
            est = min(self._fetch_estimate, packed.shape[1])
            stats = _HostCopy(torch.stack([count, overflow]))
            prefix = _HostCopy(packed[:, :est])
        return {"names": names, "l1": l1, "l2": l2_c, "cap": cap,
                "a1": a1, "a2": a2, "stats": stats,
                "packed": (packed, count), "prefix": prefix, "est": est}

    def _finish_batch_host(self, ctx):
        # deferred overflow check: re-dispatch with a bigger cap if needed
        while int(ctx["stats"].numpy()[1]) > 0 \
                and ctx["cap"] < self._cap_ceiling:
            cap = self._double_cap(ctx["cap"])
            with self.timer.stage("retry"):
                ctx = self._dispatch_batch_host(
                    ctx["names"], ctx["a1"], ctx["l1"], ctx["a2"], ctx["l2"],
                    cap=cap)

        names = ctx["names"]
        B = len(names)
        with self.timer.stage("fetch"):
            n = int(ctx["stats"].numpy()[0])
            if n <= ctx["est"]:
                arr = ctx["prefix"].numpy()[:, :n]
            else:  # estimate too small; fall back to a full-prefix fetch
                arr = compact_torch.fetch_compacted(ctx["packed"])
            self._fetch_estimate = min(
                _pow2_bucket(int(n * 1.5), floor=1 << 15),
                ctx["packed"][0].shape[1])
        with self.timer.stage("decode+sort"):
            m = sort_matches(compact_torch.decode_matches(arr, MATCH_DTYPE))
        self.total_match_cnt += len(m)

        lens1, lens2, qlens = self._query_lengths(ctx["l1"], ctx["l2"], B)
        with self.timer.stage("score"):
            read_results = self.taxonomer.classify_batch(m, qlens, B)
        return self._records(names, lens1, lens2, read_results)

    def _finish_partial(self, ctx):
        """Phase-1 finish for the pipeline (host-match flow: the whole
        finish, it has no second device step to wait for)."""
        if ctx.get("full"):
            # phase 2 is the host-scoring flow's pair decode + finish
            return {"dp2": True, "ctx": self._finish_full_phase1(ctx)}
        if ctx.get("dp"):
            return {"dp2": True, "ctx": self._finish_dp_phase1(ctx)}
        return {"dp2": False, "results": self._finish_batch_host(ctx)}

    def _finish_complete(self, part):
        if part["dp2"]:
            return self._finish_dp_phase2(part["ctx"])
        return part["results"]

    # ------------------------------------------------------------------ #
    # long reads beyond the 64k row cap: overlapping chunk windows whose
    # match lists are globalized, ownership-deduped and concatenated
    # before the standard host scoring
    LONG_ROW_CAP = 1 << 16
    _LONG_CHUNK = 49152      # multiple of 3 (frame alignment across chunks)
    _LONG_OVERLAP = 48       # multiple of 3; > 27 so every window is
    #                          fully emitted by some chunk's local scan

    def _classify_long_read(self, name: str, seq: str):
        """Classify ONE read of arbitrary length by chunked extraction.

        Chunk starts are multiples of 3, so a chunk-local window's codons
        are the read's codons and its global frame follows from its
        global position alone: forward frames have pos % 3 == frame
        (KmerScanner begin arithmetic); reverse frames have begin
        (L%3 - r)%3.  Each window is OWNED by exactly one chunk (boundary
        at chunk_start + 21: the previous full chunk provably emits
        windows up to start + CHUNK - 27, the owner from start + 2), so
        overlap duplicates drop exactly.  Matches then flow through the
        same host scorer as any batch.
        """
        if self.params.mask_mode:
            seq = mask_ops.mask_low_complexity(seq, self.params.mask_prob)
        return self._classify_long_row(
            name, np.frombuffer(seq.encode("ascii", "replace"), np.uint8))

    def _classify_long_row(self, name: str, data):
        """_classify_long_read of one read's bases as uint8 (masked
        already, where masking is on)."""
        L = len(data)
        CH, OV = self._LONG_CHUNK, self._LONG_OVERLAP
        step = CH - OV
        starts = list(range(0, max(L - OV, 1), step))
        n_ch = len(starts)
        own_lo = np.array([starts[i] + 21 if i else 0
                           for i in range(n_ch)], np.int64)
        own_hi = np.array([starts[i + 1] + 21 if i + 1 < n_ch else L
                           for i in range(n_ch)], np.int64)
        used_g = L - {0: 3, 1: 4, 2: 2}[L % 3]

        with self.timer.stage("long_probe"):
            all_m = self._long_read_matches(data, L, starts, own_lo, own_hi,
                                            used_g)
        with self.timer.stage("long_score"):
            m = (sort_matches(np.concatenate(all_m)) if all_m
                 else np.zeros(0, MATCH_DTYPE))
            self.total_match_cnt += len(m)
            qlens = np.array([0, int(_max_covered(np.array([L]))[0])],
                             np.int64)
            res = self.taxonomer.classify_batch(m, qlens, 1)[0]
        qr = QueryRecord(name, L)
        qr.result = res
        return qr

    def _long_read_matches(self, data, L, starts, own_lo, own_hi, used_g):
        """Per group of 8 chunks: the host-match device step (with the cap
        retry), then the chunk-local matches made global and cut to the
        windows each chunk owns."""
        CH = self._LONG_CHUNK
        n_ch = len(starts)
        all_m = []
        group = 8
        cap = self.cap
        for g0 in range(0, n_ch, group):
            grp = starts[g0:g0 + group]
            B = len(grp)
            lens = np.array([min(CH, L - a) for a in grp], np.int32)
            lmax = _bucket_len(int(lens.max()))
            arr = np.full((B, lmax), ord("N"), np.uint8)
            for i, a in enumerate(grp):
                arr[i, :lens[i]] = data[a:a + lens[i]]
            if self._streaming or self.mesh is not None:
                # probe the host-resident index ranges (one range on the
                # device at a time; a mesh's host shards); the host-match
                # arrays stay unbuilt
                m = self._stream_probe_matches(arr, lens)
            else:
                r1, j1 = self._up(arr), self._up(lens)
                while True:
                    packed, count, overflow = self._fused_step_host(
                        r1, j1, None, None, cap)
                    if int(overflow) == 0 or cap >= self._cap_ceiling:
                        break
                    cap = self._double_cap(cap)
                m = compact_torch.decode_matches(
                    compact_torch.fetch_compacted((packed, count)),
                    MATCH_DTYPE)
            if not len(m):
                continue
            gi = (g0 + m["qid"] - 1).astype(np.int64)
            pos_g = m["pos"].astype(np.int64) + np.asarray(grp, np.int64)[
                (m["qid"] - 1).astype(np.int64)]
            fwd = m["frame"] < 3
            fg = np.where(fwd, pos_g % 3,
                          3 + ((L % 3 - pos_g % 3) % 3)).astype(np.uint8)
            begin_g = np.where(fwd, fg.astype(np.int64),
                               (L % 3 - (fg.astype(np.int64) - 3)) % 3)
            keep = ((pos_g >= own_lo[gi]) & (pos_g < own_hi[gi])
                    & (pos_g <= begin_g + used_g - 24))
            m = m[keep].copy()
            m["qid"] = 1
            m["pos"] = pos_g[keep].astype(np.uint32)
            m["frame"] = fg[keep]
            all_m.append(m)
        return all_m

    def _stream_probe_matches(self, arr, lens):
        """Raw MATCH_DTYPE rows for a batch of rows by probing the
        host-resident index ranges — the raw-match primitive of the
        long-read chunk path under DB-range streaming and on a mesh,
        whose host shards are the ranges (each range is uploaded to
        self.device for its pass and dropped after, as in
        _dispatch_group_stream).  AA-boundary range cuts make the
        per-range candidate sets disjoint and the min(2*minHamming, 7)
        cutoff computed in the owning range globally correct (reference
        KmerMatcher.cpp:1136)."""
        from ..models.flagship import (extract_queries_step,
                                       new_accumulators, probe_range_step)

        r1, j1 = self._up(arr), self._up(lens)
        qk, qp, qf, qs, qv, _, _ = extract_queries_step(
            r1, j1, syncmer=self.syncmer, smer_len=self.smer_len,
            kmer_format=self.kmer_format, win_frac=256)
        if self._ranges is None:         # a resident mesh's host shards
            self._ranges = _RangeStream(*self._host_shards, self.device)
        cap = self.cap
        while True:
            acc = new_accumulators(cap, qk.shape[0], self.device)
            self._ranges.sweeps += 1
            for r in range(self._n_ranges):
                quad_r, hash_r = self._ranges.upload(r, self.timer.stage)
                probe_range_step(qk, qf, qv, quad_r, hash_r, acc, cap=cap,
                                 kmer_format=self.kmer_format,
                                 hash_log2_rows=self.hash_log2_rows,
                                 hash_chain=self.hash_chain)
                del quad_r, hash_r
            if int(acc["overflow"]) == 0 or cap >= self._cap_ceiling:
                break
            cap = self._double_cap(cap)
        # only the selected candidates cross to the host
        c, n = torch.nonzero(acc["sel"], as_tuple=True)
        at = lambda a: a[c, n].cpu().numpy()
        m = np.zeros(len(c), MATCH_DTYPE)
        m["qid"] = qs[n].cpu().numpy()
        m["pos"] = qp[n].cpu().numpy().astype(np.uint32)
        m["frame"] = qf[n].cpu().numpy()
        # the quad payload carries euler-first coordinates (prefolded at
        # init); the host scorer wants node ids -> one euler gather back
        m["taxid"] = self.taxonomy.euler[at(acc["taxid"])]
        m["species"] = at(acc["species"]) & np.int32(0x3FFFFFFF)
        m["dna"] = at(acc["dna_enc"]).astype(np.uint32)
        m["rh"] = at(acc["rh"]).astype(np.uint16)
        m["ham"] = at(acc["hamming"]).astype(np.uint8)
        return m

    def classify_file(self, path1, path2=None, progress=None):
        """Classify a read file (and its mate file under --seq-mode 2),
        read with the native C++ batch reader (native/seqreader.cpp)
        when its library builds, else with the Python reader
        (io/fasta.py); self.reader records which ("native" | "python")."""
        from ..io import native_reader

        p2 = path2 if self.params.seq_mode == 2 else None
        self.reader = "native" if native_reader.available() else "python"
        it = (self._read_batches_native(path1, p2)
              if self.reader == "native"
              else self._read_batches_padded(path1, p2))

        def _timed():
            while True:
                with self.timer.stage("input"):     # parse + mask + pad
                    nxt = next(it, None)
                if nxt is None:
                    return
                yield nxt

        batches = _timed()

        # long-read mode: reads beyond the row cap are pulled out of the
        # batch pass (length zeroed -> unclassified placeholder) and
        # reprocessed whole via chunked extraction afterwards, by the
        # process that reports them, at their place in its results
        long_ids: dict = {}      # read index in the file -> in the results
        if self.params.seq_mode == 3:
            cap_rows = self.LONG_ROW_CAP

            def _split_long(it):
                base = local_base = 0
                for names, a1, l1, a2, l2 in it:
                    local = self._local_reads(len(names))
                    l1 = np.asarray(l1)
                    over = np.nonzero(l1 > cap_rows)[0]
                    if len(over):
                        l1 = l1.copy()
                        l1[over] = 0
                        at = {r: k for k, r in enumerate(local)}
                        for i in over.tolist():
                            if i in at:
                                long_ids[base + i] = local_base + at[i]
                    yield names, a1, l1, a2, l2
                    base += len(names)
                    local_base += len(local)

            batches = _split_long(batches)
        results = self.drive_batches(batches, progress)
        if long_ids:
            for gi, rec in enumerate(read_seq_file(path1)):
                if gi in long_ids:
                    results[long_ids[gi]] = self._classify_long_read(
                        rec.name, rec.seq)
        return results

    def _local_reads(self, B):
        """Positions, in a batch of B reads, of the reads this process
        reports: those of its dp rows (all of them in one process)."""
        Bl = -(-max(B, 1) // self._grid.shape["dp"])
        return [r for i in self._grid.local_rows
                for r in range(i * Bl, min((i + 1) * Bl, B))]

    def _read_batches_padded(self, path1, path2=None):
        """The Python reader's batches as padded rows (masked first)."""
        for names, s1, s2 in self._read_batches(path1, path2):
            b1, bl1 = self._pad_batch(s1)
            b2 = bl2 = None
            if any(x is not None for x in s2):
                b2, bl2 = self._pad_batch(s2)
            yield names, b1, bl1, b2, bl2

    # row width of the native reader's batches (the JAX package's); a
    # longer read outside --seq-mode 3 gets a wider batch (_widen)
    _NATIVE_ROW = 4096

    def _read_batches_native(self, path1, path2=None):
        """Padded-row batches from the native C++ reader (no per-read
        Python), masked in place under --mask; mate files of different
        length raise as in _read_batches."""
        from ..io.native_reader import NativeBatchReader

        B = self.params.batch_size
        W = self.LONG_ROW_CAP if self.params.seq_mode == 3 \
            else self._NATIVE_ROW
        mates = [(path1, NativeBatchReader(path1, B, W), _FullReads(path1))]
        if path2:
            mates.append((path2, NativeBatchReader(path2, B, W),
                          _FullReads(path2)))
        n_seen = 0
        for names, a1, l1 in mates[0][1]:
            rows = [self._widen(a1, l1, mates[0][2], n_seen)]
            if path2:
                nxt = next(mates[1][1], None)
                n2 = len(nxt[0]) if nxt is not None else 0
                if n2 != len(names):
                    short, other, n = (path2, path1, n2) if n2 < len(names) \
                        else (path1, path2, len(names))
                    raise ValueError(
                        f"paired read files differ in length: {short} ends "
                        f"after {n_seen + n} reads, {other} has more")
                rows.append(self._widen(nxt[1], nxt[2], mates[1][2], n_seen))
            if self.params.mask_mode:
                rows = [(mask_ops.mask_batch_rows(a, l, self.params.mask_prob),
                         l) for a, l in rows]
            n_seen += len(names)
            (a1, l1), (a2, l2) = rows[0], rows[1] if path2 else (None, None)
            yield names, a1, l1, a2, l2
        if path2 and next(mates[1][1], None) is not None:
            raise ValueError(
                f"paired read files differ in length: {path1} ends after "
                f"{n_seen} reads, {path2} has more")

    def _widen(self, a, lens, full, base):
        """A native batch whose reads all fit its rows, as the Python
        reader pads them: the native reader drops the bases beyond the
        row width, so outside --seq-mode 3 (where such reads take the
        chunk pass) a longer read is taken whole from the Python reader
        (`full`, read `base + i` of the file) into a batch as wide as
        its longest read."""
        over = np.nonzero(lens > a.shape[1])[0]
        if not len(over) or self.params.seq_mode == 3:
            return a, lens
        seqs = {int(i): full.get(base + int(i)).encode("ascii", "replace")
                for i in over}
        lens = lens.copy()
        for i, b in seqs.items():
            lens[i] = len(b)
        wide = np.full((a.shape[0], int(lens.max())), ord("N"), np.uint8)
        wide[:, :a.shape[1]] = a
        for i, b in seqs.items():
            wide[i, :len(b)] = np.frombuffer(b, np.uint8)
        return wide, lens

    # batches between a dispatch and its phase-1 finish (and between
    # phase 1 and phase 2): device work of later batches is queued
    # while the host scores earlier ones
    PIPE_DEPTH = 6

    def drive_batches(self, batches, progress=None):
        """Software pipeline over (names, a1, l1, a2, l2) batches (a2/l2
        are None for unpaired reads).  DB-range streaming uses the
        grouped loop instead: the heavy cost there is re-uploading
        index ranges, so batches are grouped to share each sweep."""
        if self._streaming:
            return self._drive_batches_stream(batches, progress)
        all_results = []
        done = 0
        depth = self.PIPE_DEPTH
        pend1: deque = deque()   # dispatched, awaiting phase 1
        pend2: deque = deque()   # phase-1 done, awaiting phase 2

        def complete(ctx):
            nonlocal done
            res = self._finish_complete(ctx)
            all_results.extend(res)
            done += len(res)
            if progress:
                progress(done)

        for names, a1, l1, a2, l2 in batches:
            ctx = self._dispatch_batch(names, a1, l1, a2, l2)
            while len(pend2) >= depth:
                complete(pend2.popleft())
            pend1.append(ctx)
            if len(pend1) > depth:
                pend2.append(self._finish_partial(pend1.popleft()))
        while pend1:
            pend2.append(self._finish_partial(pend1.popleft()))
        while pend2:
            complete(pend2.popleft())
        return all_results

    def _drive_batches_stream(self, batches, progress=None):
        """Streaming-mode loop: dispatch GROUPS of batches through
        shared range sweeps (_dispatch_group_stream).  Two rules: the
        previous group is finished before the next is dispatched, and
        the first batch goes alone."""
        all_results = []
        done = 0
        G = self._stream_group_size()
        group: list = []
        prev_ctxs: list = []

        def finish_prev():
            nonlocal prev_ctxs, done
            for c in prev_ctxs:
                res = self._finish_complete(self._finish_partial(c))
                all_results.extend(res)
                done += len(res)
                if progress:
                    progress(done)
            prev_ctxs = []

        def flush(group):
            nonlocal prev_ctxs
            # finish BEFORE dispatching: any overflow retry in the
            # previous group updates the sticky knobs (cap, win_frac,
            # path_block, path_width) that the NEXT group's dispatch
            # reads — dispatching first would send the whole group with
            # stale knobs and each member would pay its own single-batch
            # retry sweep
            finish_prev()
            prev_ctxs = self._dispatch_group_stream(group)

        first = True
        for b in batches:
            group.append(b)
            # the first batch goes SOLO so its retries settle the
            # adaptive knobs before a full group commits to them
            if first or len(group) >= G:
                flush(group)
                group = []
                first = False
        if group:
            flush(group)
        finish_prev()
        return all_results
