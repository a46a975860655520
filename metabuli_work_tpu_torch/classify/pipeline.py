"""End-to-end single-end classification (host orchestration + device step).

Mirrors Classifier::startClassify (reference src/commons/Classifier.cpp:
44-164) with the stage boundaries moved to host<->device transfers:

  host:   FASTA/FASTQ decode -> padded uint8 batches
  device: 6-frame metamer extraction, resident-index probe, path DP
          (models/flagship.fused_step_dp)
  host:   species scoring from the emitted paths (classify/taxonomer_vec)
  device: best-species redundancy filter (flagship.redundancy_counts)
  host:   per-read assignment + reporting

Batches run through a software pipeline: device work of later batches
is queued while the host scores earlier ones, and every device->host
copy is a non-blocking copy into pinned memory behind a CUDA event.

The reference's match-buffer-overflow retry (matchPerKmer += 4 and
re-run, Classifier.cpp:127-131) becomes the per-batch overflow-retry
ladder in _finish_dp_phase1.

Only the resident, single-device, host-scoring flow over the wide
hash-probed index exists here; other configurations raise
NotImplementedError naming the ROADMAP.md item that brings them.
"""

import math
from collections import deque
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch

from ..device import resolve_device
from ..index.format import KmerIndex, load_index
from ..index.packing import load_or_pack_wide, state_from_numpy
from ..io.fasta import read_seq_file
from ..ops import mask as mask_ops
from ..ops.dp_torch import decode_paths
from ..ops.encode_torch import right_align
from ..utils.timing import StageTimer
from .taxonomer import ReadResult
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

    __slots__ = ("name", "length1", "result")

    def __init__(self, name, length1, result=None):
        self.name = name
        self.length1 = length1
        self.result = result

    @property
    def covered_length(self):
        """The length the reference REPORTS and scores against:
        getMaxCoveredLength (Reporter.cpp:56, queryLength)."""
        return int(_max_covered(np.array([self.length1]))[0])


def _max_covered(lens):
    """Reference LocalUtil::getMaxCoveredLength (LocalUtil.h:45-59): the
    read length rounded down to a multiple of 3 minus 3."""
    lens = np.asarray(lens)
    return np.maximum(lens - np.choose(lens % 3, [3, 4, 2]), 0)


def _bucket_len(n: int, quantum: int = 24) -> int:
    """Pad read length to a bucket of 24 nt (8 codons): every probe/DP
    tensor scales with lmax//3-7 windows."""
    return max(quantum, quantum * math.ceil(n / quantum))


def _step_bucket(n: int, step: int, floor: int) -> int:
    return max(floor, step * ((int(n) + step - 1) // step))


def _est_update(cur: int, n: int, step: int, floor: int) -> int:
    """Prefix-estimate update with hysteresis: grow immediately, shrink
    only when the need sits >= 2 steps below the current estimate."""
    want = _step_bucket(n, step, floor)
    if want > cur or want <= cur - 2 * step:
        return want
    return cur


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to metabuli_work_tpu_torch yet "
        f"(ROADMAP.md, {item})")


class _HostCopy:
    """Device->host copy of a tensor that lands asynchronously: a
    non-blocking copy into pinned memory plus a CUDA event (on the CPU
    the tensor is simply kept)."""

    def __init__(self, t):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Classifier:
    def __init__(self, db_dir, params: ClassifyParams, mesh=None,
                 device=None):
        self.db_dir = db_dir
        self._init_from_index(load_index(db_dir), params, mesh=mesh,
                              device=device)

    @classmethod
    def from_memory(cls, index: KmerIndex, params: ClassifyParams,
                    mesh=None, device=None):
        """Wire a Classifier around an in-memory index (no disk round-trip)."""
        self = cls.__new__(cls)
        self.db_dir = None
        self._init_from_index(index, params, mesh=mesh, device=device)
        return self

    def _init_from_index(self, index: KmerIndex, params: ClassifyParams,
                         mesh=None, device=None):
        if params.seq_mode != 1:
            raise _not_ported(f"--seq-mode {params.seq_mode}",
                              "Queue 1 items 7 and 9")
        if params.min_cons_cnt < 2 or params.min_cons_cnt_euk < 2:
            raise _not_ported("min_cons_cnt < 2 (the host-match flow)",
                              "Queue 1 item 9")
        if params.hbm_budget_gb:
            raise _not_ported("DB-range streaming (hbm_budget_gb)",
                              "Queue 1 item 10")
        if mesh is not None:
            raise _not_ported("multi-device classify", "Queue 1 item 11")
        if params.em:
            raise _not_ported("--em", "Queue 1 item 13")
        self.device = resolve_device(device)
        self.params = params
        self.index = index
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
        self.timer = StageTimer()
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

    def _init_device_dp(self):
        """Resident single-device index + LCA tables on self.device."""
        n = self.taxonomy.num_nodes()
        euk = self.taxonomy.eukaryota_id()
        if euk:
            mask = np.asarray(self.taxonomy.is_ancestor(euk, np.arange(n)))
        else:
            mask = np.zeros(n, dtype=bool)
        # euk-ness rides in bit 30 of the species payload
        sp = self.index.species.astype(np.int64)
        assert int(sp.max(initial=0)) < (1 << 30)
        sp_euk = (sp | (mask[sp].astype(np.int64) << 30)).astype(np.int32)
        depth, lift = self.taxonomy.lca_lift_tables()
        ef = self.taxonomy.euler_first.astype(np.int64)
        # the redundancy step packs (hamming, euler_first) into one i32
        # key: 6 bits hamming above a 25-bit euler coordinate
        assert len(self.taxonomy.euler) < (1 << 25), \
            "taxonomy too large for packed-key redundancy kernel"
        db_ef = ef[self.index.taxids.astype(np.int64)].astype(np.int32)
        # 512-byte rows + a one-row-chain hash up to a 3 GiB table
        rows, ht, log2_rows, chain, db_m = load_or_pack_wide(
            self.index.values, db_ef, sp_euk, max_chain=1,
            max_bytes=3 << 30)
        st = state_from_numpy(rows, ht, log2_rows, chain, db_m, depth, lift,
                              self.taxonomy.euler.astype(np.int32),
                              ef.astype(np.int32), self.device)
        for k, v in st.items():
            setattr(self, k, v)

    # ------------------------------------------------------------------ #
    def _read_batches(self, path1) -> Iterator[tuple]:
        """Yield (names, seqs) lists of batch_size reads."""
        B = self.params.batch_size
        names, seqs = [], []
        for rec in read_seq_file(path1):
            names.append(rec.name)
            seqs.append(rec.seq)
            if len(names) == B:
                yield names, seqs
                names, seqs = [], []
        if names:
            yield names, seqs

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

    def _prep_arrays(self, a1, l1, B):
        """Crop the batch to its length bucket and move reads, lengths and
        the host-built right-aligned copy to the device."""
        l1 = np.minimum(np.asarray(l1, dtype=np.int32), a1.shape[1])
        lmax1 = _bucket_len(int(l1.max()) if B else 1)
        h1 = np.ascontiguousarray(a1[:, :lmax1])
        ra1 = np.ascontiguousarray(right_align(h1, l1))
        up = lambda a: torch.from_numpy(a).to(self.device, non_blocking=True)
        return up(h1), up(l1), up(ra1), l1

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

    def _dispatch_batch_dp(self, names, a1, l1, cap=None, path_width=None,
                           win_frac=None, path_block=None):
        from ..models.flagship import fused_step_dp, part_widths

        B = len(names)
        cap = cap or self.cap
        path_width = path_width or self._path_width
        win_frac = win_frac or self._win_frac
        path_block = path_block or self._path_block
        with self.timer.stage("dispatch"):
            r1, j1, ra1, l1 = self._prep_arrays(a1, l1, B)
            packed_hdr, resident = fused_step_dp(
                r1, j1, self.db_quad, ra1=ra1,
                min_cons=int(self.params.min_cons_cnt),
                min_cons_euk=int(self.params.min_cons_cnt_euk),
                cap=cap, kmer_format=self.kmer_format,
                syncmer=self.syncmer, smer_len=self.smer_len,
                path_width=path_width, win_frac=win_frac,
                path_block=path_block, hash_table=self.hash_table,
                hash_log2_rows=self.hash_log2_rows,
                hash_chain=self.hash_chain, db_m=self.db_m)
            # column 0 is the stats header; one async copy carries both
            # the stats and the estimated path prefix home
            est = min(self._path_estimate, packed_hdr.shape[1] - 1)
            prefix = _HostCopy(packed_hdr[:, :est + 1])
            n_quot = r1.shape[1] // int(self.taxonomer.dna_shift) + 2
            part_w = part_widths(r1.shape[1], self.syncmer, self.kmer_format,
                                 self.smer_len, win_frac)
        return {"names": names, "l1": l1, "cap": cap, "a1": a1,
                "paths": packed_hdr, "prefix": prefix, "est": est,
                "resident": resident, "n_quot": n_quot, "part_w": part_w}

    def _finish_dp_phase1(self, ctx):
        """Fetch emitted paths, score species, enqueue the redundancy step
        — but do NOT wait for it (phase 2 does), so its device work sits
        behind the next batch's fused step."""
        with self.timer.stage("hdr_sync"):
            hdr = ctx["prefix"].numpy()      # ONE blocking fetch
            st = hdr[:4, 0]
        # Overflow retry ladder: every re-dispatch carries the EFFECTIVE
        # knob values of retries already taken this batch, and every
        # condition is rechecked after each retry.
        eff_wf = None                            # None -> self._win_frac
        eff_cap = ctx["cap"]
        while True:
            # window-compaction overflow: widen permanently, re-run
            # uncompacted for this batch
            if int(st[2]) > 0:
                self._win_frac = min(self._win_frac + 24, 256)
                eff_wf = 256
            # candidate-cap overflow: doubled sticky cap
            elif int(st[0]) > 0 and eff_cap < self._cap_ceiling:
                eff_cap = min(eff_cap * 2, self._cap_ceiling)
                self.cap = max(self.cap, eff_cap)
            # blocked-emission lane overflow: doubled sticky block
            elif int(st[3]) > 0:
                self._path_block *= 2
            # path-compaction width overflow: doubled static width
            elif int(st[1]) > ctx["paths"].shape[1] - 1:
                self._path_width = max(self._path_width,
                                       ctx["paths"].shape[1] - 1) * 2
            else:
                break
            with self.timer.stage("retry"):
                ctx = self._dispatch_batch_dp(ctx["names"], ctx["a1"],
                                              ctx["l1"], cap=eff_cap,
                                              win_frac=eff_wf)
                hdr = ctx["prefix"].numpy()
                st = hdr[:4, 0]

        names, l1 = ctx["names"], ctx["l1"]
        B = len(names)
        with self.timer.stage("fetch"):
            n = int(st[1])
            if n <= ctx["est"]:
                arr = hdr[:, 1:n + 1]
            else:
                arr = ctx["paths"][:, 1:n + 1].cpu().numpy()
            self._path_estimate = _est_update(self._path_estimate,
                                              int(n * 1.15), step=4096,
                                              floor=2048)
            self._update_path_width(n)

        with self.timer.stage("score"):
            paths = decode_paths(arr)
            qid = (paths["g"] // 6 + 1).astype(np.int64)
            frame = (paths["g"] % 6).astype(np.int64)
            # reference emission order per (read, species): frame asc,
            # pos asc — one packed-key stable argsort when it fits 63 bits
            if len(qid) and (int(paths["end"].max()) < (1 << 16)
                             and B < (1 << 19)):
                key = (((qid << 25) | paths["species"]) << 19) \
                    | (frame << 16) | paths["end"]
                order = np.argsort(key, kind="stable")
            else:
                order = np.lexsort((np.arange(len(qid)), paths["end"], frame,
                                    paths["species"], qid))
            pa = {
                "qid": qid[order], "species": paths["species"][order],
                "start": paths["start"][order], "end": paths["end"][order],
                "score": paths["score"][order],
                "hamming": paths["hamming"][order],
                "rh_start": paths["rh_start"][order],
                "rh_end": paths["rh_end"][order],
            }
            results = [ReadResult() for _ in range(B)]
            lens1 = np.asarray(l1)
            qlens = np.zeros(B + 1, dtype=np.int64)
            qlens[1:] = _max_covered(lens1)
            deferred = self.taxonomer.score_paths(pa, qlens, results)

        out_ctx = {"names": names, "lens1": lens1, "results": results,
                   "deferred": deferred, "qlens": qlens}
        with self.timer.stage("redundancy"):
            if deferred:
                from ..models.flagship import redundancy_counts

                best_sp = np.zeros(B + 1, dtype=np.int32)
                for rid, _, _, taxid in deferred:
                    best_sp[rid] = taxid
                bsp = torch.from_numpy(best_sp).to(self.device)
                dna_shift = int(self.taxonomer.dna_shift)
                res = ctx["resident"]

                def rerun(w, _n=ctx["n_quot"], _p=ctx["part_w"]):
                    return redundancy_counts(
                        *res, bsp, self.euler, self.lca_depth, self.lca_lift,
                        dna_shift=dna_shift, n_quot=_n, part_w=_p, out_w=w)

                out_w = self._pair_width
                out_ctx.update(prefix2=_HostCopy(rerun(out_w)), est2=out_w,
                               red_rerun=rerun)
        return out_ctx

    def _finish_dp_phase2(self, ctx):
        B = len(ctx["names"])
        results = ctx["results"]
        if ctx["deferred"]:
            with self.timer.stage("redundancy_sync"):
                hdr2 = ctx["prefix2"].numpy()    # ONE blocking fetch
                n2 = int(hdr2[0, 0])
                if n2 <= ctx["est2"]:
                    m2 = hdr2[:, 1:n2 + 1]
                else:
                    # prefix overflow: re-run at the next pow2 >= n2
                    # (sticky for later batches) and fetch the wider prefix
                    w = ctx["est2"]
                    while w < n2:
                        w *= 2
                    self._pair_width = max(self._pair_width, w)
                    hdr2 = ctx["red_rerun"](w).cpu().numpy()
                    m2 = hdr2[:, 1:n2 + 1]
                self.total_match_cnt += int(hdr2[1, 0])
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
        out = []
        for i in range(B):
            qr = QueryRecord(ctx["names"][i], int(ctx["lens1"][i]))
            qr.result = results[i]
            out.append(qr)
        return out

    def classify_file(self, path1, path2=None, progress=None):
        def batches():
            for names, seqs in self._read_batches(path1):
                a1, l1 = self._pad_batch(seqs)
                yield names, a1, l1, None, None

        return self.drive_batches(batches(), progress)

    # batches between a dispatch and its phase-1 finish (and between
    # phase 1 and phase 2): device work of later batches is queued
    # while the host scores earlier ones
    PIPE_DEPTH = 6

    def drive_batches(self, batches, progress=None):
        """Software pipeline over (names, a1, l1, a2, l2) batches (a2/l2
        are None: single-end only)."""
        all_results = []
        done = 0
        depth = self.PIPE_DEPTH
        pend1: deque = deque()   # dispatched, awaiting phase 1
        pend2: deque = deque()   # phase-1 done, awaiting phase 2

        def complete(ctx):
            nonlocal done
            res = self._finish_dp_phase2(ctx)
            all_results.extend(res)
            done += len(res)
            if progress:
                progress(done)

        for names, a1, l1, a2, l2 in batches:
            if a2 is not None:
                raise _not_ported("paired-end classify", "Queue 1 item 7")
            ctx = self._dispatch_batch_dp(names, a1, l1)
            while len(pend2) >= depth:
                complete(pend2.popleft())
            pend1.append(ctx)
            if len(pend1) > depth:
                pend2.append(self._finish_dp_phase1(pend1.popleft()))
        while pend1:
            pend2.append(self._finish_dp_phase1(pend1.popleft()))
        while pend2:
            complete(pend2.popleft())
        return all_results
