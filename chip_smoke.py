"""Smoke run of metabuli_work_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions;
2. builds the two path-DP CUDA kernels (csrc/path_dp_warp.cu, the warp
   variant for cap <= 32; csrc/path_dp.cu, the block variant for larger
   caps; one nvcc each, in parallel) and prints the build time;
3. holds the kernels against their plain torch version on the card, for
   exact equality, over the small parity grid, the shapes where the
   kernels branch (cap 32 | 33, a partial block, W ending inside a
   window tile, S = 1 and 3, block overflow), the empty case, and random
   cases at main-path shapes; checks that each case went to the variant
   its cap selects;
4. drives the main path: builds (or loads from ~/.cache) a syncmer DB of
   8 genomes x 4 Mb in 2 genera, simulates 16,384 150-bp reads (1%
   errors, half reverse-complemented) and classifies them with
   Classifier(device="cuda") through classify_file at batch size 1024;
   prints the caps the path DP was launched at and the launches per
   variant; checks that every launch at cap <= 32 went to the warp
   variant, that the plain DP never ran on the card, that >= 95% of reads
   land on their source species or genus, and that the first 256 reads
   match the same classifier on the CPU;
5. prints reads/s, the stage-timer table, and per launched cap the
   kernel's time per launch beside its bound (at the first launch's cap
   also the plain version's time and the block variant's time on the
   same input), and launches x ms/launch beside the run's wall time.

The second-to-last line is one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero.  Exits non-zero at once when no CUDA card is visible.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_GENOMES = 8
GENOME_LEN = 4_000_000
N_READS = 16384
READ_LEN = 150
BATCH = 1024
N_CPU_CHECK = 256
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate
ALU_OPS_PER_S = 67e12            # H100 SXM 32-bit non-tensor peak
QUEUE_CYCLES = 50_000_000        # ~25 ms of device spin while the host
                                 # enqueues a timed run (see time_cuda)
# parity cases where the kernels branch, as in tests/torch_dp_cases.py:
# (name, cap, G, W, max_shift, kmer_format, dyn_gap, block_w, density)
EDGES = [
    ("cap32", 32, 12, 9, 3, 2, True, 8, 0.4),
    ("cap33", 33, 12, 9, 3, 2, True, 8, 0.4),
    ("G18-S1", 8, 18, 9, 1, 2, False, 8, 0.4),
    ("W1-S1", 4, 12, 1, 1, 2, False, 4, 0.6),
    ("W1-S3", 4, 12, 1, 3, 2, True, 4, 0.6),
    ("W13-S3", 12, 18, 13, 3, 2, True, 16, 0.5),
    ("W17-S2-kf1", 5, 18, 17, 2, 1, False, 8, 0.5),
    ("overflow-cap12", 12, 18, 16, 1, 2, False, 2, 0.9),
]
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- parity
def random_case(rng, cap, G, W, n_species=5, density=0.4, dyn_gap=False):
    """Candidate tensors biased toward consecutive chains in both lane
    directions (the cases of tests/test_dp_pallas.py)."""
    sel = rng.random((cap, G, W)) < density
    species = rng.integers(1, n_species + 1, size=(cap, G, W)).astype(np.int32)
    species = species | (rng.integers(0, 2, size=species.shape)
                         << 30).astype(np.int32)
    dna = rng.integers(0, 1 << 24, size=(cap, G, W)).astype(np.int32)
    for w in range(1, W):
        m = rng.random((cap, G))
        new3 = rng.integers(0, 8, size=(cap, G))
        fwd_next = (((dna[:, :, w - 1] << 3) & 0xFFFFFF) | new3)
        rev_next = ((dna[:, :, w - 1] >> 3) | (new3 << 21))
        dna[:, :, w] = np.where(m < 0.35, fwd_next,
                                np.where(m < 0.7, rev_next,
                                         dna[:, :, w])).astype(np.int32)
    rh = rng.integers(0, 1 << 16, size=(cap, G, W)).astype(np.int32)
    ham = rng.integers(0, 8, size=(cap, G, W)).astype(np.int32)
    if dyn_gap:
        gaps = rng.integers(1, 4, size=(G, W)).astype(np.int32)
        base = np.cumsum(gaps, axis=1) * 3
        pos = np.broadcast_to(base[None], (cap, G, W)).astype(np.int32)
    else:
        pos = np.broadcast_to((np.arange(W, dtype=np.int32) * 3)[None, None],
                              (cap, G, W)).astype(np.int32)
    return sel, species, dna, rh, ham, pos


def overflow_case():
    rng = np.random.default_rng(7)
    cap, G, W = 4, 12, 12
    sel, species, _, rh, ham, pos = random_case(rng, cap, G, W, n_species=2,
                                                density=0.95)
    dna = rng.integers(0, 1 << 24, size=(cap, G, W)).astype(np.int32)
    for w in range(1, W, 2):
        new3 = rng.integers(0, 8, size=(cap, G))
        fwd_next = (((dna[:, :, w - 1] << 3) & 0xFFFFFF) | new3)
        rev_next = ((dna[:, :, w - 1] >> 3) | (new3 << 21))
        fwd_lane = (np.arange(G) % 6 < 3)[None, :]
        dna[:, :, w] = np.where(fwd_lane, fwd_next, rev_next).astype(np.int32)
    return sel, species, dna, rh, ham, pos


def flipped_cuda(case, kmer_format):
    sel, species, dna, rh, ham, pos = case
    G = sel.shape[1]
    frame = np.arange(G) % 6
    rev = ((frame >= 3) if kmer_format != 1 else (frame < 3))[None, :, None]
    fl = lambda a: np.ascontiguousarray(np.where(rev, a[:, :, ::-1], a))
    sp_m = np.where(fl(sel), fl(species), -1).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()
            for a in (sp_m, fl(dna), fl(rh), fl(ham), fl(pos))]


def parity(dp_cuda):
    """Kernels vs plain version on the card; returns the max abs error
    per variant over all cases (must be 0) and the number of cases."""
    cases = []
    for dyn_gap, S, kf in [(False, 1, 2), (False, 3, 2), (True, 3, 2),
                           (False, 1, 1)]:
        case = random_case(np.random.default_rng(42 + S + kf), 4, 12, 9,
                           dyn_gap=dyn_gap)
        for compact5 in (True, False):
            cases.append((f"grid dyn_gap={dyn_gap} S={S} kf={kf} "
                          f"compact5={compact5}", case, S, kf, dyn_gap, 8,
                          compact5, 2, 3))
    cases.append(("block overflow", overflow_case(), 1, 2, False, 2, True,
                  2, 2))
    z = np.zeros((4, 12, 6), dtype=np.int32)
    cases.append(("empty", (z.astype(bool), z, z, z, z, z), 1, 2, False, 4,
                  True, 2, 3))
    for name, cap, G, W, S, kf, dyn_gap, bw, density in EDGES:
        rng = np.random.default_rng(len(name) + cap + G + W)
        case = random_case(rng, cap, G, W, n_species=3, density=density,
                           dyn_gap=dyn_gap)
        for compact5 in (True, False):
            cases.append((f"edge {name} compact5={compact5}", case, S, kf,
                          dyn_gap, bw, compact5, 2, 3))
    # cap 384 puts the block variant's ring in global scratch (over 64 KB
    # a block) and gives each thread two candidates
    cases.append(("wide cap=384 G=24 W=10",
                  random_case(np.random.default_rng(2), 384, 24, 10,
                              n_species=3, density=0.7, dyn_gap=True),
                  3, 2, True, 16, True, 2, 3))
    for cap in (8, 16):
        cases.append((f"main-path shapes cap={cap} G=6144 W=40",
                      random_case(np.random.default_rng(cap), cap, 6144, 40,
                                  density=0.6, dyn_gap=True),
                      3, 2, True, 16, True, 2, 3))
    max_err = {"warp": 0, "block": 0}
    n_checks = 0

    def check(name, which, got, ref):
        err = int((got[0].long() - ref[0].long()).abs().max()) \
            if got[0].numel() else 0
        same = (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                and int(got[2]) == int(ref[2]))
        print(f"parity {name} [{which}]: {'exact' if same else 'MISMATCH'} "
              f"(paths={int(ref[1].sum())}, blk_over={int(ref[2])})")
        if not same:
            raise AssertionError(f"{which} kernel != plain version on {name}")
        max_err[which] = max(max_err[which], err)

    for name, case, S, kf, dyn_gap, bw, c5, mc, mce in cases:
        ins = flipped_cuda(case, kf)
        kw = dict(min_cons=mc, min_cons_euk=mce, max_shift=S, kmer_format=kf,
                  dyn_gap=dyn_gap, block_w=bw, compact5=c5)
        ref = dp_cuda.path_dp_blocked_ref(*ins, **kw)
        which = dp_cuda.variant(ins[0].shape[0])
        n0 = variant_counts(dp_cuda)
        got = dp_cuda.path_dp_blocked(*ins, **kw)
        torch.cuda.synchronize()
        n1 = variant_counts(dp_cuda)
        if n1[which] != n0[which] + 1 or sum(n1.values()) != \
                sum(n0.values()) + 1:
            raise AssertionError(f"case {name} did not launch the {which} "
                                 f"variant once: {n0} -> {n1}")
        check(name, which, got, ref)
        n_checks += 1
        if name.startswith("main-path"):
            # the block variant (cap > 32 on the main path) on the same
            # main-shape input
            got = dp_cuda._launch("block", ins, **kw)
            torch.cuda.synchronize()
            check(name, "block", got, ref)
            n_checks += 1
    return max_err, n_checks


def variant_counts(dp_cuda):
    return {"warp": dp_cuda.warp_launches, "block": dp_cuda.block_launches}


# ---------------------------------------------------------------- main path
def smoke_taxonomy(Taxonomy):
    """root(1) -> genera G1(2), G2(3) -> species 4.. (genus 2 + i % 2)."""
    parent = [0, 1, 1, 1]
    rank_idx, name_idx = [0, 0, 1, 1], [0, 0, 1, 2]
    rank_pool = ["no rank", "genus", "species"]
    name_pool = ["root", "G1", "G2"]
    int2orig = [0, 1, 101, 102]
    for i in range(N_GENOMES):
        parent.append(2 + (i % 2))
        rank_idx.append(2)
        name_pool.append(f"Species{i}")
        name_idx.append(3 + i)
        int2orig.append(1000 + i)
    return Taxonomy(np.array(parent), np.array(rank_idx), np.array(name_idx),
                    rank_pool, name_pool, np.array(int2orig))


def build_or_load_db():
    """Syncmer DB of N_GENOMES genomes (2 random bases, 3.5% mutations
    per species), cached under ~/.cache by config key."""
    from metabuli_work_tpu_torch.index.builder import IndexBuilder
    from metabuli_work_tpu_torch.index.format import KmerIndex
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    tax = smoke_taxonomy(Taxonomy)
    cache = os.path.join(os.path.expanduser("~/.cache"),
                         f"mwt_torch_smoke_db_{N_GENOMES}_{GENOME_LEN}.npz")
    meta = {"kmer_format": 2, "syncmer": True, "smer_len": 5,
            "reduced_aa": 0, "mask_mode": 0, "mask_prob": 0.9,
            "skip_redundancy": 1}
    if os.path.exists(cache):
        with np.load(cache) as z:
            genomes = [g.decode() for g in z["genomes"]]
            return KmerIndex(z["v"], z["t"], z["s"], tax, meta), genomes, True
    rng = np.random.default_rng(0)
    builder = IndexBuilder(tax, syncmer=True, mask_mode=0)
    bases = [ACGT[rng.integers(0, 4, size=GENOME_LEN)] for _ in range(2)]
    genomes = []
    for i in range(N_GENOMES):
        g = bases[i % 2].copy()
        mut = rng.random(GENOME_LEN) < 0.035
        g[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
        genomes.append(g.tobytes().decode())
        builder.add_sequence(genomes[-1], 4 + i)
    index = builder.finalize()
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    tmp = cache + ".tmp.npz"
    np.savez(tmp, v=index.values, t=index.taxids, s=index.species,
             genomes=np.array([g.encode() for g in genomes]))
    os.replace(tmp, cache)
    return index, genomes, False


def simulate_reads(genomes, rng):
    G = np.stack([np.frombuffer(g.encode(), dtype=np.uint8) for g in genomes])
    gi = rng.integers(0, len(genomes), size=N_READS)
    starts = rng.integers(0, G.shape[1] - READ_LEN, size=N_READS)
    reads = G[gi[:, None], starts[:, None] + np.arange(READ_LEN)[None, :]]
    err = rng.random((N_READS, READ_LEN)) < 0.01
    reads[err] = ACGT[rng.integers(0, 4, size=int(err.sum()))]
    rc = rng.random(N_READS) < 0.5
    reads[rc] = _COMP[reads[rc, ::-1]]
    return np.ascontiguousarray(reads), gi


def write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r.tobytes().decode()}\n")


def tuples(results):
    return [(q.result.is_classified, q.result.classification,
             float(q.result.score)) for q in results]


def time_cuda(fn, reps, queue_ahead=False):
    """Device ms per call of fn over `reps` calls between two events.
    queue_ahead keeps the device spinning while the host enqueues all the
    calls, so a kernel shorter than its Python wrapper is timed back to
    back rather than at the host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(QUEUE_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_bound_ms(args, kw):
    """Least time for the work: inputs read once + outputs written once
    over the memory rate, against the live predecessor pairs this input
    needs (8 int32 ops each: species test, shift, mask, compare, gap,
    score max, key min, select) over the 32-bit ALU peak."""
    sp = args[0]
    cap, G, W = sp.shape
    bw, S = kw["block_w"], kw["max_shift"]
    n_cols = 5 if kw["compact5"] else 7
    nbytes = 5 * cap * G * W * 4 + n_cols * bw * G * 4 + bw * G + 4
    live = (sp >= 0).sum(0).double()                    # [G, W]
    pairs = sum(float((live[:, s:] * live[:, :-s]).sum())
                for s in range(1, S + 1) if s < W)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 8 * pairs / ALU_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.ops import dp_cuda

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    dp_cuda.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")

    max_err, n_cases = parity(dp_cuda)
    print(f"parity: {n_cases} cases exact, max_abs_err {max_err}")

    t0 = time.perf_counter()
    index, genomes, hit = build_or_load_db()
    print(f"DB: {index.size} metamers, {N_GENOMES} genomes x {GENOME_LEN} bp "
          f"({'cache hit' if hit else 'built'}, "
          f"{time.perf_counter() - t0:.1f} s)")
    reads, src = simulate_reads(genomes, np.random.default_rng(1))
    params = ClassifyParams(seq_mode=1, min_score=0.15, min_sp_score=0.5,
                            batch_size=BATCH)
    t0 = time.perf_counter()
    clf = Classifier.from_memory(index, params, device="cuda")
    print(f"classifier setup (pack + upload): "
          f"{time.perf_counter() - t0:.1f} s, hash chain {clf.hash_chain}, "
          f"cap {clf.cap}, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fna")
        write_fasta(path, reads)
        warm = os.path.join(tmp, "warm.fna")
        write_fasta(warm, reads[:BATCH])
        clf.classify_file(warm)                      # first-use warm-up
        torch.cuda.synchronize()

        calls = []          # cap of every main-path launch, in order
        first = {}          # cap -> (args, kw) of its first launch
        launch = dp_cuda.path_dp_blocked

        def capture(*args, **kw):
            cap = args[0].shape[0]
            calls.append(cap)
            if cap not in first:
                first[cap] = ([a.clone() for a in args], dict(kw))
            return launch(*args, **kw)

        clf.timer.totals.clear()
        clf.timer.counts.clear()
        dp_cuda.path_dp_blocked = capture
        dp_cuda.launches = dp_cuda.warp_launches = 0
        dp_cuda.block_launches = dp_cuda.plain_cuda_calls = 0
        t0 = time.perf_counter()
        results = clf.classify_file(path)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain_calls = dp_cuda.launches, dp_cuda.plain_cuda_calls
        counts = variant_counts(dp_cuda)
        dp_cuda.path_dp_blocked = launch

        cpu_path = os.path.join(tmp, "cpu.fna")
        write_fasta(cpu_path, reads[:N_CPU_CHECK])
        cpu = Classifier.from_memory(index, ClassifyParams(
            seq_mode=1, min_score=0.15, min_sp_score=0.5,
            batch_size=N_CPU_CHECK), device="cpu")
        cpu_res = tuples(cpu.classify_file(cpu_path))

    assert len(results) == N_READS, len(results)
    assert launches > 0, "the main path never launched the path-DP kernel"
    assert launches == len(calls), (launches, len(calls))
    assert plain_calls == 0, "the plain DP ran on the card in the main path"
    n_small = sum(c <= dp_cuda.WARP_MAX_CAP for c in calls)
    by_cap = {c: calls.count(c) for c in sorted(first)}
    print(f"main path: path DP launched at caps {by_cap} (launches per cap); "
          f"warp variant {counts['warp']}, block variant {counts['block']}")
    assert counts["warp"] == n_small, \
        "a main-path launch at cap <= 32 did not go to the warp variant"
    assert counts["block"] == launches - n_small
    cls = np.array([q.result.classification for q in results])
    species = 4 + src
    genus = 2 + src % 2
    right = float(np.mean((cls == species) | (cls == genus)))
    print(f"main path: {N_READS} reads, {launches} kernel launches, "
          f"{right * 100:.2f}% at source species or genus, "
          f"{float(np.mean(cls == species)) * 100:.2f}% at species")
    assert right >= 0.95, f"only {right:.4f} of reads classified correctly"
    gpu_res = tuples(results[:N_CPU_CHECK])
    n_same = sum(a == b for a, b in zip(gpu_res, cpu_res))
    print(f"CPU check: {n_same}/{N_CPU_CHECK} reads identical to the CPU run")
    assert gpu_res == cpu_res, "GPU and CPU classifications differ"

    print(f"throughput: {N_READS / dt:.1f} reads/s ({dt:.3f} s for "
          f"{N_READS} reads, batch {BATCH}) on {card}")
    print(f"stage timer (host seconds) on {card}:")
    print(clf.timer.report())

    # each launched cap's first input, timed back to back on the device
    timed = {}
    for cap, (args, kw) in first.items():
        ms = time_cuda(lambda: launch(*args, **kw), 50, queue_ahead=True)
        b_ms, b_by = kernel_bound_ms(args, kw)
        timed[cap] = (ms, b_ms, b_by)
        _, G, W = args[0].shape
        print(f"path_dp {dp_cuda.variant(cap)} kernel at cap={cap} (G={G}, "
              f"W={W}, S={kw['max_shift']}, block_w={kw['block_w']}): "
              f"{ms:.4f} ms/launch, bound {b_ms:.5f} ms ({b_by}), "
              f"{ms / b_ms:.1f}x bound, on {card}")
    k_total = sum(timed[c][0] for c in calls)
    print(f"path DP share of the run: {launches} launches x ms/launch = "
          f"{k_total:.3f} ms of {dt * 1e3:.1f} ms wall "
          f"({100 * k_total / (dt * 1e3):.2f}%)")
    # the first launch's input: plain version and the block variant
    args, kw = first[calls[0]]
    p_ms = time_cuda(lambda: dp_cuda.path_dp_blocked_ref(*args, **kw), 3)
    blk_ms = time_cuda(lambda: dp_cuda._launch("block", args, **kw), 50,
                       queue_ahead=True)
    print(f"at the first launch's input (cap={calls[0]}): plain version "
          f"{p_ms:.3f} ms, block variant {blk_ms:.4f} ms/launch, "
          f"{dp_cuda.variant(calls[0])} variant {timed[calls[0]][0]:.4f} "
          f"ms/launch on {card}")

    kernels = []
    for which, src_file, name in (
            ("warp", "path_dp_warp.cu", "path_dp"),
            ("block", "path_dp.cu", "path_dp_block")):
        caps = [c for c in calls if dp_cuda.variant(c) == which]
        if not caps:
            print(f"{which} variant (csrc/{src_file}): not launched on the "
                  f"main path (no launch at its caps); parity max_abs_err "
                  f"{max_err[which]}")
            continue
        cap = caps[0]                     # its first main-path launch
        args, kw = first[cap]
        ms, b_ms, b_by = timed[cap]
        kernels.append({
            "name": name,
            "variant": which,
            "cap": cap,
            "route": "cuda",
            "source": f"metabuli_work_tpu_torch/csrc/{src_file}",
            "replaces": "metabuli_work_tpu/ops/dp_pallas.py:88",
            "launches": counts[which],
            "max_abs_err": max_err[which],
            "ms": ms,
            "plain_ms": p_ms if cap == calls[0] else time_cuda(
                lambda: dp_cuda.path_dp_blocked_ref(*args, **kw), 3),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })

    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
