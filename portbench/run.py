"""One run of one cell of the benchmark of metabuli_work_tpu_torch.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for (it exits 2, printing no result, without them).  In order:

1. the cell's configuration (configs/), traffic mix (traffic/) and
   metrics are read from BENCHMARK.json by name;
2. the configuration's genomes are made from its `db_seed`, and its
   database is built by the program's IndexBuilder, both kept under
   build/portbench/ in the checkout (the first run of a cell builds,
   later runs map them; the packed layout goes to the program's pack
   cache, METABULI_PACK_CACHE, beside them);
3. the program's Classifier is made on the card and warmed up on reads
   of its own (stream 1 of --seed), through the cell's entry;
4. the timed sample, of the mix's fixed size, and the queries the check
   compares are drawn from --seed (streams 2 and 3); the window runs
   the sample through the entry (entries/) until --seconds have passed;
5. with --trace 0 the end-to-end metrics are printed, with --trace 1
   the per-layer ones (torch.profiler over a slice of the window, from
   40% of it, for 2 s);
6. once the window has closed and the program's state is freed, the
   checked queries are classified again by the plain reference
   (reference/) and compared with every answer the window gave them
   (check.py).

The last line on standard output is one JSON object: correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last
`checks`, each compared number beside its limit; the same numbers are
the last lines on standard error.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from portbench import catalog, check  # noqa: E402
from portbench import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "metabuli_work_tpu")
DB_VERSION = "1"
SLICE_FROM = 0.4                 # the traced slice starts at 40% of the window
SLICE_S = 2.0                    # and lasts 2 s
DESCRIPTIVE = ("name", "source", "reduced", "reduced_because", "assumed",
               "published", "why")


def cache_root(root=catalog.ROOT):
    return os.path.join(root, "build", "portbench")


def config_key(cfg):
    """Key of what makes a configuration's genomes and database."""
    spec = {k: v for k, v in cfg.items() if k not in DESCRIPTIVE}
    blob = json.dumps([DB_VERSION, spec], sort_keys=True).encode()
    return f"{cfg['name']}-{hashlib.blake2b(blob, digest_size=8).hexdigest()}"


def pin_environment(cache, traffic):
    """The program's knobs as the cell states them (none but the mix's
    `env`), and every cache it writes inside the checkout."""
    for k in [k for k in os.environ if k.startswith("METABULI_")]:
        del os.environ[k]
    os.environ["METABULI_PACK_CACHE"] = os.path.join(cache, "pack")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.update({k: str(v) for k, v in traffic.get("env", {}).items()})


def ref_cache(cache, cfg):
    """Where the reference keeps its own index of the configuration."""
    return os.path.join(cache, "ref", f"{config_key(cfg)}-{check.REF_VERSION}")


def load_genomes(cfg, cache):
    """The configuration's genomes (kept as one .npy), its taxonomy and
    each genome's species id."""
    kind = catalog.database_kind(cfg["kind"])
    path = os.path.join(cache, "genomes", config_key(cfg) + ".npy")
    if os.path.exists(path):
        genomes = np.load(path)
    else:
        genomes = kind.genomes(cfg)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.npy"
        np.save(tmp, genomes)
        os.replace(tmp, path)
    return genomes, kind.taxonomy(cfg)


def program_db(cfg, genomes, tax, cache):
    """The database built by the program's IndexBuilder, saved once
    under the configuration's key; (directory, seconds to build or
    None when it was there)."""
    from metabuli_work_tpu_torch.index.builder import IndexBuilder
    from metabuli_work_tpu_torch.index.format import save_index
    from metabuli_work_tpu_torch.taxonomy import Taxonomy

    db_dir = os.path.join(cache, "db", config_key(cfg))
    if os.path.exists(os.path.join(db_dir, "kmers.npy")):
        return db_dir, None
    t0 = time.perf_counter()
    parent, ranks, names, orig, species = tax
    pool = list(dict.fromkeys(ranks))
    taxonomy = Taxonomy(parent, [pool.index(r) for r in ranks],
                        list(range(len(names))), pool, names, orig)
    builder = IndexBuilder(taxonomy, syncmer=cfg["syncmer"],
                           smer_len=cfg["smer_len"],
                           mask_mode=cfg["mask_mode"])
    for g, sp in zip(genomes, species):
        builder.add_sequence(g.tobytes().decode(), sp)
    tmp = db_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    save_index(tmp, builder.finalize())
    os.replace(tmp, db_dir)
    return db_dir, time.perf_counter() - t0


class Run:
    """What a run holds: the program's classifier and what the window
    and the trace left for the metric readers."""

    def __init__(self, cfg, traffic, seed, seconds, trace_on, device,
                 tmpdir):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace_on = seed, seconds, trace_on
        self.device, self.tmpdir = device, tmpdir
        self.gen = catalog.generator(traffic["kind"])
        self.entry = catalog.entry(traffic["entry"])
        self.slice = None
        self.win = None
        self.trace = None
        self.dp_shapes = []
        self.peak_bytes = 0
        self.setup_s = None
        self.kind = "cpu"

    def rng(self, stream):
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed & ((1 << 64) - 1), stream]))

    def _kept(self, t):
        return self.slice is None or not self.slice.excluded(t)

    def stage_per_batch(self, name, t0=None, t1=None):
        """ms of stage `name` a batch: its spans in the window (or in
        [t0, t1] of it) over the batches completed there, both outside
        the traced slice."""
        w = self.win
        t0 = w["t0"] if t0 is None else t0
        t1 = w["t1"] if t1 is None else t1
        spans = [b - a for n, a, b in self.clf.timer.spans
                 if n == name and t0 <= a <= t1 and self._kept(a)]
        batches = sum(1 for t in w["batch_ends"]
                      if t0 <= t <= t1 and self._kept(t))
        if not spans or not batches:
            return None
        return 1e3 * sum(spans) / batches

    def call_ms(self):
        return [ms for t, ms in self.win["calls"] if self._kept(t)]

    def free(self):
        """Drops the program's classifier and its device memory."""
        import torch

        self.dp.restore()
        self.clf = None
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def card_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def prepare(cfg, traffic, seed, seconds, trace_on, device, cache, tmpdir):
    """Everything before the window: returns (run, state, seconds the
    benchmark spent drawing and writing the timed sample)."""
    import torch

    pin_environment(cache, traffic)
    genomes, tax = load_genomes(cfg, cache)
    db_dir, built = program_db(cfg, genomes, tax, cache)
    print(f"database {config_key(cfg)}: "
          + ("mapped from the checkout's cache" if built is None
             else f"built by IndexBuilder in {built:.1f} s"), flush=True)

    from metabuli_work_tpu_torch.classify.pipeline import (Classifier,
                                                           ClassifyParams)
    from metabuli_work_tpu_torch.ops import dp_cuda
    from metabuli_work_tpu_torch.utils.timing import StageTimer

    run = Run(cfg, traffic, seed, seconds, trace_on, device, tmpdir)
    run.genomes, run.tax, run.dp_cuda = genomes, tax, dp_cuda
    params = ClassifyParams(seq_mode=traffic["seq_mode"],
                            min_score=traffic["min_score"],
                            min_sp_score=traffic["min_sp_score"],
                            batch_size=traffic["batch"],
                            **traffic.get("params", {}))
    t0 = time.perf_counter()
    run.clf = Classifier(db_dir, params, device=device)
    t_clf = time.perf_counter() - t0
    cap0 = run.clf.cap
    run.clf.timer = tr.recording_timer(StageTimer)()
    run.dp = tr.DpCalls(dp_cuda)
    t0 = time.perf_counter()
    rate = run.entry.warm(run)
    print(f"classifier made in {t_clf:.2f} s (setup cap {cap0}); warm-up "
          f"{time.perf_counter() - t0:.2f} s, last pass {rate:.1f} "
          f"queries/s; cap {run.clf.cap} after it", flush=True)
    if trace_on:
        tr.warm_profiler()
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run.entry.prepare(run)
    return run, state, time.perf_counter() - t0


def measure(run, state):
    """The window; fills run.win, run.trace, run.dp_shapes and
    run.peak_bytes."""
    import torch

    on_card = run.device != "cpu"
    dp = run.dp_cuda
    dp.launches = dp.warp_launches = dp.block_launches = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if run.trace_on:
        run.slice = tr.Slice(
            time.perf_counter() + SLICE_FROM * run.seconds,
            SLICE_S,
            [run.clf.timer, run.dp])
    run.win = run.entry.window(run, state)
    if run.slice is not None:
        run.slice.stop()
        if run.slice.events is not None:
            run.trace = tr.reduce_events(run.slice.events)
            run.dp_shapes = list(run.dp.shapes)
    if on_card:
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
        run.kind = torch.cuda.get_device_name()
    run.launches = {"warp": dp.warp_launches, "block": dp.block_launches}


def source_share(run):
    """Share of the checked answers at their source species or its
    genus."""
    parent, _, _, _, species = run.tax
    src = run.state["sample"].src
    got = [(species[int(src[i])], a[1]) for i, a in run.win["answers"]
           if a is not None]
    return sum(t in (sp, parent[sp]) for sp, t in got) / max(len(got), 1)


def verify(run, cache):
    """The check (check.py) on the window's answers; frees the program's
    state first.  Returns (checks, seconds of the reference, queries it
    classified)."""
    sample = run.state["sample"]
    missing = run.win["sent"] - run.win["queries"]
    run.free()
    parent, ranks, _, _, species = run.tax
    values, sp = check.reference_index(run.cfg, run.genomes, species,
                                       ref_cache(cache, run.cfg))
    ref = check.make_reference(run.cfg, run.traffic, values, sp, parent,
                               ranks)
    bad, secs, n = check.compare(sample, run.win["answers"], ref)
    return check.checks(bad, missing), secs, n


class ForbiddenImport(RuntimeError):
    """A module of JAX or the JAX package was loaded by the run."""


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench, cell_name, seed, seconds, trace_on, device="cuda",
             root=catalog.ROOT, cfg=None, traffic=None, fault=None):
    """One run; returns the result object (the last line).  cfg and
    traffic default to the cell's files; fault(classifier) returns a
    broken Classifier._finish_complete, for the tests of the check."""
    cell = catalog.cell(bench, cell_name)
    cfg = cfg or catalog.config(cell["config"])
    traffic = traffic or catalog.traffic(cell["traffic"])
    cache = cache_root(root)
    tmpdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        run, state, gen_s = prepare(cfg, traffic, seed, seconds, trace_on,
                                    device, cache, tmpdir)
        run.state = state
        run.setup_s = time.perf_counter() - T_PROCESS - gen_s
        if fault is not None:
            run.clf._finish_complete = fault(run.clf)
        measure(run, state)
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(found)
        metrics = {}
        for m in catalog.cell_metrics(bench, cell_name, trace_on):
            reader = (catalog.metric_reader if trace_on
                      else catalog.endtoend_reader)(m["name"])
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        w = run.win
        print(f"window: {w['queries']} queries in {w['t1'] - w['t0']:.3f} s"
              f"; path DP launches: warp {run.launches['warp']}, block "
              f"{run.launches['block']}; cap {run.clf.cap}; "
              f"{100 * source_share(run):.2f}% at source species or genus; "
              f"stage totals (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                  run.clf.timer.totals.items())), flush=True)
        device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                       "kind": run.kind, "count": cell["chips"],
                       "memory_peak_bytes": int(run.peak_bytes)}
        result = {"correct": False, "attempted": int(w["queries"]),
                  "failed": 0, "metrics": metrics, "device": device_info}
        if trace_on and run.trace is not None:
            device_info["busy_s"] = run.trace["busy_s"]
            device_info["window_s"] = run.trace["window_s"]
            result["breakdown"] = {"device_ops": run.trace["device_ops"],
                                   "idle_gaps": run.trace["idle_gaps"]}
        if trace_on:
            t = run.trace or {}
            print(f"trace: slice {t.get('window_s', 0):.3f} s, device busy "
                  f"{t.get('busy_s', 0):.4f} s; {len(run.dp_shapes)} path-DP "
                  f"calls, {len(t.get('dp_device_s', []))} ranges with "
                  f"{sum(t.get('dp_device_s', [])):.6f} s of device time; "
                  f"device operations with no launch seen: "
                  f"{[(n[:60], c) for n, c in t.get('unlinked', [])[:3]]}",
                  flush=True)
        chk, ref_s, n_ref = verify(run, cache)
        print(f"reference: {n_ref} queries classified again in "
              f"{ref_s:.2f} s, {len(run.win['answers'])} answers compared",
              flush=True)
        result["failed"] = chk["missing_results"]["value"]
        result["correct"] = check.passed(chk)
        result["checks"] = chk
        return result
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = catalog.benchmark()
    cell = catalog.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except ForbiddenImport as e:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(e.args[0])}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
