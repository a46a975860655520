"""The torch package's two on-disk caches shared by several processes:
the import cache of a reference-format DB (<db>/.import_cache) and the
packed-layout cache (METABULI_PACK_CACHE).  Two spawned processes,
released together by a barrier, import one cold reference DB (each
index equal to the native DB's, array for array with dtypes, and no
*.new file left) or pack one layout into an empty cache (one entry, no
.tmp_* directory left); a damaged cache entry is replaced once and then
mapped; the *.new files of a killed import are overwritten.

    PYTHONPATH=. python tests/test_torch_cache_races.py [GENOME_LEN] [TRIALS]

prints the seconds of a cold import of a diffIdx DB of 4 genomes by one
process alone and by two processes at once (default 1 Mb, 3 trials)."""

import glob
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import pytest
from numpy.lib.format import open_memmap

from metabuli_work_tpu_torch.index import format as tformat
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.index.builder import build_database as tbuild

from torch_port_db import write_inputs, write_reference_copy
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

LAYOUTS = ("diffIdx", "mtbl")
NAMES = ("values", "taxids", "species")
WIDE = dict(max_chain=1, max_bytes=3 << 30)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A native DB of 4 genomes of 20 kb (no syncmers, so some 160,000
    entries) and its index; reference-layout copies are made from it
    per test, each with a cold import cache."""
    return _native_db(str(tmp_path_factory.mktemp("races")), 20_000)


def _native_db(root, genome_len):
    _, p = write_inputs(root, n_species=4, genome_len=genome_len)
    native = os.path.join(root, "native")
    tbuild(native, p["fastas"], p["acc2taxid"], p["taxdump"],
           syncmer=False, mask_mode=0)
    return native, tformat.load_index(native)


def _equal_to_native(index, native):
    for k in NAMES:
        got, want = index[k], getattr(native, k)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _left(d, pattern):
    return glob.glob(os.path.join(d, "**", pattern), recursive=True)


def _two_processes(target, args):
    """target(*args[i], barrier) in two spawned processes that pass one
    barrier before their work; both must end with exit code 0."""
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(2)
    procs = [ctx.Process(target=target, args=(*a, barrier)) for a in args]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, "a process did not finish in 120 s"
    assert [p.exitcode for p in procs] == [0, 0]


def _import_worker(dirs, out, barrier):
    """Imports each DB of `dirs` in step with the other process; saves
    the arrays of each, the file its values are mapped from and the
    seconds the import took."""
    got = {}
    for i, d in enumerate(dirs):
        barrier.wait(timeout=60)
        t0 = time.perf_counter()
        index = tformat.load_index(d)
        got[f"seconds{i}"] = time.perf_counter() - t0
        got.update({f"{k}{i}": getattr(index, k) for k in NAMES})
        got[f"source{i}"] = np.array(index.values.filename)
    np.savez(out, **got)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_processes_import_one_cold_reference_db(dbs, tmp_path, layout):
    """Three cold DBs in turn, each imported by both processes at once:
    both succeed, each index is the native one, mapped from the DB's own
    import cache (not from a temp dir of a process that found the DB
    unwritable), and no *.new file is left."""
    native, index = dbs
    dirs = [write_reference_copy(native, str(tmp_path / f"ref{i}"), layout)
            for i in range(3)]
    outs = [str(tmp_path / f"out_{i}.npz") for i in range(2)]
    _two_processes(_import_worker, [(dirs, out) for out in outs])
    for out in outs:
        with np.load(out) as z:
            for i, d in enumerate(dirs):
                _equal_to_native({k: z[f"{k}{i}"] for k in NAMES}, index)
                assert os.path.dirname(str(z[f"source{i}"])) == \
                    os.path.join(d, ".import_cache")
    for d in dirs:
        assert not _left(d, "*.new")


def _pack_inputs():
    """Sorted distinct metamers with random payload columns."""
    rng = np.random.default_rng(3)
    values = np.unique(rng.integers(0, 1 << 62, size=120_000,
                                    dtype=np.uint64))
    db_ef = rng.integers(0, 1 << 20, size=len(values)).astype(np.int32)
    sp_euk = rng.integers(1, 1 << 10, size=len(values)).astype(np.int32)
    return values, db_ef, sp_euk


def _pack_worker(cache, out, barrier):
    os.environ["METABULI_PACK_CACHE"] = cache
    inputs = _pack_inputs()
    barrier.wait(timeout=60)
    rows, ht, log2, chain, m = packing.load_or_pack_wide(*inputs, **WIDE)
    np.savez(out, rows=rows, hash=ht, geometry=np.array([log2, chain, m]))


def test_two_processes_pack_into_one_empty_cache(tmp_path):
    cache = str(tmp_path / "packs")
    outs = [str(tmp_path / f"out_{i}.npz") for i in range(2)]
    _two_processes(_pack_worker, [(cache, out) for out in outs])
    assert len(os.listdir(cache)) == 1, os.listdir(cache)
    assert not _left(cache, ".tmp_*")
    with np.load(outs[0]) as a, np.load(outs[1]) as b:
        for k in ("rows", "hash", "geometry"):
            np.testing.assert_array_equal(a[k], b[k])


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("damage", ["hash.npy", "rows.npy", "meta.json",
                                    "rows.npy cut short"])
def test_damaged_pack_entry_is_replaced_then_mapped(tmp_path, monkeypatch,
                                                    damage):
    cache = str(tmp_path / "packs")
    monkeypatch.setenv("METABULI_PACK_CACHE", cache)
    made = []
    build = packing.build_aa_hash

    def counted(*a, **kw):
        made.append(1)
        return build(*a, **kw)

    monkeypatch.setattr(packing, "build_aa_hash", counted)
    inputs = _pack_inputs()
    first = packing.load_or_pack_wide(*inputs, **WIDE)
    (entry,) = [os.path.join(cache, e) for e in os.listdir(cache)]
    name = damage.split()[0]
    if damage.endswith("cut short"):
        _truncate(os.path.join(entry, name))
    else:
        os.unlink(os.path.join(entry, name))

    for _ in range(2):      # packed again and replaced, then mapped
        got = packing.load_or_pack_wide(*inputs, **WIDE)
        assert len(made) == 2
        assert os.listdir(cache) == [os.path.basename(entry)]
        for a, b in zip(got, first):
            np.testing.assert_array_equal(a, b)
    assert isinstance(got[0], np.memmap) and isinstance(got[1], np.memmap)
    assert sorted(os.listdir(entry)) == ["hash.npy", "meta.json", "rows.npy"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_killed_import_leftovers_are_overwritten(dbs, tmp_path, layout):
    """*.new files as a decode killed half way leaves them (arrays of
    the wrong length, a signature never renamed) are overwritten by the
    next import."""
    native, index = dbs
    d = write_reference_copy(native, str(tmp_path / "ref"), layout)
    cache = os.path.join(d, ".import_cache")
    os.makedirs(cache)
    half = index.size // 2
    for name, dtype in (("kmers", np.uint64), ("infos", np.int32),
                        ("species", np.int32)):
        open_memmap(os.path.join(cache, f"{name}.npy.new"), mode="w+",
                    dtype=dtype, shape=(half,)).flush()
    with open(os.path.join(cache, "source.sig.new"), "w") as f:
        f.write("diffIdx:1:2")
    got = tformat.load_index(d)
    _equal_to_native({k: getattr(got, k) for k in NAMES}, index)
    assert not _left(d, "*.new")


def main(genome_len=1_000_000, trials=3):
    with tempfile.TemporaryDirectory() as root:
        native, index = _native_db(root, genome_len)
        copy = lambda name: write_reference_copy(
            native, os.path.join(root, name), "diffIdx")
        for t in range(trials):
            d = copy(f"alone{t}")
            t0 = time.perf_counter()
            tformat.load_index(d)
            alone = time.perf_counter() - t0
            dirs = [copy(f"pair{t}")]
            outs = [os.path.join(root, f"out{t}_{i}.npz") for i in range(2)]
            _two_processes(_import_worker, [(dirs, out) for out in outs])
            took = sorted(float(np.load(out)["seconds0"]) for out in outs)
            print(f"{index.size} entries: one process alone {alone:.3f} s; "
                  f"two at once {took[0]:.3f} s and {took[1]:.3f} s")


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
