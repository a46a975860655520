"""Reference-format databases in the torch package against the JAX
package: the 15-bit delta codecs (the vectorised 96-bit encoder against
JAX's per-entry loop), the bytes export_reference_format writes, the
windowed import of both layouts (diffIdx/info and deltaIdx.mtbl) and its
memmap cache, the taxonomyDB blob parser, and classification of a
reference-layout DB, per read equal to JAX's on the same directory and
to the native-layout run.  Exact equality throughout."""

import os
import shutil
import tempfile
import warnings

import numpy as np
import pytest

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.index import delta as jdelta
from metabuli_work_tpu.index import format as jformat
from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index import delta as tdelta
from metabuli_work_tpu_torch.index import format as tformat
from metabuli_work_tpu_torch.index.builder import build_database as tbuild

from torch_port_db import (simulate_reads, write_inputs, write_reads,
                           write_reference_copy, write_taxonomy_blob)
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=8)
U64 = np.uint64


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Both builders with --reference-format on one input, a reads file,
    and one reference-layout directory per layout, made from the torch
    build: diffIdx/info (the export) or deltaIdx.mtbl (the 96-bit
    stream), with db.parameters and a taxonomyDB blob and no
    db.meta.json.  Each layout has a twin directory for the JAX package,
    so neither package reads the other's import cache."""
    root = str(tmp_path_factory.mktemp("ref"))
    genomes, p = write_inputs(root)
    dirs = {}
    for name, build in (("jdb", jbuild), ("tdb", tbuild)):
        dirs[name] = os.path.join(root, name)
        build(dirs[name], p["fastas"], p["acc2taxid"], p["taxdump"],
              syncmer=True, mask_mode=0, write_reference_format=True)
    reads, _ = simulate_reads(genomes, 22, seed=5)
    path = os.path.join(root, "reads.fna")
    write_reads(path, reads)
    for layout in ("diffIdx", "mtbl"):
        for who in ("t", "j"):
            dirs[f"{who}ref_{layout}"] = write_reference_copy(
                dirs["tdb"], os.path.join(root, f"{who}ref_{layout}"),
                layout)
    return root, dirs, path


# ------------------------------------------------------------ delta codecs
def _codec_case(name):
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return np.zeros(0, U64), np.zeros(0, U64)
    if name == "one":
        return np.array([123456789], U64), np.array([7], U64)
    if name == "five-chunk":
        # gaps of 2^60 to 2^61: five-chunk 64-bit deltas, seven-chunk words
        v = np.cumsum(rng.integers(1 << 60, 1 << 61, size=7, dtype=U64))
        return v, rng.integers(0, 1 << 30, size=7).astype(U64)
    # mtbl carry: equal metamers with rising ids, then a metamer step
    # with a smaller id (the low 30 bits borrow from the metamer part)
    v = np.repeat(np.cumsum(rng.integers(1, 1 << 12, size=50, dtype=U64)), 3)
    ids = rng.integers(0, 1 << 30, size=(50, 3)).astype(U64)
    ids.sort(axis=1)
    return v, ids.ravel()


@pytest.mark.parametrize("case", ["empty", "one", "five-chunk", "carry"])
def test_delta_codecs_equal_jax(case):
    v, ids = _codec_case(case)
    chunks = tdelta.encode_deltas(v)
    np.testing.assert_array_equal(chunks, jdelta.encode_deltas(v))
    assert chunks.dtype == np.uint16
    np.testing.assert_array_equal(tdelta.decode_deltas(chunks), v)
    np.testing.assert_array_equal(tdelta.decode_deltas(chunks),
                                  jdelta.decode_deltas(chunks))
    m96 = tdelta.encode_metamer_deltas(v, ids)
    np.testing.assert_array_equal(m96, jdelta.encode_metamer_deltas(v, ids))
    assert m96.dtype == np.uint16
    for a, b in zip(tdelta.decode_metamer_deltas(m96),
                    jdelta.decode_metamer_deltas(m96)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdelta.decode_metamer_deltas(m96)[0], v)
    for a, b in zip(tdelta._split_deltas_96(m96),
                    jdelta._split_deltas_96(m96)):
        np.testing.assert_array_equal(a, b)
    assert tdelta.count_entries(m96) == jdelta.count_entries(m96) == len(v)
    if case == "five-chunk":
        ends = np.nonzero(chunks & 0x8000)[0]
        assert np.diff(np.concatenate([[-1], ends])).max() >= 5


def test_vectorised_mtbl_encoder_equals_jax_loop():
    """20,000 entries: repeated metamers with id borrows, gaps from 1 to
    2^60 (one to seven chunks a word), the JAX loop's chunk stream byte
    for byte; a descending entry is refused."""
    rng = np.random.default_rng(9)
    gaps = np.where(rng.random(20_000) < 0.3, 0,
                    rng.integers(1, 1 << 60, size=20_000, dtype=U64)
                    >> rng.integers(0, 60, size=20_000).astype(U64))
    v = np.cumsum(gaps.astype(U64), dtype=U64)
    ids = rng.integers(0, 1 << 30, size=20_000).astype(U64)
    order = np.lexsort((ids, v))
    v, ids = v[order], ids[order]
    got = tdelta.encode_metamer_deltas(v, ids)
    assert got.tobytes() == jdelta.encode_metamer_deltas(v, ids).tobytes()
    with pytest.raises(ValueError, match="ascend"):
        tdelta.encode_metamer_deltas(v[::-1], ids[::-1])


# ------------------------------------------------------------ export/import
def test_export_bytes_equal_jax(dbs):
    _, dirs, _ = dbs
    for f in ("diffIdx", "info", "split"):
        with open(os.path.join(dirs["jdb"], f), "rb") as a, \
                open(os.path.join(dirs["tdb"], f), "rb") as b:
            ref = a.read()
            assert b.read() == ref and ref, f
    assert os.path.getsize(os.path.join(dirs["tdb"], "split")) == 4096 * 24


class _FlatTax:
    """Taxonomy stand-in for the import (species_of only)."""

    def species_of(self, t):
        return np.asarray(t)


@pytest.mark.parametrize("layout", ["diffIdx", "mtbl"])
def test_windowed_import_equals_jax(tmp_path, layout):
    """100,000 entries (some 200,000 chunks) through 65,536-chunk
    windows, against the JAX import of a twin directory; a second import
    maps the cache instead of decoding again."""
    rng = np.random.default_rng(11)
    n = 100_000
    v = np.cumsum(rng.integers(1, 1 << 20, size=n, dtype=U64), dtype=U64)
    t = rng.integers(1, 1 << 29, size=n).astype(U64)
    dirs = [str(tmp_path / who) for who in ("t", "j")]
    for d in dirs:
        os.makedirs(d)
        if layout == "diffIdx":
            tdelta.encode_deltas(v).astype("<u2").tofile(
                os.path.join(d, "diffIdx"))
            t.astype("<u4").tofile(os.path.join(d, "info"))
        else:
            tdelta.encode_metamer_deltas(v, t).astype("<u2").tofile(
                os.path.join(d, "deltaIdx.mtbl"))
    got = tformat.import_reference_format(dirs[0], _FlatTax(),
                                          window_bytes=1 << 16)
    ref = jformat.import_reference_format(dirs[1], _FlatTax(),
                                          window_bytes=1 << 16)
    for k in ("values", "taxids", "species"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    np.testing.assert_array_equal(got.values, v)
    cache = os.path.join(dirs[0], ".import_cache")
    stamp = {f: os.stat(os.path.join(cache, f)).st_mtime_ns
             for f in os.listdir(cache)}
    again = tformat.import_reference_format(dirs[0], _FlatTax(),
                                            window_bytes=1 << 16)
    np.testing.assert_array_equal(again.values, v)
    assert stamp == {f: os.stat(os.path.join(cache, f)).st_mtime_ns
                     for f in os.listdir(cache)}
    assert isinstance(again.values, np.memmap) and again.values.flags.writeable


class _Reranked:
    """A taxonomy whose genus nodes are ranked species and whose species
    nodes are ranked below them: every species id gets its genus as its
    species."""

    def __init__(self, tax):
        self.parent, self.int2orig, self.name_of = \
            tax.parent, tax.int2orig, tax.name_of
        self._rank_of = tax.rank_of

    def rank_of(self, i):
        r = self._rank_of(i)
        return {"genus": "species", "species": "no rank"}.get(r, r)


def _expected_species(index):
    sp = index.taxonomy.species_of(index.taxids)
    return np.where(sp == 0, index.taxids, sp)


def test_import_cache_follows_the_taxonomy(dbs, tmp_path):
    """An edited taxonomyDB makes the next load decode again with the new
    species; the earlier import's arrays stay readable meanwhile."""
    _, dirs, _ = dbs
    d = str(tmp_path / "db")
    shutil.copytree(dirs["tref_diffIdx"], d,
                    ignore=shutil.ignore_patterns(".import_cache"))
    first = tformat.load_index(d)
    before = np.array(first.species)
    np.testing.assert_array_equal(before, _expected_species(first))
    write_taxonomy_blob(os.path.join(d, "taxonomyDB"),
                        _Reranked(first.taxonomy))
    second = tformat.load_index(d)
    np.testing.assert_array_equal(second.species, _expected_species(second))
    assert (np.asarray(second.species) != before).any()
    np.testing.assert_array_equal(second.values, first.values)
    np.testing.assert_array_equal(first.species, before)


def test_import_of_a_read_only_db_leaves_nothing(dbs, tmp_path, monkeypatch,
                                                 capsys):
    """When the DB directory takes no cache, the import decodes into a
    temp dir that is gone once the arrays are mapped, and says so."""
    _, dirs, _ = dbs
    want = tformat.load_index(dirs["tref_mtbl"])
    d = str(tmp_path / "db")
    shutil.copytree(dirs["tref_mtbl"], d,
                    ignore=shutil.ignore_patterns(".import_cache"))
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))

    def refuse(path, *a, **kw):
        raise PermissionError(path)

    monkeypatch.setattr(os, "makedirs", refuse)
    got = tformat.load_index(d)
    monkeypatch.undo()
    assert "not writable" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(d, ".import_cache"))
    assert not os.listdir(tmp)
    for k in ("values", "taxids", "species"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_reference_taxonomy_equals_jax(dbs):
    _, dirs, _ = dbs
    blob = os.path.join(dirs["tref_diffIdx"], "taxonomyDB")
    got = tformat.load_reference_taxonomy(blob)
    ref = jformat.load_reference_taxonomy(blob)
    for k in ("parent", "rank_idx", "name_idx", "int2orig"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert got.rank_pool == ref.rank_pool and got.name_pool == ref.name_pool
    native = tformat.load_index(dirs["tdb"]).taxonomy
    np.testing.assert_array_equal(got.parent, native.parent)
    np.testing.assert_array_equal(got.int2orig, native.int2orig)
    ids = range(1, len(got.parent))
    assert [(got.rank_of(i), got.name_of(i)) for i in ids] \
        == [(native.rank_of(i), native.name_of(i)) for i in ids]
    assert isinstance(tformat.load_db_taxonomy(dirs["tref_diffIdx"]),
                      type(got))


def _records(results):
    return [(q.name, q.result.is_classified, q.result.classification,
             float(q.result.score), dict(q.result.tax_cnt),
             int(q.result.top_species)) for q in results]


@pytest.mark.parametrize("layout", ["diffIdx", "mtbl"])
def test_reference_db_classifies_as_jax_and_native(dbs, layout):
    """load_index routes to load_reference_db; the imported arrays are
    copy-on-write maps that the host-match state and the streamed ranges
    read without a copy or a warning; every flow gives the native-layout
    run's records, and JAX gives the same on its twin directory."""
    _, dirs, path = dbs
    ref_dir = dirs[f"tref_{layout}"]
    native = _records(Classifier(dirs["tdb"], ClassifyParams(**PARAMS),
                                 device="cpu").classify_file(path))
    assert sum(r[1] for r in native) >= 18
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        clf = Classifier(ref_dir, ClassifyParams(**PARAMS), device="cpu")
        assert not os.path.exists(os.path.join(ref_dir, "db.meta.json"))
        assert isinstance(clf.index.values, np.memmap)
        assert _records(clf.classify_file(path)) == native
        jdir = dirs[f"jref_{layout}"]
        if layout == "diffIdx":
            jref = JClassifier(jdir, JParams(**PARAMS))
        else:
            # the JAX load_index routes only a diffIdx directory
            with pytest.raises(FileNotFoundError, match="db.meta.json"):
                jformat.load_index(jdir)
            jref = JClassifier.from_memory(jformat.load_reference_db(jdir),
                                           JParams(**PARAMS))
        assert _records(jref.classify_file(path)) == native
        for kw in (dict(min_cons_cnt=1), dict(hbm_budget_gb=1e-4)):
            p = {**PARAMS, **kw}
            c = Classifier(ref_dir, ClassifyParams(**p), device="cpu")
            want = Classifier(dirs["tdb"], ClassifyParams(**p),
                              device="cpu").classify_file(path)
            assert _records(c.classify_file(path)) == _records(want), kw
        assert c._streaming
    # the host-match state reads the map's pages (no host copy)
    ms = Classifier(ref_dir, ClassifyParams(**{**PARAMS, "min_cons_cnt": 1}),
                    device="cpu")
    st = ms._host_match_state()
    assert st["db_values"].data_ptr() == ms.index.values.ctypes.data
