"""The general read generator: deterministic for a seed, the mixes'
shapes as stated."""

import numpy as np
import pytest

from portbench import catalog
from portbench.generators import reads as gen
from portbench.run import Run

from .conftest import tiny_config

MIXES = ["paired150", "long", "api-se150"]


@pytest.fixture(scope="module")
def genomes():
    return catalog.database_kind("clades").genomes(tiny_config(((2, 2),)))


def _rng(seed, stream):
    return Run({}, {"kind": "reads", "entry": "classify_file"}, seed, 1,
               False, "cpu", None).rng(stream)


def _draw(genomes, mix, seed, n=64):
    return gen.draw(genomes, catalog.traffic(mix), n, _rng(seed, 2))


def _rows(s):
    out = list(s.seqs1) if not isinstance(s.seqs1, np.ndarray) \
        else list(s.seqs1)
    return [r.tobytes() for r in out]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_sample(genomes, mix):
    a, b = _draw(genomes, mix, 2 ** 31 + 17), _draw(genomes, mix, 2 ** 31 + 17)
    assert _rows(a) == _rows(b)
    assert np.array_equal(a.src, b.src)
    if a.seqs2 is not None:
        assert np.array_equal(a.seqs2, b.seqs2)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_sample(genomes, mix):
    assert _rows(_draw(genomes, mix, 1)) != _rows(_draw(genomes, mix, 2))


def test_streams_differ(genomes):
    t = catalog.traffic("api-se150")
    a = gen.draw(genomes, t, 32, _rng(5, 1))
    b = gen.draw(genomes, t, 32, _rng(5, 2))
    assert _rows(a) != _rows(b)


def test_long_lengths_same_for_every_seed(genomes):
    t = catalog.traffic("long")
    n = 200
    la = sorted(gen.lengths(t["length"], n, _rng(1, 2)).tolist())
    lb = sorted(gen.lengths(t["length"], n, _rng(99, 2)).tolist())
    assert la == lb
    assert min(la) >= 1000 and max(la) <= 60_000
    assert 7000 <= np.median(la) <= 9000


def test_long_reads_have_their_lengths(genomes):
    t = dict(catalog.traffic("long"),
             length=dict(catalog.traffic("long")["length"], max=9000))
    s = gen.draw(genomes, t, 20, _rng(3, 2))
    want = sorted(gen.lengths(t["length"], 20, _rng(3, 2)).tolist())
    assert sorted(len(r) for r in s.seqs1) == want
    assert all(set(r.tobytes()) <= set(b"ACGT") for r in s.seqs1)


def test_pairs_geometry(genomes):
    t = dict(catalog.traffic("paired150"),
             errors={"substitution": 0.0, "insertion": 0.0, "deletion": 0.0})
    s = gen.draw(genomes, t, 50, _rng(4, 2))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for i in range(50):
        g = genomes[s.src[i]].tobytes()
        m1 = s.seqs1[i].tobytes()
        m2 = s.seqs2[i].tobytes().translate(comp)[::-1]
        at = g.find(m1)
        assert at >= 0
        end = g.find(m2, at)
        assert 280 <= end + 150 - at <= 420


def test_fasta_round_trip(genomes, tmp_path):
    s = _draw(genomes, "paired150", 8, n=10)
    p1, p2 = tmp_path / "a.fna", tmp_path / "b.fna"
    gen.write_fasta(s, p1, p2)
    lines = p2.read_bytes().split(b"\n")
    assert lines[0] == b">r0" and lines[1] == s.seqs2[0].tobytes()
    assert len(lines) == 21
    assert gen.as_strings(s.seqs1)[3] == s.seqs1[3].tobytes().decode()
