"""The general read generator (traffic `kind` "reads").

Reads a mix's parameters:

- `length`: {"dist": "fixed", "bases": L} or {"dist": "lognormal",
  "median": m, "sigma": s, "min": a, "max": b};
- `pairs` (optional): {"insert_min", "insert_max"}: paired fragments,
  mate 1 the fragment's first L bases, mate 2 the reverse complement of
  its last L (Illumina orientation);
- `errors`: per-base shares of "substitution" (a base redrawn from
  ACGT), "insertion" and "deletion";
- `reverse_fraction`: share of single reads reverse-complemented.

Each read comes from a genome drawn uniformly and a uniform position.
Lognormal lengths are drawn stratified: n reads take the n quantiles
(i + 0.5) / n of the distribution, shuffled by the seed, so every seed
sends the same lengths in another order.

Fixed-length reads without indels are made as chip_smoke.py makes them
(simulate_reads, simulate_pairs): a substitution may redraw the same
base.
"""

from statistics import NormalDist

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b


class Sample:
    """n queries: mate 1 (and mate 2 of pairs) as a [n, L] uint8 array
    or a list of uint8 arrays, and each query's source genome."""

    def __init__(self, seqs1, seqs2, src):
        self.seqs1, self.seqs2, self.src = seqs1, seqs2, src

    def __len__(self):
        return len(self.src)

    def mate(self, i, which=1):
        s = self.seqs1 if which == 1 else self.seqs2
        return None if s is None else s[i]

    def lengths(self, which=1):
        s = self.seqs1 if which == 1 else self.seqs2
        if isinstance(s, np.ndarray):
            return np.full(len(self), s.shape[1], dtype=np.int64)
        return np.array([len(x) for x in s], dtype=np.int64)


def lengths(spec, n, rng):
    if spec["dist"] == "fixed":
        return np.full(n, spec["bases"], dtype=np.int64)
    if spec["dist"] == "lognormal":
        nd = NormalDist(np.log(spec["median"]), spec["sigma"])
        q = np.exp([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
        q = np.clip(np.rint(q), spec["min"], spec["max"]).astype(np.int64)
        return rng.permutation(q)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _indel_read(G, g, start, L, err, rng):
    """One read of L bases from genome g at `start` through the error
    model: a template base is deleted, else kept (substituted at the
    substitution rate); an insertion adds a random base after it."""
    p_sub, p_ins, p_del = (err.get("substitution", 0.0),
                           err.get("insertion", 0.0),
                           err.get("deletion", 0.0))
    n_t = int(L * (1 + 2 * p_del) + 64)
    tpl = G[g, start:start + n_t]
    keep = rng.random(len(tpl)) >= p_del
    ins = rng.random(len(tpl)) < p_ins
    both = np.empty((len(tpl), 2), dtype=np.uint8)
    both[:, 0] = tpl
    both[:, 1] = ACGT[rng.integers(0, 4, size=len(tpl))]
    out = both[np.stack([keep, ins], 1)]
    if len(out) < L:
        raise RuntimeError("read template too short for its length")
    out = out[:L].copy()
    sub = rng.random(L) < p_sub
    out[sub] = ACGT[rng.integers(0, 4, size=int(sub.sum()))]
    return out


def draw(genomes, traffic, n, rng):
    """The Sample of n queries of the mix, from rng."""
    G = genomes
    err = traffic["errors"]
    indels = err.get("insertion", 0) > 0 or err.get("deletion", 0) > 0
    spec = traffic["length"]
    gi = rng.integers(0, G.shape[0], size=n)
    if "pairs" in traffic:
        if spec["dist"] != "fixed" or indels:
            raise ValueError("pairs take fixed lengths and substitutions")
        L = spec["bases"]
        lo, hi = traffic["pairs"]["insert_min"], traffic["pairs"]["insert_max"]
        ins = rng.integers(lo, hi + 1, size=n)
        starts = rng.integers(0, G.shape[1] - hi, size=n)
        frag = G[gi[:, None], starts[:, None] + np.arange(hi)[None, :]]
        e = rng.random(frag.shape) < err["substitution"]
        frag[e] = ACGT[rng.integers(0, 4, size=int(e.sum()))]
        r1 = np.ascontiguousarray(frag[:, :L])
        idx = ins[:, None] - 1 - np.arange(L)[None, :]
        r2 = np.ascontiguousarray(COMP[frag[np.arange(n)[:, None], idx]])
        return Sample(r1, r2, gi)
    rc = traffic.get("reverse_fraction", 0.0)
    if spec["dist"] == "fixed" and not indels:
        L = spec["bases"]
        starts = rng.integers(0, G.shape[1] - L, size=n)
        reads = G[gi[:, None], starts[:, None] + np.arange(L)[None, :]]
        e = rng.random((n, L)) < err["substitution"]
        reads[e] = ACGT[rng.integers(0, 4, size=int(e.sum()))]
        flip = rng.random(n) < rc
        reads[flip] = COMP[reads[flip, ::-1]]
        return Sample(np.ascontiguousarray(reads), None, gi)
    lens = lengths(spec, n, rng)
    reads = []
    for g, L in zip(gi.tolist(), lens.tolist()):
        span = int(L * (1 + 2 * err.get("deletion", 0.0)) + 64)
        start = int(rng.integers(0, G.shape[1] - span))
        r = _indel_read(G, g, start, L, err, rng)
        if rng.random() < rc:
            r = COMP[r[::-1]]
        reads.append(r)
    return Sample(reads, None, gi)


def _fasta(path, seqs):
    with open(path, "wb") as f:
        if isinstance(seqs, np.ndarray):
            L = seqs.shape[1]
            buf = seqs.tobytes()
            f.write(b"".join(b">r%d\n%s\n" % (i, buf[i * L:(i + 1) * L])
                             for i in range(seqs.shape[0])))
        else:
            f.write(b"".join(b">r%d\n%s\n" % (i, s.tobytes())
                             for i, s in enumerate(seqs)))


def write_fasta(sample, path1, path2=None):
    """The sample as FASTA files (mate 2 into path2)."""
    _fasta(path1, sample.seqs1)
    if sample.seqs2 is not None:
        _fasta(path2, sample.seqs2)


def as_strings(seqs):
    """The reads as str, as a caller holding them in memory has them."""
    if isinstance(seqs, np.ndarray):
        L = seqs.shape[1]
        buf = seqs.tobytes().decode("ascii")
        return [buf[i * L:(i + 1) * L] for i in range(seqs.shape[0])]
    return [s.tobytes().decode("ascii") for s in seqs]
