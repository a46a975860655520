"""A many-species database, where every path-DP launch is the cap > 32
kernel's: a genus of N_SPECIES species, each its ancestor with 1% of the
bases mutated, so an AA 8-mer of the genus occurs once in almost every
species and the setup cap (the 99.9% AA-run quantile) is above 32.  The
port's Classifier on the CPU against the JAX package's, every read's
(is_classified, classification, score) equal (f32 scores bit-equal),
and the fused device step's stats header and emitted path columns
bit-identical to the JAX step's (its XLA path DP: Pallas interpret mode
compiles for half a minute at this cap)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.classify.pipeline import Classifier as JClassifier
from metabuli_work_tpu.classify.pipeline import ClassifyParams as JParams
from metabuli_work_tpu.models import flagship as jfl
from metabuli_work_tpu.ops.encode_jax import right_align
from metabuli_work_tpu_torch.classify.pipeline import Classifier, ClassifyParams
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.index.builder import IndexBuilder
from metabuli_work_tpu_torch.index.format import load_index, save_index
from metabuli_work_tpu_torch.models import flagship as tfl
from metabuli_work_tpu_torch.ops import dp_cuda
from metabuli_work_tpu_torch.taxonomy import Taxonomy

from test_torch_match import packed_state
from torch_port_db import ACGT, simulate_reads, write_reads
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

N_SPECIES = 40
GENOME_LEN = 6000
N_READS = 160
PARAMS = dict(seq_mode=1, min_score=0.15, min_sp_score=0.5, batch_size=80)
PATH_BLOCK = 128


@pytest.fixture(scope="module")
def highcap(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("highcap"))
    n = N_SPECIES
    tax = Taxonomy(np.array([0, 1, 1] + [2] * n),
                   np.array([0, 0, 1] + [2] * n),
                   np.array([0, 0, 1] + [2 + i for i in range(n)]),
                   ["no rank", "genus", "species"],
                   ["root", "G"] + [f"S{i}" for i in range(n)],
                   np.array([0, 1, 101] + [1000 + i for i in range(n)]))
    rng = np.random.default_rng(9)
    ancestor = ACGT[rng.integers(0, 4, size=GENOME_LEN)]
    builder = IndexBuilder(tax, syncmer=True, mask_mode=0)
    genomes = []
    for i in range(n):
        g = ancestor.copy()
        mut = rng.random(GENOME_LEN) < 0.01
        g[mut] = ACGT[rng.integers(0, 4, size=int(mut.sum()))]
        genomes.append(g.tobytes().decode())
        builder.add_sequence(genomes[-1], 3 + i)
    index = builder.finalize()
    index.meta.update({"kmer_format": 2, "syncmer": True, "smer_len": 5,
                       "reduced_aa": 0, "mask_mode": 0, "mask_prob": 0.9,
                       "skip_redundancy": 1})
    db = os.path.join(root, "db")
    save_index(db, index)
    reads, src = simulate_reads(genomes, N_READS, seed=10)
    path = os.path.join(root, "reads.fna")
    write_reads(path, reads)
    return db, path, reads, src


def _tuples(results):
    return [(q.name, q.result.is_classified, q.result.classification,
             float(q.result.score)) for q in results]


def test_setup_cap_takes_the_high_cap_kernel(highcap):
    db = highcap[0]
    clf = Classifier(db, ClassifyParams(**PARAMS), device="cpu")
    assert clf.cap > dp_cuda.WARP_MAX_CAP
    assert dp_cuda.variant(clf.cap) == "block"


def test_classifier_matches_jax(highcap):
    db, path, _, src = highcap
    jclf = JClassifier(db, JParams(**PARAMS))
    clf = Classifier(db, ClassifyParams(**PARAMS), device="cpu")
    # a lane emits about a path a species chain, more than the default 16
    # slots: both start where their retry ladders settle (each batch
    # then runs once; the JAX step compiles once)
    for c in (jclf, clf):
        c._path_block = PATH_BLOCK
    ref = _tuples(jclf.classify_file(path))
    got = _tuples(clf.classify_file(path))
    assert got == ref
    assert clf.timer.counts["retry"] == 0
    cls = np.array([t[2] for t in got])
    # internal ids: genus 2, species 3 + i
    assert np.mean((cls == 3 + src) | (cls == 2)) >= 0.95


def test_path_columns_match_jax(highcap):
    """One batch through the fused device step at the setup cap: the
    stats header and every emitted path column bit-identical to the JAX
    step's (the padding past the path count differs: the XLA DP leaves
    the lane id in empty slots, the kernels and their plain version 0)."""
    db, _, reads, _ = highcap
    index = load_index(db)
    cap = Classifier(db, ClassifyParams(**PARAMS), device="cpu").cap
    rows, ht, log2_rows, chain, db_m, _, _ = packed_state(index)
    tax = index.taxonomy
    depth, lift = tax.lca_lift_tables()
    st = packing.state_from_numpy(rows, ht, log2_rows, chain, db_m, depth,
                                  lift, tax.euler.astype(np.int32),
                                  tax.euler_first.astype(np.int32), "cpu")
    reads = np.ascontiguousarray(reads[:16])
    lens = np.full(len(reads), reads.shape[1], np.int32)
    ra = right_align(reads, lens)
    kw = dict(min_cons=2, min_cons_euk=9, cap=cap, kmer_format=2,
              syncmer=True, smer_len=5, path_width=0, win_frac=184,
              path_block=PATH_BLOCK, hash_log2_rows=log2_rows,
              hash_chain=chain, db_m=db_m)
    jh, _ = jfl.fused_step_dp(
        jnp.asarray(reads), jnp.asarray(lens),
        jnp.zeros((len(reads), 96), jnp.uint8),
        jnp.zeros(len(reads), jnp.int32), jnp.asarray(rows),
        ra1=jnp.asarray(ra), hash_table=jnp.asarray(ht), dp_pallas=False,
        **kw)
    th, _ = tfl.fused_step_dp(
        torch.from_numpy(reads), torch.from_numpy(lens),
        st["db_quad"], ra1=torch.from_numpy(np.asarray(ra)),
        hash_table=st["hash_table"], **kw)
    jh, th = np.asarray(jh), th.numpy()
    n_paths = int(jh[1, 0])
    assert jh.shape == th.shape and n_paths > len(reads)  # many paths a read
    np.testing.assert_array_equal(jh[:, :1 + n_paths], th[:, :1 + n_paths])
    assert jh[0, 0] == 0 and jh[3, 0] == 0   # no cap or block overflow
