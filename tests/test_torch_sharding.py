"""The (dp, db) mesh steps of the torch package vs the JAX package's, on
the CPU, tolerance 0: mesh shapes, shard_index, the two older steps on 8
virtual CPU cells against the JAX steps on the 8-device CPU mesh, the
production step + redundancy (stats header rows 0-4, path columns, pair
columns), the db merge as what combines the cells, measure_scaling on
CPU cells, and the disk cache of the shards."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from metabuli_work_tpu.index.builder import build_database as jbuild
from metabuli_work_tpu.index.format import load_index
from metabuli_work_tpu.parallel import sharding as jsh
from metabuli_work_tpu_torch.index import packing
from metabuli_work_tpu_torch.models import flagship as tfl
from metabuli_work_tpu_torch.ops import match_torch
from metabuli_work_tpu_torch.ops.encode_torch import right_align
from metabuli_work_tpu_torch.parallel import sharding as tsh

from test_torch_match import packed_state
from torch_port_db import build_db, simulate_pairs, simulate_reads, write_inputs
from torch_port_db import one_torch_thread  # noqa: F401  (autouse)

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n):
    m = tsh.make_mesh(n, devices=CPU8)
    assert m.shape == dict(jsh.make_mesh(n).shape)
    assert m.size == n and m.local_rows == list(range(m.shape["dp"]))
    assert all(d == torch.device("cpu") for d in m.devices.ravel())


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.make_mesh(4, devices=["cuda"] * 4)


def test_shard_index_matches_jax():
    rng = np.random.default_rng(4)
    aa = np.sort(rng.integers(0, 1000, 5000).astype(np.uint64))
    values = np.unique((aa << np.uint64(24))
                       | rng.integers(0, 2**24, 5000).astype(np.uint64))
    taxids = rng.integers(1, 9, len(values)).astype(np.int32)
    species = rng.integers(1, 9, len(values)).astype(np.int32)
    for n in (2, 4):
        ref = jsh.shard_index(values, taxids, species, n)
        got = tsh.shard_index(values, taxids, species, n)
        for a, b in zip(ref, got):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- the older steps
@pytest.fixture(scope="module")
def genome_index():
    """One genome indexed (plain 6-frame DB) and 16 reads of 96 bp from
    it, as tests/test_sharding.py builds them."""
    from metabuli_work_tpu.index.builder import IndexBuilder
    from tests_helpers_tax import make_flat_tax

    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), 4000))
    builder = IndexBuilder(make_flat_tax(), syncmer=False, mask_mode=0)
    builder.add_sequence(genome, 4)
    index = builder.finalize()
    B, L = 16, 96
    reads = np.zeros((B, L), dtype=np.uint8)
    for i in range(B):
        s = int(rng.integers(0, len(genome) - L))
        reads[i] = np.frombuffer(genome[s:s + L].encode(), np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[3] = 80
    return index, reads, lengths


def _jax_index(mesh, index):
    pv, pt, ps, counts = jsh.shard_index(
        index.values, index.taxids.astype(np.int32),
        index.species.astype(np.int32), mesh.shape["db"])
    return jsh.device_put_sharded_index(mesh, pv, pt, ps, counts), \
        (pv, pt, ps, counts)


def _jax_reads(mesh, reads, lengths):
    return (jax.device_put(jnp.asarray(reads), NamedSharding(mesh, P("dp"))),
            jax.device_put(jnp.asarray(lengths),
                           NamedSharding(mesh, P("dp"))))


def test_sharded_classify_step_matches_jax(genome_index):
    index, reads, lengths = genome_index
    jmesh = jsh.make_mesh(8)
    jidx, arrays = _jax_index(jmesh, index)
    ref = jsh.make_sharded_classify_step(jmesh, cap=8)(
        *_jax_reads(jmesh, reads, lengths), *jidx)

    mesh = tsh.make_mesh(8, devices=CPU8)
    idx = tsh.device_put_sharded_index(mesh, *arrays)
    got = tsh.make_sharded_classify_step(mesh, cap=8)(reads, lengths, idx)
    for k in ("sel", "hamming", "rh", "taxid", "species", "dna_enc", "pos",
              "frame", "seq_id"):
        np.testing.assert_array_equal(
            np.asarray(ref[k]), torch.cat(got[k]).numpy(), k)
    assert int(np.asarray(ref["match_count"])) == got["match_count"] > 0


def test_sharded_fused_dp_step_matches_jax(genome_index):
    index, reads, lengths = genome_index
    jmesh = jsh.make_mesh(8)
    jidx, arrays = _jax_index(jmesh, index)
    kw = dict(cap=8, path_block=16, path_width=512)
    packed, count = jsh.make_sharded_fused_dp_step(jmesh, **kw)(
        *_jax_reads(jmesh, reads, lengths), *jidx)

    mesh = tsh.make_mesh(8, devices=CPU8)
    idx = tsh.device_put_sharded_index(mesh, *arrays)
    got = tsh.make_sharded_fused_dp_step(mesh, **kw)(reads, lengths, idx)
    assert sorted(got) == [0, 1]
    for i, (p, c) in got.items():
        np.testing.assert_array_equal(np.asarray(packed)[i], p.numpy())
        assert int(np.asarray(count)[i]) == int(c)
    assert int(np.asarray(count).sum()) > 0


# -------------------------------------------------- the production steps
@pytest.fixture(scope="module", params=[False, True], ids=["plain",
                                                           "syncmer"])
def prod(request, tmp_path_factory):
    """A built DB cut into 4 wide shards (the mesh's db axis), its LCA
    tables, and a batch of 16 reads (or pairs) from its genomes."""
    syncmer = request.param
    root = str(tmp_path_factory.mktemp("shard"))
    index = load_index(build_db(jbuild, root, "db", syncmer=syncmer))
    genomes, _ = write_inputs(root)
    _, _, _, _, _, db_ef, sp_euk = packed_state(index)
    quad = packing.pack_db_quad(index.values, db_ef, sp_euk)
    quads, hts, log2, chain, _ = packing.shard_quad_index(quad, 4)
    depth, lift = index.taxonomy.lca_lift_tables()
    euler = index.taxonomy.euler.astype(np.int32)
    if syncmer:                      # single-end, one short read
        r1, _ = simulate_reads(genomes, 16, seed=40)
        l1 = np.full(16, 150, np.int32)
        l1[5] = 117
        r2 = l2 = None
    else:                            # paired, mate 2 in its own bucket
        r1, r2, _ = simulate_pairs(genomes, 16, seed=41)
        r2 = np.ascontiguousarray(r2[:, :120])
        l1 = np.full(16, 150, np.int32)
        l2 = np.full(16, 120, np.int32)
    return dict(syncmer=syncmer, index=index, quad=quad, quads=quads,
                hts=hts, log2=log2, chain=chain, depth=depth, lift=lift,
                euler=euler, r1=r1, l1=l1, r2=r2, l2=l2)


def _torch_rows(mesh, d):
    """The batch's dp rows on the mesh, as the classifier uploads them."""
    Bl = len(d["r1"]) // mesh.shape["dp"]
    t = lambda a, i: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a[i * Bl:(i + 1) * Bl]))
    ra = lambda r, l: None if r is None else right_align(r, l)
    return {i: (t(d["r1"], i), t(d["l1"], i), t(d["r2"], i), t(d["l2"], i),
                t(ra(d["r1"], d["l1"]), i), t(ra(d["r2"], d["l2"]), i))
            for i in mesh.local_rows}


def _step_kw(d):
    return dict(cap=8, kmer_format=2, syncmer=d["syncmer"], smer_len=5,
                min_cons=2, min_cons_euk=9, path_width=256,
                win_frac=184 if d["syncmer"] else 256, path_block=16,
                hash_log2_rows=d["log2"], hash_chain=d["chain"])


def test_fused_dp_prod_and_redundancy_match_jax(prod):
    d = prod
    paired = d["r2"] is not None
    kw = _step_kw(d)
    jmesh = jsh.make_mesh(8)
    shN = NamedSharding(jmesh, P("dp", None))
    sh1 = NamedSharding(jmesh, P("dp"))
    shQ = NamedSharding(jmesh, P("db", None, None))
    B = len(d["r1"])
    r2 = d["r2"] if paired else np.zeros((B, 96), np.uint8)
    l2 = d["l2"] if paired else np.zeros(B, np.int32)
    jstep = jsh.make_sharded_fused_dp_prod(jmesh, paired=paired,
                                           has_ra=True, **kw)
    jout = jstep(jax.device_put(d["r1"], shN), jax.device_put(d["l1"], sh1),
                 jax.device_put(r2, shN), jax.device_put(l2, sh1),
                 jax.device_put(d["quads"], shQ),
                 jax.device_put(d["hts"], shQ),
                 jax.device_put(right_align(d["r1"], d["l1"]), shN),
                 jax.device_put(right_align(r2, l2), shN))
    jhdr = np.asarray(jout[0])

    mesh = tsh.make_mesh(8, devices=CPU8)
    st = packing.sharded_state_from_numpy(
        d["quads"], d["hts"], d["log2"], d["chain"], d["depth"], d["lift"],
        d["euler"], np.zeros(1, np.int32), mesh)
    outs, merged = tsh.make_sharded_fused_dp_prod(mesh, **kw)(
        _torch_rows(mesh, d), st["cells"])
    assert merged > 0
    local = {i: ph[:4, 0].numpy() for i, (ph, _) in outs.items()}
    hdr = tsh.reduce_header(local, mesh.shape["dp"])
    for i, (ph, res) in outs.items():
        ph = ph.numpy().copy()
        ph[:5, 0] = hdr[i]
        np.testing.assert_array_equal(jhdr[i], ph)
        for a, b in zip(jout[1:], res):
            np.testing.assert_array_equal(np.asarray(a)[i],
                                          b.numpy().astype(np.asarray(a).dtype))
    assert jhdr[:, 1, 0].min() > 0              # every row emitted paths

    # redundancy: each read's best species = its first emitted path's
    Bl = B // 2
    best = np.zeros((2, Bl + 1), np.int32)
    for i in range(2):
        n = int(jhdr[i, 1, 0])
        u = jhdr[i, :, 1:n + 1]
        g = (u[0].view(np.uint32) >> 16) if u.shape[0] == 5 else u[0]
        sp = u[3] if u.shape[0] == 5 else u[1]
        for gg, s in zip(g[::-1], sp[::-1]):
            best[i, gg // 6 + 1] = s
    lmax = d["r1"].shape[1] + (r2.shape[1] + 3 if paired else 0)
    n_quot = lmax // 3 + 2
    part_w = tfl.part_widths(d["r1"].shape[1], d["syncmer"], 2, 5,
                             kw["win_frac"],
                             lmax2=r2.shape[1] if paired else None)
    jred = jsh.make_sharded_redundancy(jmesh, dna_shift=3, n_quot=n_quot,
                                       part_w=part_w)
    jp2 = np.asarray(jred(*jout[1:], jax.device_put(best, shN),
                          jnp.asarray(d["euler"]), jnp.asarray(d["depth"]),
                          jnp.asarray(d["lift"])))
    red = tsh.make_sharded_redundancy(mesh, dna_shift=3, n_quot=n_quot,
                                      part_w=part_w)
    got = red({i: res for i, (_, res) in outs.items()}, best, st["tables"])
    for i, p2 in got.items():
        np.testing.assert_array_equal(jp2[i], p2.numpy())
    assert jp2[:, 0, 0].min() > 0               # pairs in every row


def test_db_merge_combines_the_cells(prod):
    """Each cell probes only its own shard into its own accumulators
    (cells of one device too); the merge is what combines them, and the
    merged accumulators equal one probe of the unsharded index."""
    d = prod
    kw = _step_kw(d)
    mesh = tsh.make_mesh(8, devices=CPU8)
    st = packing.sharded_state_from_numpy(
        d["quads"], d["hts"], d["log2"], d["chain"], d["depth"], d["lift"],
        d["euler"], np.zeros(1, np.int32), mesh)
    extract, probe, _ = tsh.make_sharded_stream_steps(mesh, **kw)
    state = extract(_torch_rows(mesh, d))
    probe(state, st["cells"])
    rows, ht, log2, chain, db_m, _, _ = packed_state(d["index"])
    for i, s in state.items():
        accs = s["acc"]
        assert len({id(a["sel"]) for a in accs}) == 4   # one set a cell
        per_cell = [int(a["sel"].sum()) for a in accs]
        assert sum(c > 0 for c in per_cell) >= 2        # the cells share
        # a query's candidates lie in exactly one cell
        owners = torch.stack([a["sel"].any(0) for a in accs]).sum(0)
        assert int(owners.max()) == 1
        qk, qf, qv = s["q_on"][mesh.devices[i, 0]]
        ref = match_torch.match_kmers_quad(
            qk, qf, qv, torch.from_numpy(rows.view(np.int32)), cap=8,
            kmer_format=2, hash_table=torch.from_numpy(ht.view(np.int32)),
            hash_log2_rows=log2, hash_chain=chain, db_m=db_m)
        merged = tsh.merge_db(accs, mesh.row_device(i))
        assert int(merged["sel"].sum()) == sum(per_cell) > max(per_cell)
        for k, v in ref.items():
            want = torch.where(ref["sel"], v, 0) if v.dim() else v
            np.testing.assert_array_equal(want.numpy(), merged[k].numpy(), k)


def test_measure_scaling_runs_on_cpu_cells(capsys):
    from metabuli_work_tpu_torch.parallel.scaling import measure_scaling

    res = measure_scaling(device_counts=(1, 4), batch=8, length=96, iters=1,
                          genome_len=4000, devices=["cpu"] * 4)
    assert set(res) == {1, 4} and all(r > 0 for r in res.values())
    assert "reads_per_s" in capsys.readouterr().out


def test_load_or_shard_caches_the_cut(prod, tmp_path, monkeypatch):
    """The shards come from the disk cache the second time (another
    classifier, process or sequence mode of the same DB), equal to a
    fresh cut."""
    monkeypatch.setenv("HOME", str(tmp_path))
    d = prod
    _, _, _, _, _, db_ef, sp_euk = packed_state(d["index"])
    first = packing.load_or_shard(d["index"].values, db_ef, sp_euk, 4)

    def refuse(*a, **k):
        raise AssertionError("cut again instead of read from the cache")

    monkeypatch.setattr(packing, "shard_quad_index", refuse)
    again = packing.load_or_shard(d["index"].values, db_ef, sp_euk, 4)
    want = (d["quads"], d["hts"], d["log2"], d["chain"])
    for a, b, w in zip(first, again, want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    np.testing.assert_array_equal(again[4], first[4])
    assert again[0].flags.writeable          # copy-on-write map
    with pytest.raises(AssertionError, match="cut again"):
        packing.load_or_shard(d["index"].values, db_ef, sp_euk, 2)
