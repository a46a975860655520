"""Torch metamer extraction vs the JAX package's encode_jax, bit-exact;
extraction without right-aligned copies; CPU tensors routed to the torch
body, never to the CUDA kernel's wrapper."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.ops import encode_jax
from metabuli_work_tpu_torch.models import flagship
from metabuli_work_tpu_torch.ops import encode_cuda, encode_torch

from torch_port_db import one_torch_thread  # noqa: F401  (autouse)


def _reads(seed, B=6, L=96):
    rng = np.random.default_rng(seed)
    arr = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=(B, L),
                     p=[.24, .24, .24, .24, .01, .01, .01, .005, .005])
    lens = rng.integers(20, L + 1, size=B).astype(np.int32)
    lens[0] = L
    return arr, lens


@pytest.mark.parametrize("syncmer", [False, True])
@pytest.mark.parametrize("kmer_format", [1, 2])
@pytest.mark.parametrize("with_ra", [False, True])
def test_extract_batch_matches_jax(syncmer, kmer_format, with_ra):
    arr, lens = _reads(11 + kmer_format + 2 * syncmer)
    ra = encode_jax.right_align(arr, lens) if with_ra else None
    jk, jp, jv = encode_jax.extract_batch(
        jnp.asarray(arr), jnp.asarray(lens), syncmer=syncmer,
        kmer_format=kmer_format,
        reads_ra=None if ra is None else jnp.asarray(ra))
    tk, tp, tv = encode_torch.extract_batch(
        torch.from_numpy(arr), torch.from_numpy(lens), syncmer=syncmer,
        kmer_format=kmer_format,
        reads_ra=None if ra is None else torch.from_numpy(ra))
    np.testing.assert_array_equal(np.asarray(jk).view(np.int64), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_right_align_and_helpers():
    arr, lens = _reads(3)
    np.testing.assert_array_equal(encode_jax.right_align(arr, lens),
                                  encode_torch.right_align(arr, lens))
    for n in (0, 23, 24, 150, 168):
        assert encode_jax.max_windows(n) == encode_torch.max_windows(n)
    lj = np.asarray(encode_jax._used_len(jnp.asarray(lens)))
    np.testing.assert_array_equal(
        lj, encode_torch._used_len(torch.from_numpy(lens)).numpy())


@pytest.mark.parametrize("w_c", [4, 12, 30])
def test_compact_and_flatten_match_jax(w_c):
    arr, lens = _reads(5)
    jk, jp, jv = encode_jax.extract_batch(jnp.asarray(arr), jnp.asarray(lens),
                                          syncmer=True)
    tk, tp, tv = encode_torch.extract_batch(torch.from_numpy(arr),
                                            torch.from_numpy(lens),
                                            syncmer=True)
    jc = encode_jax.compact_windows(jk, jp, jv, w_c)
    tc = encode_torch.compact_windows(tk, tp, tv, w_c)
    np.testing.assert_array_equal(np.asarray(jc[0]).view(np.int64),
                                  tc[0].numpy())
    for a, b in zip(jc[1:], tc[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    sids = np.arange(1, arr.shape[0] + 1, dtype=np.int32)
    jf = encode_jax.flatten_batch(*jc[:3], jnp.asarray(sids))
    tf = encode_torch.flatten_batch(*tc[:3], torch.from_numpy(sids))
    np.testing.assert_array_equal(np.asarray(jf[0]).view(np.int64),
                                  tf[0].numpy())
    for a, b in zip(jf[1:], tf[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("syncmer", [False, True], ids=["plain", "syncmer"])
def test_aa_only_extract_batch_matches_jax(syncmer):
    """AA-only 12-mers (the dna2aa scanners), no DNA part: bit-exact
    against JAX, and per read the (k-mer, position) multiset of the
    host scanner ops/encode_np.extract_query_kmers(aa_only=True)."""
    from metabuli_work_tpu_torch.ops import encode_np

    arr, lens = _reads(21 + syncmer, B=8, L=120)
    jk, jp, jv = encode_jax.extract_batch(
        jnp.asarray(arr), jnp.asarray(lens), syncmer=syncmer, k=12,
        aa_only=True)
    tk, tp, tv = encode_torch.extract_batch(
        torch.from_numpy(arr), torch.from_numpy(lens), syncmer=syncmer,
        k=12, aa_only=True)
    np.testing.assert_array_equal(np.asarray(jk).view(np.int64), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert tv.any() and int(tk[tv].min()) >= 0 and int(tk[tv].max()) < 1 << 60
    for b in range(len(arr)):
        seq = arr[b, :lens[b]].tobytes().decode()
        km, pos, _ = encode_np.extract_query_kmers(
            seq, syncmer=syncmer, k=12, aa_only=True)
        v = tv[b].numpy()
        got = sorted(zip(tk[b].numpy()[v].tolist(), tp[b].numpy()[v].tolist()))
        assert got == sorted(zip(km.astype(np.int64).tolist(),
                                 pos.astype(np.int64).tolist()))


def _queries(paired, syncmer, win_frac, with_ra):
    a1, l1 = _reads(31, B=6, L=96)
    a2, l2 = _reads(32, B=6, L=120)
    t = torch.from_numpy
    mate2 = (t(a2), t(l2)) if paired else (None, None)
    ras = ()
    if with_ra:
        ras = (t(encode_torch.right_align(a1, l1)),
               t(encode_torch.right_align(a2, l2)) if paired else None)
    return flagship.extract_queries_step(t(a1), t(l1), *mate2, *ras,
                                         syncmer=syncmer, win_frac=win_frac)


@pytest.mark.parametrize("paired", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("syncmer,win_frac", [(False, 0), (True, 184)],
                         ids=["plain", "compacted"])
def test_extract_queries_step_without_ra(paired, syncmer, win_frac):
    """extract_queries_step with no right-aligned copies (as every flow
    now calls it) equals what it gives with them, for one and two
    parts."""
    got = _queries(paired, syncmer, win_frac, with_ra=False)
    ref = _queries(paired, syncmer, win_frac, with_ra=True)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)
    assert got[5] == ref[5] and len(got[5]) == 1 + paired
    assert int(got[6]) == int(ref[6])


def test_cpu_tensors_take_the_torch_body(monkeypatch):
    """CPU tensors go to the plain torch versions without building or
    launching the CUDA kernel (no nvcc needed), and the kernel's wrapper
    refuses them."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA extraction wrapper was reached")

    for name in ("cuda_libraries", "build", "_launch", "extract_batch",
                 "extract_queries"):
        monkeypatch.setattr(encode_cuda, name, refuse)
    n = encode_cuda.launches
    arr, lens = _reads(7)
    t = lambda: (torch.from_numpy(arr), torch.from_numpy(lens))
    for kw in (dict(syncmer=True), dict(k=12, aa_only=True),
               dict(kmer_format=1)):
        got = encode_torch.extract_batch(*t(), **kw)
        ref = encode_torch.extract_batch_ref(*t(), **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got = flagship.extract_queries_step(*t(), *t(), syncmer=True,
                                        win_frac=184)
    ref = flagship.extract_queries_step_ref(*t(), *t(), syncmer=True,
                                            win_frac=184)
    assert all(torch.equal(a, b) for a, b in zip(got[:5], ref[:5]))
    values, taxids, species = flagship.synthetic_db(256)
    out = flagship.classify_step(arr, lens, values, taxids, species,
                                 device="cpu")
    assert out["seq_id"].shape[0] == arr.shape[0] * 6 * 25
    assert encode_cuda.launches == n
    monkeypatch.undo()
    for fn in (lambda: encode_cuda.extract_batch(
                   *t(), syncmer=False, smer_len=5, k=8, aa_only=False,
                   kmer_format=2),
               lambda: encode_cuda.extract_queries(
                   [(*t(), 25)], syncmer=False, smer_len=5, kmer_format=2,
                   compact=False)):
        with pytest.raises(ValueError, match="unsupported device cpu"):
            fn()
    assert encode_cuda.launches == n
