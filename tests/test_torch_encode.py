"""Torch metamer extraction vs the JAX package's encode_jax, bit-exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from metabuli_work_tpu.ops import encode_jax
from metabuli_work_tpu_torch.ops import encode_torch


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
