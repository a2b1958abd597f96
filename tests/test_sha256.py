"""Vectorized SHA-256 vs hashlib and reference golden vectors."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np

from stark_symphony.ops import sha256 as S
from stark_symphony.utils.packing import (
    bytes32_to_words,
    hex_to_words,
    words_to_bytes32,
)


def test_zero32_golden():
    # hasher.simf:112-116: sha256(0^32)
    out = S.sha256_words(jnp.zeros((8,), jnp.uint32))
    assert (
        words_to_bytes32(np.asarray(out)).hex()
        == "66687aadf862bd776c8fc18b8e9f8e20089714856ee233b3902a591d0d5f2925"
    )


def test_u32_golden():
    # hasher.simf:118-122: sha256_32(2915689030)
    out = S.sha256_words(jnp.asarray(np.array([2915689030], np.uint32)))
    want = 64711419806867828842001989061968035503454892533703351743109315571114974747662
    assert int.from_bytes(words_to_bytes32(np.asarray(out)), "big") == want


def test_random_lengths_vs_hashlib():
    rng = np.random.default_rng(7)
    for n_words in [1, 2, 8, 9, 10, 13, 16, 17, 24, 88, 100]:
        msg = rng.integers(0, 2**32, size=(4, n_words), dtype=np.uint64).astype(
            np.uint32
        )
        out = np.asarray(jax.jit(S.sha256_words)(jnp.asarray(msg)))
        for i in range(msg.shape[0]):
            want = hashlib.sha256(msg[i].astype(">u4").tobytes()).digest()
            assert words_to_bytes32(out[i]) == want, (n_words, i)


def test_pair():
    la = bytes32_to_words(hashlib.sha256(b"left").digest())
    rb = bytes32_to_words(hashlib.sha256(b"right").digest())
    out = S.sha256_pair(jnp.asarray(la), jnp.asarray(rb))
    want = hashlib.sha256(
        hashlib.sha256(b"left").digest() + hashlib.sha256(b"right").digest()
    ).digest()
    assert words_to_bytes32(np.asarray(out)) == want


def test_batch_shapes():
    msg = np.arange(3 * 5 * 9, dtype=np.uint32).reshape(3, 5, 9)
    out = np.asarray(S.sha256_words(jnp.asarray(msg)))
    assert out.shape == (3, 5, 8)
    for i in range(3):
        for j in range(5):
            want = hashlib.sha256(msg[i, j].astype(">u4").tobytes()).digest()
            assert words_to_bytes32(out[i, j]) == want
