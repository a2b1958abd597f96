"""Vectorized SHA-256 over uint32 lanes.

The reference verifiers spend essentially all of their work in SHA-256
compressions (Fiat-Shamir channel + Merkle decommitments; the jets
`sha_256_ctx_8_*` in /root/reference/stwo-verifier/src/channel.simf,
hasher.simf, merkle.simf).  Here the compression function is written
directly over uint32 arrays with arbitrary batch shape, so one call hashes
an entire proof batch per lane.

Message framing: every message the verifiers hash has a *static* byte
length that is a multiple of 4, so messages are passed as big-endian u32
word arrays `(..., n_words)` and the SHA-256 padding is appended at trace
time as compile-time constants.

Two compression paths:
* `compress(state, block)` — computes the message schedule with a
  `lax.fori_loop` (compact HLO, reused at many call sites).
* `compress_const_schedule(state, w)` — for blocks that are compile-time
  constants (e.g. the pure-padding second block of a 64-byte message), the
  64-entry schedule is precomputed on host.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from .u32 import U32, rotr

K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)


def iv(shape=()):
    return np.broadcast_to(IV, tuple(shape) + (8,))


def _small_sigma0(x):
    return rotr(x, 7) ^ rotr(x, 18) ^ (x >> U32(3))


def _small_sigma1(x):
    return rotr(x, 17) ^ rotr(x, 19) ^ (x >> U32(10))


def _big_sigma0(x):
    return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22)


def _big_sigma1(x):
    return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25)


# fori_loop unroll factor: trades XLA loop overhead against traced-graph
# size (compile time).  tests/conftest.py sets STPU_SHA_UNROLL=1 so the CPU suite
# compiles ~4x less HLO per compression call site.
UNROLL = int(os.environ.get("STPU_SHA_UNROLL", "4"))


def _round_fn(k_t, w_t, vs):
    a, b, c, d, e, f, g, h = vs
    # 3-op ch / 4-op maj forms, bitwise-identical to the spec formulas
    ch = g ^ (e & (f ^ g))
    maj = (a & (b | c)) | (b & c)
    t1 = h + _big_sigma1(e) + ch + k_t + w_t
    t2 = _big_sigma0(a) + maj
    return (t1 + t2, a, b, c, d + t1, e, f, g)


def compress(state, block):
    """One SHA-256 compression: state (..., 8), block (..., 16) -> (..., 8).

    The message schedule is computed in-loop over a rolling 16-word window
    so each call site contributes only two compact fori_loop bodies to the
    traced graph.
    """
    k = jnp.asarray(K)
    # When `state` is a host constant (the IV) but `block` is
    # device-varying (e.g. under shard_map), the loop carry must already
    # have block's type (varying manual axes) on entry or scan/fori carry
    # typing fails.  OR-ing a varying zero joins the vma without changing
    # values (XLA folds the op away).
    anchor = block[..., 0] & U32(0)
    vs = tuple(state[..., i] | anchor for i in range(8))

    def body16(t, c):
        vs = c
        return _round_fn(k[t], jax.lax.dynamic_index_in_dim(
            block, t, axis=-1, keepdims=False), vs)

    vs = jax.lax.fori_loop(0, 16, body16, vs, unroll=UNROLL)

    def body48(t, c):
        vs, w = c
        wt = (
            _small_sigma1(jax.lax.dynamic_index_in_dim(w, (t - 2) % 16, -1, False))
            + jax.lax.dynamic_index_in_dim(w, (t - 7) % 16, -1, False)
            + _small_sigma0(jax.lax.dynamic_index_in_dim(w, (t - 15) % 16, -1, False))
            + jax.lax.dynamic_index_in_dim(w, t % 16, -1, False)
        )
        w = jax.lax.dynamic_update_index_in_dim(w, wt, t % 16, axis=-1)
        return (_round_fn(k[t], wt, vs), w)

    vs, _ = jax.lax.fori_loop(16, 64, body48, (vs, block), unroll=UNROLL)
    return state + jnp.stack(vs, axis=-1)


def compress_const_schedule(state, w_const: np.ndarray):
    """Compression against a host-precomputed 64-word schedule."""
    k = jnp.asarray(K)
    w = jnp.asarray(w_const)
    vs = tuple(state[..., i] for i in range(8))

    def body(t, vs):
        return _round_fn(k[t], w[t], vs)

    vs = jax.lax.fori_loop(0, 64, body, vs, unroll=UNROLL)
    return state + jnp.stack(vs, axis=-1)


def schedule_host(block16: np.ndarray) -> np.ndarray:
    """Host-side message schedule for a constant 16-word block."""
    w = list(block16.astype(np.uint64))
    m = (1 << 32) - 1

    def rr(x, n):
        return ((x >> n) | (x << (32 - n))) & m

    for t in range(16, 64):
        s0 = rr(w[t - 15], 7) ^ rr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rr(w[t - 2], 17) ^ rr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & m)
    return np.array(w, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _padding_words(n_words: int):
    """SHA-256 padding (as u32 words) for a message of n_words*4 bytes.

    Returns (pad, n_blocks): `pad` completes the message to a multiple of
    16 words.
    """
    bit_len = n_words * 32
    # message + 0x80... + zeros + 8-byte length
    total = n_words + 1  # the 0x80000000 word (length multiple of 4 bytes)
    while (total + 2) % 16 != 0:
        total += 1
    pad = [0x80000000] + [0] * (total - n_words - 1)
    pad += [bit_len >> 32, bit_len & 0xFFFFFFFF]
    return np.array(pad, dtype=np.uint32), (total + 2) // 16


@functools.lru_cache(maxsize=None)
def _const_pad_block_schedule(n_words: int):
    """If the final block of an n_words message is pure padding, return its
    host-precomputed schedule; else None."""
    pad, n_blocks = _padding_words(n_words)
    if n_words % 16 == 0:
        # final block is entirely padding
        assert pad.shape[0] == 16
        return schedule_host(pad)
    return None


def sha256_words(words):
    """SHA-256 of a big-endian u32 word array (..., n) with static n.

    Matches `sha_256_ctx_8_init / add / finalize` on the same 4n bytes.
    """
    n = words.shape[-1]
    pad, n_blocks = _padding_words(n)
    const_sched = _const_pad_block_schedule(n)
    state = iv(words.shape[:-1])
    if const_sched is not None:
        # data fills whole blocks; final block is constant padding
        for b in range(n // 16):
            state = compress(state, words[..., 16 * b : 16 * (b + 1)])
        state = compress_const_schedule(state, const_sched)
        return state
    full = jnp.concatenate(
        [words, jnp.broadcast_to(pad, words.shape[:-1] + pad.shape)],
        axis=-1,
    )
    for b in range(n_blocks):
        state = compress(state, full[..., 16 * b : 16 * (b + 1)])
    return state


def sha256_pair(left, right):
    """SHA-256 of two concatenated 32-byte digests (the Merkle node hash).

    left/right: (..., 8) u32 arrays.
    """
    state = iv(left.shape[:-1])
    state = compress(state, jnp.concatenate([left, right], axis=-1))
    return compress_const_schedule(state, _const_pad_block_schedule(16))
