"""Word-major SHA-256 over lane vectors, written as loops.

The per-query stages of the tiled verifier (ops/pallas/gpu_stages.py) hold
every message, state and schedule word as its own vector over the lane
(query) axis.  These helpers are that form of ``ops.sha256``: a word is any
array (a ``(lanes,)`` block inside a Pallas kernel, or a plain array in the
tests), and messages are tuples of words.

Rounds are a ``lax.fori_loop`` over four chunks of 16 unrolled rounds, with
the message-schedule window as a static 16-word carry.  Fully unrolling the
64 rounds (or the Merkle levels) makes the traced program grow with depth,
which costs Triton's compile time and registers on the GPU, and the Pallas
interpreter's XLA compile on the CPU.  Round constants are read from a
table (``tables()``) with a dynamic index, so the same code runs on a table
ref inside a kernel and on a plain array outside one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sha256 import IV, K, _padding_words, schedule_host

# Offsets into the table built by `tables()`:
#   [K_OFF, K_OFF + 64)   round constants K[t]
#   [KW64_OFF, +64)       K[t] + W[t] of the pure-padding block that ends
#                         every 64-byte message (Merkle nodes, 16-word leaves)
K_OFF = 0
KW64_OFF = 64
_PAD64 = np.array([0x80000000] + [0] * 13 + [0, 512], np.uint32)


def tables(extra: np.ndarray | None = None) -> np.ndarray:
    """The u32 constant table the lane SHA reads, optionally followed by
    `extra` words (a kernel's own per-layer metadata), padded to a power
    of two."""
    kw = (K.astype(np.uint64) + schedule_host(_PAD64)) & 0xFFFFFFFF
    parts = [K, kw.astype(np.uint32)]
    if extra is not None:
        parts.append(np.asarray(extra, np.uint32))
    tab = np.concatenate(parts)
    n = 1 << (len(tab) - 1).bit_length()
    return np.concatenate([tab, np.zeros(n - len(tab), np.uint32)])


def _rotr(x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _ssig0(x):
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> np.uint32(3))


def _ssig1(x):
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> np.uint32(10))


def _round(vs, kw):
    """One round; kw = K[t] + W[t].  3-op ch / 4-op maj forms, bitwise
    identical to the spec formulas."""
    a, b, c, d, e, f, g, h = vs
    ch = g ^ (e & (f ^ g))
    maj = (a & (b | c)) | (b & c)
    t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ch + kw
    t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + maj
    return (t1 + t2, a, b, c, d + t1, e, f, g)


def _expand(w):
    """The next 16 schedule words W[16+j] from the window W[0..15]."""
    nw = []
    for j in range(16):
        w2 = w[14 + j] if j < 2 else nw[j - 2]
        w7 = w[9 + j] if j < 7 else nw[j - 7]
        w15 = w[1 + j] if j < 15 else nw[0]
        nw.append(_ssig1(w2) + w7 + _ssig0(w15) + w[j])
    return tuple(nw)


def compress(vs, w, tab):
    """One compression of the 16-word block `w` into state `vs`."""

    def chunk(c, carry):
        vs, w = carry
        for j in range(16):
            vs = _round(vs, tab[K_OFF + c * 16 + j] + w[j])
        return vs, _expand(w)

    out, _ = jax.lax.fori_loop(0, 4, chunk, (tuple(vs), tuple(w)))
    return tuple(v + o for v, o in zip(vs, out))


def compress_pad64(vs, tab):
    """The final compression of a 64-byte message: its block is constant
    padding, so K[t] + W[t] comes from the table."""

    def chunk(c, vs):
        for j in range(16):
            vs = _round(vs, tab[KW64_OFF + c * 16 + j])
        return vs

    out = jax.lax.fori_loop(0, 4, chunk, tuple(vs))
    return tuple(v + o for v, o in zip(vs, out))


def sha_words(ws, tab):
    """SHA-256 of the message of words `ws` (a tuple of same-shape u32
    arrays, big-endian words) -> 8-word digest tuple."""
    n = len(ws)
    pad, n_blocks = _padding_words(n)
    like = ws[0]
    vs = tuple(jnp.full_like(like, np.uint32(IV[i])) for i in range(8))
    for blk in range(n_blocks):
        if n == 16 and blk == 1:
            return compress_pad64(vs, tab)
        w = []
        for i in range(16):
            j = 16 * blk + i
            w.append(ws[j] if j < n else
                     jnp.full_like(like, np.uint32(pad[j - n])))
        vs = compress(vs, w, tab)
    return vs


def node(left, right, tab):
    """Merkle node hash sha256(left || right) of two digest tuples."""
    return sha_words(tuple(left) + tuple(right), tab)


def walk(cur, idx, depth, sib, tab):
    """Authentication-path walk: `depth` levels (static or traced) from
    leaf digest `cur` at index `idx`; sib(level) returns that level's
    sibling digest, leaf level first.  Returns the recomputed root."""

    def level(lvl, carry):
        cur, idx = carry
        s = sib(lvl)
        bit = (idx & np.uint32(1)) != 0
        left = tuple(jnp.where(bit, a, b) for a, b in zip(s, cur))
        right = tuple(jnp.where(bit, b, a) for a, b in zip(s, cur))
        return node(left, right, tab), idx >> np.uint32(1)

    root, _ = jax.lax.fori_loop(0, depth, level, (tuple(cur), idx))
    return root
