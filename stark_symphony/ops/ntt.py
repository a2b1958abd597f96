"""Radix-2 NTT over F_q (q = 3*2^30 + 1) for the stark101 prover.

The reference prover interpolates with O(n^2 * deg) Lagrange
(/root/reference/stark101/scripts/fibsquare/polynomial.py:291-335) and
evaluates with per-point Horner — minutes of Python.  Here both directions
are O(n log n) batched butterflies over uint32 lanes (Montgomery products),
usable on any JAX backend.

Layout: coefficient/evaluation vectors are (..., n) uint32 with n a power of
two; twiddles are host-precomputed per (n, root) pair.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from . import field101 as F


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, root: int, inverse: bool):
    """Per-stage twiddle tables for a DIT NTT of size n."""
    w = pow(root, F.Q - 2, F.Q) if inverse else root
    assert pow(w, n, F.Q) == 1 and pow(w, n // 2, F.Q) != 1
    stages = []
    m = 2
    while m <= n:
        wm = pow(w, n // m, F.Q)
        tw = np.empty(m // 2, dtype=np.uint32)
        cur = 1
        for j in range(m // 2):
            tw[j] = cur
            cur = (cur * wm) % F.Q
        stages.append(tw)
        m *= 2
    return stages


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt(values, root: int, inverse: bool = False):
    """NTT/INTT of (..., n) along the last axis w.r.t. an order-n root.

    Forward: X_k = sum_i x_i root^{ik}.  Inverse includes the 1/n factor.
    """
    n = values.shape[-1]
    assert n & (n - 1) == 0
    perm = _bit_reverse_perm(n)
    x = jnp.asarray(values, jnp.uint32)[..., perm]
    for stage, tw in enumerate(_twiddles(n, root, inverse)):
        m = 2 << stage
        # reshape to (..., n/m, m) and split halves
        shape = x.shape[:-1] + (n // m, m)
        xb = x.reshape(shape)
        even = xb[..., : m // 2]
        odd = xb[..., m // 2 :]
        t = F.f_mul(odd, jnp.asarray(tw))
        x = jnp.concatenate([F.f_add(even, t), F.f_sub(even, t)], axis=-1).reshape(
            values.shape[:-1] + (n,)
        )
    if inverse:
        n_inv = pow(n, F.Q - 2, F.Q)
        x = F.f_mul(x, jnp.uint32(n_inv))
    return x


def eval_on_coset(coeffs, offset: int, root: int, n_out: int | None = None):
    """Evaluate a polynomial on the size-n_out coset {offset * root^i}.

    p(offset * root^i) = NTT(c_k * offset^k)_i; coefficients are zero-padded
    to n_out (root must have order n_out).
    """
    if n_out is not None and coeffs.shape[-1] < n_out:
        pad = n_out - coeffs.shape[-1]
        coeffs = jnp.concatenate(
            [coeffs, jnp.zeros(coeffs.shape[:-1] + (pad,), jnp.uint32)], axis=-1
        )
    n = coeffs.shape[-1]
    offs = np.empty(n, dtype=np.uint32)
    cur = 1
    for k in range(n):
        offs[k] = cur
        cur = (cur * offset) % F.Q
    scaled = F.f_mul(coeffs, jnp.asarray(offs))
    return ntt(scaled, root)
