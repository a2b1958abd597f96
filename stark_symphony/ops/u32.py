"""uint32 building blocks for batched lanes.

Every wide (32x32 -> 64 bit) product in this framework is computed from
16-bit limbs in uint32 arithmetic, so no value ever needs a 64-bit lane.  These helpers
are shape-polymorphic: inputs may carry arbitrary (broadcastable) batch
dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32

MASK16 = U32(0xFFFF)


def _u(x):
    return jnp.asarray(x, dtype=jnp.uint32)


def _is_host_const(x) -> bool:
    """True for values that should be limb-split on host (Python ints,
    numpy scalars/arrays) — never via eager jnp ops."""
    import numpy as _np

    return isinstance(x, (int, _np.integer, _np.ndarray))


def mul32_wide(a, b):
    """Full 32x32 -> 64-bit product as a (hi, lo) pair of uint32 arrays.

    Schoolbook product over 16-bit limbs; all intermediates fit in uint32
    with explicit carry recovery.

    Python-int / numpy-scalar operands are limb-split on host: eager jnp
    ops on concrete values during tracing are catastrophically slow on some
    backends, so constants must never flow through traced bit ops.
    """
    import numpy as _np

    if _is_host_const(a) and not _is_host_const(b):
        a, b = b, a
    if isinstance(b, (int, _np.integer)):
        b = int(b)
        b0 = _np.uint32(b & 0xFFFF)
        b1 = _np.uint32(b >> 16)
    elif isinstance(b, _np.ndarray):
        b = b.astype(_np.uint32)
        b0 = b & _np.uint32(0xFFFF)
        b1 = b >> 16
    else:
        b = _u(b)
        b0 = b & MASK16
        b1 = b >> 16
    if isinstance(a, (int, _np.integer, _np.ndarray)):
        a = _np.asarray(a, _np.uint32)
        a0 = a & _np.uint32(0xFFFF)
        a1 = a >> 16
    else:
        a = _u(a)
        a0 = a & MASK16
        a1 = a >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10  # may wrap: max ~2^33
    carry_mid = (mid < p01).astype(U32)
    lo = p00 + (mid << 16)  # may wrap
    carry_lo = (lo < p00).astype(U32)
    hi = p11 + (mid >> 16) + (carry_mid << 16) + carry_lo
    return hi, lo


def mullo32(a, b):
    """Low 32 bits of the product (wrapping multiply)."""
    return _u(a) * _u(b)


def add_with_carry(a, b):
    """(a + b) mod 2^32 and the carry-out bit."""
    s = _u(a) + _u(b)
    return s, (s < _u(a)).astype(U32)


def add64(a_hi, a_lo, b_hi, b_lo):
    """Add two 64-bit values held as (hi, lo) uint32 pairs (wrapping)."""
    lo, c = add_with_carry(a_lo, b_lo)
    hi = _u(a_hi) + _u(b_hi) + c
    return hi, lo


def lt64(a_hi, a_lo, b_hi, b_lo):
    """Unsigned comparison of 64-bit (hi, lo) pairs: a < b."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def rotr(x, n: int):
    """Rotate right by a static amount (0 < n < 32)."""
    x = _u(x)
    return (x >> U32(n)) | (x << U32(32 - n))


def byte_swap32(x):
    """Reverse the 4 bytes of each uint32 value."""
    x = _u(x)
    return (
        ((x & U32(0x000000FF)) << 24)
        | ((x & U32(0x0000FF00)) << 8)
        | ((x & U32(0x00FF0000)) >> 8)
        | ((x & U32(0xFF000000)) >> 24)
    )


def bit_reverse(x, log_size: int):
    """Reverse the low `log_size` bits of x (vectorized, static log_size).

    Mirrors the semantics of the reference bit_reverse_position
    (/root/reference/stwo-verifier/src/groups/coset.simf:20-25): reverse all
    32 bits then shift right by (32 - log_size).
    """
    x = _u(x)
    x = ((x & U32(0x55555555)) << 1) | ((x >> 1) & U32(0x55555555))
    x = ((x & U32(0x33333333)) << 2) | ((x >> 2) & U32(0x33333333))
    x = ((x & U32(0x0F0F0F0F)) << 4) | ((x >> 4) & U32(0x0F0F0F0F))
    x = byte_swap32(x)
    return x >> U32(32 - log_size) if log_size < 32 else x
