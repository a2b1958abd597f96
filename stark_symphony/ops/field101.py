"""Batched arithmetic in F_q, q = 3 * 2^30 + 1 = 3221225473 (stark101 field).

The reference performs `a*b mod q` with a 64-bit modulo jet
(/root/reference/stark101/src/field.simf:31-37) and inversion with a
data-dependent extended-Euclid loop (field.simf:40-63).  Neither maps to
uint32 lanes: the lanes carry no 64-bit integers, and data-dependent
iteration counts do not jit.  We instead use:

* Montgomery multiplication with R = 2^32 over 16-bit limb products —
  branch-free, fixed-depth, uint32-only;
* Fermat inversion a^(q-2) with a host-unrolled fixed exponent, which is
  value-identical to extended Euclid for all units (and maps 0 -> 0).

Elements are canonical uint32 in [0, q).  All ops broadcast over batch dims.
"""

from __future__ import annotations

import jax.numpy as jnp

import numpy as np

from .u32 import U32, mul32_wide, mullo32

Q = 3221225473  # 3 * 2^30 + 1
GEN = 5  # multiplicative generator (field.simf:11)
Q32 = U32(Q)

# Montgomery constants (host-computed Python ints)
R_MOD_Q = (1 << 32) % Q                 # 1073741823
R2_MOD_Q = pow(1 << 32, 2, Q)           # R^2 mod q
NEG_QINV = (-pow(Q, -1, 1 << 32)) % (1 << 32)  # -q^{-1} mod 2^32

_R2 = U32(R2_MOD_Q)
_NQI = U32(NEG_QINV)
_2_32_MINUS_Q = U32((1 << 32) - Q)


def _u(x):
    return jnp.asarray(x, dtype=jnp.uint32)


def _mont_redc(hi, lo):
    """Montgomery reduction of a 64-bit value t = hi*2^32 + lo (t < q*2^32).

    Returns t * 2^-32 mod q, canonical in [0, q).
    """
    m = mullo32(lo, _NQI)
    mq_hi, _ = mul32_wide(m, Q)
    # (lo + mq_lo) is a multiple of 2^32: carry is 1 iff lo != 0.
    carry = (lo != 0).astype(U32)
    # t = hi + mq_hi + carry may exceed 2^32 (q > 2^31): track carries.
    s1 = hi + mq_hi
    c1 = (s1 < hi).astype(U32)
    t = s1 + carry
    c2 = (t < s1).astype(U32)
    overflow = (c1 + c2) > 0
    # true t' = t + overflow * 2^32, and t' < 2q.  Subtract q when t' >= q.
    res_overflow = t + _2_32_MINUS_Q           # t + 2^32 - q (no wrap: t < 2q - 2^32)
    res_plain = jnp.where(t >= Q32, t - Q32, t)
    return jnp.where(overflow, res_overflow, res_plain)


def mont_mul(a, b):
    """a * b * 2^-32 mod q."""
    hi, lo = mul32_wide(a, b)
    return _mont_redc(hi, lo)


def f_mul(a, b):
    """a * b mod q (standard form in, standard form out)."""
    return mont_mul(mont_mul(a, b), np.uint32(R2_MOD_Q))


def f_add(a, b):
    from .checks import check_lt, enabled as _chk

    if _chk():  # STPU_CHECK=1: assert canonical inputs (ops/checks.py)
        check_lt(a, Q, "f_add lhs")
        check_lt(b, Q, "f_add rhs")
    a = _u(a)
    b = _u(b)
    s = a + b  # may wrap: a + b < 2q < 2^33
    wrapped = s < a
    # if wrapped, true value = s + 2^32 ≡ s + (2^32 - q) ... then still < q?
    # true sum < 2q; wrapped => true sum >= 2^32 > q => subtract q once.
    s_w = s + _2_32_MINUS_Q
    s_nw = jnp.where(s >= Q32, s - Q32, s)
    return jnp.where(wrapped, s_w, s_nw)


def f_neg(a):
    a = _u(a)
    return jnp.where(a == 0, a, Q32 - a)


def f_sub(a, b):
    return f_add(a, f_neg(b))


def f_pow(a, exponent: int):
    """a ** exponent for a static Python-int exponent (host-unrolled).

    Runs in the Montgomery domain internally: one conversion in, one out.
    """
    e = int(exponent)
    if e == 0:
        return jnp.broadcast_to(U32(1), jnp.shape(_u(a)))
    am = mont_mul(a, np.uint32(R2_MOD_Q))  # to Montgomery form
    result = None
    base = am
    while e > 0:
        if e & 1:
            result = base if result is None else mont_mul(result, base)
        e >>= 1
        if e:
            base = mont_mul(base, base)
    return mont_mul(result, np.uint32(1))  # back to standard form


def f_inv(a):
    """a^(q-2); maps 0 -> 0 (validity handled by caller masks)."""
    return f_pow(a, Q - 2)


def f_div(a, b):
    return f_mul(a, f_inv(b))


def f_inv_many(values):
    """Batch inversion (Montgomery's trick): one f_inv for N values.

    `values` is a list of arrays (any broadcast-compatible shapes); returns
    the list of elementwise inverses.  Zero inputs yield zeros for ALL
    entries sharing a lane with the zero — callers must ensure nonzero
    inputs (verifier denominators are nonzero for honest and dishonest
    proofs alike; a zero would indicate a malformed query anyway and is
    caught by the Merkle masks).
    """
    prefix = [values[0]]
    for v in values[1:]:
        prefix.append(f_mul(prefix[-1], v))
    inv_all = f_inv(prefix[-1])
    out = [None] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = f_mul(inv_all, prefix[i - 1])
        inv_all = f_mul(inv_all, values[i])
    out[0] = inv_all
    return out


def mod_u64(hi, lo, m: int):
    """(hi * 2^32 + lo) mod m for a static modulus m (uint32 arrays in/out).

    Powers of two reduce by masking.  Odd m uses Montgomery-style reduction
    with host-computed constants.  Even non-power-of-two m is split as
    m = 2^k * odd via CRT — not needed by any current call site, so it is
    unsupported.
    """
    hi = _u(hi)
    lo = _u(lo)
    m = int(m)
    if m & (m - 1) == 0:  # power of two
        return lo & U32(m - 1)
    if m % 2 == 1:
        neg_minv = (-pow(m, -1, 1 << 32)) % (1 << 32)
        r2 = pow(1 << 32, 2, m)
        m32 = U32(m)
        two32_minus_m = U32((1 << 32) - m)

        def redc(h, l):
            mm = mullo32(l, U32(neg_minv))
            mqh, _ = mul32_wide(mm, m)
            carry = (l != 0).astype(U32)
            s1 = h + mqh
            c1 = (s1 < h).astype(U32)
            t = s1 + carry
            c2 = (t < s1).astype(U32)
            overflow = (c1 + c2) > 0
            res_overflow = t + two32_minus_m
            res_plain = jnp.where(t >= m32, t - m32, t)
            return jnp.where(overflow, res_overflow, res_plain)

        # value = hi*2^32 + lo; redc gives value * 2^-32 mod m (requires
        # value < m * 2^32, i.e. hi < m — reduce hi first).
        hi_r = _umod_small(hi, m)
        t = redc(hi_r, lo)            # value * 2^-32 mod m
        th, tl = mul32_wide(t, np.uint32(r2))
        return redc(th, tl)           # value mod m
    raise NotImplementedError("even non-power-of-two modulus")


def _umod_small(x, m: int):
    """x mod m for uint32 x and static uint32 m, via float-free reduction."""
    # Barrett with 32-bit reciprocal: q = (x * floor(2^32/m)) >> 32 underestimates
    # by at most 1 for m not a power of two; correct with one subtract.
    recip = ((1 << 32) // m)
    qh, _ = mul32_wide(x, np.uint32(recip))
    r = _u(x) - mullo32(qh, U32(m))
    r = jnp.where(r >= U32(m), r - U32(m), r)
    r = jnp.where(r >= U32(m), r - U32(m), r)
    return r


def mod_words_be(words, m: int):
    """Big-endian u32 word array (..., n) interpreted as a big integer, mod m.

    Mirrors the Horner reduction of the reference channel
    (/root/reference/stark101/src/channel.simf:67-99): r = 0; for each limb
    (most-significant first): r = (r * 2^32 + limb) mod m.
    """
    n = words.shape[-1]
    r = jnp.zeros(words.shape[:-1], dtype=jnp.uint32)
    for i in range(n):
        r = mod_u64(r, words[..., i], m)
    return r
