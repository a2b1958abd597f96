"""Batched M31 / CM31 / QM31 field arithmetic (uint32 lanes).

The Mersenne-31 tower used by the stwo circle-STARK scheme:

* M31  = GF(p), p = 2^31 - 1, elements are canonical uint32 in [0, p).
* CM31 = M31[i] / (i^2 + 1), stored as a trailing axis of size 2: [re, im].
* QM31 = CM31[j] / (j^2 - (2 + i)), stored as a trailing axis of size 4:
  [a, b, c, d] meaning (a + b*i) + (c + d*i) * j.

Semantics match the reference implementations
(/root/reference/stwo-verifier/src/fields/{m31,cm31,qm31}.simf) bit-exactly,
including the (2+i) constant in QM31 multiplication and the denominator
formula of qm31_inv.  Unlike the reference (one scalar per jet call), every
op here is elementwise over arbitrary batch shapes, so a single fused XLA
kernel processes millions of lanes.

Wide products use 16-bit limb decomposition (ops.u32.mul32_wide), in
uint32 lanes.
"""

from __future__ import annotations

import jax.numpy as jnp

from .u32 import U32, mul32_wide

P = 0x7FFFFFFF  # 2^31 - 1
P32 = U32(P)


def _u(x):
    return jnp.asarray(x, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# M31
# ---------------------------------------------------------------------------

def m31_reduce(x):
    """Reduce a uint32 in [0, 2^32) to canonical [0, p).

    Equivalent to `val % p` (reference m31.simf:17-19).
    """
    x = _u(x)
    x = (x & P32) + (x >> 31)  # <= p + 1
    return jnp.where(x >= P32, x - P32, x)


def m31_add(a, b):
    from .checks import check_lt, enabled as _chk

    if _chk():  # STPU_CHECK=1: assert canonical inputs (ops/checks.py)
        check_lt(a, P, "m31_add lhs")
        check_lt(b, P, "m31_add rhs")
    s = _u(a) + _u(b)  # < 2^32, no wrap for canonical inputs
    return m31_reduce(s)


def m31_neg(a):
    # p - a; maps 0 -> p -> reference keeps p? m31_neg in reference returns
    # p - a without reduction, so neg(0) = p... but p ≡ 0; downstream ops
    # reduce.  We keep canonical form instead: neg(0) = 0.  All reference
    # call sites feed the result into m31_add/m31_mul which reduce mod p,
    # so canonical form is observationally identical.
    a = _u(a)
    return jnp.where(a == 0, a, P32 - a)


def m31_sub(a, b):
    return m31_add(a, m31_neg(b))


def m31_mul(a, b):
    """a * b mod p via 62-bit product folded twice (2^31 ≡ 1 mod p)."""
    from .checks import check_lt, enabled as _chk

    if _chk():
        check_lt(a, P, "m31_mul lhs")
        check_lt(b, P, "m31_mul rhs")
    hi, lo = mul32_wide(a, b)
    low31 = lo & P32
    high = (hi << 1) | (lo >> 31)  # product >> 31, fits uint32
    s = low31 + high  # <= 2^32 - 2
    return m31_reduce(s)


def m31_sqr(a):
    return m31_mul(a, a)


def m31_pow(a, exponent: int):
    """a ** exponent for a static Python-int exponent (host-unrolled)."""
    result = None
    base = a
    e = int(exponent)
    while e > 0:
        if e & 1:
            result = base if result is None else m31_mul(result, base)
        e >>= 1
        if e:
            base = m31_sqr(base)
    if result is None:
        import numpy as np

        return np.broadcast_to(np.uint32(1), jnp.shape(_u(a)))
    return result


def m31_inv(a):
    """a^(p-2) via the 37-multiplication addition chain.

    Same chain as the reference (m31.simf:117-133); inv(0) = 0 (the
    reference aborts — we return 0 and let validity masks catch it upstream
    where it matters).
    """
    t0 = m31_mul(m31_pow(a, 4), a)          # a^5
    t1 = m31_mul(m31_sqr(t0), t0)           # a^15
    t2 = m31_mul(m31_pow(t1, 8), t0)        # a^125
    t3 = m31_mul(m31_sqr(t2), t0)           # a^255
    t4 = m31_mul(m31_pow(t3, 1 << 8), t3)   # a^65535
    t5 = m31_mul(m31_pow(t4, 1 << 8), t3)   # a^16777215
    return m31_mul(m31_pow(t5, 1 << 7), t2)  # a^2147483645


def m31_div(a, b):
    return m31_mul(a, m31_inv(b))


# ---------------------------------------------------------------------------
# CM31: trailing axis [re, im]
# ---------------------------------------------------------------------------

def cm31(re, im):
    return jnp.stack([_u(re), _u(im)], axis=-1)


def cm31_add(a, b):
    return m31_add(a, b)


def cm31_neg(a):
    return m31_neg(a)


def cm31_sub(a, b):
    return m31_sub(a, b)


def cm31_conj(a):
    return jnp.stack([a[..., 0], m31_neg(a[..., 1])], axis=-1)


def cm31_mul(a, b):
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    re = m31_sub(m31_mul(ar, br), m31_mul(ai, bi))
    im = m31_add(m31_mul(ar, bi), m31_mul(ai, br))
    return jnp.stack([re, im], axis=-1)


def cm31_mul_m31(a, s):
    return m31_mul(a, s[..., None])


def cm31_inv(a):
    ar, ai = a[..., 0], a[..., 1]
    norm = m31_add(m31_sqr(ar), m31_sqr(ai))
    ninv = m31_inv(norm)
    return cm31_mul_m31(cm31_conj(a), ninv)


def cm31_sub_m31(a, s):
    return jnp.stack([m31_sub(a[..., 0], s), a[..., 1]], axis=-1)


# ---------------------------------------------------------------------------
# QM31: trailing axis [a, b, c, d]
# ---------------------------------------------------------------------------

def qm31(a, b, c, d):
    return jnp.stack([_u(a), _u(b), _u(c), _u(d)], axis=-1)


def qm31_scalar(a, b, c, d):
    import numpy as np

    return jnp.asarray(np.array([a, b, c, d], dtype=np.uint32))


def qm31_zero(shape=()):
    import numpy as np

    return np.zeros(tuple(shape) + (4,), dtype=np.uint32)


def qm31_one(shape=()):
    import numpy as np

    return np.broadcast_to(
        np.asarray([1, 0, 0, 0], dtype=np.uint32), tuple(shape) + (4,)
    )


def qm31_re(x):
    """First CM31 coordinate (trailing axis 2)."""
    return x[..., 0:2]


def qm31_im(x):
    """Second CM31 coordinate (trailing axis 2)."""
    return x[..., 2:4]


def qm31_from_cm31(re, im=None):
    if im is None:
        im = jnp.zeros_like(re)
    return jnp.concatenate([re, im], axis=-1)


def qm31_from_m31(x):
    x = _u(x)
    z = jnp.zeros_like(x)
    return jnp.stack([x, z, z, z], axis=-1)


def qm31_add(a, b):
    return m31_add(a, b)


def qm31_neg(a):
    return m31_neg(a)


def qm31_sub(a, b):
    return m31_sub(a, b)


def qm31_conj(a):
    return qm31_from_cm31(qm31_re(a), cm31_neg(qm31_im(a)))


_R_CONST = None  # (2 + i) as a module-level lazy constant


def _two_plus_i(shape):
    import numpy as np

    return np.broadcast_to(np.asarray([2, 1], dtype=np.uint32), tuple(shape) + (2,))


def qm31_mul(x, y):
    """(ar + ai*j)(br + bi*j) = (ar*br + (2+i)*ai*bi) + (ar*bi + ai*br) j."""
    ar, ai = qm31_re(x), qm31_im(x)
    br, bi = qm31_re(y), qm31_im(y)
    aibi = cm31_mul(ai, bi)
    re = cm31_add(cm31_mul(ar, br), cm31_mul(aibi, _two_plus_i(aibi.shape[:-1])))
    im = cm31_add(cm31_mul(ar, bi), cm31_mul(ai, br))
    return qm31_from_cm31(re, im)


def qm31_sqr(a):
    return qm31_mul(a, a)


def qm31_mul_m31(a, s):
    return m31_mul(a, s[..., None])


def qm31_mul_cm31(a, c):
    return qm31_from_cm31(cm31_mul(qm31_re(a), c), cm31_mul(qm31_im(a), c))


def qm31_inv(a):
    """Inverse via the CM31-norm trick (reference qm31.simf:87-97).

    denom = ar^2 - (2+i) * ai^2 ; inv = (ar - ai j) / denom.
    The reference computes (2+i)*ai_sq as ai_sq_dbl + i*ai_sq where
    i*(r, s) = (-s, r).
    """
    ar, ai = qm31_re(a), qm31_im(a)
    ar_sq = cm31_mul(ar, ar)
    ai_sq = cm31_mul(ai, ai)
    ai_sq_dbl = cm31_add(ai_sq, ai_sq)
    ai_sq_rev = jnp.stack([m31_neg(ai_sq[..., 1]), ai_sq[..., 0]], axis=-1)
    den = cm31_sub(ar_sq, cm31_add(ai_sq_dbl, ai_sq_rev))
    den_inv = cm31_inv(den)
    return qm31_from_cm31(cm31_mul(ar, den_inv), cm31_mul(cm31_neg(ai), den_inv))


def qm31_div(a, b):
    return qm31_mul(a, qm31_inv(b))


def qm31_eq(a, b):
    """Elementwise QM31 equality -> bool with trailing axis reduced."""
    return jnp.all(a == b, axis=-1)
