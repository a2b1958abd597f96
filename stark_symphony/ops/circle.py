"""Circle group over M31 and circle/line domains (batched over lanes).

Covers the functionality of /root/reference/stwo-verifier/src/groups/
{m31_point,qm31_point,coset,circle_domain,line_domain}.simf, re-designed for
vector lanes:

* Point-index -> point scalar multiplication is a 31-step fixed unroll over a
  host-precomputed table of generator doublings (the reference walks bits of
  the index with double-and-add per scalar; here the doublings are constants
  so each step is one conditional point-add across the whole batch).
* Domains are tiny static named-tuples of Python ints — they parameterize
  traced code, never live on device.

Points are stored as a trailing axis of size 2: [x, y].
"""

from __future__ import annotations

import functools as _functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from . import field as F
from .u32 import bit_reverse

M31_CIRCLE_GEN = (2, 1268011823)  # m31_point.simf:13
M31_CIRCLE_LOG_ORDER = 31
ORDER_MASK = (1 << 31) - 1

P = F.P

# QM31 circle generator (qm31_point.simf:15): ((x_re, x_im), (y_re, y_im))
# with each coordinate a QM31 given as (a, b, c, d).
QM31_CIRCLE_GEN_X = (1, 0, 478637715, 513582971)
QM31_CIRCLE_GEN_Y = (992285211, 649143431, 740191619, 1186584352)


def _host_m31_mul(a, b):
    return (a * b) % P


def _host_point_add(p, q):
    x0, y0 = p
    x1, y1 = q
    return (
        (_host_m31_mul(x0, x1) - _host_m31_mul(y0, y1)) % P,
        (_host_m31_mul(x0, y1) + _host_m31_mul(y0, x1)) % P,
    )


def _host_point_dbl(p):
    return _host_point_add(p, p)


def _gen_pow2_table() -> np.ndarray:
    """G * 2^k for k in [0, 31): host-precomputed constants, shape (31, 2)."""
    pts = []
    cur = M31_CIRCLE_GEN
    for _ in range(31):
        pts.append(cur)
        cur = _host_point_dbl(cur)
    return np.array(pts, dtype=np.uint32)


GEN_POW2 = _gen_pow2_table()


def point_add(p, q):
    """Circle group law (x0x1 - y0y1, x0y1 + y0x1); p, q: (..., 2)."""
    x0, y0 = p[..., 0], p[..., 1]
    x1, y1 = q[..., 0], q[..., 1]
    x = F.m31_sub(F.m31_mul(x0, x1), F.m31_mul(y0, y1))
    y = F.m31_add(F.m31_mul(x0, y1), F.m31_mul(y0, x1))
    return jnp.stack([x, y], axis=-1)


def point_neg(p):
    return jnp.stack([p[..., 0], F.m31_neg(p[..., 1])], axis=-1)


def point_dbl(p):
    x, y = p[..., 0], p[..., 1]
    x2 = F.m31_sqr(x)
    xd = F.m31_sub(F.m31_add(x2, x2), jnp.ones_like(x))
    xy = F.m31_mul(x, y)
    yd = F.m31_add(xy, xy)
    return jnp.stack([xd, yd], axis=-1)


def point_from_index(index):
    """index (uint32 array) -> point on the M31 circle: G * index.

    31 conditional adds against the constant doubling table (the reference
    does 31 double-and-add steps per scalar, m31_point.simf:59-97).
    """
    index = jnp.asarray(index, dtype=jnp.uint32)
    shape = index.shape
    identity = np.broadcast_to(np.array([1, 0], np.uint32), shape + (2,))
    # first bit: select identity or G directly so `res` is traced from the
    # start (all-concrete jnp ops during tracing are pathologically slow)
    bit0 = ((index >> 0) & 1).astype(bool)
    g0 = np.broadcast_to(GEN_POW2[0], shape + (2,))
    res = jnp.where(bit0[..., None], g0, identity)
    for k in range(1, 31):
        gk = np.broadcast_to(GEN_POW2[k], res.shape)
        added = point_add(res, gk)
        bit = ((index >> k) & 1).astype(bool)
        res = jnp.where(bit[..., None], added, res)
    return res


def index_add(a, b):
    return (jnp.asarray(a, jnp.uint32) + jnp.asarray(b, jnp.uint32)) & jnp.uint32(ORDER_MASK)


def index_mul(a, b):
    return (jnp.asarray(a, jnp.uint32) * jnp.asarray(b, jnp.uint32)) & jnp.uint32(ORDER_MASK)


def index_neg(a):
    a = jnp.asarray(a, jnp.uint32)
    return (jnp.uint32(1 << 31) - a) & jnp.uint32(ORDER_MASK)


def subgroup_gen_index(log_size: int) -> int:
    """Generator index of the subgroup of size 2^log_size (coset.simf:28-31)."""
    return 1 << (M31_CIRCLE_LOG_ORDER - log_size)


class CircleDomain(NamedTuple):
    """Canonic coset of size 2^log_size (circle_domain.simf:14-24)."""

    log_size: int

    @property
    def half_size(self) -> int:
        return 1 << (self.log_size - 1)

    @property
    def offset(self) -> int:
        return subgroup_gen_index(self.log_size + 1)

    @property
    def step(self) -> int:
        return subgroup_gen_index(self.log_size - 1)


class LineDomain(NamedTuple):
    """x-coordinates of a half-coset (line_domain.simf:14-23)."""

    log_size: int

    @property
    def offset(self) -> int:
        return subgroup_gen_index(self.log_size + 2)

    @property
    def step(self) -> int:
        return subgroup_gen_index(self.log_size)


def circle_position_to_index(domain: CircleDomain, position):
    """Position in the canonic coset -> point index, with negation for the
    second half (circle_domain.simf:27-37)."""
    position = jnp.asarray(position, jnp.uint32)
    in_first = position < jnp.uint32(domain.half_size)
    pos2 = jnp.where(in_first, position, position - jnp.uint32(domain.half_size))
    idx = index_add(jnp.uint32(domain.offset), index_mul(jnp.uint32(domain.step), pos2))
    return jnp.where(in_first, idx, index_neg(idx))


def circle_position_to_point(domain: CircleDomain, position):
    return point_from_index(circle_position_to_index(domain, position))


@_functools.lru_cache(maxsize=None)
def query_point_table(log_size: int) -> np.ndarray:
    """Host-precomputed LDE-domain points in *query index* order.

    table[q] = point at position bit_reverse(q, log_size) of the canonic
    coset of size 2^log_size — i.e. the composition of the verifier's
    bit-reversal (coset.simf:20-25), position->index map
    (circle_domain.simf:27-37), and 31-step scalar mul
    (m31_point.simf:59-91), folded into one (2^log, 2) uint32 constant.
    Replaces the per-lane 31-step conditional-add chain (the dominant
    field-op cost of stages VI/VII at production shape: one table gather
    instead of ~124 M31 multiplies per lane).

    Size: 2^log * 8 bytes (64 KiB at the production log 13).
    """
    n = 1 << log_size
    d = CircleDomain(log_size)
    q = np.arange(n, dtype=np.uint64)
    # bit-reverse the low log_size bits
    pos = np.zeros(n, np.uint64)
    for b in range(log_size):
        pos |= ((q >> b) & 1) << (log_size - 1 - b)
    half = np.uint64(d.half_size)
    in_first = pos < half
    pos2 = np.where(in_first, pos, pos - half)
    mask31 = np.uint64((1 << 31) - 1)
    idx = (np.uint64(d.offset) + np.uint64(d.step) * pos2) & mask31
    # vectorized 31-step double-and-add against the constant G*2^k table
    x = np.ones(n, np.uint64)
    y = np.zeros(n, np.uint64)
    p64 = np.uint64(P)
    for k in range(31):
        gx, gy = np.uint64(GEN_POW2[k][0]), np.uint64(GEN_POW2[k][1])
        # products < 2^62; sums < 2^63: fits uint64
        nx = ((x * gx) % p64 + p64 - (y * gy) % p64) % p64
        ny = ((x * gy) % p64 + (y * gx) % p64) % p64
        bit = ((idx >> np.uint64(k)) & np.uint64(1)).astype(bool)
        x = np.where(bit, nx, x)
        y = np.where(bit, ny, y)
    # second domain half: negated points (y -> -y)
    y = np.where(in_first, y, np.where(y == 0, y, p64 - y))
    return np.stack([x, y], axis=-1).astype(np.uint32)


def line_position_to_x(domain: LineDomain, position):
    idx = index_add(
        jnp.uint32(domain.offset),
        index_mul(jnp.uint32(domain.step), jnp.asarray(position, jnp.uint32)),
    )
    return point_from_index(idx)[..., 0]


def bit_reverse_position(position, log_size: int):
    return bit_reverse(position, log_size)


# ---------------------------------------------------------------------------
# QM31 circle points (OODS points): trailing shape (2, 4) = (x|y, qm31 coords)
# ---------------------------------------------------------------------------

def qm31_point(x, y):
    return jnp.stack([x, y], axis=-2)


def qm31_point_x(p):
    return p[..., 0, :]


def qm31_point_y(p):
    return p[..., 1, :]


def qm31_point_add(p, q):
    x0, y0 = qm31_point_x(p), qm31_point_y(p)
    x1, y1 = qm31_point_x(q), qm31_point_y(q)
    x = F.qm31_sub(F.qm31_mul(x0, x1), F.qm31_mul(y0, y1))
    y = F.qm31_add(F.qm31_mul(x0, y1), F.qm31_mul(y0, x1))
    return qm31_point(x, y)


def vanishing_poly_eval(log_size: int, point):
    """V_{2^log_size}(x, y) = pi^(log_size-1)(x), pi(x) = 2x^2 - 1.

    (composition_poly.simf:66-71, docs/vanishing_polynomial.md)
    """
    x = qm31_point_x(point)
    one = F.qm31_one(x.shape[:-1])
    for _ in range(log_size - 1):
        x2 = F.qm31_sqr(x)
        x = F.qm31_sub(F.qm31_add(x2, x2), one)
    return x
