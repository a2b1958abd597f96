"""Circle FFT over M31 (evaluation/interpolation on canonic circle domains).

The capability behind the stwo prover and the "Circle FFT at log-sizes
10-20" benchmark config (BASELINE.json).  Not present in the reference
(the reference ships no stwo prover); designed for batched lanes:

* Natural-position radix-2 structure: for a canonic circle domain of size
  N enumerated by the reference's position convention
  (groups/circle_domain.simf:27-37), positions i and i + N/2 are the point
  pair (p, -p), and the squaring/projection maps send position i of a
  domain to position i of the half-size domain.  Every butterfly is then a
  contiguous (first-half, second-half) split — perfectly vectorizable,
  no gathers, no bit-reversal permutes inside the transform.
* All twiddles (y-coordinates at the circle level, x-coordinates at the
  line levels, and their inverses) are host-precomputed per log_size and
  staged as constants.

Coefficient layout (index bits MSB first): [y_bit | x_bit | pi bits...]:
  b_index(x, y) = y^{y_bit} * x^{x_bit} * pi(x)^{b2} * pi^2(x)^{b3} * ...
with pi(x) = 2x^2 - 1.  The stwo composition decomposition
F = F_a + y F_b + x F_c + x y F_d (evals/composition_poly.simf:47-59) is
then a contiguous quarter split of the coefficient vector:
  quarter 0 -> F_a, quarter 1 -> F_c (x), quarter 2 -> F_b (y),
  quarter 3 -> F_d (xy).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from . import field as F
from .circle import CircleDomain, LineDomain, GEN_POW2

P = F.P
INV2 = (P + 1) // 2  # 1/2 mod P


def _host_point_at(index: int):
    res = (1, 0)
    for k in range(31):
        if (index >> k) & 1:
            g = (int(GEN_POW2[k][0]), int(GEN_POW2[k][1]))
            res = (
                (res[0] * g[0] - res[1] * g[1]) % P,
                (res[0] * g[1] + res[1] * g[0]) % P,
            )
    return res


@functools.lru_cache(maxsize=None)
def twiddles(log_size: int):
    """Twiddle tables per butterfly level, outermost first.

    levels[0]: y(position i) of the size-2^log circle domain, i < N/2.
    levels[k>=1]: x(position i) of the size-2^(log-k) line domain,
                  i < 2^(log-k-1).
    Returns (levels, levels_inv) as numpy uint32 arrays.
    """
    n = 1 << log_size
    levels = []
    d = CircleDomain(log_size)
    ys = [
        _host_point_at((d.offset + d.step * i) & ((1 << 31) - 1))[1]
        for i in range(n // 2)
    ]
    levels.append(np.array(ys, dtype=np.uint32))
    log = log_size - 1
    while log >= 1:
        ld = LineDomain(log)
        xs = [
            _host_point_at((ld.offset + ld.step * i) & ((1 << 31) - 1))[0]
            for i in range(1 << (log - 1))
        ]
        levels.append(np.array(xs, dtype=np.uint32))
        log -= 1
    levels_inv = tuple(
        np.array([pow(int(t), P - 2, P) for t in lvl], dtype=np.uint32)
        for lvl in levels
    )
    return tuple(levels), levels_inv


def _mul_tw(v, tw, qm31: bool):
    tw = jnp.asarray(tw)
    if qm31:
        return F.m31_mul(v, tw[..., None])
    return F.m31_mul(v, tw)


def cfft_eval(coeffs, log_size: int, qm31: bool = False):
    """Coefficients -> evaluations at natural circle-domain positions.

    coeffs: (..., N) M31, or (..., N, 4) QM31 with qm31=True.
    """
    lvls, _ = twiddles(log_size)
    n = 1 << log_size
    v = coeffs
    tail = (4,) if qm31 else ()
    lead = v.shape[: v.ndim - 1 - len(tail)]
    for k in reversed(range(log_size)):
        block = n >> k
        half = block >> 1
        vb = v.reshape(lead + (n // block, block) + tail)
        e = vb[..., :half, :] if qm31 else vb[..., :half]
        o = vb[..., half:, :] if qm31 else vb[..., half:]
        to = _mul_tw(o, lvls[k], qm31)
        axis = -2 if qm31 else -1
        v = jnp.concatenate(
            [F.m31_add(e, to), F.m31_sub(e, to)], axis=axis
        ).reshape(lead + (n,) + tail)
    return v


def cfft_interpolate(values, log_size: int, qm31: bool = False):
    """Evaluations at natural positions -> coefficients (inverse of
    cfft_eval)."""
    _, lvls_inv = twiddles(log_size)
    n = 1 << log_size
    v = values
    tail = (4,) if qm31 else ()
    lead = v.shape[: v.ndim - 1 - len(tail)]
    inv2 = jnp.uint32(INV2)
    for k in range(log_size):
        block = n >> k
        half = block >> 1
        vb = v.reshape(lead + (n // block, block) + tail)
        a = vb[..., :half, :] if qm31 else vb[..., :half]
        b = vb[..., half:, :] if qm31 else vb[..., half:]
        g = F.m31_mul(F.m31_add(a, b), inv2)
        h = _mul_tw(F.m31_mul(F.m31_sub(a, b), inv2), lvls_inv[k], qm31)
        axis = -2 if qm31 else -1
        v = jnp.concatenate([g, h], axis=axis).reshape(lead + (n,) + tail)
    return v


def extend(values, log_size: int, log_size_out: int, qm31: bool = False):
    """Low-degree extension: evaluations on the size-2^log domain ->
    evaluations on the size-2^log_out domain (zero-padded coefficients).

    Note the coefficient embedding: a size-N basis element with bit layout
    [y|x|pi...] maps into the size-M basis by keeping the (y, x) top bits
    and zero-extending the pi-tower bits (pi_k of the small domain is
    pi_{k + log_out - log} of the large domain... the tower is the SAME map
    pi, so small-basis pi^j factors are identical in the big basis; the
    embedding keeps coefficient index bits [y | x | rest] and inserts zeros
    for the new LOW pi bits).
    """
    coeffs = cfft_interpolate(values, log_size, qm31)
    return cfft_eval(
        embed_coeffs(coeffs, log_size, log_size_out, qm31), log_size_out, qm31
    )


def embed_coeffs(coeffs, log_size: int, log_size_out: int, qm31: bool = False):
    """Embed a size-2^log coefficient vector into the size-2^log_out basis.

    Bit layout is [y | x | pi^1 .. pi^(log-2)] with pi^j at bit (log-1-j-1);
    in the big basis the same pi^j sits at bit (log_out-2-j), so each
    quarter-local index R maps to R << (log_out - log) — a strided
    embedding with zeros in the new low bits.
    """
    n = 1 << log_size
    m = 1 << log_size_out
    stride = m // n
    tail = (4,) if qm31 else ()
    lead = coeffs.shape[: coeffs.ndim - 1 - len(tail)]
    cb = coeffs.reshape(lead + (n, 1) + tail)
    pad = jnp.zeros(lead + (n, stride - 1) + tail, jnp.uint32)
    out = jnp.concatenate([cb, pad], axis=-1 - len(tail))
    return out.reshape(lead + (m,) + tail)


def eval_at_point(coeffs, log_size: int, point, qm31_coeffs: bool = False):
    """Evaluate at a single QM31 point: log N folds with scalar twiddles.

    coeffs: (..., N) M31 (or (..., N, 4) QM31); point: (..., 2, 4) QM31
    circle point.  Returns (..., 4) QM31.
    """
    x = point[..., 0, :]
    y = point[..., 1, :]
    # twiddle chain: y, x, pi(x), pi^2(x), ...
    tws = [y, x]
    cur = x
    for _ in range(log_size - 2):
        sq = F.qm31_sqr(cur)
        cur = F.qm31_sub(F.qm31_add(sq, sq), F.qm31_one(sq.shape[:-1]))
        tws.append(cur)
    if qm31_coeffs:
        v = coeffs
    else:
        z = jnp.zeros(coeffs.shape + (3,), jnp.uint32)
        v = jnp.concatenate([coeffs[..., None], z], axis=-1)
    for k in range(log_size):
        half = v.shape[-2] // 2
        lo = v[..., :half, :]
        hi = v[..., half:, :]
        tw = tws[k][..., None, :]
        v = F.qm31_add(lo, F.qm31_mul(jnp.broadcast_to(tw, hi.shape), hi))
    return v[..., 0, :]
