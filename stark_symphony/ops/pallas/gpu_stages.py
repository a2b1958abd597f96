"""Pallas kernels (Triton route) for the stwo verifier's per-query stages.

The tiled verify path (models/stwo/verifier.verify_batch_tiled) spends
almost all of its SHA-256 compressions in two stages, which run here as
one kernel each:

* ``leafwalk`` (``stwo_stage5_leafwalk``) — stage V (evals/verify.simf:
  47-64): hash the queried column evals into the leaf digest, walk the
  authentication path, compare with the commitment root.
* ``fri_layers`` (``stwo_stage7_fri``) — stage VII (fri/layers.simf:29-69 +
  fri/folding.simf:15-41 for every layer): hash the (eval, witness) pair
  into adjacent leaves, walk the layer's Merkle path at its true depth,
  QM31-fold with the layer alpha and halve the query, carrying
  (query, eval) through all layers in registers.

Design for the GPU: the tiled arrays ``(W, M, 128)`` are word-major with
contiguous lanes, read here as ``(W, lanes)``.  Each program owns
``LANE_BLOCK`` consecutive lanes, one lane per thread, so every word load is
coalesced; the 8 state words, the 16-word schedule window and the fold
values stay in registers for the whole chain, and only sibling digests
stream in.  The work is 32-bit integer ALU work (no shared memory, no
tensor cores).  Rounds, Merkle levels and FRI layers are loops
(ops/sha256_lanes.py), with per-layer depths and sibling offsets read from
the kernel's constant table.

M31/QM31 products use 16-bit limbs, bit-exact with ops/field.py.

Dispatch: on ``gpu`` the kernel is compiled by Triton; on ``cpu`` the same
``pallas_call`` runs in the Pallas interpreter (the tests); any other
platform raises.  ``leafwalk_reference`` / ``fri_reference`` are the plain
XLA forms of the two stages, built on ops.sha256 / ops.merkle /
ops.field: they are the reference the tests and chip_smoke.py compare the
kernels with.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import sha256_lanes as S

# Lanes per program: one lane per thread.  Lane counts handed to the
# kernels are padded to a multiple of this (models/stwo/tiled.py).
LANE_BLOCK = 128
NUM_WARPS = 4

_P = np.uint32(0x7FFFFFFF)
_LOW16 = np.uint32(0xFFFF)
_ONE = np.uint32(1)


def interpret_mode() -> bool:
    """False on a GPU (compiled by Triton), True on the CPU (the Pallas
    interpreter); any other platform has no kernel and raises."""
    platform = jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise NotImplementedError(
        f"no stwo stage kernel for platform {platform!r} (gpu or cpu)")


def _call(kernel, name, out_shape, in_specs, out_specs, lanes):
    assert lanes % LANE_BLOCK == 0, (lanes, LANE_BLOCK)
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(lanes // LANE_BLOCK,),
        in_specs=in_specs,
        out_specs=out_specs,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret_mode(),
        name=name,
    )


def _rows(n):
    """BlockSpec of an (n, lanes) array: all rows, this program's lanes."""
    return pl.BlockSpec((n, LANE_BLOCK), lambda i: (0, i))


def _whole(n):
    return pl.BlockSpec((n,), lambda i: (0,))


def _flat(x):
    """(..., M, 128) -> (prod(...), lanes): a free reshape."""
    return x.reshape(-1, x.shape[-2] * x.shape[-1])


# ---------------------------------------------------------------------------
# M31 / QM31 on lane vectors (bit-exact with ops/field.py)
# ---------------------------------------------------------------------------

def _m31_red(x):
    x = (x & _P) + (x >> np.uint32(31))
    return jnp.where(x >= _P, x - _P, x)


def _m31_add(a, b):
    return _m31_red(a + b)


def _m31_neg(a):
    return jnp.where(a == 0, a, _P - a)


def _m31_sub(a, b):
    return _m31_add(a, _m31_neg(b))


def _m31_mul(a, b):
    a0 = a & _LOW16
    a1 = a >> np.uint32(16)
    b0 = b & _LOW16
    b1 = b >> np.uint32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + p10
    carry_mid = (mid < p01).astype(jnp.uint32)
    lo = p00 + (mid << np.uint32(16))
    carry_lo = (lo < p00).astype(jnp.uint32)
    hi = p11 + (mid >> np.uint32(16)) + (carry_mid << np.uint32(16)) + carry_lo
    low31 = lo & _P
    high = (hi << _ONE) | (lo >> np.uint32(31))
    return _m31_red(low31 + high)


def _cm31_mul(ar, ai, br, bi):
    return (
        _m31_sub(_m31_mul(ar, br), _m31_mul(ai, bi)),
        _m31_add(_m31_mul(ar, bi), _m31_mul(ai, br)),
    )


def _qm31_mul(a, b):
    """(ar + ai j)(br + bi j); j^2 = 2 + i (qm31.simf:73-79)."""
    ar_r, ar_i, ai_r, ai_i = a
    br_r, br_i, bi_r, bi_i = b
    rr, ri = _cm31_mul(ar_r, ar_i, br_r, br_i)
    pr, pi = _cm31_mul(ai_r, ai_i, bi_r, bi_i)
    # (2 + i) * (pr + pi i) = (2 pr - pi) + (pr + 2 pi) i
    tr = _m31_sub(_m31_add(pr, pr), pi)
    ti = _m31_add(pr, _m31_add(pi, pi))
    ir, ii = _cm31_mul(ar_r, ar_i, bi_r, bi_i)
    jr, ji = _cm31_mul(ai_r, ai_i, br_r, br_i)
    return (_m31_add(rr, tr), _m31_add(ri, ti),
            _m31_add(ir, jr), _m31_add(ii, ji))


def _fold(e0, e1, cinv, alpha):
    """fri/folding.simf:15-41: (e0 + e1) + alpha * (e0 - e1) / coord."""
    f0 = tuple(_m31_add(x, y) for x, y in zip(e0, e1))
    f1 = tuple(_m31_mul(_m31_sub(x, y), cinv) for x, y in zip(e0, e1))
    return tuple(_m31_add(x, y) for x, y in zip(f0, _qm31_mul(alpha, f1)))


def _all_equal(cur, ref, base):
    ok = None
    for i in range(8):
        eq = cur[i] == ref[base + i]
        ok = eq if ok is None else (ok & eq)
    return ok.astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Stage V: leaf hash + path walk + root compare
# ---------------------------------------------------------------------------

def _leafwalk_kernel(n_words, depth, tab_ref, ev_ref, idx_ref, sib_ref,
                     root_ref, ok_ref):
    leaf = S.sha_words(tuple(ev_ref[i] for i in range(n_words)), tab_ref)
    cur = S.walk(leaf, idx_ref[0], depth,
                 lambda lvl: tuple(sib_ref[lvl * 8 + i] for i in range(8)),
                 tab_ref)
    ok_ref[0] = _all_equal(cur, root_ref, 0)


@functools.partial(jax.jit, static_argnums=(4, 5))
def leafwalk(evals, idx, sibs, root, n_words: int, depth: int):
    """evals (n_words, M, 128), idx (1, M, 128), sibs (depth, 8, M, 128),
    root (8, M, 128) -> ok (1, M, 128) u32 in {0, 1}."""
    m = evals.shape[-2]
    lanes = m * 128
    tab = jnp.asarray(S.tables())
    ok = _call(
        functools.partial(_leafwalk_kernel, n_words, depth),
        "stwo_stage5_leafwalk",
        jax.ShapeDtypeStruct((1, lanes), jnp.uint32),
        [_whole(tab.shape[0]), _rows(n_words), _rows(1), _rows(depth * 8),
         _rows(8)],
        _rows(1), lanes,
    )(tab, _flat(evals), _flat(idx.astype(jnp.uint32)), _flat(sibs),
      _flat(root))
    return ok.reshape(1, m, 128)


def leafwalk_reference(evals, idx, sibs, root, n_words: int, depth: int):
    """Plain XLA form of `leafwalk` (ops.sha256 + ops.merkle)."""
    from .. import merkle
    from ..sha256 import sha256_words

    leaf = sha256_words(jnp.stack([evals[i] for i in range(n_words)], -1))
    sibs_wt = jnp.moveaxis(sibs, (0, 1), (-2, -1))  # (M, 128, depth, 8)
    root_wt = jnp.moveaxis(root, 0, -1)
    ok = merkle.verify_path(leaf, idx[0].astype(jnp.uint32), sibs_wt,
                            root_wt)
    return ok.astype(jnp.uint32)[None]


# ---------------------------------------------------------------------------
# Stage VII: all FRI layers (hash pair, walk, fold, halve)
# ---------------------------------------------------------------------------

def _fri_kernel(n_layers, meta, tab_ref, q_ref, ev_ref, wit_ref, cinv_ref,
                alpha_ref, sib_ref, root_ref, ok_ref, out_ref, qout_ref):
    def layer(l, carry):
        q, e = carry
        odd = (q & _ONE) != 0
        w = tuple(wit_ref[l * 4 + i] for i in range(4))
        e0 = tuple(jnp.where(odd, wi, ei) for wi, ei in zip(w, e))
        e1 = tuple(jnp.where(odd, ei, wi) for wi, ei in zip(w, e))
        cur = S.node(S.sha_words(e0, tab_ref), S.sha_words(e1, tab_ref),
                     tab_ref)
        depth = tab_ref[meta + l].astype(jnp.int32)
        off = tab_ref[meta + n_layers + l].astype(jnp.int32)
        cur = S.walk(
            cur, q >> _ONE, depth,
            lambda lvl: tuple(sib_ref[(off + lvl) * 8 + i] for i in range(8)),
            tab_ref)
        ok_ref[l] = _all_equal(cur, root_ref, l * 8)
        alpha = tuple(alpha_ref[l * 4 + i] for i in range(4))
        return q >> _ONE, _fold(e0, e1, cinv_ref[l], alpha)

    q, e = jax.lax.fori_loop(
        0, n_layers, layer, (q_ref[0], tuple(ev_ref[i] for i in range(4))))
    for i in range(4):
        out_ref[i] = e[i]
    qout_ref[0] = q


@functools.partial(jax.jit, static_argnums=(7,))
def fri_layers(queries, evals, wits, cinvs, alphas, sibs, roots, depths):
    """All FRI layers in one kernel.

    queries (1, M, 128); evals (4, M, 128) — the stage-VI answers;
    wits (L, 4, M, 128); cinvs (L, M, 128) — precomputed 1/fold-coordinate;
    alphas (L, 4, M, 128); sibs (sum(depths), 8, M, 128) — all layers'
    sibling digests concatenated, leaf level first within each layer;
    roots (L, 8, M, 128); depths: static tuple of per-layer path depths.

    Returns (ok (L, M, 128) u32, folded (4, M, 128), q_out (1, M, 128)).
    """
    n_layers = len(depths)
    m = queries.shape[-2]
    lanes = m * 128
    offsets = np.concatenate([[0], np.cumsum(depths)[:-1]])
    meta = S.KW64_OFF + 64
    tab = jnp.asarray(S.tables(np.concatenate([depths, offsets])))
    u32 = jnp.uint32
    ok, folded, q_out = _call(
        functools.partial(_fri_kernel, n_layers, meta),
        "stwo_stage7_fri",
        (jax.ShapeDtypeStruct((n_layers, lanes), u32),
         jax.ShapeDtypeStruct((4, lanes), u32),
         jax.ShapeDtypeStruct((1, lanes), u32)),
        [_whole(tab.shape[0]), _rows(1), _rows(4), _rows(n_layers * 4),
         _rows(n_layers), _rows(n_layers * 4), _rows(sum(depths) * 8),
         _rows(n_layers * 8)],
        (_rows(n_layers), _rows(4), _rows(1)), lanes,
    )(tab, _flat(queries.astype(u32)), _flat(evals), _flat(wits),
      _flat(cinvs), _flat(alphas), _flat(sibs), _flat(roots))
    return (ok.reshape(n_layers, m, 128), folded.reshape(4, m, 128),
            q_out.reshape(1, m, 128))


def fri_reference(queries, evals, wits, cinvs, alphas, sibs, roots, depths):
    """Plain XLA form of `fri_layers` (ops.sha256, ops.merkle, ops.field)."""
    from .. import field as F
    from .. import merkle
    from ..sha256 import sha256_pair, sha256_words

    last = lambda x: jnp.moveaxis(x, 0, -1)  # word axis -> trailing
    q = queries[0].astype(jnp.uint32)
    e = last(evals)
    oks, off = [], 0
    for l, d in enumerate(depths):
        odd = ((q & _ONE) != 0)[..., None]
        w = last(wits[l])
        e0 = jnp.where(odd, w, e)
        e1 = jnp.where(odd, e, w)
        node = sha256_pair(sha256_words(e0), sha256_words(e1))
        sibs_wt = jnp.moveaxis(sibs[off:off + d], (0, 1), (-2, -1))
        ok = merkle.verify_path(node, q >> _ONE, sibs_wt, last(roots[l]))
        oks.append(ok.astype(jnp.uint32))
        f1 = F.qm31_mul_m31(F.qm31_sub(e0, e1), cinvs[l])
        e = F.qm31_add(F.qm31_add(e0, e1), F.qm31_mul(last(alphas[l]), f1))
        q = q >> _ONE
        off += d
    return jnp.stack(oks), jnp.moveaxis(e, -1, 0), q[None]
