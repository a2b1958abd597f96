"""Fold-stage parallelism: FRI layers sharded across devices by position.

The reference folds FRI layers serially inside one program
(/root/reference/stark101/src/fri.simf:74-91 pairs position i with
i + N/2; /root/reference/stwo-verifier/src/fri/folding.simf:15-41 pairs
p with -p).  This module is the SP/CP analogue mandated by SURVEY.md
§2.4: one FRI layer's full evaluation array is sharded over a mesh axis,
and every fold stage performs the sibling exchange between devices with
`lax.ppermute` inside `shard_map` — the "FRI fold stages exchanged
all-to-all" design of BASELINE.md.

Layout and exchange pattern (D devices, chunk C = N/D, natural order):

* fold pairs (i, i + N/2): the sibling of every element in device d's
  chunk lives in device (d + D/2)'s chunk -> ONE ppermute (rotation by
  D/2) delivers all siblings; devices d < D/2 hold the folded output.
* rebalance: the folded array (N/2 values on D/2 devices) is split back
  over all D devices — device d < D/2 sends its lower/upper half-chunk
  to devices 2d / 2d+1 (two ppermutes).  Chunk size halves with the
  domain, so every stage is load-balanced and the exchange volume drops
  2x per stage (total traffic <= 3/2 N elements regardless of depth).

This is the building block for proving/verifying AIRs whose LDE domain
exceeds one chip's HBM; the batched per-proof verifiers (models/*) keep
using the in-lane fold because their layers are tiny.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pspec

from ..ops import field101 as F101


def _rebalance(chunks, axis_name: str, n_dev: int):
    """Redistribute the folded halves (valid on devices d < n_dev/2) so
    every device holds an equally sized contiguous chunk again."""
    half = chunks.shape[0] // 2
    lo, hi = chunks[:half], chunks[half:]
    perm_lo = [(d, 2 * d) for d in range(n_dev // 2)]
    perm_hi = [(d, 2 * d + 1) for d in range(n_dev // 2)]
    recv_lo = jax.lax.ppermute(lo, axis_name, perm_lo)
    recv_hi = jax.lax.ppermute(hi, axis_name, perm_hi)
    is_even = (jax.lax.axis_index(axis_name) % 2) == 0
    return jnp.where(is_even, recv_lo, recv_hi)


def sharded_fold(values, coords, betas, mesh: Mesh, *, fold_fn, coord_step,
                 n_stages: int, axis_name: str = "sp"):
    """Run `n_stages` FRI fold stages with the evaluation domain sharded
    over `mesh` axis `axis_name`.

    Args:
      values: (N, ...) layer evaluations in natural position order.
      coords: (N, ...) per-position fold coordinate payload (e.g. 1/x for
        stark101 line folds, (x, y) point pairs for stwo); folds alongside
        values via `coord_step`.
      betas: sequence of n_stages fold randomness values (replicated).
      fold_fn: (a, b, coord, beta) -> folded value, where a = v[i],
        b = v[i + N/2], coord = coords[i].  May be a list of n_stages
        per-stage functions (stwo: circle fold first, line folds after).
      coord_step: coords -> next-layer coords at the SAME positions
        (e.g. squaring: x_{l+1}(i) = x_l(i)^2).  May be a list like
        fold_fn.
      n_stages: static number of folds; requires
        N / n_devices / 2**n_stages >= 1.

    Returns:
      (values', coords') of size N / 2**n_stages, sharded the same way.
    """
    n_dev = mesh.shape[axis_name]
    n = values.shape[0]
    assert n % n_dev == 0 and n_dev % 2 == 0
    assert (n // n_dev) % (1 << n_stages) == 0, (
        f"chunk {n // n_dev} not divisible by 2**{n_stages}; "
        f"fewer stages or fewer devices"
    )
    fold_fns = (list(fold_fn) if isinstance(fold_fn, (list, tuple))
                else [fold_fn] * n_stages)
    coord_steps = (list(coord_step) if isinstance(coord_step, (list, tuple))
                   else [coord_step] * n_stages)

    sibling_perm = [((d + n_dev // 2) % n_dev, d) for d in range(n_dev)]

    def body(v, x):
        for s in range(n_stages):
            v_sib = jax.lax.ppermute(v, axis_name, sibling_perm)
            folded = fold_fns[s](v, v_sib, x, betas[s])
            x_next = coord_steps[s](x)
            v = _rebalance(folded, axis_name, n_dev)
            x = _rebalance(x_next, axis_name, n_dev)
        return v, x

    spec_v = Pspec(axis_name, *([None] * (values.ndim - 1)))
    spec_x = Pspec(axis_name, *([None] * (coords.ndim - 1)))
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(spec_v, spec_x),
        out_specs=(spec_v, spec_x),
    )
    values = jax.device_put(values, NamedSharding(mesh, spec_v))
    coords = jax.device_put(coords, NamedSharding(mesh, spec_x))
    return jax.jit(fn)(values, coords)


# ---------------------------------------------------------------------- #
# stark101 instantiation: out[i] = (a+b)/2 + beta*(a-b)/(2*x_i), x <- x^2 #
# (/root/reference/stark101/src/fri.simf:58-62)                           #
# ---------------------------------------------------------------------- #

_INV2 = pow(2, F101.Q - 2, F101.Q)


def _stark101_fold(a, b, x_inv, beta):
    inv2 = jnp.uint32(_INV2)
    op0 = F101.f_mul(F101.f_add(a, b), inv2)
    op1 = F101.f_mul(F101.f_mul(F101.f_sub(a, b), inv2), x_inv)
    return F101.f_add(op0, F101.f_mul(op1, beta))


def stark101_fold_reference(values, x_invs, betas, n_stages: int):
    """Single-device oracle for the sharded fold (used by tests)."""
    v, x = values, x_invs
    for s in range(n_stages):
        half = v.shape[0] // 2
        v = _stark101_fold(v[:half], v[half:], x[:half], betas[s])
        x = F101.f_mul(x, x)[:half]
    return v, x


def stark101_fold_sharded(values, x_invs, betas, mesh: Mesh,
                          n_stages: int, axis_name: str = "sp"):
    """stark101 FRI fold with the LDE domain sharded over `axis_name`."""
    return sharded_fold(
        values, x_invs, betas, mesh,
        fold_fn=_stark101_fold,
        coord_step=lambda x: F101.f_mul(x, x),
        n_stages=n_stages, axis_name=axis_name,
    )


# ---------------------------------------------------------------------- #
# stwo instantiation: circle fold then line folds over M31 circle/line    #
# domains (/root/reference/stwo-verifier/src/fri/folding.simf:15-41).     #
# Natural position order pairs (i, i + N/2) = (p, -p) on the circle and   #
# (x, -x)... on the line — the same single-ppermute exchange.             #
# Coordinate payload: the (x, y) M31 point per position; the circle fold  #
# divides by y, line folds divide by x with x <- pi(x) = 2x^2 - 1 (the    #
# line domains' doubling map — LineDomain(log-1) of position i IS the     #
# x-projection of the circle point at position i).                        #
# ---------------------------------------------------------------------- #


def _stwo_alpha(alpha, like):
    return jnp.broadcast_to(alpha, like.shape)


def _stwo_circle_fold(a, b, pt, alpha):
    from ..ops import field as F

    f0 = F.qm31_add(a, b)
    f1 = F.qm31_mul_m31(F.qm31_sub(a, b), F.m31_inv(pt[..., 1]))
    return F.qm31_add(f0, F.qm31_mul(_stwo_alpha(alpha, f1), f1))


def _stwo_line_fold(a, b, pt, alpha):
    from ..ops import field as F

    f0 = F.qm31_add(a, b)
    f1 = F.qm31_mul_m31(F.qm31_sub(a, b), F.m31_inv(pt[..., 0]))
    return F.qm31_add(f0, F.qm31_mul(_stwo_alpha(alpha, f1), f1))


def _stwo_pi_step(pt):
    from ..ops import field as F

    x = pt[..., 0]
    x2 = F.m31_sqr(x)
    pi_x = F.m31_sub(F.m31_add(x2, x2), jnp.ones_like(x))
    return jnp.stack([pi_x, pt[..., 1]], axis=-1)


def stwo_domain_points(lde_log: int):
    """(N, 2) M31 points of the canonic circle domain, natural position
    order (host constants; same table as models/stwo/prover.py)."""
    from ..models.stwo.prover import _domain_points_host

    return _domain_points_host(lde_log)


def stwo_fold_reference(values, points, alphas, n_stages: int):
    """Single-device oracle for the sharded stwo fold (used by tests);
    bit-identical to the prover's in-lane fold loop (prover.py step 7)."""
    from ..ops import field as F

    v = values
    pts = jnp.asarray(points)
    for s in range(n_stages):
        half = v.shape[0] // 2
        a, b = v[:half], v[half:]
        coord = pts[:half, 1] if s == 0 else pts[:half, 0]
        f0 = F.qm31_add(a, b)
        f1 = F.qm31_mul_m31(F.qm31_sub(a, b), F.m31_inv(coord))
        v = F.qm31_add(f0, F.qm31_mul(_stwo_alpha(alphas[s], f1), f1))
        pts = pts[:half] if s == 0 else _stwo_pi_step(pts[:half])
    return v


def stwo_fold_sharded(values, alphas, lde_log: int, mesh: Mesh,
                      n_stages: int, axis_name: str = "sp"):
    """stwo FRI folds (circle + line) with the LDE domain sharded over
    `axis_name`: per stage one `ppermute` sibling exchange + rebalance.

    values: (N, 4) QM31 first-layer evaluations, natural position order.
    alphas: n_stages fold randomness values (4,) (replicated).
    """
    assert values.shape[0] == 1 << lde_log
    points = jnp.asarray(np.array(stwo_domain_points(lde_log)))
    fold_fns = [_stwo_circle_fold] + [_stwo_line_fold] * (n_stages - 1)
    coord_steps = [lambda p: p] + [_stwo_pi_step] * (n_stages - 1)
    v, _ = sharded_fold(
        values, points, alphas, mesh,
        fold_fn=fold_fns, coord_step=coord_steps,
        n_stages=n_stages, axis_name=axis_name,
    )
    return v


# ---------------------------------------------------------------------- #
# Sharded FRI layer commitment (Merkle root of bit-reversed leaves).      #
# Key identity: adjacent bit-reversed leaf slots (2t, 2t+1) are natural   #
# positions (i, i + N/2) — the SAME pairing as the fold.  So the whole    #
# tree builds bottom-up in natural-index space with one ppermute +        #
# rebalance per level (exchange volume halves per level), then the top    #
# log2(D) levels run replicated after an all_gather of one digest per     #
# device.  The root equals ops.merkle.build_tree over bit-reversed        #
# leaves (models/stwo/prover.py _commit_leaves).                          #
# ---------------------------------------------------------------------- #


def stwo_commit_sharded(values, mesh: Mesh, axis_name: str = "sp",
                        return_levels: bool = False):
    """Merkle root of a sharded stwo FRI/trace layer.

    values: (N, W) M31/QM31 leaf word arrays in NATURAL position order
    (leaf s of the committed tree = sha256 of values[bit_reverse(s)]).
    Returns the (8,) root digest (replicated); with ``return_levels`` also
    the list of per-level digest arrays in NATURAL index order — level l
    has shape (N/2^l, 8); tree-order node t of that level is natural index
    bit_reverse(t, log-l) (see natural_levels_to_tree).  Distributed
    levels stay sharded over `axis_name`; levels of size < n_devices are
    replicated.
    """
    from ..ops.sha256 import sha256_pair, sha256_words

    n_dev = mesh.shape[axis_name]
    n = values.shape[0]
    assert n % n_dev == 0 and n_dev % 2 == 0 and n >= 2 * n_dev

    sibling_perm = [((d + n_dev // 2) % n_dev, d) for d in range(n_dev)]
    n_dist_levels = (n // n_dev).bit_length() - 1  # size n -> size n_dev

    def body(vals):
        levels = []
        cur = sha256_words(vals)  # local leaf digests (C, 8)
        levels.append(cur)
        for _ in range(n_dist_levels):
            sib = jax.lax.ppermute(cur, axis_name, sibling_perm)
            # natural-order node: left = lower half (this device for
            # d < D/2), right = upper half (the permuted sibling)
            node = sha256_pair(cur, sib)
            cur = _rebalance(node, axis_name, n_dev)
            levels.append(cur)
        # one digest per device: finish the top levels replicated
        # (all_gather output can't be *statically* proven replicated, so
        # every device returns its copy of the root and the caller reads
        # row 0)
        top = jax.lax.all_gather(cur, axis_name, axis=0)  # (D, 1, 8)
        top = top.reshape(n_dev, 8)
        top_levels = []
        size = n_dev
        while size > 1:
            half = size // 2
            top = sha256_pair(top[:half], top[half : 2 * half])
            top_levels.append(top)
            size = half
        return top[0:1], tuple(levels), tuple(top_levels)

    spec_v = Pspec(axis_name, *([None] * (values.ndim - 1)))
    fn = shard_map(
        body, mesh=mesh, in_specs=(spec_v,),
        out_specs=(
            Pspec(axis_name),
            tuple(Pspec(axis_name) for _ in range(1 + n_dist_levels)),
            tuple(Pspec(axis_name) for _ in range(n_dev.bit_length() - 1)),
        ),
    )
    values = jax.device_put(values, NamedSharding(mesh, spec_v))
    root_rows, dist_levels, top_levels = jax.jit(fn)(values)
    root = root_rows[0]
    if not return_levels:
        return root
    # top levels came back tiled over the axis (each device contributed an
    # identical copy); keep one copy each
    n_top = len(top_levels)
    tops = [lvl.reshape(n_dev, -1, 8)[0] for lvl in top_levels]
    # dist_levels[-1] has one digest per device == tops' input level
    all_levels = list(dist_levels) + tops
    return root, all_levels


def natural_levels_to_tree(levels, log: int):
    """Convert natural-index-order level arrays (stwo_commit_sharded) to
    the bit-reversed-leaf tree order of ops.merkle.build_tree, so
    merkle.gather_path works unchanged (host-side, numpy)."""
    from ..ops.u32 import bit_reverse

    out = []
    for l, arr in enumerate(levels):
        arr = np.asarray(arr)
        m_log = log - l
        if m_log <= 0:
            out.append(arr)
            continue
        t = np.arange(1 << m_log, dtype=np.uint32)
        perm = np.asarray(bit_reverse(t, m_log)).astype(np.int64)
        out.append(arr[perm])
    # append the root level for gather_path's levels[:-1] convention
    return out
