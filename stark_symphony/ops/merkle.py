"""Batched SHA-256 Merkle path verification and tree building.

Verification follows the reference walk
(/root/reference/stwo-verifier/src/merkle.simf:22-44): the authentication
path is packed as `leaf_index + num_leaves`; at each level the low bit says
whether the sibling is left (odd) or right (even), then the path halves.
With a static depth D the terminal `path == 1` check of the reference is
equivalent to `leaf_index < 2^D`, which we expose as a mask.

Unlike the reference (one path at a time, assert-abort), `verify_path`
processes an arbitrary batch of (leaf, index) pairs against an arbitrary
batch of roots and returns a boolean mask.

Tree building (prover side) hashes a full layer per step — each level is one
batched `sha256_pair` over contiguous lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sha256 import sha256_pair


def verify_path(leaf_digest, index, siblings, root):
    """Recompute the root from a leaf digest and sibling path; compare.

    Args:
      leaf_digest: (..., 8) uint32 — hash of the leaf.
      index:       (...,)  uint32 — leaf position in [0, 2^depth).
      siblings:    (..., depth, 8) uint32 — sibling digests, leaf level first.
      root:        (..., 8) uint32.

    Returns:
      ok: (...,) bool.
    """
    recomputed = compute_root(leaf_digest, index, siblings)
    return jnp.all(recomputed == root, axis=-1)


def compute_root(leaf_digest, index, siblings):
    """Recompute the root digest from leaf + sibling path.

    Implemented as a `lax.scan` over the depth axis so the SHA-256
    compression body appears once per call site in the traced graph
    (compile-time, not correctness, concern).
    """
    idx = jnp.asarray(index, jnp.uint32)
    leaf_digest, idx = jnp.broadcast_arrays(leaf_digest, idx[..., None])
    idx = idx[..., 0]
    sibs = jnp.moveaxis(siblings, -2, 0)  # (depth, ..., 8)
    sibs = jnp.broadcast_to(sibs, sibs.shape[:1] + leaf_digest.shape)

    def step(carry, sib):
        cur, i = carry
        bit = (i & 1).astype(bool)[..., None]
        left = jnp.where(bit, sib, cur)
        right = jnp.where(bit, cur, sib)
        return (sha256_pair(left, right), i >> 1), None

    (cur, _), _ = jax.lax.scan(step, (leaf_digest, idx), sibs)
    return cur


def verify_path_padded(leaf_digest, index, siblings, root, depths):
    """verify_path for a batch of paths of DIFFERENT depths, zero-padded to
    a common max depth.

    Args:
      leaf_digest: (..., B, 8); index: (..., B); siblings: (..., B, D, 8)
      root: (..., B, 8); depths: (B,) numpy int array of true path depths.

    One scan over D levels; levels beyond a path's depth leave its digest
    unchanged.  This collapses many differently-shaped Merkle checks into a
    single compression-function call site (compile-time win).
    """
    idx = jnp.asarray(index, jnp.uint32)
    leaf_digest, idx = jnp.broadcast_arrays(leaf_digest, idx[..., None])
    idx = idx[..., 0]
    sibs = jnp.moveaxis(siblings, -2, 0)  # (D, ..., B, 8)
    sibs = jnp.broadcast_to(sibs, sibs.shape[:1] + leaf_digest.shape)
    depths = jnp.asarray(np.asarray(depths, np.int32))
    d_iota = jnp.arange(sibs.shape[0], dtype=jnp.int32)

    def step(carry, inp):
        cur, i = carry
        sib, d = inp
        bit = (i & 1).astype(bool)[..., None]
        left = jnp.where(bit, sib, cur)
        right = jnp.where(bit, cur, sib)
        nxt = sha256_pair(left, right)
        active = (d < depths)[..., None]
        cur = jnp.where(active, nxt, cur)
        i = jnp.where(d < depths, i >> 1, i)
        return (cur, i), None

    (cur, _), _ = jax.lax.scan(step, (leaf_digest, idx), (sibs, d_iota))
    return jnp.all(cur == root, axis=-1)


def build_tree(leaf_digests):
    """Build a full Merkle tree from (..., n, 8) leaf digests (n power of 2).

    Returns the list of levels, leaves first: [(..., n, 8), (..., n/2, 8),
    ..., (..., 1, 8)].  The root is levels[-1][..., 0, :].
    """
    n = leaf_digests.shape[-2]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    levels = [leaf_digests]
    cur = leaf_digests
    while cur.shape[-2] > 1:
        left = cur[..., 0::2, :]
        right = cur[..., 1::2, :]
        cur = sha256_pair(left, right)
        levels.append(cur)
    return levels


def gather_path(levels, index):
    """Extract sibling digests for `index` from tree `levels`.

    Args:
      levels: output of build_tree; level l has shape (..., n >> l, 8).
      index:  (...,) uint32 leaf positions (batch dims must broadcast with
              the levels' batch dims).

    Returns:
      siblings: (..., depth, 8), leaf level first.
    """
    idx = jnp.asarray(index, jnp.uint32)
    out = []
    for lvl in levels[:-1]:
        sib_idx = (idx ^ 1).astype(jnp.int32)
        out.append(jnp.take_along_axis(lvl, sib_idx[..., None, None], axis=-2)[..., 0, :])
        idx = idx >> 1
    return jnp.stack(out, axis=-2)
