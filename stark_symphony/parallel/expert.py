"""Expert parallelism: heterogeneous-AIR routing (SURVEY.md §2.4 EP row).

The reference compiles exactly one constraint set per program (the
`#include` at /root/reference/stwo-verifier/src/deep/oods.simf:17); a
production verification service receives proofs for MANY constraint
systems in one stream.  Here every proof carries an `air_id` and the
batched verifier routes its composition-polynomial check to the matching
AIR from `constraints.REGISTRY`.

Routing strategy (dense dispatch): with a handful of AIRs the constraint
evaluation at the single OODS point is a few QM31 ops — orders of
magnitude cheaper than the proof's SHA-256 Merkle work — so each lane
evaluates every AIR and selects by `air_id`.  This keeps the batch a
single SPMD program (no gather/scatter regrouping, no load imbalance),
which beats sparse dispatch until the per-AIR cost dominates
hashing.  Capacity-style token dropping is unnecessary: lanes are
independent proofs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..models.stwo import verifier
from ..models.stwo.config import StwoConfig
from ..models.stwo.constraints import AIR_IDS
from .batch import shard_batch


def verify_batch_routed(proof_batch, air_ids, cfg: StwoConfig,
                        airs=AIR_IDS, linkage: str = "reference"):
    """Accept bitmap for a mixed-AIR proof batch.

    Args:
      proof_batch: stacked proof pytree, leading axis B.
      air_ids: (B,) int32 index into `airs` per proof.
      airs: static tuple of AIR names (indexes constraints.REGISTRY).
    """
    air_ids = jnp.asarray(air_ids, jnp.int32)
    return jax.vmap(
        lambda p, aid: verifier.verify(p, cfg, tuple(airs), linkage, aid)[0]
    )(proof_batch, air_ids)


def verify_batch_routed_sharded(proof_batch, air_ids, cfg: StwoConfig,
                                mesh: Mesh, airs=AIR_IDS,
                                linkage: str = "reference"):
    """DP-sharded routed verification: proofs and their air_ids sharded
    over the 'dp' mesh axis; returns (bitmap, n_accepted)."""
    air_ids = jnp.asarray(air_ids, jnp.int32)
    proof_batch = shard_batch(proof_batch, mesh)
    air_ids = shard_batch(air_ids, mesh)

    @jax.jit
    def run(b, ids):
        bitmap = jax.vmap(
            lambda p, aid: verifier.verify(p, cfg, tuple(airs), linkage, aid)[0]
        )(b, ids)
        return bitmap, jnp.sum(bitmap.astype(jnp.int32))

    return run(proof_batch, air_ids)
