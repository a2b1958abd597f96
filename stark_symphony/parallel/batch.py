"""Device-mesh sharding of proof batches (the DP/TP layer).

The reference has zero parallelism (one proof per SimplicityHL program run);
this module is the scale-out of SURVEY.md §2.4:

* DP (`verify_batch_dp`): shard_map over the 'dp' mesh axis — every device
  runs the natively-batched verifier on its local proof shard, and the
  accept count is one scalar `psum` (NCCL between GPUs).
* TP (`verify_batch_tp`, `verify_batch_gspmd`): per-query work split over
  the 'tp' axis, manually inside shard_map or by GSPMD from the verifier's
  `with_sharding_constraint`s on its per-query tensors (queries, Merkle
  leaves/siblings, FRI evaluations) — the reference's 16-query x
  20-column grid, fri/answers.simf:97-130.

The cards of one host are joined all to all (NVLink), so the mesh follows
the algorithm alone: a flat ('dp', 'tp') grid over `jax.devices()`.
Several hosts: build it after `jax.distributed.initialize()`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """A (dp, tp) mesh over the first n_devices devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = n_devices or len(devices)
    assert n % tp == 0
    dev_array = np.array(devices[:n]).reshape(n // tp, tp)
    return Mesh(dev_array, ("dp", "tp"))


def shard_batch(batch, mesh: Mesh, axis: str = "dp"):
    """Place a stacked proof batch with the leading axis sharded over `axis`."""
    def put(x):
        spec = P(axis) if np.ndim(x) >= 1 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, batch)


def verify_batch_dp(batch, cfg, mesh: Mesh, air: str = "wide_fibonacci",
                    linkage: str = "reference", axis_name: str = "dp"):
    """DP scale-out: shard_map over `axis_name`, natively-batched verifier
    per device, psum'd accept count.

    This is the production multi-device path: inside shard_map each device
    verifies its local (B/D, ...) shard and the only collective is the
    final scalar psum.

    Returns (bitmap (B,) sharded over dp, n_accepted replicated scalar).
    """
    batch = shard_batch(batch, mesh, axis_name)
    fn = _dp_fn(cfg, mesh, air, linkage, axis_name)
    if jax.process_count() > 1:
        # multi-controller: every process compiles this program
        # independently (minutes of skew on loaded hosts), but the first
        # collective's rendezvous window is short (Gloo KV ~30 s) — sync
        # on the coordination service between compile and execution
        from ..utils import distributed as D

        compiled = fn.lower(batch).compile()
        D.barrier("verify_batch_dp_compiled")
        return compiled(batch)
    return fn(batch)


@functools.lru_cache(maxsize=None)
def _dp_fn(cfg, mesh: Mesh, air: str, linkage: str, axis_name: str):
    """The jitted DP program, built once per (cfg, mesh, air, linkage)."""
    from ..models.stwo import verifier

    def local(b):
        bitmap = verifier.verify(b, cfg, air, linkage)[0]
        n_ok = jax.lax.psum(jnp.sum(bitmap.astype(jnp.int32)), axis_name)
        return bitmap, n_ok

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis_name),
        out_specs=(P(axis_name), P()),
    ))


def _proof_specs(batch_axis: str, query_axis: str):
    """PartitionSpec pytree for a stacked StwoProof: per-query arrays split
    over (batch, query) axes, per-proof arrays over batch only."""
    from ..models.stwo.proof import StwoProof

    def pq(_):
        return P(batch_axis, query_axis)

    return StwoProof(
        commitments=P(batch_axis),
        trace_evals=pq(None),
        trace_sibs=pq(None),
        cp_evals=pq(None),
        cp_sibs=pq(None),
        oods_trace=P(batch_axis),
        oods_cp=P(batch_axis),
        fri_first_commit=P(batch_axis),
        fri_inner_commits=P(batch_axis),
        fri_last=P(batch_axis),
        fri_witnesses=None,  # filled per-layer below
        fri_sibs=None,
        pow_nonce=P(batch_axis),
    )


def verify_batch_tp(batch, cfg, mesh: Mesh, air: str = "wide_fibonacci",
                    linkage: str = "reference", batch_axis: str = "dp",
                    query_axis: str = "tp"):
    """Manual tensor parallelism over the query axis.

    shard_map over ('dp', 'tp'): every device holds a (B/dp, Q/tp, ...)
    shard of the per-query proof arrays.  Inside the shard the verifier
    runs its transcript per-proof (replicated over 'tp' — it is <1% of the
    work), slices its local queries (verify(query_slice=...)), and runs
    every per-query stage on local data.  Per-query masks are AND-reduced
    over 'tp' with a psum; the accept count psums over 'dp'.

    Q must be divisible by the 'tp' mesh size (the reference grid is 16
    queries x 20 columns, fri/answers.simf:97-130).

    Returns (bitmap (B,) sharded over dp, replicated accept count).
    """
    from ..models.stwo import verifier
    from ..models.stwo.proof import StwoProof

    tp_size = mesh.shape[query_axis]
    assert cfg.n_queries % tp_size == 0, (
        f"n_queries={cfg.n_queries} not divisible by tp={tp_size}"
    )
    n_local = cfg.n_queries // tp_size

    specs = _proof_specs(batch_axis, query_axis)._asdict()
    specs["fri_witnesses"] = tuple(
        P(batch_axis, query_axis) for _ in batch.fri_witnesses
    )
    specs["fri_sibs"] = tuple(
        P(batch_axis, query_axis) for _ in batch.fri_sibs
    )
    in_specs = StwoProof(**specs)

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    # manual zip: PartitionSpec is a tuple subclass, so tree_map would
    # descend into the specs instead of treating them as leaves
    placed = {}
    for name in StwoProof._fields:
        val, spec = getattr(batch, name), getattr(in_specs, name)
        if isinstance(val, tuple):
            placed[name] = tuple(put(v, s) for v, s in zip(val, spec))
        else:
            placed[name] = put(val, spec)
    batch = StwoProof(**placed)

    def local(b):
        ok = verifier.verify(b, cfg, air, linkage,
                             query_slice=(query_axis, n_local))[0]
        # AND over the query shards: every shard's masks must pass
        ok_all = jax.lax.psum(ok.astype(jnp.int32), query_axis) == tp_size
        n_ok = jax.lax.psum(
            jnp.sum(ok_all.astype(jnp.int32)), batch_axis
        )
        return ok_all, n_ok

    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(in_specs,),
        out_specs=(P(batch_axis), P()),
    )
    return jax.jit(fn)(batch)


def verify_batch_gspmd(batch, cfg, mesh: Mesh, air: str = "wide_fibonacci",
                       linkage: str = "reference", batch_axis: str = "dp",
                       query_axis: str = "tp"):
    """DP+TP via GSPMD: the proof batch is sharded over `batch_axis` and
    per-query hashing is constrained to partition over `query_axis`.

    Returns (bitmap (B,), n_accepted).
    """
    from ..models.stwo import verifier

    batch = shard_batch(batch, mesh, batch_axis)

    fn = jax.jit(
        lambda b: verifier.verify(
            b, cfg, air, linkage,
            query_sharding=(mesh, batch_axis, query_axis),
        )[0]
    )
    bitmap = fn(batch)
    return bitmap, jnp.sum(bitmap.astype(jnp.int32))
