"""Scaling harness: verification throughput vs device count.

Measures the sharded DP path (parallel/batch.verify_batch_dp — shard_map
over 'dp', psum'd accept count) at n_devices in {1, 2, 4, ...} with weak
scaling (fixed per-device batch), reporting efficiency vs n=1 — the
BASELINE.md ">= 80% scaling efficiency 1 -> N" metric.

Backends:
* Several GPUs of one host (all to all over NVLink): scaling numbers.
* One GPU: n=1 only — the absolute per-card rate.
* Virtual CPU mesh (JAX_PLATFORMS=cpu
  XLA_FLAGS=--xla_force_host_platform_device_count=8): validates the
  collective program end-to-end; the efficiency numbers measure XLA's
  partitioned program, not hardware (virtual devices share host cores).

Writes SCALING.json (one object) and prints it as one line.

Env: SCALE_CONFIG=testing|production (default: testing on cpu,
production on gpu), SCALE_BATCH (per-device; default 256),
SCALE_ITERS (default 3), SCALE_OUT (default SCALING.json).
"""

import json
import os
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache"),
)


def main():
    import jax
    import numpy as np

    jax.config.update("jax_compilation_cache_dir",
                      os.environ["JAX_COMPILATION_CACHE_DIR"])

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Pspec

    from stark_symphony.models.stwo import proof as P
    from stark_symphony.models.stwo import verifier
    from stark_symphony.models.stwo.config import PRODUCTION, TESTING
    from stark_symphony.parallel.batch import make_mesh, shard_batch
    from stark_symphony.utils.proofcache import cached_stwo_proof

    backend = jax.default_backend()
    cfg_name = os.environ.get(
        "SCALE_CONFIG", "production" if backend == "gpu" else "testing"
    )
    cfg = PRODUCTION if cfg_name == "production" else TESTING
    per_dev = int(os.environ.get("SCALE_BATCH", "256"))
    n_iters = int(os.environ.get("SCALE_ITERS", "3"))

    proof = cached_stwo_proof(cfg)

    n_avail = jax.device_count()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]

    results = {}
    for n in counts:
        mesh = make_mesh(n, tp=1)

        def local(b):
            bitmap = verifier.verify(b, cfg, linkage="reference")[0]
            return bitmap, jax.lax.psum(
                jnp.sum(bitmap.astype(jnp.int32)), "dp"
            )

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=Pspec("dp"),
            out_specs=(Pspec("dp"), Pspec()),
        ))
        batch = P.replicate(proof, per_dev * n)
        # distinct device buffers per iteration: identical resident inputs
        # can be legitimately cached by a deterministic runtime
        copies = [shard_batch(batch, mesh) for _ in range(n_iters)]
        bitmap, n_ok = fn(copies[0])
        assert np.asarray(bitmap).all()
        assert int(np.asarray(n_ok).reshape(-1)[0]) == per_dev * n
        t0 = time.perf_counter()
        outs = [fn(c) for c in copies]
        # fetch each iteration's (tiny) accept count to host: no runtime
        # shortcut or lazy block can fake the steady-state number
        fetched = [int(np.asarray(o[1]).reshape(-1)[0]) for o in outs]
        dt = (time.perf_counter() - t0) / n_iters
        assert all(f == per_dev * n for f in fetched)
        results[n] = per_dev * n / dt

    eff = {
        n: round(results[n] / (n * results[1]), 4) for n in counts
    }
    virtual = backend == "cpu"
    # SCALE_ANCHOR: the real-chip n=1 rate (proofs/s) from bench.py's
    # chained measurement, recorded IN the artifact so the absolute anchor
    # and the (virtual) curve live together (VERDICT r04 task 10).
    anchor = os.environ.get("SCALE_ANCHOR")
    out = {
        "metric": "stwo_dp_scaling",
        "backend": backend,
        "config": cfg_name,
        "per_device_batch": per_dev,
        "throughput_proofs_per_sec": {str(n): round(v, 1) for n, v in results.items()},
        "efficiency_vs_1": {str(n): eff[n] for n in counts},
        "virtual_mesh": virtual,
        # what this curve actually measures: on a virtual CPU mesh the N
        # partitions oversubscribe the host's cores, so efficiency-vs-1
        # is a host-oversubscription number, NOT device scaling
        "measures": ("host_oversubscription" if virtual
                     else "device_scaling"),
        "real_chip_anchor": (
            {"n": 1, "proofs_per_sec": float(anchor),
             "source": "bench.py chained device measurement"}
            if anchor else None),
        # BASELINE.md's ">= 80% efficiency 1 -> N hosts" metric needs >= 2
        # real chips; this environment has exactly one
        "scaling_efficiency_80pct_metric": (
            "blocked: real multi-chip unavailable in this environment"
            if virtual or n_avail < 2 else "measured"),
    }
    path = os.environ.get("SCALE_OUT", "SCALING.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
