"""DP-vs-TP cost comparison at PRODUCTION shape (VERDICT r03 task 6).

Runs the same PRODUCTION proof batch through the pure-DP path (shard_map
over 'dp' only) and the manual-TP path (per-query arrays sharded over
'tp'; Pallas-compatible) on the available mesh and records both timings.

On the 8-virtual-CPU-device mesh the numbers compare the partitioned
PROGRAMS (collective structure, exchange volume), not hardware — the
virtual devices share host cores; the artifact records that caveat.

Writes TPCOMPARE.json (TP_OUT to override) and prints it.
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

    from stark_symphony.models.stwo import proof as P
    from stark_symphony.models.stwo.config import PRODUCTION
    from stark_symphony.parallel.batch import (
        make_mesh, verify_batch_dp, verify_batch_tp,
    )
    from stark_symphony.utils.proofcache import cached_stwo_proof

    n_dev = min(8, jax.device_count())
    b = int(os.environ.get("TP_BATCH", "32"))
    iters = int(os.environ.get("TP_ITERS", "3"))
    batch = P.replicate(cached_stwo_proof(PRODUCTION), b)

    def timed(run):
        out = run()
        n0 = int(np.asarray(out[1]).reshape(-1)[0])
        assert n0 == b, f"accept count {n0} != {b}"
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run()
            assert int(np.asarray(out[1]).reshape(-1)[0]) == b
        return (time.perf_counter() - t0) / iters

    mesh_dp = make_mesh(n_dev, tp=1)
    dt_dp = timed(lambda: verify_batch_dp(batch, PRODUCTION, mesh_dp))

    tp = 4 if n_dev % 4 == 0 else 2
    mesh_tp = make_mesh(n_dev, tp=tp)
    dt_tp = timed(lambda: verify_batch_tp(batch, PRODUCTION, mesh_tp))

    out = {
        "metric": "dp_vs_tp_production",
        "backend": jax.default_backend(),
        "devices": n_dev,
        "batch": b,
        "dp_ms": round(dt_dp * 1e3, 1),
        "tp_ms": round(dt_tp * 1e3, 1),
        "tp_layout": f"dp={n_dev // tp} x tp={tp}",
        "tp_over_dp": round(dt_tp / dt_dp, 3),
        "virtual_mesh": jax.default_backend() == "cpu",
        "note": ("TP splits the 16-query grid so per-device lane count "
                 "drops 4x; for throughput DP wins (no intra-proof "
                 "collectives) — TP exists for latency / large-AIR "
                 "memory splitting. Virtual-mesh timings compare the "
                 "partitioned programs, not hardware."),
    }
    with open(os.environ.get("TP_OUT", "TPCOMPARE.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
