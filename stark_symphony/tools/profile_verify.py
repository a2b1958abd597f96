"""Per-stage wall-clock profile of the batched stwo verifier.

Times each verification stage as its own jitted function on the current
backend with PRODUCTION shapes, so the end-to-end proofs/s number can be
attributed to hashing vs field ops vs transcript (SURVEY.md §3.1 hot
loops; the reference has no profiler — its analogue is the static
`node.bounds()` cost model, simfony-cli/src/main.rs:142-154).

Stage bodies mirror models/stwo/verifier.verify (same ops, same shapes);
they are measured in isolation, so cross-stage fusion the real verifier
enjoys is not counted — treat the numbers as upper bounds that localize,
not as a decomposition that sums to the e2e time.

Usage:
    python -m stark_symphony.tools.profile_verify [batch] [iters]

Prints one JSON line per stage: {"stage": ..., "ms_per_batch": ...,
"proofs_per_sec": ...}.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"),
)


def _log(msg):
    print(f"[profile {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _time(fn, args, iters, name=""):
    import jax

    _log(f"compiling {name} ...")
    t0 = time.perf_counter()
    out = fn(*args)  # compile
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    _log(f"compiled {name} in {compile_s:.1f}s; timing")
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters, compile_s


def main_tiled(batch: int, iters: int) -> int:
    """Per-stage profile of the TILED path (verify_batch_tiled): its two
    stage kernels (ops/pallas/gpu_stages.py) and the XLA stages."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update(
        "jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"]
    )

    from ..models.stwo import proof as P
    from ..models.stwo import tiled, verifier
    from ..models.stwo.config import PRODUCTION
    from ..ops.pallas import gpu_stages as GS
    from ..utils.proofcache import cached_stwo_proof

    cfg = PRODUCTION
    tb = tiled.tile_batch(
        P.replicate(cached_stwo_proof(cfg, "bench"), batch), cfg
    )
    tb = jax.device_put(tb)
    b, q_n = batch, cfg.n_queries
    m = tb.trace_evals_t.shape[-2]
    rng = np.random.default_rng(0)
    results = {}

    # synthetic per-lane inputs (shape-correct; values irrelevant to cost)
    q_t = jax.device_put(jnp.asarray(
        rng.integers(0, 1 << cfg.lde_log_size, (1, m, 128), dtype=np.uint32)))
    root8 = jax.device_put(jnp.asarray(
        rng.integers(0, 1 << 32, (8, m, 128), dtype=np.uint32)))

    @jax.jit
    def stage_v_trace(ev, qq):
        return GS.leafwalk(ev, qq, tb.trace_sibs_t, root8,
                           cfg.n_columns, cfg.lde_log_size)

    results["tiled_leafwalk_trace"] = _time(
        stage_v_trace, (tb.trace_evals_t, q_t), iters, "tiled_leafwalk_trace")

    @jax.jit
    def stage_v_cp(ev, qq):
        return GS.leafwalk(ev, qq, tb.cp_sibs_t, root8,
                           cfg.n_cp_partitions, cfg.lde_log_size)

    results["tiled_leafwalk_cp"] = _time(
        stage_v_cp, (tb.cp_evals_t, q_t), iters, "tiled_leafwalk_cp")

    # FRI kernel with synthetic scalars
    n_layers = 1 + cfg.n_inner_layers
    depths = tuple(cfg.fri_layer_depth(l) for l in range(n_layers))
    ev4 = jax.device_put(jnp.asarray(
        rng.integers(0, (1 << 31) - 1, (4, m, 128), dtype=np.uint32)))
    cinvs = jax.device_put(jnp.asarray(
        rng.integers(1, (1 << 31) - 1, (n_layers, m, 128), dtype=np.uint32)))
    alphas = jax.device_put(jnp.asarray(
        rng.integers(0, (1 << 31) - 1, (n_layers, 4, m, 128), dtype=np.uint32)))
    roots_t = jax.device_put(jnp.asarray(
        rng.integers(0, 1 << 32, (n_layers, 8, m, 128), dtype=np.uint32)))

    @jax.jit
    def fri_fused(qq, ev):
        return GS.fri_layers(qq, ev, tb.fri_wits_t, cinvs, alphas,
                             tb.fri_sibs_t, roots_t, depths)

    results["tiled_fri_fused"] = _time(
        fri_fused, (q_t, ev4), iters, "tiled_fri_fused")

    # stage VI (XLA) with the point-table gather
    queries = jax.device_put(jnp.asarray(
        rng.integers(0, 1 << cfg.lde_log_size, (b, q_n), dtype=np.uint32)))

    @jax.jit
    def points_only(qq):
        return verifier.query_points(cfg, qq)

    results["tiled_query_points_gather"] = _time(
        points_only, (queries,), iters, "tiled_query_points_gather")

    @jax.jit
    def stage_vi(qq):
        trace_evals = jnp.stack(
            [qq_ for qq_ in [tb.trace_evals_t[c].reshape(-1)[: b * q_n]
                             .reshape(b, q_n) for c in range(cfg.n_columns)]],
            axis=-1)
        cp_evals = jnp.stack(
            [tb.cp_evals_t[k].reshape(-1)[: b * q_n].reshape(b, q_n)
             for k in range(cfg.n_cp_partitions)], axis=-1)
        pts = verifier.query_points(cfg, qq)
        oods_point = jnp.stack([tb.oods_trace[..., 0, :],
                                tb.oods_trace[..., 1, :]], axis=-2)
        return verifier.fri_answers(
            cfg, qq, trace_evals, cp_evals, tb.oods_cp[..., 0, :],
            oods_point, tb.oods_trace, tb.oods_cp, pts=pts)

    results["tiled_stage_vi"] = _time(stage_vi, (queries,), iters,
                                      "tiled_stage_vi")

    @jax.jit
    def full(t):
        return verifier.verify_batch_tiled(t, cfg, linkage="reference")

    results["tiled_full_verify"] = _time(full, (tb,), iters,
                                         "tiled_full_verify")

    for stage, (dt, compile_s) in results.items():
        print(json.dumps({
            "stage": stage,
            "ms_per_batch": round(dt * 1e3, 3),
            "batch": batch,
            "proofs_per_sec": round(batch / dt, 1),
            "compile_s": round(compile_s, 1),
        }))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--tiled":
        argv = argv[1:]
        batch = int(argv[0]) if argv else 2048
        iters = int(argv[1]) if len(argv) > 1 else 5
        return main_tiled(batch, iters)
    batch = int(argv[0]) if argv else 2048
    iters = int(argv[1]) if len(argv) > 1 else 5

    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update(
        "jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"]
    )

    from ..models.stwo import channel as ch
    from ..models.stwo import proof as P
    from ..models.stwo import verifier
    from ..models.stwo.config import PRODUCTION
    from ..ops import merkle
    from ..ops.sha256 import sha256_words
    from ..utils.proofcache import cached_stwo_proof

    cfg = PRODUCTION
    proof = P.replicate(cached_stwo_proof(cfg, "bench"), batch)
    proof = jax.device_put(proof)

    results = {}

    # transcript stages I-IV: sequential channel SHA chain over B lanes
    @jax.jit
    def stages_i_iv(p):
        state = ch.init(p.commitments.shape[:-2])
        state = ch.mix_root(state, p.commitments[..., 0, :])
        state = ch.mix_root(state, p.commitments[..., 1, :])
        state, cp_alpha, _ = ch.draw_qm31(state)
        state = ch.mix_root(state, p.commitments[..., 2, :])
        state, oods_point, _ = ch.draw_qm31_point(state)
        ow = jnp.concatenate(
            [p.oods_trace.reshape(p.oods_trace.shape[:-2] + (-1,)),
             p.oods_cp.reshape(p.oods_cp.shape[:-2] + (-1,))], axis=-1)
        state = ch.mix_words(state, ow)
        state, deep_alpha, _ = ch.draw_qm31(state)
        state = ch.mix_root(state, p.fri_first_commit)
        state, a, _ = ch.draw_qm31(state)
        for i in range(cfg.n_inner_layers):
            state = ch.mix_root(state, p.fri_inner_commits[..., i, :])
            state, a, _ = ch.draw_qm31(state)
        state = ch.mix_words(state, p.fri_last)
        state = ch.mix_u64(state, p.pow_nonce[..., 0], p.pow_nonce[..., 1])
        state, queries = ch.draw_queries(state, cfg.n_queries, cfg.lde_log_size)
        return state.digest, queries

    results["transcript_I_IV"] = _time(stages_i_iv, (proof,), iters, "transcript_I_IV")
    _, queries = stages_i_iv(proof)
    queries = jax.device_put(np.asarray(queries))

    # stage V: leaf hashing + 2Q Merkle paths, depth 13
    @jax.jit
    def stage_v(p, q):
        trace_leaf = sha256_words(p.trace_evals)
        cp_leaf = sha256_words(p.cp_evals)
        leaves = jnp.concatenate([trace_leaf, cp_leaf], axis=-2)
        sibs = jnp.concatenate([p.trace_sibs, p.cp_sibs], axis=-3)
        roots = jnp.concatenate(
            [jnp.broadcast_to(p.commitments[..., None, 1, :], trace_leaf.shape),
             jnp.broadcast_to(p.commitments[..., None, 2, :], cp_leaf.shape)],
            axis=-2)
        return merkle.verify_path(
            leaves, jnp.concatenate([q, q], axis=-1), sibs, roots)

    results["evals_merkle_V"] = _time(stage_v, (proof, queries), iters, "evals_merkle_V")

    # stage VI: query points (31-step scalar mul) + DEEP quotients
    @jax.jit
    def stage_vi(p, q):
        pts = verifier.query_points(cfg, q)
        oods_point = jnp.stack([p.oods_trace[..., 0, :],
                                p.oods_trace[..., 1, :]], axis=-2)
        return verifier.fri_answers(
            cfg, q, p.trace_evals, p.cp_evals, p.oods_cp[..., 0, :],
            oods_point, p.oods_trace, p.oods_cp, pts=pts)

    results["deep_quotients_VI"] = _time(stage_vi, (proof, queries), iters, "deep_quotients_VI")

    @jax.jit
    def stage_vi_points_only(q):
        return verifier.query_points(cfg, q)

    results["query_points_only"] = _time(stage_vi_points_only, (queries,), iters, "query_points_only")

    # stage VII: folds + layer Merkle walks (alphas faked as constants;
    # same op mix and shapes as the real stage)
    alphas = [jax.device_put(np.full(
        (batch, 4), 7 + i, np.uint32)) for i in range(1 + cfg.n_inner_layers)]

    @jax.jit
    def stage_vii(p, q, als):
        pts = verifier.query_points(cfg, q)
        coord_invs = verifier.batch_inv_m31(
            verifier.fri_fold_coords(cfg, q, pts))
        cur_q, cur_e = q, jnp.zeros(q.shape + (4,), jnp.uint32)
        roots = [p.fri_first_commit] + [
            p.fri_inner_commits[..., i, :] for i in range(cfg.n_inner_layers)]
        max_depth = cfg.fri_layer_depth(0)
        m_nodes, m_idx, m_sibs, m_roots, m_depths = [], [], [], [], []
        for l, root in enumerate(roots):
            node_idx = (cur_q & jnp.uint32(0xFFFFFFFE)) >> 1
            cur_q, cur_e, node = verifier._fri_layer(
                cur_q, cur_e, p.fri_witnesses[l], coord_invs[l], als[l])
            depth = cfg.fri_layer_depth(l)
            sib = p.fri_sibs[l]
            if depth < max_depth:
                z = jnp.zeros(sib.shape[:-2] + (max_depth - depth, 8), jnp.uint32)
                sib = jnp.concatenate([sib, z], axis=-2)
            m_nodes.append(node)
            m_idx.append(node_idx)
            m_sibs.append(sib)
            m_roots.append(jnp.broadcast_to(root[..., None, :], node.shape))
            m_depths.extend([depth] * cfg.n_queries)
        ok = merkle.verify_path_padded(
            jnp.concatenate(m_nodes, axis=-2),
            jnp.concatenate(m_idx, axis=-1),
            jnp.concatenate(m_sibs, axis=-3),
            jnp.concatenate(m_roots, axis=-2),
            np.array(m_depths))
        return ok, cur_e

    results["fri_VII"] = _time(stage_vii, (proof, queries, alphas), iters, "fri_VII")

    # end-to-end reference point
    @jax.jit
    def full(p):
        return verifier.verify_batch(p, cfg, linkage="reference")

    results["full_verify"] = _time(full, (proof,), iters, "full_verify")

    for stage, (dt, compile_s) in results.items():
        print(json.dumps({
            "stage": stage,
            "ms_per_batch": round(dt * 1e3, 3),
            "batch": batch,
            "proofs_per_sec": round(batch / dt, 1),
            "compile_s": round(compile_s, 1),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
