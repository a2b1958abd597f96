"""Executable evidence for the stage-VI linkage decision (see
models/stwo/verifier.py `verify` docstring).

The claim: the reference fixtures' prover (an external patched stwo,
/root/reference/stwo-verifier/tests/data/proof.json) committed a first FRI
layer that CANNOT be any per-column weighting of the written DEEP-quotient
numerators (deep/quotients.simf:25-44, fri/answers.simf:44-130) — i.e. the
linear system

    first_layer(q) * denominator(q) = sum_k  w_k * numerator_k(q)

over the 16 production queries q and the 20 columns k (4 trace + 16 CP
partitions) is inconsistent: rank(M) = 15 but rank([M | rhs]) = 16.
Proofs from this framework's own prover (models/stwo/prover.py), which
implements the written semantics, make the system consistent (the exact
weights w_k = batch_coeff * alpha^i_k are recovered).

Everything here is exact arithmetic: the transcript values come from the
in-tree (golden-tested) channel, the committed first-layer values from the
fold-chain unwind (which checks out against the reference's own golden
fold vectors), and the linear algebra runs over the QM31 field in Python
integers — no floating point, no tolerance.

Run:  python -m stark_symphony.tools.linkage_audit [proof.json]
"""

from __future__ import annotations

import json
import sys

import numpy as np

P = (1 << 31) - 1


# --------------------------------------------------------------------------
# Exact QM31 arithmetic on 4-tuples of Python ints (a + bi) + (c + di) j,
# j^2 = 2 + i  — mirrors ops/field.py, but arbitrary-precision/host.
# --------------------------------------------------------------------------

def _cm_mul(a, b):
    (ar, ai), (br, bi) = a, b
    return ((ar * br - ai * bi) % P, (ar * bi + ai * br) % P)


def _cm_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _cm_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def qm_mul(x, y):
    ar, ai = (x[0], x[1]), (x[2], x[3])
    br, bi = (y[0], y[1]), (y[2], y[3])
    aibi = _cm_mul(ai, bi)
    re = _cm_add(_cm_mul(ar, br), _cm_mul(aibi, (2, 1)))
    im = _cm_add(_cm_mul(ar, bi), _cm_mul(ai, br))
    return (re[0], re[1], im[0], im[1])


def qm_add(x, y):
    return tuple((a + b) % P for a, b in zip(x, y))


def qm_sub(x, y):
    return tuple((a - b) % P for a, b in zip(x, y))


def qm_inv(x):
    ar, ai = (x[0], x[1]), (x[2], x[3])
    ar_sq = _cm_mul(ar, ar)
    ai_sq = _cm_mul(ai, ai)
    den = _cm_sub(ar_sq, _cm_add(_cm_add(ai_sq, ai_sq), (-ai_sq[1] % P, ai_sq[0])))
    norm = (den[0] * den[0] + den[1] * den[1]) % P
    ninv = pow(norm, P - 2, P)
    den_inv = ((den[0] * ninv) % P, (-den[1] * ninv) % P)
    re = _cm_mul(ar, den_inv)
    im = _cm_mul((-ai[0] % P, -ai[1] % P), den_inv)
    return (re[0], re[1], im[0], im[1])


QM_ZERO = (0, 0, 0, 0)


def _rank(rows, ncols):
    """Row-echelon rank of a QM31 matrix given as lists of 4-tuples."""
    rows = [list(r) for r in rows]
    rank = 0
    col = 0
    nrows = len(rows)
    while rank < nrows and col < ncols:
        piv = next(
            (r for r in range(rank, nrows) if rows[r][col] != QM_ZERO), None
        )
        if piv is None:
            col += 1
            continue
        rows[rank], rows[piv] = rows[piv], rows[rank]
        inv = qm_inv(rows[rank][col])
        rows[rank] = [qm_mul(inv, v) for v in rows[rank]]
        for r in range(nrows):
            if r != rank and rows[r][col] != QM_ZERO:
                f = rows[r][col]
                rows[r] = [
                    qm_sub(v, qm_mul(f, p)) for v, p in zip(rows[r], rows[rank])
                ]
        rank += 1
        col += 1
    return rank


# --------------------------------------------------------------------------
# System construction (reuses the golden-tested in-tree JAX components)
# --------------------------------------------------------------------------

def build_system(proof, cfg):
    """Return (M, rhs): M[q][k] = numerator_k(q), rhs[q] =
    first_layer(q) * pair_line_denominator(q), all exact QM31 tuples."""
    import jax.numpy as jnp

    from ..models.stwo import channel as ch
    from ..models.stwo.verifier import (
        deep_interpolant_coefficients,
        unfold_first_layer,
    )
    from ..ops.circle import CircleDomain, circle_position_to_point
    from ..ops.u32 import bit_reverse

    # transcript (stages I-V; mirrors verifier.verify, golden-tested
    # channel underneath)
    state = ch.init()
    state = ch.mix_root(state, proof.commitments[0])
    state = ch.mix_root(state, proof.commitments[1])
    state, _cp_alpha, _ = ch.draw_qm31(state)
    state = ch.mix_root(state, proof.commitments[2])
    state, oods_point, _ = ch.draw_qm31_point(state)
    oods_words = jnp.concatenate(
        [proof.oods_trace.reshape(-1), proof.oods_cp.reshape(-1)]
    )
    state = ch.mix_words(state, oods_words)
    state, deep_alpha, _ = ch.draw_qm31(state)
    fri_alphas = []
    state = ch.mix_root(state, proof.fri_first_commit)
    state, alpha, _ = ch.draw_qm31(state)
    fri_alphas.append(alpha)
    for i in range(cfg.n_inner_layers):
        state = ch.mix_root(state, proof.fri_inner_commits[i])
        state, alpha, _ = ch.draw_qm31(state)
        fri_alphas.append(alpha)
    state = ch.mix_words(state, proof.fri_last)
    state = ch.mix_u64(state, proof.pow_nonce[0], proof.pow_nonce[1])
    state, queries = ch.draw_queries(state, cfg.n_queries, cfg.lde_log_size)

    # committed first-layer values: fold chain unwound from the last-layer
    # constant through every Merkle-checked witness
    first_layer = np.asarray(
        unfold_first_layer(proof, cfg, queries, fri_alphas)
    )  # (Q, 4)

    # query points and the pair-line denominator (deep/quotients.simf:15-22)
    positions = bit_reverse(queries, cfg.lde_log_size)
    pts = np.asarray(
        circle_position_to_point(CircleDomain(cfg.lde_log_size), positions)
    )  # (Q, 2)
    px = np.asarray(oods_point)[0]  # (4,) [re0, re1, im0, im1]
    py = np.asarray(oods_point)[1]
    q_n = cfg.n_queries

    def cm(t):
        return (int(t[0]), int(t[1]))

    prx, pix = cm(px[0:2]), cm(px[2:4])
    pry, piy = cm(py[0:2]), cm(py[2:4])
    denominators = []
    for q in range(q_n):
        x, y = int(pts[q, 0]), int(pts[q, 1])
        dx = _cm_sub(prx, (x, 0))
        dy = _cm_sub(pry, (y, 0))
        d = _cm_sub(_cm_mul(dx, piy), _cm_mul(dy, pix))
        denominators.append((d[0], d[1], 0, 0))

    # numerators per column, UNWEIGHTED (alpha_i = 1)
    one = np.array([1, 0, 0, 0], dtype=np.uint32)
    cols = [
        (proof.oods_trace[c], proof.trace_evals[:, c])
        for c in range(cfg.n_columns)
    ]
    cols += [
        (proof.oods_cp[k], proof.cp_evals[:, k])
        for k in range(cfg.n_cp_partitions)
    ]
    M = [[None] * len(cols) for _ in range(q_n)]
    for k, (oods_val, vals) in enumerate(cols):
        a, b, c = (
            np.asarray(v)
            for v in deep_interpolant_coefficients(
                jnp.asarray(np.asarray(oods_point)),
                jnp.asarray(oods_val),
                jnp.asarray(one),
            )
        )
        a_t, b_t, c_t = tuple(map(int, a)), tuple(map(int, b)), tuple(map(int, c))
        for q in range(q_n):
            v = int(vals[q])
            y_q = int(pts[q, 1])
            num = qm_sub(
                tuple((x * v) % P for x in b_t),
                qm_add(tuple((x * y_q) % P for x in a_t), c_t),
            )
            M[q][k] = num

    rhs = [
        qm_mul(tuple(int(v) for v in first_layer[q]), denominators[q])
        for q in range(q_n)
    ]
    return M, rhs


def audit(proof, cfg) -> dict:
    M, rhs = build_system(proof, cfg)
    r = _rank(M, len(M[0]))
    ra = _rank([row + [v] for row, v in zip(M, rhs)], len(M[0]) + 1)
    return {
        "n_queries": len(M),
        "n_columns": len(M[0]),
        "rank": r,
        "rank_augmented": ra,
        "consistent": r == ra,
    }


def main(argv=None):
    from ..models.stwo import proof as Pf

    argv = argv if argv is not None else sys.argv[1:]
    if argv:
        path = argv[0]
        proof, cfg = Pf.load_json(path)
        res = audit(proof, cfg)
        res["proof"] = path
    else:
        import pathlib

        root = pathlib.Path(__file__).resolve().parents[2]
        path = str(root / "tests/fixtures/stwo/proof.json")
        proof, cfg = Pf.load_json(path)
        res = audit(proof, cfg)
        res["proof"] = path
    print(json.dumps(res))
    if not res["consistent"]:
        print(
            "=> INCONSISTENT: no per-column weights reproduce the committed "
            "first FRI layer from the written DEEP-quotient numerators; the "
            "fixture prover used a different stage-VI aggregation.",
            file=sys.stderr,
        )
    return 0 if res["consistent"] else 1


if __name__ == "__main__":
    sys.exit(main())
