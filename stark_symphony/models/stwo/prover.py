"""stwo-style circle-STARK prover (wide-Fibonacci AIR) — JAX, batched.

The reference ships no stwo prover (its fixtures come from the external
stwo prover); this is a from-scratch batched JAX prover whose proofs the
batched verifier accepts end-to-end with the 'reference' quotient linkage
(deep/quotients.simf + fri/answers.simf semantics).

Pipeline (all value arrays in natural circle-domain position order; Merkle
leaves are bit-reversed positions, matching the query convention of
evals/verify.simf):

1. trace columns (C, T) -> circle-FFT low-degree extension to the LDE
   domain (C, L);
2. commit trace (leaf = 4-byte BE concatenation of the C column values);
3. draw cp_alpha; build the composition polynomial on the LDE domain:
   CP = sum_k alpha^.. * (c_k - c_{k-1}^2 - c_{k-2}^2) / V_T(x)
   (Horner with cp_alpha, matching constraints/wide_fibonacci.simf:24-38);
4. interpolate CP (QM31) -> quarter-split coefficients = the decomposition
   F = F_a + y F_b + x F_c + x y F_d; each F_* splits into 4 M31
   coordinate columns -> 16 M31 columns, evaluated on the LDE domain and
   committed (leaf = 16 values, hasher.simf:93-97);
5. OODS: draw point, evaluate all 20 column polys at it, mix; draw
   deep_alpha;
6. first FRI layer = DEEP quotients over the whole LDE domain
   (fri/answers.simf aggregation, including its batch_coeff factor);
7. FRI: commit first layer, draw alpha, circle fold; then line folds per
   inner layer down to the final log size; last layer must be constant;
8. grind the PoW nonce (vectorized candidate search);
9. draw queries, gather decommitments.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...ops import field as F
from ...ops import merkle
from ...ops.circle import CircleDomain, LineDomain
from ...ops.circle_fft import (
    cfft_eval,
    cfft_interpolate,
    embed_coeffs,
    eval_at_point,
    twiddles,
)
from ...ops.sha256 import sha256_words
from ...ops.u32 import bit_reverse, byte_swap32, lt64
from . import channel as ch
from .config import StwoConfig
from .proof import StwoProof
from .verifier import deep_denominator_inverse, deep_interpolant_coefficients

P = F.P


def generate_trace(cfg: StwoConfig, seeds=None,
                   air: str = "wide_fibonacci") -> np.ndarray:
    """AIR-satisfying trace: per-row sequences col_k = rule(col_{k-2},
    col_{k-1}) with col0 = 1 and col1 = seed (default row index + 1).
    Default rule is wide-Fibonacci (c = a^2 + b^2)."""
    from .constraints import TRACE_RULES

    rule = TRACE_RULES[air]
    t = 1 << cfg.trace_log_size
    if seeds is None:
        seeds = np.arange(1, t + 1, dtype=np.uint64)
    cols = [np.ones(t, np.uint64), np.asarray(seeds, np.uint64) % P]
    for _ in range(2, cfg.n_columns):
        cols.append(rule(cols[-2], cols[-1]) % P)
    return np.stack(cols).astype(np.uint32)  # (C, T)


def _host_vanishing_inv(cfg: StwoConfig) -> np.ndarray:
    """1 / V_T(x) on the LDE domain (host constants).

    V_T = pi^(T_log - 1)(x) (composition_poly.simf:66-71); nonzero on the
    LDE domain because canonic cosets of different sizes are disjoint.
    """
    from .. import stwo  # noqa: F401  (package anchor)
    from ...ops.circle_fft import _host_point_at

    d = CircleDomain(cfg.lde_log_size)
    n = 1 << cfg.lde_log_size
    out = np.empty(n, np.uint32)
    for i in range(n):
        if i < n // 2:
            idx = (d.offset + d.step * i) & ((1 << 31) - 1)
        else:
            idx = (1 << 31) - ((d.offset + d.step * (i - n // 2)) & ((1 << 31) - 1))
            idx &= (1 << 31) - 1
        x = _host_point_at(idx)[0]
        for _ in range(cfg.trace_log_size - 1):
            x = (2 * x * x - 1) % P
        out[i] = pow(x, P - 2, P)
    return out


def _commit_leaves(leaf_words_natural, lde_log: int):
    """leaf_words (..., L, W) in natural position order -> Merkle levels
    with leaves in bit-reversed order, plus the root."""
    n = 1 << lde_log
    perm = np.zeros(n, np.int64)
    idx = np.arange(n)
    for b in range(lde_log):
        perm |= ((idx >> b) & 1) << (lde_log - 1 - b)
    leaves_br = leaf_words_natural[..., perm, :]
    digests = sha256_words(leaves_br)
    levels = merkle.build_tree(digests)
    return levels, levels[-1][..., 0, :]


def _gather(levels, indices):
    return jax.vmap(lambda i: merkle.gather_path(levels, i))(indices)


def prove(cfg: StwoConfig, trace: np.ndarray | None = None,
          air: str = "wide_fibonacci"):
    """Generate one stwo proof.  Returns (StwoProof numpy pytree, info)."""
    if trace is None:
        trace = generate_trace(cfg, air=air)
    out = _prove_jit(cfg, jnp.asarray(trace, jnp.uint32), air)
    to_np = lambda x: np.asarray(x)
    proof = StwoProof(
        commitments=to_np(out.commitments),
        trace_evals=to_np(out.trace_evals),
        trace_sibs=to_np(out.trace_sibs),
        cp_evals=to_np(out.cp_evals),
        cp_sibs=to_np(out.cp_sibs),
        oods_trace=to_np(out.oods_trace),
        oods_cp=to_np(out.oods_cp),
        fri_first_commit=to_np(out.fri_first_commit),
        fri_inner_commits=to_np(out.fri_inner_commits),
        fri_last=to_np(out.fri_last),
        fri_witnesses=tuple(to_np(w) for w in out.fri_witnesses),
        fri_sibs=tuple(to_np(s) for s in out.fri_sibs),
        pow_nonce=to_np(out.pow_nonce),
    )
    return proof, {}


def pow_grind(cfg: StwoConfig, state):
    """Find the PoW nonce for a channel state, chunked by difficulty.

    pow_bits is a free config axis (the reference hard-wires 5 bits with a
    TODO to raise to 32, config.simf:49-51); expected work is 2^pow_bits
    hashes, searched in vectorized chunks under a while_loop so memory
    stays bounded.  Traceable (used inside _prove_jit) and jittable
    standalone (sharded prover).
    """
    n_cand = min(1 << 16, max(4096, 8 << cfg.pow_bits))
    target = cfg.pow_target

    def _grind_chunk(start_hi, start_lo):
        nonces = start_lo + jnp.arange(n_cand, dtype=jnp.uint32)
        his = jnp.broadcast_to(start_hi, (n_cand,))
        cand_states = ch.ChannelState(
            jnp.broadcast_to(state.digest, (n_cand, 8)),
            jnp.broadcast_to(state.counter, (n_cand,)),
        )
        mixed = ch.mix_u64(cand_states, his, nonces)
        hi = byte_swap32(mixed.digest[..., 7])
        lo = byte_swap32(mixed.digest[..., 6])
        ok = lt64(hi, lo, jnp.uint32(target >> 32),
                  jnp.uint32(target & 0xFFFFFFFF))
        best = jnp.argmax(ok)
        return jnp.any(ok), his[best], nonces[best]

    def _cond(c):
        return ~c[0]

    def _body(c):
        _, _, _, start_hi, start_lo = c
        found, nhi, nlo = _grind_chunk(start_hi, start_lo)
        # advance over the full 64-bit nonce space: the low word wraps to 0
        # after 2^32 candidates (n_cand is a power of two) and carries into
        # the high word, so the search terminates iff ANY 64-bit nonce
        # meets the target (advisor r04: hi was pinned to 0, re-scanning
        # the same 2^32 candidates forever at pow_bits near 32).
        next_lo = start_lo + jnp.uint32(n_cand)
        next_hi = start_hi + jnp.where(next_lo == 0, jnp.uint32(1),
                                       jnp.uint32(0))
        return found, nhi, nlo, next_hi, next_lo

    _, nhi, nlo, _, _ = jax.lax.while_loop(
        _cond, _body,
        (jnp.bool_(False), jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
         jnp.uint32(0)),
    )
    return jnp.stack([nhi, nlo])


EMPTY_ROOT_WORDS = np.frombuffer(
    bytes.fromhex(
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
    ),
    dtype=">u4",
).astype(np.uint32)  # sha256("") — the empty preprocessed tree commitment


class PreFri(NamedTuple):
    """Everything the prover knows after stage 6 (pre-FRI): transcript
    state, commitments + tree levels, LDE values, OODS samples, and the
    DEEP-quotient first FRI layer.  Shared between the single-device
    prover (_prove_jit) and the domain-sharded prover
    (models/stwo/prover_sharded.py)."""

    state_digest: jnp.ndarray
    state_counter: jnp.ndarray
    trace_root: jnp.ndarray
    cp_root: jnp.ndarray
    trace_levels: tuple
    cp_levels: tuple
    trace_lde: jnp.ndarray
    cp_col_vals: jnp.ndarray
    oods_trace: jnp.ndarray
    oods_cp: jnp.ndarray
    first_layer: jnp.ndarray


def _pre_fri(cfg: StwoConfig, trace, air: str = "wide_fibonacci"):
    """Prover stages 1-6 (trace LDE/commit -> CP -> OODS -> DEEP
    quotients); traceable, shared by _prove_jit and prover_sharded."""
    lde_log = cfg.lde_log_size
    t_log = cfg.trace_log_size
    L = 1 << lde_log
    C = cfg.n_columns

    # 1. LDE of trace columns (natural position order)
    t_coeffs = cfft_interpolate(trace, t_log)  # (C, T)
    lde_coeffs = embed_coeffs(t_coeffs, t_log, lde_log)  # (C, L)
    trace_lde = cfft_eval(lde_coeffs, lde_log)  # (C, L)

    # 2. commit trace
    trace_levels, trace_root = _commit_leaves(
        jnp.moveaxis(trace_lde, 0, -1), lde_log
    )

    const_root = EMPTY_ROOT_WORDS
    state = ch.init()
    state = ch.mix_root(state, const_root)
    state = ch.mix_root(state, trace_root)
    state, cp_alpha, _ = ch.draw_qm31(state)

    # 3. composition polynomial on LDE domain (QM31 values (L, 4))
    from .constraints import lde_rule

    rule = lde_rule(air)
    acc = F.qm31_zero((L,))
    for k in range(2, C):
        a = trace_lde[k - 2]
        b = trace_lde[k - 1]
        c = trace_lde[k]
        constraint = F.m31_sub(c, rule(a, b))
        acc = F.qm31_add(
            F.qm31_mul(acc, jnp.broadcast_to(cp_alpha, acc.shape)),
            F.qm31_from_m31(constraint),
        )
    v_inv = jnp.asarray(_host_vanishing_inv(cfg))
    cp_vals = F.qm31_mul_m31(acc, v_inv)  # (L, 4)

    # 4. decomposition -> 16 M31 columns on LDE domain
    cp_coeffs = cfft_interpolate(cp_vals, lde_log, qm31=True)  # (L, 4)
    q = L // 4
    # Coefficient bit layout is [y | x | pi-tower] (circle_fft.py:18-24), so
    # CP = F_a + y F_b + x F_c + x y F_d with
    #   quarter 0 -> F_a, 1 -> x*F_c, 2 -> y*F_b, 3 -> x*y*F_d.
    # The committed decomposition columns are the polys WITHOUT their
    # monomial factors (the verifier re-applies x/y/xy when recombining,
    # evals/composition_poly.simf:47-59), so each quarter's coefficients are
    # re-based into quarter 0 (pure pi-tower basis) before evaluating.
    quarter_of_poly = {0: 0, 1: 2, 2: 1, 3: 3}  # poly index (a,b,c,d) -> quarter
    cp_cols = []
    col_coeffs = []
    for g in range(4):  # coordinate groups (hasher order: a_g, b_g, c_g, d_g)
        for p_idx in range(4):  # poly a, b, c, d
            quarter = quarter_of_poly[p_idx]
            coeff = jnp.zeros((L,), jnp.uint32)
            coeff = coeff.at[0:q].set(cp_coeffs[quarter * q : (quarter + 1) * q, g])
            col_coeffs.append(coeff)
            cp_cols.append(cfft_eval(coeff, lde_log))
    cp_col_vals = jnp.stack(cp_cols)  # (16, L)

    cp_levels, cp_root = _commit_leaves(jnp.moveaxis(cp_col_vals, 0, -1), lde_log)
    state = ch.mix_root(state, cp_root)

    # 5. OODS
    state, oods_point, _ = ch.draw_qm31_point(state)
    oods_trace = jax.vmap(
        lambda cfs: eval_at_point(cfs, lde_log, oods_point)
    )(lde_coeffs)  # (C, 4)
    oods_cp = jax.vmap(
        lambda cfs: eval_at_point(cfs, lde_log, oods_point)
    )(jnp.stack(col_coeffs))  # (16, 4)
    oods_words = jnp.concatenate([oods_trace.reshape(-1), oods_cp.reshape(-1)])
    state = ch.mix_words(state, oods_words)
    state, deep_alpha, _ = ch.draw_qm31(state)

    # 6. DEEP quotients over the whole LDE domain (natural order)
    pts = _domain_points(cfg)  # (L, 2) host constants
    denom_inv = deep_denominator_inverse(oods_point, pts)  # (L, 2)
    py = pts[..., 1]
    acc = F.qm31_zero((L,))
    alpha_i = deep_alpha
    items = [(oods_trace[c], trace_lde[c]) for c in range(C)]
    items += [(oods_cp[k], cp_col_vals[k]) for k in range(16)]
    for oods_val, vals in items:
        a, b, c = deep_interpolant_coefficients(oods_point, oods_val, alpha_i)
        num = F.qm31_sub(
            F.qm31_mul_m31(jnp.broadcast_to(b, vals.shape + (4,)), vals),
            F.qm31_add(
                F.qm31_mul_m31(jnp.broadcast_to(a, vals.shape + (4,)), py),
                jnp.broadcast_to(c, vals.shape + (4,)),
            ),
        )
        acc = F.qm31_add(acc, num)
        alpha_i = F.qm31_mul(alpha_i, deep_alpha)
    first_layer = F.qm31_mul(
        F.qm31_mul_cm31(acc, denom_inv), jnp.broadcast_to(alpha_i, acc.shape)
    )  # (L, 4)
    return PreFri(
        state_digest=state.digest,
        state_counter=state.counter,
        trace_root=trace_root,
        cp_root=cp_root,
        trace_levels=tuple(trace_levels),
        cp_levels=tuple(cp_levels),
        trace_lde=trace_lde,
        cp_col_vals=cp_col_vals,
        oods_trace=oods_trace,
        oods_cp=oods_cp,
        first_layer=first_layer,
    )


@functools.partial(jax.jit, static_argnums=(0, 2))
def _prove_jit(cfg: StwoConfig, trace, air: str = "wide_fibonacci"):
    lde_log = cfg.lde_log_size
    pre = _pre_fri(cfg, trace, air)
    state = ch.ChannelState(pre.state_digest, pre.state_counter)
    first_layer = pre.first_layer
    trace_lde = pre.trace_lde
    cp_col_vals = pre.cp_col_vals
    trace_levels = list(pre.trace_levels)
    cp_levels = list(pre.cp_levels)
    trace_root, cp_root = pre.trace_root, pre.cp_root
    oods_trace, oods_cp = pre.oods_trace, pre.oods_cp
    const_root = EMPTY_ROOT_WORDS

    # 7. FRI
    lvls, lvls_inv = twiddles(lde_log)
    fri_layers_vals = [first_layer]
    fri_levels = []
    fri_roots = []
    fri_alphas = []
    cur = first_layer
    log = lde_log
    for layer in range(1 + cfg.n_inner_layers):
        levels, root = _commit_leaves(cur, log)
        fri_levels.append(levels)
        fri_roots.append(root)
        state = ch.mix_root(state, root)
        state, alpha, _ = ch.draw_qm31(state)
        fri_alphas.append(alpha)
        half = cur.shape[-2] // 2
        a_half = cur[:half]
        b_half = cur[half:]
        # fold twiddle inverses for this level (host)
        tw_inv = jnp.asarray(
            twiddles(lde_log)[1][lde_log - log][:half]
            if log != lde_log
            else twiddles(lde_log)[1][0]
        )
        f0 = F.qm31_add(a_half, b_half)
        f1 = F.qm31_mul_m31(F.qm31_sub(a_half, b_half), tw_inv)
        cur = F.qm31_add(f0, F.qm31_mul(jnp.broadcast_to(alpha, f1.shape), f1))
        log -= 1
        fri_layers_vals.append(cur)
    # last layer: constant polynomial; mix its coefficient
    fri_last = cur[0]
    state = ch.mix_words(state, fri_last)

    # 8. PoW grind (pow_grind below)
    nonce = pow_grind(cfg, state)  # (2,) = (hi, lo) over the u64 space
    state = ch.mix_u64(state, nonce[0], nonce[1])

    # 9. queries + decommitments (bit-reversed leaf indexing)
    state, queries = ch.draw_queries(state, cfg.n_queries, lde_log)
    nat_pos = bit_reverse(queries, lde_log)  # natural positions of queries

    trace_evals = jnp.moveaxis(
        jnp.take(trace_lde, nat_pos.astype(jnp.int32), axis=-1), 0, -1
    )  # (Q, C)
    cp_evals = jnp.moveaxis(
        jnp.take(cp_col_vals, nat_pos.astype(jnp.int32), axis=-1), 0, -1
    )  # (Q, 16)
    trace_sibs = _gather(trace_levels, queries)
    cp_sibs = _gather(cp_levels, queries)

    fri_wits = []
    fri_sibs = []
    cur_q = queries
    log = lde_log
    for layer in range(1 + cfg.n_inner_layers):
        sib_leaf = cur_q ^ 1
        nat_sib = bit_reverse(sib_leaf, log)
        vals = fri_layers_vals[layer]
        fri_wits.append(
            jnp.take(vals, nat_sib.astype(jnp.int32), axis=-2)
        )  # (Q, 4)
        # node-level proof: start at the paired node (depth log-1)
        node_idx = (cur_q & jnp.uint32(0xFFFFFFFE)) >> 1
        levels = fri_levels[layer]
        # drop the leaf level: proof covers levels 1..; siblings for node
        node_levels = levels[1:]
        fri_sibs.append(
            jax.vmap(lambda i: merkle.gather_path(node_levels, i))(node_idx)
        )
        cur_q = node_idx
        log -= 1

    return StwoProof(
        commitments=jnp.stack([jnp.asarray(const_root), trace_root, cp_root]),
        trace_evals=trace_evals,
        trace_sibs=trace_sibs,
        cp_evals=cp_evals,
        cp_sibs=cp_sibs,
        oods_trace=oods_trace,
        oods_cp=oods_cp,
        fri_first_commit=fri_roots[0],
        fri_inner_commits=(
            jnp.stack(fri_roots[1:])
            if len(fri_roots) > 1
            else jnp.zeros((0, 8), jnp.uint32)
        ),
        fri_last=fri_last,
        fri_witnesses=tuple(fri_wits),
        fri_sibs=tuple(fri_sibs),
        pow_nonce=nonce,
    )


@functools.lru_cache(maxsize=None)
def _domain_points_host(lde_log: int):
    from ...ops.circle_fft import _host_point_at

    d = CircleDomain(lde_log)
    n = 1 << lde_log
    pts = np.empty((n, 2), np.uint32)
    for i in range(n):
        if i < n // 2:
            idx = (d.offset + d.step * i) & ((1 << 31) - 1)
            x, y = _host_point_at(idx)
        else:
            idx = (d.offset + d.step * (i - n // 2)) & ((1 << 31) - 1)
            x, y = _host_point_at(idx)
            y = (P - y) % P
        pts[i] = (x, y)
    return pts


def _domain_points(cfg: StwoConfig):
    return jnp.asarray(_domain_points_host(cfg.lde_log_size))
