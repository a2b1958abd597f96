"""Batched stark101 (FibonacciSq) verifier — JAX, mask-based.

Pipeline of /root/reference/stark101/src/verifier.simf:24-42:
mix trace root -> draw 3 CP coefficients -> replay FRI commitments
(mix root / draw & check beta) -> draw the query index -> Merkle-checked
trace reads -> composition polynomial evaluation -> FRI layer walk.

Batched re-design notes:
* The reference's data-dependent extended-Euclid division (field.simf:40-63)
  becomes Fermat inversion (fixed 31-step exponent) — value-identical.
* `exp_mod(h, idx)` with a runtime index becomes 13 conditional Montgomery
  multiplies against host-precomputed h^(2^k) tables.
* Assert-aborts become masks; a failed proof never kills the batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...ops import field101 as F
from ...ops import merkle
from ...ops.sha256 import sha256_words
from . import channel as ch
from .config import Stark101Config


def _pow_dyn(base: int, exponent, n_bits: int):
    """base^exponent for a host-constant base and runtime exponent (< 2^n_bits)."""
    table = [pow(base, 1 << k, F.Q) for k in range(n_bits)]
    exponent = jnp.asarray(exponent, jnp.uint32)
    bit0 = ((exponent >> 0) & 1).astype(bool)
    res = jnp.where(bit0, np.uint32(table[0]), np.uint32(1))
    for k in range(1, n_bits):
        bit = ((exponent >> k) & 1).astype(bool)
        res = jnp.where(bit, F.f_mul(res, np.uint32(table[k])), res)
    return res


def compose(cfg: Stark101Config, x, coeffs, f_x, f_gx, f_ggx):
    """Composition polynomial evaluation (air.simf:63-101).

    The three constraint divisions share one batched inversion (the
    reference runs extended Euclid per division; we do a single Fermat
    inversion via Montgomery's trick — compile-time and runtime win).
    """
    a0, a1, a2 = coeffs
    one = jnp.uint32(1)
    g1021 = jnp.uint32(cfg.g_pow(1021))
    g1022 = jnp.uint32(cfg.g_pow(1022))
    g1023 = jnp.uint32(cfg.g_pow(1023))
    den0 = F.f_sub(x, one)
    den1 = F.f_sub(x, g1022)
    den2 = F.f_sub(F.f_pow(x, cfg.domain_size), one)
    inv0, inv1, inv2 = F.f_inv_many([den0, den1, den2])
    p0 = F.f_mul(F.f_sub(f_x, one), inv0)
    p1 = F.f_mul(F.f_sub(f_x, jnp.uint32(cfg.boundary1)), inv1)
    num0 = F.f_sub(f_ggx, F.f_add(F.f_mul(f_x, f_x), F.f_mul(f_gx, f_gx)))
    num1 = F.f_mul(
        F.f_mul(F.f_sub(x, g1021), den1), F.f_sub(x, g1023)
    )
    p2 = F.f_mul(F.f_mul(num0, num1), inv2)
    return F.f_add(
        F.f_add(F.f_mul(p0, a0), F.f_mul(p1, a1)), F.f_mul(p2, a2)
    )


def verify(proof, cfg: Stark101Config = Stark101Config()):
    """Verify one stark101 proof; returns (ok, diagnostics).

    vmap over a leading proof axis for batches.
    """
    masks = {}
    n_ex = cfg.domain_ex_size
    log_ex = cfg.log_domain_ex
    n_layers = cfg.n_fri_layers

    # Channel genesis: state = H(root) (verifier.simf:30; Python channel
    # starts from b'' so the first mix hashes just the root).
    state = sha256_words(proof.p_mt_root)

    # CP coefficients
    state, a0 = ch.draw(state, F.Q)
    state, a1 = ch.draw(state, F.Q)
    state, a2 = ch.draw(state, F.Q)

    # FRI commitment replay (fri.simf:37-54)
    for i in range(n_layers):
        state = ch.mix_words(state, proof.fri_roots[..., i, :])
        state, beta = ch.draw(state, F.Q)
        masks[f"fri_beta_{i}"] = beta == proof.fri_betas[..., i]
    state = ch.mix_u32(state, proof.last)

    # Query index
    state, idx = ch.draw(state, n_ex)

    # Trace decommitments at idx, idx+8, idx+16 (air.simf:47-56).
    # The auth-path walk only consumes the low 13 bits, i.e. (idx+k) mod
    # 8192.  All three paths verify in one batched walk.
    offsets = jnp.asarray(
        np.arange(3, dtype=np.uint32) * cfg.idx_offset
    )
    trace_pos = idx[..., None] + offsets
    trace_leaves = sha256_words(proof.evals[..., :, None])  # (..., 3, 8)
    masks["trace_merkle"] = jnp.all(
        merkle.verify_path(
            trace_leaves, trace_pos, proof.eval_sibs,
            proof.p_mt_root[..., None, :],
        ),
        axis=-1,
    )
    for k in range(3):
        state = ch.mix_u32(state, proof.evals[..., k])

    # x = FIELD_GEN * h^idx (air.simf:58-60)
    x = F.f_mul(jnp.uint32(F.GEN), _pow_dyn(cfg.coset_gen, idx, log_ex))

    cp_ev = compose(
        cfg, x, (a0, a1, a2),
        proof.evals[..., 0], proof.evals[..., 1], proof.evals[..., 2],
    )

    # FRI walk (fri.simf:74-91).  1/(2x) per layer comes from one upfront
    # inversion: x_{i} = x_0^(2^i) so 1/x_i = (1/x_0)^(2^i).  All 2*L
    # Merkle paths (different depths) verify in one padded batched walk.
    inv2 = jnp.uint32(pow(2, F.Q - 2, F.Q))
    x_inv = F.f_inv(x)
    fri_leaves = []
    fri_indices = []
    fri_sibs = []
    fri_roots = []
    depths = []
    for i in range(n_layers):
        ds = n_ex >> i
        masks[f"fri_carry_{i}"] = cp_ev == proof.cpa_evals[..., i]
        cpa_idx = idx & jnp.uint32(ds - 1)
        cpb_idx = (idx + jnp.uint32(ds // 2)) & jnp.uint32(ds - 1)
        cpa_ev = proof.cpa_evals[..., i]
        cpb_ev = proof.cpb_evals[..., i]
        depth = log_ex - i
        pad = log_ex - depth
        for sib, pos in ((proof.cpa_sibs[i], cpa_idx), (proof.cpb_sibs[i], cpb_idx)):
            if pad:
                zeros = jnp.zeros(sib.shape[:-2] + (pad, 8), jnp.uint32)
                sib = jnp.concatenate([sib, zeros], axis=-2)
            fri_sibs.append(sib)
            fri_indices.append(pos)
            depths.append(depth)
        fri_leaves.append(cpa_ev)
        fri_leaves.append(cpb_ev)
        fri_roots.append(proof.fri_roots[..., i, :])
        fri_roots.append(proof.fri_roots[..., i, :])
        beta = proof.fri_betas[..., i]
        op0 = F.f_mul(F.f_add(cpa_ev, cpb_ev), inv2)
        op1 = F.f_mul(F.f_mul(F.f_sub(cpa_ev, cpb_ev), inv2), x_inv)
        cp_ev = F.f_add(op0, F.f_mul(op1, beta))
        x = F.f_mul(x, x)
        x_inv = F.f_mul(x_inv, x_inv)

    leaves = sha256_words(jnp.stack(fri_leaves, axis=-1)[..., None])  # (..., 2L, 8)
    masks["fri_merkle"] = jnp.all(
        merkle.verify_path_padded(
            leaves,
            jnp.stack(fri_indices, axis=-1),
            jnp.stack(fri_sibs, axis=-3),
            jnp.stack(fri_roots, axis=-2),
            np.array(depths),
        ),
        axis=-1,
    )

    masks["fri_last"] = cp_ev == proof.last

    ok = None
    for m in masks.values():
        ok = m if ok is None else (ok & m)
    return ok, masks


def verify_batch(proof_batch, cfg: Stark101Config = Stark101Config()):
    return jax.vmap(lambda p: verify(p, cfg)[0])(proof_batch)


# Shared jitted entry point: traces once per cfg per process.
verify_jit = jax.jit(verify, static_argnums=(1,))
