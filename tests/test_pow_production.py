"""High-difficulty PoW roundtrip + PRODUCTION-size tamper matrix.

The 15-class tamper matrix (models/stwo/tamper.py) at PRODUCTION size under
'reference' linkage, through both verify paths, and the PoW stage above the
reference's TODO-level 5 bits (config.simf:49-51).
"""

import numpy as np
import pytest

from stark_symphony.models.stwo import proof as P
from stark_symphony.models.stwo import prover, verifier
from stark_symphony.models.stwo.config import PRODUCTION, StwoConfig
from stark_symphony.models.stwo.tamper import PROD_TAMPERS, tamper_lanes
from stark_symphony.utils.proofcache import cached_stwo_proof


def test_pow_bits_20_roundtrip():
    """Raised difficulty (2^20 expected hashes — beyond one grind chunk, so
    the while_loop search is exercised) proves and verifies; a tampered
    nonce is rejected (collision probability 2^-20 per delta)."""
    cfg = StwoConfig(trace_log_size=3, lde_log_size=4, n_queries=1,
                     n_inner_layers=2, pow_bits=20)
    proof, _ = prover.prove(cfg)
    ok, masks = verifier.verify_jit(proof, cfg, "wide_fibonacci", "reference")
    assert bool(ok), [k for k, v in masks.items() if not np.asarray(v).all()]
    bad = proof._replace(pow_nonce=proof.pow_nonce + np.uint32([0, 1]))
    ok2, masks2 = verifier.verify_jit(bad, cfg, "wide_fibonacci", "reference")
    assert not bool(np.asarray(masks2["pow"]))
    assert not bool(ok2)


def _tamper_lane(proof, field, mutate, tuple_idx):
    d = proof._asdict()
    if tuple_idx is None:
        d[field] = mutate(np.array(d[field]))
    else:
        t = list(d[field])
        t[tuple_idx] = mutate(np.array(t[tuple_idx]))
        d[field] = tuple(t)
    return P.StwoProof(**d)


@pytest.mark.slow
def test_production_tamper_matrix_reference_linkage():
    """Full 15-class matrix at PRODUCTION shape (16 queries, 8 inner
    layers) under enforced stage-VI linkage, through the STANDARD path.
    One single-proof executable (verify_jit) compiled once and run per
    class.  The tiled path's PRODUCTION matrix is the batched-lane test
    below (one compile, tampers in lanes)."""
    proof = cached_stwo_proof(PRODUCTION)
    ok0, masks0 = verifier.verify_jit(
        proof, PRODUCTION, "wide_fibonacci", "reference"
    )
    assert bool(ok0), [
        k for k, v in masks0.items() if not np.asarray(v).all()
    ]
    accepted = []
    for field, mutate, tuple_idx in PROD_TAMPERS:
        bad = _tamper_lane(proof, field, mutate, tuple_idx)
        ok, _ = verifier.verify_jit(
            bad, PRODUCTION, "wide_fibonacci", "reference"
        )
        if bool(ok):
            accepted.append((field, tuple_idx))
    assert not accepted, f"tamper classes accepted: {accepted}"


@pytest.mark.gpu
def test_production_tamper_matrix_tiled_path():
    """The same 15-class matrix at PRODUCTION shape through the TILED
    fast path (verify_batch_tiled, with the compiled stage kernels).
    All 15 tampers ride one 16-proof batch, one per lane (lane 0 is the
    untampered control), so the matrix costs a single PRODUCTION compile
    and a single execution; the per-lane bitmap must reject exactly lanes
    1..15 and equal the standard path's.  chip_smoke.py runs the same
    matrix inside a 4,096-proof batch."""
    import jax

    from stark_symphony.models.stwo import tiled

    proof = cached_stwo_proof(PRODUCTION)
    batch = tamper_lanes(P.replicate(proof, 1 + len(PROD_TAMPERS)))
    tb = tiled.tile_batch(batch, PRODUCTION)
    fn = jax.jit(
        lambda b: verifier.verify_batch_tiled(b, PRODUCTION,
                                              linkage="reference")
    )
    bm = np.asarray(fn(tb))
    assert bm.shape == (1 + len(PROD_TAMPERS),)
    assert bm[0], "untampered control lane must verify"
    accepted = [
        (PROD_TAMPERS[i - 1][0], PROD_TAMPERS[i - 1][2])
        for i in range(1, len(bm)) if bm[i]
    ]
    assert not accepted, f"tiled path accepted tamper classes: {accepted}"
    std = np.asarray(verifier.verify_batch(batch, PRODUCTION))
    np.testing.assert_array_equal(bm, std)
