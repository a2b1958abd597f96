"""Big-domain sharded prove -> standard verify (VERDICT r03 task 7).

The SP building blocks (sharded FRI fold + sharded Merkle commit) compose
into a REAL proof: prover_sharded runs the FRI phase with every layer's
evaluation array sharded over the 8-device mesh (transcript interleaved
with the sharded commits/folds), and the emitted proof is accepted by the
completely standard single-device verifier under full 'reference' linkage.
"""

import numpy as np
import pytest

import jax

from stark_symphony.models.stwo import prover_sharded, verifier
from stark_symphony.models.stwo.config import StwoConfig
from stark_symphony.parallel.batch import make_mesh

# lde 2^18 (the "exceeds one chip for big AIRs" scale point, blowup 2^4
# like production), folds all the way to a constant last layer
BIG = StwoConfig(trace_log_size=14, lde_log_size=18, n_queries=4,
                 n_inner_layers=13, pow_bits=5)


@pytest.mark.slow
def test_sharded_prove_verifies_at_lde_18():
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("sp",))
    proof, info = prover_sharded.prove_sharded(BIG, mesh)
    # the domain supports sharding for the first 18-log2(16)=14.. layers
    assert info["n_sharded_layers"] >= 10
    ok, masks = verifier.verify_jit(proof, BIG, "wide_fibonacci",
                                    "reference")
    failing = [k for k, v in masks.items() if not np.asarray(v).all()]
    assert bool(ok), f"sharded-proved big-domain proof rejected: {failing}"

    # tamper: a flipped word in a mid FRI layer witness must be rejected
    bad_wits = tuple(w.copy() for w in proof.fri_witnesses)
    bad_wits[6][1, 2] ^= 1
    bad = proof._replace(fri_witnesses=bad_wits)
    ok2, _ = verifier.verify_jit(bad, BIG, "wide_fibonacci", "reference")
    assert not bool(ok2)
