"""Stage-VI linkage evidence + PRODUCTION-size full-linkage roundtrip.

Makes the load-bearing claim of models/stwo/verifier.py executable:
* the external fixture prover's first FRI layer is NOT any per-column
  weighting of the written DEEP-quotient numerators (rank 15 vs augmented
  rank 16 over the 16 production queries) — tools/linkage_audit.py;
* proofs from the in-tree prover (the written semantics,
  deep/quotients.simf + fri/answers.simf) satisfy the system AND verify
  end-to-end at PRODUCTION size under linkage='reference' with every
  stage mask passing.
"""

import numpy as np
import pytest

from stark_symphony.models.stwo import proof as P
from stark_symphony.models.stwo import verifier
from stark_symphony.tools.linkage_audit import audit


@pytest.mark.slow
def test_fixture_stage_vi_inconsistent(fixtures_dir):
    """The reference fixture cannot satisfy the written stage-VI semantics:
    the committed first-layer vector lies OUTSIDE the numerator span
    (measured: rank 11, augmented rank 12 — augmenting with the rhs raises
    the rank, so no weights exist)."""
    proof, cfg = P.load_json(str(fixtures_dir / "stwo/proof.json"))
    res = audit(proof, cfg)
    assert res["n_queries"] == 16 and res["n_columns"] == 20
    assert not res["consistent"], res
    assert res["rank_augmented"] == res["rank"] + 1, res


@pytest.mark.slow
def test_own_prover_stage_vi_consistent(production_proof):
    """Positive control: the in-tree prover's proofs DO satisfy the
    written semantics (the audit system is consistent)."""
    proof, cfg = production_proof
    res = audit(proof, cfg)
    assert res["consistent"], res


@pytest.mark.slow
def test_production_roundtrip_reference_linkage(production_proof):
    """prove(PRODUCTION) -> verify(..., 'reference'): every stage mask
    passes at 16 queries / 8 inner layers (the shape the TESTING-size
    roundtrips cannot cover)."""
    proof, cfg = production_proof
    batch = P.replicate(proof, 2)
    ok, masks = verifier.verify(batch, cfg, linkage="reference")
    for name, m in masks.items():
        assert np.asarray(m).all(), f"mask failed at PRODUCTION size: {name}"
    assert np.asarray(ok).all()


@pytest.mark.slow
def test_production_tamper_rejected(production_proof):
    """PRODUCTION-size tamper spot-check under full linkage."""
    proof, cfg = production_proof
    batch = P.replicate(proof, 2)
    batch.fri_witnesses[3][1, 5] ^= 1  # inner FRI layer witness, lane 1
    ok = np.asarray(verifier.verify_batch(batch, cfg, linkage="reference"))
    assert list(ok) == [True, False]
