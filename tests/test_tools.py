"""L3 ingestion/export tools vs the reference generator scripts.

The *.wit.json fixtures are captured outputs of the reference generators
(stwo-verifier/scripts/generate_wit.py, stark101/scripts/generate_wit.py)
run on the same proof fixtures — our generators must match them exactly.
"""

import json

import numpy as np
import pytest

from stark_symphony.tools import witness as W


@pytest.mark.parametrize("name", ["proof_test", "proof"])
def test_stwo_wit_matches_reference(fixtures_dir, name):
    data = json.load(open(fixtures_dir / "stwo" / f"{name}.json"))
    golden = json.load(open(fixtures_dir / "stwo" / f"{name}.wit.json"))
    assert W.stwo_wit(data) == golden


def test_stark101_wit_matches_reference(fixtures_dir):
    data = json.load(open(fixtures_dir / "stark101" / "golden_proof.json"))
    golden = json.load(
        open(fixtures_dir / "stark101" / "golden_proof.wit.json")
    )
    assert W.stark101_wit(data) == golden


def test_stwo_simf_literal(fixtures_dir):
    data = json.load(open(fixtures_dir / "stwo" / "proof_test.json"))
    lit = W.stwo_simf(data)
    assert lit.startswith("let proof: Proof = (")
    assert lit.endswith(");")


def test_stark101_simf_literal(fixtures_dir):
    data = json.load(open(fixtures_dir / "stark101" / "golden_proof.json"))
    lit = W.stark101_simf(data)
    assert lit.startswith("let proof: FibSquareProof = (")
    assert str(data["p_mt_root"]) in lit


@pytest.mark.parametrize("name", ["proof_test", "proof"])
def test_stwo_proof_json_roundtrip(fixtures_dir, name):
    """parse -> export -> parse is the identity (array-exact)."""
    from stark_symphony.models.stwo import proof as P

    data = json.load(open(fixtures_dir / "stwo" / f"{name}.json"))
    p1, cfg1 = P.parse(data)
    p2, cfg2 = P.parse(W.stwo_proof_json(p1, cfg1))
    assert cfg1 == cfg2
    import jax

    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(a, b)
    # and the exported json feeds the wit generator identically
    assert W.stwo_wit(data) == W.stwo_wit(W.stwo_proof_json(p1, cfg1))
