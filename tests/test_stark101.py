"""stark101 end-to-end: verifier vs the reference golden proof (the inline
test proof of /root/reference/stark101/src/verifier.simf:44-388, extracted
to tests/fixtures/stark101/golden_proof.json) and prover bit-exactness
(same trace => byte-identical proof to the reference Python prover output)."""

import jax
import numpy as np
import pytest

from stark_symphony.models.stark101 import proof as P
from stark_symphony.models.stark101 import prover, verifier
from stark_symphony.models.stark101.config import Stark101Config


@pytest.fixture(scope="module")
def golden(fixtures_dir):
    return P.load_json(str(fixtures_dir / "stark101" / "golden_proof.json"))


@pytest.fixture(scope="module")
def cfg():
    return Stark101Config()


def test_derived_constants(cfg):
    # air.simf:16-18 and hardcoded boundary constants (air.simf:63-91)
    assert cfg.coset_gen == 1734477367
    assert cfg.g_pow(1022) == 2450347685
    assert cfg.g_pow(1021) == 2342081930
    assert cfg.g_pow(1023) == 532203874


def test_verify_golden(golden, cfg):
    ok, masks = verifier.verify_jit(golden, cfg)
    failed = [k for k, v in masks.items() if not bool(np.asarray(v).all())]
    assert bool(ok), f"failed masks: {failed}"


@pytest.mark.parametrize(
    "field,mutate",
    [
        ("evals", lambda a: a + np.uint32(1)),
        ("fri_betas", lambda a: a ^ np.uint32(1)),
        ("cpa_evals", lambda a: a ^ np.uint32(1)),
        ("last", lambda a: a ^ np.uint32(1)),
        ("p_mt_root", lambda a: a ^ np.uint32(1)),
    ],
)
def test_tampered_rejected(golden, cfg, field, mutate):
    d = golden._asdict()
    d[field] = mutate(np.array(d[field]))
    bad = P.Stark101Proof(**d)
    ok, _ = verifier.verify_jit(bad, cfg)
    assert not bool(ok)


def test_prover_reproduces_reference_proof(golden, cfg):
    """Same trace + transcript => our NTT prover must emit the exact proof
    the reference O(n^2) Lagrange prover produced."""
    mine, info = prover.prove(cfg)
    np.testing.assert_array_equal(mine.p_mt_root, golden.p_mt_root)
    np.testing.assert_array_equal(mine.evals, golden.evals)
    np.testing.assert_array_equal(mine.eval_sibs, golden.eval_sibs)
    np.testing.assert_array_equal(mine.fri_roots, golden.fri_roots)
    np.testing.assert_array_equal(mine.fri_betas, golden.fri_betas)
    np.testing.assert_array_equal(mine.cpa_evals, golden.cpa_evals)
    np.testing.assert_array_equal(mine.cpb_evals, golden.cpb_evals)
    assert mine.last == golden.last
    for a, b in zip(mine.cpa_sibs, golden.cpa_sibs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(mine.cpb_sibs, golden.cpb_sibs):
        np.testing.assert_array_equal(a, b)


def test_prove_verify_roundtrip(cfg):
    proof, _ = prover.prove(cfg)
    ok, masks = verifier.verify_jit(proof, cfg)
    failed = [k for k, v in masks.items() if not bool(np.asarray(v).all())]
    assert bool(ok), f"failed masks: {failed}"
