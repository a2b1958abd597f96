"""End-to-end stwo verifier tests against the reference prover fixtures
(tests/fixtures/stwo/proof_test.json and proof.json — real stwo outputs,
copied from /root/reference/stwo-verifier/tests/data/).

Linkage note (documented divergence): the reference's SimplicityHL quotient
aggregation (deep/quotients.simf + fri/answers.simf) does NOT reproduce the
first-FRI-layer values its own fixtures committed — the upstream e2e path
was never executed (verifier.simf:62-108's test builds the proof but never
calls verify_proof; fri/verify.simf:127's `log_size == 0` assert is
unsatisfiable for both reference configs).  We verified this by recovering
the committed first-layer evaluations bit-exactly via backward unfolding
(Merkle-validated, 16/16 on the production fixture) and showing no
alpha-power assignment of the reference's quotient formula matches them.

Fixture tests therefore assert:
  * every transcript stage (I-V) bit-exact: commitments, OODS consistency,
    PoW, query positions, trace/CP Merkle decommitments;
  * the full FRI chain (all layer Merkle paths + circle/line folds +
    last-layer constant) via 'unfold' linkage;
  * with 'reference' linkage, the failure is CONFINED to the quotient
    linkage masks — everything else passes.
Round-trip tests with this framework's own stwo prover exercise the full
'reference' linkage end-to-end.
"""

import jax
import numpy as np
import pytest

from stark_symphony.models.stwo import proof as P
from stark_symphony.models.stwo import verifier
from stark_symphony.models.stwo.config import PRODUCTION, TESTING


@pytest.fixture(scope="module")
def test_proof(fixtures_dir):
    return P.load_json(str(fixtures_dir / "stwo" / "proof_test.json"))


@pytest.fixture(scope="module")
def prod_proof(fixtures_dir):
    return P.load_json(str(fixtures_dir / "stwo" / "proof.json"))


def test_config_detection(test_proof, prod_proof):
    assert test_proof[1] == TESTING
    assert prod_proof[1] == PRODUCTION


LINKAGE_MASKS = ("fri_merkle_", "fri_last_eval", "fri_last_query")


def _split_masks(masks):
    linkage = {k: v for k, v in masks.items()
               if k.startswith(LINKAGE_MASKS)}
    transcript = {k: v for k, v in masks.items() if k not in linkage}
    return transcript, linkage


WHICH = ["test", pytest.param("prod", marks=pytest.mark.slow)]


@pytest.mark.parametrize("which", WHICH)
def test_fixture_transcript_and_chain(which, test_proof, prod_proof):
    proof, cfg = test_proof if which == "test" else prod_proof
    ok, masks = verifier.verify_jit(proof, cfg, "wide_fibonacci", "unfold")
    failed = [k for k, v in masks.items() if not bool(np.asarray(v).all())]
    assert bool(ok), f"failed masks: {failed}"


@pytest.mark.parametrize("which", WHICH)
def test_fixture_reference_linkage_divergence_is_confined(
    which, test_proof, prod_proof
):
    """With 'reference' linkage only the quotient-linkage masks may fail."""
    proof, cfg = test_proof if which == "test" else prod_proof
    ok, masks = verifier.verify_jit(proof, cfg, "wide_fibonacci", "reference")
    transcript, linkage = _split_masks(masks)
    failed_transcript = [
        k for k, v in transcript.items() if not bool(np.asarray(v).all())
    ]
    assert not failed_transcript, failed_transcript


def _tamper(proof, field, mutate, tuple_idx=None):
    d = proof._asdict()
    if tuple_idx is None:
        d[field] = mutate(np.array(d[field]))
    else:
        t = list(d[field])
        t[tuple_idx] = mutate(np.array(t[tuple_idx]))
        d[field] = tuple(t)
    return P.StwoProof(**d)


# Every proof field class has a rejection case (tamper => abort in the
# reference; tamper => mask False here).
TAMPERS = [
    ("trace_evals", lambda a: a + np.uint32(1), None),
    ("trace_sibs", lambda a: a ^ np.uint32(1), None),
    ("cp_evals", lambda a: a ^ np.uint32(1), None),
    ("cp_sibs", lambda a: a ^ np.uint32(4), None),
    ("oods_trace", lambda a: a ^ np.uint32(1), None),
    ("oods_cp", lambda a: a ^ np.uint32(2), None),
    ("fri_first_commit", lambda a: a ^ np.uint32(1), None),
    ("fri_inner_commits", lambda a: a ^ np.uint32(1), None),
    ("fri_last", lambda a: a ^ np.uint32(1), None),
    ("fri_witnesses", lambda a: a ^ np.uint32(1), 0),
    ("fri_witnesses", lambda a: a + np.uint32(1), 1),
    ("fri_sibs", lambda a: a ^ np.uint32(1), 0),
    ("fri_sibs", lambda a: a ^ np.uint32(2), 2),
    ("pow_nonce", lambda a: a + np.uint32(1), None),
    ("commitments", lambda a: a ^ np.uint32(1), None),
]


@pytest.mark.parametrize("field,mutate,tuple_idx", TAMPERS)
def test_tampered_proof_rejected(test_proof, field, mutate, tuple_idx):
    proof, cfg = test_proof
    bad = _tamper(proof, field, mutate, tuple_idx)
    ok, _ = verifier.verify_jit(bad, cfg, "wide_fibonacci", "unfold")
    assert not bool(ok)


# pow_nonce is excluded from the own-proof matrix: at TESTING size (one
# query drawn mod 16, 5-bit PoW) a nonce change can land on a transcript
# whose query position and PoW digest both collide, making the tampered
# proof genuinely protocol-valid (the reference verifier accepts it too).
# test_pow_nonce_tamper_rejected covers the nonce with multiple deltas.
REF_TAMPERS = [t for t in TAMPERS if t[0] != "pow_nonce"]


@pytest.mark.parametrize("field,mutate,tuple_idx", REF_TAMPERS)
def test_tampered_proof_rejected_reference_linkage(
    own_testing_proof, field, mutate, tuple_idx
):
    """Same tamper matrix under the FULL stage-VI linkage, on a proof from
    the in-tree prover (external fixtures never pass 'reference')."""
    proof, cfg = own_testing_proof
    ok0, masks0 = verifier.verify_jit(proof, cfg, "wide_fibonacci", "reference")
    assert bool(ok0), [k for k, v in masks0.items() if not np.asarray(v).all()]
    bad = _tamper(proof, field, mutate, tuple_idx)
    ok, _ = verifier.verify_jit(bad, cfg, "wide_fibonacci", "reference")
    assert not bool(ok)


def test_pow_nonce_tamper_rejected(own_testing_proof):
    """The nonce feeds the transcript: across several deltas at least one
    must be rejected (each non-colliding delta moves the drawn query, which
    breaks every decommitment; P[all 6 deltas collide] ~ (1/512)^6)."""
    proof, cfg = own_testing_proof
    rejected = 0
    for delta in range(1, 7):
        bad = _tamper(proof, "pow_nonce", lambda a: a + np.uint32(delta), None)
        ok, _ = verifier.verify_jit(bad, cfg, "wide_fibonacci", "reference")
        rejected += int(not bool(ok))
    assert rejected >= 1


@pytest.mark.parametrize("lde_log,n_inner", [(4, 2), (13, 8)])
def test_fold_coords_match_position_map(lde_log, n_inner):
    """The pi-doubling-map fold coordinates (fri_fold_coords) are bit-exact
    vs the reference's per-layer position-map path
    (circle_domain.simf:27-43 / line_domain.simf:26-32 recomputed per
    layer) for every layer and query parity."""
    import dataclasses

    import jax.numpy as jnp

    from stark_symphony.ops.circle import (
        CircleDomain,
        LineDomain,
        circle_position_to_point,
        line_position_to_x,
    )
    from stark_symphony.ops.u32 import bit_reverse

    cfg = dataclasses.replace(
        TESTING, lde_log_size=lde_log, n_inner_layers=n_inner
    )
    rng = np.random.default_rng(7)
    q = jnp.asarray(
        rng.integers(0, 1 << lde_log, size=257).astype(np.uint32)
    )
    pts = verifier.query_points(cfg, q)
    coords = verifier.fri_fold_coords(cfg, q, pts)

    mask = jnp.uint32(0xFFFFFFFE)
    for l, c in enumerate(coords):
        log = lde_log - l
        rev = bit_reverse((q >> l) & mask, log)
        if l == 0:
            want = circle_position_to_point(CircleDomain(log), rev)[..., 1]
        else:
            want = line_position_to_x(LineDomain(log), rev)
        np.testing.assert_array_equal(np.asarray(c), np.asarray(want), err_msg=f"layer {l}")

    # batch inversion agrees with per-element addition-chain inverses
    from stark_symphony.ops import field as F

    invs = verifier.batch_inv_m31(coords)
    for l, (c, i) in enumerate(zip(coords, invs)):
        np.testing.assert_array_equal(
            np.asarray(i), np.asarray(F.m31_inv(c)), err_msg=f"inv layer {l}"
        )


@pytest.mark.parametrize("lde_log", [4, 13])
def test_query_point_table_matches_scalar_mul(lde_log, monkeypatch):
    """query_points' two branches are bit-identical: the host-precomputed
    table gather vs the 31-step scalar-mul path (advisor r04: the fallback
    branch itself was never executed by any test — both parametrizations
    took the table branch)."""
    import dataclasses

    cfg = dataclasses.replace(TESTING, lde_log_size=lde_log)
    rng = np.random.default_rng(11)
    q = np.concatenate([
        rng.integers(0, 1 << lde_log, size=200).astype(np.uint32),
        np.array([0, 1, (1 << lde_log) - 1], np.uint32),
    ])
    via_table = np.asarray(verifier.query_points(cfg, q))
    # force the scalar-mul fallback branch of query_points itself
    monkeypatch.setattr(verifier, "_POINT_TABLE_MAX_LOG", lde_log - 1)
    via_scalar = np.asarray(verifier.query_points(cfg, q))
    np.testing.assert_array_equal(via_table, via_scalar)


def test_batch_verify(test_proof):
    proof, cfg = test_proof
    batch = P.replicate(proof, 4)
    te = np.array(batch.trace_evals)
    te[2] += 1  # tamper proof #2
    batch = batch._replace(trace_evals=te)
    bitmap = verifier.verify_batch(batch, cfg, linkage="unfold")
    np.testing.assert_array_equal(np.asarray(bitmap), [True, True, False, True])
