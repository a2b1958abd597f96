"""Manual tensor parallelism (query-axis shard_map) — VERDICT r03 task 6.

verify_batch_tp shards the per-query proof arrays over the 'tp' mesh axis
and keeps the Pallas kernels (each device sees ordinary local shards);
results must be bit-identical to the unsharded verifier.
"""

import jax
import numpy as np
import pytest

from stark_symphony.models.stwo import proof as P
from stark_symphony.models.stwo import verifier
from stark_symphony.models.stwo.config import TESTING_Q4
from stark_symphony.parallel.batch import (
    make_mesh,
    verify_batch_dp,
    verify_batch_tp,
)
from stark_symphony.utils.proofcache import cached_stwo_proof


@pytest.fixture(scope="module")
def q4_batch():
    pf = cached_stwo_proof(TESTING_Q4)
    return P.replicate(pf, 4)


def test_tp_matches_unsharded(q4_batch):
    mesh = make_mesh(8, tp=4)  # dp=2, tp=4 over the 8 virtual devices
    ref = np.asarray(
        verifier.verify_batch(q4_batch, TESTING_Q4, linkage="reference")
    )
    assert ref.all()
    bitmap, n_ok = verify_batch_tp(q4_batch, TESTING_Q4, mesh)
    assert (np.asarray(bitmap) == ref).all()
    assert int(np.asarray(n_ok).reshape(-1)[0]) == 4


def test_tp_tamper_localizes(q4_batch):
    mesh = make_mesh(8, tp=2)
    bad = jax.tree_util.tree_map(np.copy, q4_batch)
    # tamper a query handled by the SECOND tp shard (query 3 of 4)
    bad.trace_evals[1, 3, 0] ^= 1
    bitmap, n_ok = verify_batch_tp(bad, TESTING_Q4, mesh)
    bitmap = np.asarray(bitmap)
    assert not bitmap[1] and bitmap[[0, 2, 3]].all()
    assert int(np.asarray(n_ok).reshape(-1)[0]) == 3
    # agreement with the DP (unsplit-query) path on the same batch
    bm_dp, _ = verify_batch_dp(bad, TESTING_Q4, make_mesh(4, tp=1))
    assert (np.asarray(bm_dp) == bitmap).all()
