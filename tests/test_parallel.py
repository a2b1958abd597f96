"""Parallel-layer tests on the simulated 8-device CPU mesh (SURVEY.md §2.4):
fold-stage sharding (SP), microbatch pipelining (PP), multi-AIR routing (EP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stark_symphony.models.stwo import config as stwo_config
from stark_symphony.models.stwo import proof as stwo_proof
from stark_symphony.models.stwo import prover as stwo_prover
from stark_symphony.models.stwo import verifier as stwo_verifier
from stark_symphony.ops import field101 as F101
from stark_symphony.parallel.batch import make_mesh
from stark_symphony.parallel.expert import (
    verify_batch_routed,
    verify_batch_routed_sharded,
)
from stark_symphony.parallel.fri_shard import (
    stark101_fold_reference,
    stark101_fold_sharded,
)
from stark_symphony.parallel.pipeline import StreamVerifier, scan_microbatches

CFG = stwo_config.TESTING


def test_sharded_fold_matches_reference():
    rng = np.random.default_rng(7)
    n, stages = 256, 3
    values = jnp.asarray(rng.integers(0, F101.Q, n, dtype=np.uint64), jnp.uint32)
    # fold coordinates: 1/x over a multiplicative coset (like stark101's LDE)
    x0 = pow(F101.GEN, 3, F101.Q)
    xs = np.empty(n, np.uint32)
    cur = 1
    for i in range(n):
        xs[i] = cur
        cur = (cur * x0) % F101.Q
    x_invs = jnp.asarray([pow(int(v), F101.Q - 2, F101.Q) for v in xs], jnp.uint32)
    betas = [jnp.uint32(rng.integers(1, F101.Q)) for _ in range(stages)]

    want_v, want_x = stark101_fold_reference(values, x_invs, betas, stages)
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("sp",))
    got_v, got_x = stark101_fold_sharded(values, x_invs, betas, mesh1, stages)
    np.testing.assert_array_equal(np.asarray(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(np.asarray(got_x), np.asarray(want_x))


def _rand_qm31(shape, seed):
    from stark_symphony.ops.field import P as M31P

    return np.random.default_rng(seed).integers(
        0, M31P, size=shape + (4,), dtype=np.uint32
    )


def test_stwo_fold_sharded_matches_tables():
    """Sharded stwo circle+line folds == the in-lane twiddle-table fold
    (the prover's step-7 loop) bit-exactly on the 8-device mesh."""
    from stark_symphony.ops import field as F
    from stark_symphony.ops.circle_fft import twiddles
    from stark_symphony.parallel.fri_shard import (
        stwo_fold_reference,
        stwo_fold_sharded,
        stwo_domain_points,
    )

    lde_log, n_stages = 8, 3
    n = 1 << lde_log
    values = jnp.asarray(_rand_qm31((n,), 3))
    alphas = [jnp.asarray(_rand_qm31((), 10 + s)) for s in range(n_stages)]

    # oracle 1: the prover's twiddle-table fold
    _, lvls_inv = twiddles(lde_log)
    cur = values
    for layer in range(n_stages):
        half = cur.shape[0] // 2
        tw_inv = jnp.asarray(lvls_inv[layer][:half])
        f0 = F.qm31_add(cur[:half], cur[half:])
        f1 = F.qm31_mul_m31(F.qm31_sub(cur[:half], cur[half:]), tw_inv)
        cur = F.qm31_add(
            f0, F.qm31_mul(jnp.broadcast_to(alphas[layer], f1.shape), f1)
        )
    want = np.asarray(cur)

    # oracle 2: the single-device point-payload fold
    ref = np.asarray(
        stwo_fold_reference(
            values, stwo_domain_points(lde_log), alphas, n_stages
        )
    )
    np.testing.assert_array_equal(ref, want)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("sp",))
    got = np.asarray(
        stwo_fold_sharded(values, alphas, lde_log, mesh, n_stages)
    )
    np.testing.assert_array_equal(got, want)


def test_stwo_commit_sharded_matches_tree():
    """Sharded layer commitment (ppermute tree in natural-index space)
    == the prover's bit-reversed-leaf Merkle root."""
    from stark_symphony.models.stwo.prover import _commit_leaves
    from stark_symphony.parallel.fri_shard import stwo_commit_sharded

    lde_log = 7
    n = 1 << lde_log
    values = jnp.asarray(_rand_qm31((n,), 4))  # (N, 4) leaf words
    _, want_root = _commit_leaves(values, lde_log)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("sp",))
    got_root = stwo_commit_sharded(values, mesh)
    np.testing.assert_array_equal(np.asarray(got_root), np.asarray(want_root))


@pytest.fixture(scope="module")
def fib_proof(own_testing_proof):
    return own_testing_proof[0]


@pytest.fixture(scope="module")
def product_proof():
    from stark_symphony.utils.proofcache import cached_stwo_proof

    return cached_stwo_proof(CFG, "testing", air="wide_product")


def test_scan_microbatches_matches_vmap(fib_proof):
    batch = stwo_proof.replicate(fib_proof, 8)
    verify_one = lambda p: stwo_verifier.verify(p, CFG)[0]
    want = jax.vmap(verify_one)(batch)
    got = scan_microbatches(verify_one, batch, micro=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).all()


def test_stream_verifier(fib_proof):
    sv = StreamVerifier(
        lambda b: stwo_verifier.verify_batch(b, CFG), depth=2
    )
    for _ in range(5):
        sv.feed(stwo_proof.replicate(fib_proof, 4))
    outs = sv.finish()
    assert len(outs) == 5
    assert all(np.asarray(o).all() for o in outs)


def test_wide_product_air_roundtrip(product_proof):
    ok, _ = stwo_verifier.verify_jit(product_proof, CFG, "wide_product")
    assert bool(ok)
    # the wrong AIR must reject (OODS composition check fails)
    bad, masks = stwo_verifier.verify_jit(product_proof, CFG, "wide_fibonacci")
    assert not bool(bad)
    assert not bool(masks["oods_cp_match"])


def test_routed_batch(fib_proof, product_proof):
    batch = stwo_proof.stack([fib_proof, product_proof, product_proof, fib_proof])
    air_ids = np.array([0, 1, 1, 0], np.int32)
    bits = verify_batch_routed(batch, air_ids, CFG)
    assert np.asarray(bits).all()
    # swapped routing rejects every proof
    bits_bad = verify_batch_routed(batch, 1 - air_ids, CFG)
    assert not np.asarray(bits_bad).any()


def test_routed_batch_sharded(fib_proof, product_proof):
    mesh = make_mesh(8)
    batch = stwo_proof.stack([fib_proof, product_proof] * 4)
    air_ids = np.array([0, 1] * 4, np.int32)
    bitmap, n_ok = verify_batch_routed_sharded(batch, air_ids, CFG, mesh)
    assert np.asarray(bitmap).all()
    assert int(n_ok) == 8


def test_verify_batch_dp(fib_proof):
    """shard_map DP path: full 'reference' linkage, psum'd accept count,
    tampered lane survives locally (mask, not abort)."""
    from stark_symphony.parallel.batch import verify_batch_dp

    mesh = make_mesh(8, tp=1)
    batch = stwo_proof.replicate(fib_proof, 16)
    batch.cp_evals[3, 0, 0] ^= 1
    bitmap, n_ok = verify_batch_dp(batch, CFG, mesh, linkage="reference")
    bitmap = np.asarray(bitmap)
    assert not bitmap[3] and bitmap.sum() == 15
    assert int(np.asarray(n_ok).reshape(-1)[0]) == 15


def test_verify_batch_gspmd_tp(fib_proof):
    """GSPMD DP+TP path: per-query sharding constraints over 'tp'."""
    from stark_symphony.parallel.batch import verify_batch_gspmd

    mesh = make_mesh(8, tp=2)
    batch = stwo_proof.replicate(fib_proof, 8)
    bitmap, n_ok = verify_batch_gspmd(batch, CFG, mesh, linkage="reference")
    assert np.asarray(bitmap).all()
    assert int(n_ok) == 8
