"""Tiled (stage-kernel) verify path: bit-equivalence with the standard path.

The tiled path (models/stwo/tiled.py + verifier.verify_batch_tiled) is the
GPU throughput path; its semantics must match verify_batch exactly.  On the
CPU its Pallas kernels run in the interpreter
(ops/pallas/gpu_stages.interpret_mode).
"""

import numpy as np
import pytest

from stark_symphony.models.stwo import proof as P
from stark_symphony.models.stwo import tiled, verifier
from stark_symphony.models.stwo.config import TESTING
from stark_symphony.models.stwo.tamper import PROD_TAMPERS, tamper_lanes
from stark_symphony.ops.pallas import gpu_stages as G
from stark_symphony.utils.proofcache import cached_stwo_proof


@pytest.fixture(scope="module")
def batch():
    pf = cached_stwo_proof(TESTING)
    return P.replicate(pf, 6)


def test_tiled_accepts_valid_batch(batch):
    tb = tiled.tile_batch(batch, TESTING)
    bm = np.asarray(verifier.verify_batch_tiled(tb, TESTING))
    assert bm.shape == (6,) and bm.all()


def test_tiled_matches_standard_on_tampered_lanes(batch):
    # corrupt lane 2's cp evals and lane 4's FRI witness; every mask bit
    # must agree with the standard path, and only those lanes may fail
    bad = batch._replace(
        cp_evals=batch.cp_evals.copy(),
        fri_witnesses=tuple(w.copy() for w in batch.fri_witnesses),
    )
    bad.cp_evals[2, 0, 3] ^= 1
    bad.fri_witnesses[1][4, 0, 1] ^= 1

    bm_std = np.asarray(
        verifier.verify_batch(bad, TESTING, linkage="reference")
    )
    tb = tiled.tile_batch(bad, TESTING)
    bm_tld, masks = verifier.verify_batch_tiled(tb, TESTING, with_masks=True)
    bm_tld = np.asarray(bm_tld)
    assert (bm_tld == bm_std).all()
    assert not bm_tld[2] and not bm_tld[4]
    assert bm_tld[[0, 1, 3, 5]].all()
    # the tampered cp evals must flip the cp Merkle mask specifically
    assert not np.asarray(masks["cp_merkle"])[2]


def test_native_relayout_matches_numpy(monkeypatch):
    """The C++ ingestion transpose (native/tile.cpp via ctypes) is
    bit-identical to the numpy relayout for every array shape tile_batch
    produces, including lane padding.  tiled._stile() builds the library
    from native/Makefile at first use."""
    assert tiled._stile() is not None, "native/libstile.so did not build"
    rng = np.random.default_rng(3)
    for shape, m in [((7, 3, 5, 8), 8), ((31, 16, 4), 8),
                     ((6, 1, 8), 8), ((130, 16, 13, 8), 24)]:
        x = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
        got = tiled._tile_words(x, m)
        monkeypatch.setattr(tiled, "_STILE", False)  # force numpy path
        want = tiled._tile_words(x, m)
        monkeypatch.setattr(tiled, "_STILE", None)
        np.testing.assert_array_equal(got, want, err_msg=str(shape))


def test_tiled_padding_lanes_are_dropped():
    # B * Q = 5 lanes -> padded to one kernel lane block; pad lanes must
    # not affect results
    pf = cached_stwo_proof(TESTING)
    b5 = P.replicate(pf, 5)
    tb = tiled.tile_batch(b5, TESTING)
    assert tb.trace_evals_t.shape[-2] * 128 == G.LANE_BLOCK
    bm = np.asarray(verifier.verify_batch_tiled(tb, TESTING))
    assert bm.shape == (5,) and bm.all()


@pytest.mark.parametrize("batch_size,n_queries,rows", [
    (5, 1, 1), (128, 1, 1), (129, 1, 2), (4096, 16, 512), (9, 16, 2)])
def test_lane_padding_to_kernel_block(batch_size, n_queries, rows):
    """Lanes pad to whole kernel lane blocks (128 lanes, one container
    row), and pad lanes are zero."""
    assert G.LANE_BLOCK == 128
    assert tiled.n_tiles(batch_size, n_queries) == rows
    x = np.arange(1, batch_size * n_queries * 3 + 1, dtype=np.uint32)
    t = tiled._tile_words(x.reshape(batch_size, n_queries, 3), rows)
    assert t.shape == (3, rows, 128)
    flat = t.reshape(3, -1)
    lanes = batch_size * n_queries
    assert not flat[:, lanes:].any()
    np.testing.assert_array_equal(flat[:, :lanes].T.reshape(-1), x)


# ---------------------------------------------------------------------------
# The 15 tamper classes at TESTING size through the tiled path (lane i
# carries class i-1).  The classes' FRI layer indices clamp to TESTING's 3
# layers, and the nonce tamper moves one word only: with 1 query and a
# 5-bit PoW, moving both words of this fixture's nonce happens to pass.
# ---------------------------------------------------------------------------

_TESTING_TAMPERS = [
    (f, (lambda a: a + np.uint32([1, 0])) if f == "pow_nonce" else m,
     None if t is None else min(t, TESTING.n_inner_layers))
    for f, m, t in PROD_TAMPERS
]


@pytest.fixture(scope="module")
def tamper_run():
    bad = tamper_lanes(
        P.replicate(cached_stwo_proof(TESTING), 1 + len(_TESTING_TAMPERS)),
        _TESTING_TAMPERS)
    tb = tiled.tile_batch(bad, TESTING)
    bm = verifier.verify_batch_tiled(tb, TESTING)
    std = verifier.verify_batch(bad, TESTING, linkage="reference")
    return np.asarray(bm), np.asarray(std), tb


def test_tamper_run_control_lane_and_standard_path(tamper_run):
    bm, std, _ = tamper_run
    assert bm[0], "untampered control lane must verify"
    np.testing.assert_array_equal(bm, std)


@pytest.mark.parametrize(
    "lane", range(1, 1 + len(PROD_TAMPERS)),
    ids=[f"{f}{'' if t is None else t}" for f, _, t in PROD_TAMPERS])
def test_tamper_class_rejected(tamper_run, lane):
    bm, _, _ = tamper_run
    assert not bm[lane], _TESTING_TAMPERS[lane - 1][:1]


def test_kernels_match_reference_on_testing_batch(tamper_run):
    """Both stage kernels (interpreted) equal their plain XLA forms on the
    tiled TESTING batch, tamper lanes included, at the batch's own queries
    (FRI evals, coordinates and alphas random)."""
    from stark_symphony.models.stwo.constraints import REGISTRY

    _, _, tb = tamper_run
    b, m = tb.commitments.shape[0], tb.trace_evals_t.shape[-2]
    queries = verifier._stages_i_to_iv(
        tb, TESTING, REGISTRY["wide_fibonacci"], {})[0]

    def lanes(x):  # (B * Q, ...) -> (..., M, 128), zero pad lanes
        out = np.zeros(x.shape[1:] + (m * 128,), np.uint32)
        out[..., :b * TESTING.n_queries] = np.moveaxis(np.asarray(x), 0, -1)
        return out.reshape(x.shape[1:] + (m, 128))

    q = lanes(np.asarray(queries).reshape(-1, 1))
    root = lanes(np.repeat(tb.commitments[:, 1], TESTING.n_queries, 0))
    args = (tb.trace_evals_t, q, tb.trace_sibs_t, root,
            TESTING.n_columns, TESTING.lde_log_size)
    ok = np.asarray(G.leafwalk(*args))
    np.testing.assert_array_equal(ok, np.asarray(G.leafwalk_reference(*args)))
    assert ok.reshape(-1)[0] == 1 and ok.reshape(-1)[2] == 0  # trace_sibs
    depths = tuple(TESTING.fri_layer_depth(l)
                   for l in range(1 + TESTING.n_inner_layers))
    n_l = len(depths)
    rng = np.random.default_rng(5)
    ev = rng.integers(0, 0x7FFFFFFF, (4, m, 128), dtype=np.uint32)
    ci = rng.integers(0, 0x7FFFFFFF, (n_l, m, 128), dtype=np.uint32)
    al = rng.integers(0, 0x7FFFFFFF, (n_l, 4, m, 128), dtype=np.uint32)
    roots = np.stack([lanes(tb.fri_first_commit)] + [
        lanes(tb.fri_inner_commits[:, i]) for i in range(n_l - 1)])
    fargs = (q, ev, tb.fri_wits_t, ci, al, tb.fri_sibs_t, roots, depths)
    for g, w in zip(G.fri_layers(*fargs), G.fri_reference(*fargs)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
