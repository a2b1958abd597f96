"""Tests for the stage kernels (ops/pallas/gpu_stages.py) and the lane-form
SHA-256 they are built from (ops/sha256_lanes.py).

The kernels are the GPU hot path for the verifier's dominant op (SHA-256
compressions — the `sha_256_ctx_8_*` jets of
/root/reference/stwo-verifier/src/{channel,hasher,merkle}.simf).

Strategy: the lane helpers are pure functions over word vectors, tested
here against hashlib and the lax implementations; the kernels run on the
CPU through the Pallas interpreter (the same `pallas_call`, BlockSpecs and
grid that Triton compiles on the GPU) and must equal their plain XLA forms
bit for bit.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stark_symphony.ops import merkle, sha256_lanes as SL
from stark_symphony.ops.pallas import gpu_stages as G
from stark_symphony.ops.sha256 import sha256_words

_TAB = jnp.asarray(SL.tables())
_P = 0x7FFFFFFF


def _rand(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=shape, dtype=np.uint32
    )


def _hashlib_words(msg_words_row) -> np.ndarray:
    raw = msg_words_row.astype(">u4").tobytes()
    return np.frombuffer(hashlib.sha256(raw).digest(), dtype=">u4").astype(
        np.uint32
    )


@pytest.mark.parametrize("n_words", [4, 9, 16, 24])
def test_kernel_math_sha_words(n_words):
    """The lane SHA the kernels run == hashlib, any message length."""
    msgs = _rand((33, n_words), seed=n_words)
    words = tuple(jnp.asarray(msgs[:, i]) for i in range(n_words))
    out = np.stack([np.asarray(t) for t in SL.sha_words(words, _TAB)], 1)
    want = np.stack([_hashlib_words(msgs[i]) for i in range(len(msgs))])
    np.testing.assert_array_equal(out, want)


def test_kernel_math_node_pair():
    left = _rand((17, 8), seed=2)
    right = _rand((17, 8), seed=3)
    out = np.stack(
        [
            np.asarray(t)
            for t in SL.node(
                tuple(jnp.asarray(left[:, i]) for i in range(8)),
                tuple(jnp.asarray(right[:, i]) for i in range(8)),
                _TAB,
            )
        ],
        axis=1,
    )
    for i in (0, 9, 16):
        raw = left[i].astype(">u4").tobytes() + right[i].astype(">u4").tobytes()
        want = np.frombuffer(hashlib.sha256(raw).digest(), dtype=">u4")
        np.testing.assert_array_equal(out[i], want.astype(np.uint32))


def test_kernel_math_walk_matches_scan():
    """The lane walk == ops.merkle lax scan, at several traced depths."""
    max_depth, n = 6, 64
    leaves = _rand((n, 8), seed=8)
    sibs = _rand((max_depth * 8, n), seed=9)  # row = level * 8 + word
    idx = _rand((n,), seed=10) % (1 << max_depth)
    sibs_wt = sibs.reshape(max_depth, 8, n).transpose(2, 0, 1)
    walk = jax.jit(
        lambda cur, i, s, d: SL.walk(
            cur, i, d, lambda lvl: tuple(s[lvl * 8 + w] for w in range(8)),
            _TAB))
    for depth in (1, 4, max_depth):
        got = np.stack([np.asarray(t) for t in walk(
            tuple(jnp.asarray(leaves[:, i]) for i in range(8)),
            jnp.asarray(idx), jnp.asarray(sibs), jnp.int32(depth))], 1)
        want = np.asarray(merkle.compute_root(
            leaves, idx, sibs_wt[:, :depth]))
        np.testing.assert_array_equal(got, want, err_msg=f"depth {depth}")


# --------------------------------------------------------------------------
# The kernels, in the Pallas interpreter, against their plain XLA forms
# --------------------------------------------------------------------------

def _leafwalk_case(n_words, depth, m, seed):
    """Random lanes; every third lane's root is corrupted, the rest are
    the true roots, so `ok` takes both values."""
    ev = _rand((n_words, m, 128), seed)
    idx = _rand((1, m, 128), seed + 1) % (1 << depth)
    sibs = _rand((depth, 8, m, 128), seed + 2)
    leaf = sha256_words(jnp.moveaxis(jnp.asarray(ev), 0, -1))
    root = merkle.compute_root(
        leaf, jnp.asarray(idx[0]),
        jnp.moveaxis(jnp.asarray(sibs), (0, 1), (-2, -1)))
    root = np.array(jnp.moveaxis(root, -1, 0))
    root[0].reshape(-1)[::3] ^= 1
    return ev, idx, sibs, root


@pytest.mark.parametrize("n_words,depth", [(4, 5), (16, 3)])
def test_leafwalk_kernel_matches_reference(n_words, depth):
    args = _leafwalk_case(n_words, depth, 2, seed=20 + n_words)
    got = np.asarray(G.leafwalk(*args, n_words, depth))
    want = np.asarray(G.leafwalk_reference(*args, n_words, depth))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1, 2, 128)
    assert 0 < got.sum() < got.size  # both outcomes exercised


@pytest.mark.parametrize("depths", [(5, 3, 1), (2, 6, 4, 1)])
def test_fri_kernel_matches_reference(depths):
    """Random lanes with mixed per-layer depths (also not monotone)."""
    m, n_layers = 2, len(depths)
    rng = np.random.default_rng(sum(depths))
    u = lambda *s: rng.integers(0, 1 << 32, size=s, dtype=np.uint32)
    args = (u(1, m, 128) % (1 << (max(depths) + n_layers)),
            u(4, m, 128) % _P, u(n_layers, 4, m, 128) % _P,
            u(n_layers, m, 128) % _P, u(n_layers, 4, m, 128) % _P,
            u(sum(depths), 8, m, 128), u(n_layers, 8, m, 128))
    got = G.fri_layers(*args, depths)
    want = G.fri_reference(*args, depths)
    for name, g, w in zip(("ok", "folded", "q_out"), got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("platform,interpret", [
    ("gpu", False), ("cpu", True), ("metal", None), ("rocm", None)])
def test_kernel_dispatch_rule(monkeypatch, platform, interpret):
    """gpu compiles, cpu interprets, any other platform raises: no silent
    swap to the reference or to the interpreter."""
    monkeypatch.setattr(G.jax, "default_backend", lambda: platform)
    if interpret is None:
        with pytest.raises(NotImplementedError):
            G.interpret_mode()
    else:
        assert G.interpret_mode() is interpret


# --------------------------------------------------------------------------
# Natively-batched verify — backend-agnostic
# --------------------------------------------------------------------------

def test_batched_verify_equals_vmapped(fixtures_dir):
    """Natively-batched verify == vmapped verify, and tampering flips only
    the tampered lane."""
    from stark_symphony.models.stwo import proof as P
    from stark_symphony.models.stwo import verifier

    proof, cfg = P.load_json(str(fixtures_dir / "stwo/proof_test.json"))
    batch = P.replicate(proof, 3)
    batch.trace_evals[1, 0, 0] ^= 1
    results = {}
    for linkage in ("unfold", "reference"):
        native = np.asarray(verifier.verify_batch(batch, cfg, linkage=linkage))
        vmapped = np.asarray(
            verifier.verify_batch(batch, cfg, linkage=linkage, use_vmap=True)
        )
        np.testing.assert_array_equal(native, vmapped)
        results[linkage] = native
    # external fixtures verify under 'unfold' only (see verifier.py);
    # the tampered lane must be rejected, the untouched lanes accepted
    assert list(results["unfold"]) == [True, False, True]
