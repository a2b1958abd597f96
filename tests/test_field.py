"""Field-layer tests: random cross-checks vs Python bigints + reference
golden vectors (cited from /root/reference/stwo-verifier/src/fields/*.simf
and /root/reference/stark101/src/field.simf test functions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stark_symphony.ops import field as F
from stark_symphony.ops import field101 as F1

P = F.P
Q = F1.Q


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


class TestM31:
    def test_mul_random(self, rng):
        a = rng.integers(0, P, 4096).astype(np.uint32)
        b = rng.integers(0, P, 4096).astype(np.uint32)
        got = np.asarray(jax.jit(F.m31_mul)(a, b))
        want = (a.astype(np.uint64) * b) % P
        np.testing.assert_array_equal(got, want)

    def test_add_sub(self, rng):
        a = rng.integers(0, P, 4096).astype(np.uint32)
        b = rng.integers(0, P, 4096).astype(np.uint32)
        np.testing.assert_array_equal(
            np.asarray(jax.jit(F.m31_add)(a, b)), (a.astype(np.uint64) + b) % P
        )
        np.testing.assert_array_equal(
            np.asarray(jax.jit(F.m31_sub)(a, b)),
            (a.astype(np.int64) - b) % P,
        )

    def test_golden_add(self):
        # m31.simf:150-162
        assert int(F.m31_add(jnp.uint32(2147483646), jnp.uint32(1))) == 0
        assert int(F.m31_sub(jnp.uint32(0), jnp.uint32(1))) == 2147483646

    def test_inv(self, rng):
        a = rng.integers(1, P, 2048).astype(np.uint32)
        inv = np.asarray(jax.jit(F.m31_inv)(a))
        assert ((inv.astype(np.object_) * a) % P == 1).all()

    def test_reduce_full_range(self, rng):
        x = rng.integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)
        got = np.asarray(jax.jit(F.m31_reduce)(x))
        np.testing.assert_array_equal(got, x.astype(np.uint64) % P)


class TestCM31:
    def test_golden_mul(self):
        # cm31.simf:134-139: (1,2)*(5,6) = (2147483640, 16)
        c = F.cm31_mul(F.cm31(jnp.uint32(1), jnp.uint32(2)),
                       F.cm31(jnp.uint32(5), jnp.uint32(6)))
        np.testing.assert_array_equal(np.asarray(c), [2147483640, 16])

    def test_golden_mul2(self):
        # cm31.simf:141-147: ((3,4)*(7,8))*(2,1) = (2147483573, 93)
        d = F.cm31_mul(
            F.cm31_mul(F.cm31(jnp.uint32(3), jnp.uint32(4)),
                       F.cm31(jnp.uint32(7), jnp.uint32(8))),
            F.cm31(jnp.uint32(2), jnp.uint32(1)),
        )
        np.testing.assert_array_equal(np.asarray(d), [2147483573, 93])

    def test_inv(self):
        cm = F.cm31(jnp.uint32(1), jnp.uint32(2))
        out = F.cm31_mul(cm, F.cm31_inv(cm))
        np.testing.assert_array_equal(np.asarray(out), [1, 0])

    def test_golden_div(self):
        # cm31.simf:149-154
        a = F.cm31(jnp.uint32(2147483641), jnp.uint32(13))
        b = F.cm31(jnp.uint32(4), jnp.uint32(5))
        c = F.cm31_mul(a, F.cm31_inv(b))
        np.testing.assert_array_equal(np.asarray(c), [1, 2])


class TestQM31:
    def test_golden_mul(self):
        # qm31.simf:186-192: (1,2,3,4)*(4,5,6,7)
        c = F.qm31_mul(F.qm31_scalar(1, 2, 3, 4), F.qm31_scalar(4, 5, 6, 7))
        np.testing.assert_array_equal(
            np.asarray(c), [2147483576, 93, 2147483631, 50]
        )

    def test_inv(self):
        a = F.qm31_scalar(1, 2, 3, 4)
        np.testing.assert_array_equal(
            np.asarray(F.qm31_mul(a, F.qm31_inv(a))), [1, 0, 0, 0]
        )

    def test_batch_inv(self, rng):
        a = rng.integers(0, P, (256, 4)).astype(np.uint32)
        inv = jax.jit(F.qm31_inv)(a)
        out = np.asarray(jax.jit(F.qm31_mul)(a, inv))
        np.testing.assert_array_equal(
            out, np.broadcast_to([1, 0, 0, 0], out.shape)
        )


class TestField101:
    def test_mul_random(self, rng):
        a = rng.integers(0, Q, 4096, dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, Q, 4096, dtype=np.uint64).astype(np.uint32)
        got = np.asarray(jax.jit(F1.f_mul)(a, b)).astype(np.object_)
        want = (a.astype(np.object_) * b) % Q
        np.testing.assert_array_equal(got, want)

    def test_golden_mul(self):
        # field.simf:121-133
        assert int(F1.f_mul(jnp.uint32(56756), jnp.uint32(56756))) == 18063
        assert (
            int(F1.f_mul(jnp.uint32(1734477367), jnp.uint32(1033050121)))
            == 510964216
        )

    def test_golden_div(self):
        # field.simf:143-148: 2915689029 / 1944025131 = 3199116755
        got = F1.f_div(jnp.uint32(2915689029), jnp.uint32(1944025131))
        assert int(got) == 3199116755

    def test_golden_exp(self):
        # field.simf:150-162
        assert int(F1.f_pow(jnp.uint32(2), 32)) == 1073741823
        assert int(F1.f_pow(jnp.uint32(1734477367), 365)) == 1033050121

    def test_add_wraparound(self, rng):
        a = rng.integers(0, Q, 4096, dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, Q, 4096, dtype=np.uint64).astype(np.uint32)
        got = np.asarray(jax.jit(F1.f_add)(a, b)).astype(np.object_)
        np.testing.assert_array_equal(got, (a.astype(np.object_) + b) % Q)

    def test_inv(self, rng):
        a = rng.integers(1, Q, 1024, dtype=np.uint64).astype(np.uint32)
        inv = np.asarray(jax.jit(F1.f_inv)(a))
        assert ((inv.astype(np.object_) * a) % Q == 1).all()

    def test_mod_words_golden(self):
        # stark101/src/channel.simf:109-114 draw test: state % 8193 == 365
        from stark_symphony.utils.packing import u256_to_words

        st = 53741377836084766287364085417998971256852254673610164556110591250061061441088
        w = jnp.asarray(u256_to_words(st))
        assert int(F1.mod_words_be(w, 8193)) == 365
        assert int(F1.mod_words_be(w, 8192)) == st % 8192
        assert int(F1.mod_words_be(w, Q)) == st % Q


def test_overflow_checks_debug_mode(monkeypatch):
    """STPU_CHECK=1 asserts canonical inputs (ops/checks.py); default mode
    adds no checks (zero-overhead: trace-time branch)."""
    import numpy as np

    from stark_symphony.ops import field as F
    from stark_symphony.ops import field101 as F101

    monkeypatch.delenv("STPU_CHECK", raising=False)
    # non-canonical input passes silently when checks are off
    F.m31_add(np.uint32(0x7FFFFFFF), np.uint32(1))

    monkeypatch.setenv("STPU_CHECK", "1")
    import pytest

    with pytest.raises(FloatingPointError, match="m31_add"):
        F.m31_add(np.uint32(0x7FFFFFFF), np.uint32(1))  # lhs == p
    with pytest.raises(FloatingPointError, match="m31_mul"):
        F.m31_mul(np.uint32(0xFFFFFFFF), np.uint32(2))
    with pytest.raises(FloatingPointError, match="f_add"):
        F101.f_add(np.uint32(0xFFFFFFFF), np.uint32(1))
    # canonical inputs still work with checks on
    assert int(np.asarray(F.m31_add(np.uint32(5), np.uint32(6)))) == 11
    assert int(np.asarray(F101.f_add(np.uint32(5), np.uint32(6)))) == 11
