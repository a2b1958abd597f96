"""stwo channel golden-transcript tests (vectors from
/root/reference/stwo-verifier/src/{channel,pow,evals/commit,fri/commit,
fri/queries,deep/oods}.simf test functions)."""

import jax
import jax.numpy as jnp
import numpy as np

from stark_symphony.models.stwo import channel as ch
from stark_symphony.ops.u32 import byte_swap32, lt64
from stark_symphony.utils.packing import u256_to_words


def qm(a, b, c, d):
    return np.array([a, b, c, d], np.uint32)


def test_draw_qm31_golden():
    # channel.simf:176-186
    state = ch.init()
    state, v1, ok1 = ch.draw_qm31(state)
    np.testing.assert_array_equal(
        np.asarray(v1), qm(1840668629, 533944055, 1922121815, 459001195)
    )
    state, v2, ok2 = ch.draw_qm31(state)
    np.testing.assert_array_equal(
        np.asarray(v2), qm(559458448, 1834888235, 1610726090, 1135320235)
    )
    assert bool(ok1) and bool(ok2)


def test_draw_qm31_point_golden():
    # channel.simf:188-194
    state = ch.init()
    state, p, ok = ch.draw_qm31_point(state)
    np.testing.assert_array_equal(
        np.asarray(p[0]), qm(877266510, 837585062, 67369234, 641637369)
    )
    np.testing.assert_array_equal(
        np.asarray(p[1]), qm(1140140443, 711987229, 851311779, 496972972)
    )


def test_draw_queries_golden():
    # fri/queries.simf:60-72: mask 63
    state = ch.ChannelState(
        jnp.asarray(u256_to_words(
            0x733DFCCEC28657E75A61A34954FA6D0C8915E3ADBCF40C765B4EAA488DB84902)),
        jnp.uint32(0),
    )
    state, queries = ch.draw_queries(state, 8, 6)
    np.testing.assert_array_equal(
        np.asarray(queries), [45, 54, 34, 10, 13, 7, 12, 47]
    )


def test_pow_golden():
    # pow.simf:44-50
    state = ch.ChannelState(
        jnp.asarray(u256_to_words(
            0xA906ADFE1AC2B7CF283AE8A11E16A1C4C44834F259056EACD36D14044761266C)),
        jnp.uint32(0),
    )
    state = ch.mix_u64(state, jnp.uint32(0), jnp.uint32(57))
    want = 0x2B43649271B97D2EAEB7F037B1D23AD2FD06E6546BC512BB0EEC27C7F24B2105
    np.testing.assert_array_equal(np.asarray(state.digest), u256_to_words(want))
    # 5-bit PoW check passes for this digest
    hi = byte_swap32(state.digest[7])
    lo = byte_swap32(state.digest[6])
    target = (1 << 59) - 1
    assert bool(lt64(hi, lo, jnp.uint32(target >> 32), jnp.uint32(target & 0xFFFFFFFF)))


def test_evals_commit_golden():
    # evals/commit.simf:39-49
    state = ch.init()
    state = ch.mix_root(state, jnp.asarray(u256_to_words(
        0xE3B0C44298FC1C149AFBF4C8996FB92427AE41E4649B934CA495991B7852B855)))
    state = ch.mix_root(state, jnp.asarray(u256_to_words(
        0x2151E980C7AE914E9B486E36B8392DB505E1848BD7DCC89329245C61CDB95096)))
    state, coeff, ok = ch.draw_qm31(state)
    state = ch.mix_root(state, jnp.asarray(u256_to_words(
        0xE85DEB2EAADB5E5376CE81FFB6EE36EAB838C2A97686F83D5DE609BA03845E0C)))
    np.testing.assert_array_equal(
        np.asarray(coeff), qm(2012724549, 1128459570, 1584582850, 1454574268)
    )
    want = 0x94642214378090859916AF45C596713B6D8ABAA2C72F3ED8AD41F869AD35491B
    np.testing.assert_array_equal(np.asarray(state.digest), u256_to_words(want))


def test_fri_commit_golden():
    # fri/commit.simf:89-105
    state = ch.ChannelState(
        jnp.asarray(u256_to_words(
            0x44DFF4EFFAE0BE493C21672683C892B3BAEAA7D251E5E7153BC0E0B2DA8A9D96)),
        jnp.uint32(0),
    )
    state = ch.mix_root(state, jnp.asarray(u256_to_words(
        0x768A89291D8DB4BE401F5545F1CC7F25A1B00753773A4B3789592BADC33ECF3F)))
    state, alpha, _ = ch.draw_qm31(state)
    np.testing.assert_array_equal(
        np.asarray(alpha), qm(299390734, 1867715474, 641071780, 899293580)
    )
    for root in [
        0x3F2A2CB1B0384B1DDD57C16BB40B67A0B011C1449606196E959FDBFF885A0280,
        0xB03EEDEDD1682FCAB8C82D0D284CCF0F8DDC7D003708ECD12323ADFD843F0F5F,
    ]:
        state = ch.mix_root(state, jnp.asarray(u256_to_words(root)))
        state, _, _ = ch.draw_qm31(state)
    state = ch.mix_words(
        state,
        jnp.asarray(qm(1462473176, 2065988908, 1080482792, 1497677558)),
    )
    want = 0xA906ADFE1AC2B7CF283AE8A11E16A1C4C44834F259056EACD36D14044761266C
    np.testing.assert_array_equal(np.asarray(state.digest), u256_to_words(want))


def test_batched_channel_matches_scalar():
    state = ch.init((5,))
    state, vals, ok = ch.draw_qm31(state)
    s0 = ch.init()
    _, v0, _ = ch.draw_qm31(s0)
    for i in range(5):
        np.testing.assert_array_equal(np.asarray(vals[i]), np.asarray(v0))
