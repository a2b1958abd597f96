"""Merkle path + circle geometry tests against reference golden vectors."""

import jax
import jax.numpy as jnp
import numpy as np

from stark_symphony.ops import circle as C
from stark_symphony.ops import merkle as M
from stark_symphony.ops import sha256 as S
from stark_symphony.ops.u32 import bit_reverse
from stark_symphony.utils.packing import u256_to_words


def test_merkle_golden_small():
    # merkle.simf test_merkle: depth-2 proof, auth_path=4 -> leaf index 0
    root = jnp.asarray(u256_to_words(
        0x875EF7B0A28899D85920FA5586628C27DD7F3CA3D221EE018EE34FC5D758A477))
    leaf = S.sha256_words(jnp.zeros((8,), jnp.uint32))
    sibs = jnp.stack([
        jnp.asarray(u256_to_words(
            0xA665A45920422F9D417E4867EFDC4FB8A04A1F3FFF1FA07E998E86F7F7A27AE3)),
        jnp.asarray(u256_to_words(
            0x114BD151F8FB0C58642D2170DA4AE7D7C57977260AC2CC8905306CAB6B2ACABC)),
    ])
    assert bool(M.verify_path(leaf, jnp.uint32(0), sibs, root))


def test_merkle_golden_depth13():
    # merkle.simf test_decommitment: leaf sha256_32(2915689030) @ 365 of 8192
    root = jnp.asarray(u256_to_words(
        104500214297066916133126671825692285761566746556879834723302550549120383229768))
    leaf = S.sha256_words(jnp.asarray(np.array([2915689030], np.uint32)))
    proof_ints = [
        40002981752987147694309380063602322877192470823891740405244967830358421330165,
        68230051127233951163966464088993224369415563839403172920771929824688376897836,
        44367194844377689594601408886911285881450064458724818845992887113201531757121,
        60552900297880916965024681698561373284576136923986771043513996698868811233985,
        79218389783070783756683999973685334738468089983346892627711616664675847169649,
        86056786573167414412681166168252960406880608123124193289687215839010289393365,
        42453213914905194455440404069578264192574453344270898367924206751883339264593,
        100519484132498123993280827552597641444767528842124397297226835189343039225855,
        30418746830344061354082449665096536031982034761593207228745631004087660418979,
        94840054322059291530750321008166965053871351749658110562305809404250112199706,
        42301955221152678394190333573390831727995145343891343924222537015244996575494,
        68599396864515883651939550638527607595242626780681277342646949156789742939178,
        56974666195930694403713290580441264812544914556973432228768127355537336583012,
    ]
    sibs = jnp.stack([jnp.asarray(u256_to_words(x)) for x in proof_ints])
    assert bool(M.verify_path(leaf, jnp.uint32(365), sibs, root))
    # tampered leaf index fails
    assert not bool(M.verify_path(leaf, jnp.uint32(366), sibs, root))


def test_build_and_gather_roundtrip():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2**31, (64,), dtype=np.uint64).astype(np.uint32)
    leaves = S.sha256_words(jnp.asarray(vals)[:, None])
    levels = M.build_tree(leaves)
    root = levels[-1][0]
    idx = jnp.asarray(np.arange(64, dtype=np.uint32))
    sibs = jax.vmap(lambda i: M.gather_path(levels, i))(idx)
    ok = M.verify_path(leaves, idx, sibs, root)
    assert bool(np.asarray(ok).all())


class TestCircle:
    def test_point_add_golden(self):
        # m31_point.simf:137-142
        p1 = jnp.asarray(np.array([750649172, 1991648574], np.uint32))
        p2 = jnp.asarray(np.array([1737427771, 309481134], np.uint32))
        out = C.point_add(p1, p2)
        np.testing.assert_array_equal(np.asarray(out), [1476625263, 1040927458])

    def test_point_dbl_golden(self):
        # m31_point.simf:158-163: dbl(gen) = (7, 777079998)
        out = C.point_dbl(jnp.asarray(np.array([2, 1268011823], np.uint32)))
        np.testing.assert_array_equal(np.asarray(out), [7, 777079998])

    def test_index_to_point_golden(self):
        # m31_point.simf:165-170: index 1389 -> (1670284485, 627279409)
        out = C.point_from_index(jnp.uint32(1389))
        np.testing.assert_array_equal(np.asarray(out), [1670284485, 627279409])

    def test_bit_reverse_golden(self):
        # coset.simf:57-62: reverse(15, 11 bits) = 1920
        assert int(bit_reverse(jnp.uint32(15), 11)) == 1920

    def test_index_ops_golden(self):
        # coset.simf:64-82
        assert int(C.index_add(jnp.uint32(1389), jnp.uint32(1390))) == 2779
        assert int(C.index_mul(jnp.uint32(1389), jnp.uint32(123))) == 170847
        assert int(C.index_neg(jnp.uint32(1389))) == 2147482259

    def test_circle_domain_golden(self):
        # circle_domain.simf:47-68
        d = C.CircleDomain(11)
        assert (d.half_size, d.offset, d.step) == (1024, 524288, 2097152)
        assert int(C.circle_position_to_index(d, jnp.uint32(1133))) == 1918369792
        assert int(C.circle_position_to_index(d, jnp.uint32(201))) == 422051840

    def test_vanishing_poly_golden(self):
        # composition_poly.simf:90-100
        from stark_symphony.ops.field import qm31_scalar

        point = jnp.stack([
            qm31_scalar(853359656, 1678958373, 358478267, 760744889),
            qm31_scalar(23994856, 240802263, 189516568, 1941571865),
        ], axis=-2)
        out = C.vanishing_poly_eval(2, point)
        np.testing.assert_array_equal(
            np.asarray(out), [1577521274, 883254348, 2004066876, 1290622108]
        )
