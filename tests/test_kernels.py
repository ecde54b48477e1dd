"""Pallas kernel tests (interpreter mode on the CPU mesh — SURVEY.md §5:
interpret-mode CI in place of the reference's never-run
compute-sanitizer)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpudct.kernels import hp_dct, hp_idct, hp_roundtrip, supports
from tests.golden import golden_dct, golden_idct


def _img(rng, h, w):
    return rng.integers(0, 256, size=(h, w)).astype(np.float32)


def test_supports():
    assert supports(128, 128) and supports(8, 256) and supports(256, 512)
    assert supports(128, 64) and supports(24, 40)  # any 8x8-aligned plane
    assert not supports(4, 128) and not supports(128, 12)


@pytest.mark.parametrize("shape", [(128, 128), (8, 128), (64, 256), (128, 512), (256, 384)])
def test_hp_dct_matches_golden(rng, shape):
    img = _img(rng, *shape)
    c = np.asarray(hp_dct(jnp.asarray(img), interpret=True))
    g = golden_dct(img)
    mismatches = int((c != g).sum())
    assert mismatches <= max(4, c.size // 200), mismatches  # half-boundary ties (see test_pipelines docstring)
    assert np.abs(c - g).max() <= 1.0


@pytest.mark.parametrize("shape", [(128, 128), (64, 256)])
def test_hp_idct_matches_golden(rng, shape):
    img = _img(rng, *shape)
    coeffs = golden_dct(img).astype(np.float32)
    r = np.asarray(hp_idct(jnp.asarray(coeffs), interpret=True))
    np.testing.assert_allclose(r, golden_idct(coeffs), atol=1e-2)


def test_hp_roundtrip_consistent_with_separate_calls(rng):
    img = _img(rng, 128, 256)
    c, r = hp_roundtrip(jnp.asarray(img), interpret=True)
    c2 = hp_dct(jnp.asarray(img), interpret=True)
    r2 = hp_idct(c2, interpret=True)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(c2))
    np.testing.assert_allclose(np.asarray(r), np.asarray(r2), atol=1e-4)


def test_hp_roundtrip_retention(rng):
    img = _img(rng, 128, 128)
    c, _ = hp_roundtrip(jnp.asarray(img), retain_k=2, interpret=True)
    c = np.asarray(c)
    # k=2 keeps only (0,0),(0,1),(1,0) per block.
    blocks = c.reshape(16, 8, 16, 8)
    for u in range(8):
        for v in range(8):
            if u + v >= 2:
                assert np.all(blocks[:, u, :, v] == 0)


def test_hp_tile_geometry_variants(rng):
    # Same result independent of band/tile decomposition.
    img = _img(rng, 256, 512)
    a = np.asarray(hp_dct(jnp.asarray(img), band_rows=128, tile_cols=512, interpret=True))
    b = np.asarray(hp_dct(jnp.asarray(img), band_rows=64, tile_cols=128, interpret=True))
    c = np.asarray(hp_dct(jnp.asarray(img), band_rows=256, tile_cols=256, interpret=True))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


# ---- u8/int8-native variants ------------------------------------------------

from tpudct.kernels import hp_encode_u8, hp_decode_u8, hp_roundtrip_u8, supports_u8


def test_supports_u8():
    assert supports_u8(128, 128) and supports_u8(32, 256)
    assert supports_u8(8, 128) and supports_u8(128, 64)  # masked edges
    assert not supports_u8(12, 128)
    assert not supports_u8(128, 128, q_scale=0.5)  # coeffs would overflow int8


def test_u8_roundtrip_matches_f32_path(rng):
    img = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    c8, r8 = hp_roundtrip_u8(jnp.asarray(img), interpret=True)
    cf, rf = hp_roundtrip(jnp.asarray(img, jnp.float32), interpret=True, int_core=True)
    assert np.asarray(c8).dtype == np.int8 and np.asarray(r8).dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(c8).astype(np.float32), np.asarray(cf))
    rf_u8 = np.clip(np.trunc(np.asarray(rf)), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(r8), rf_u8)


def test_u8_encode_decode_separate(rng):
    img = rng.integers(0, 256, (64, 128)).astype(np.uint8)
    c = hp_encode_u8(jnp.asarray(img), interpret=True)
    r = hp_decode_u8(c, interpret=True)
    c2, r2 = hp_roundtrip_u8(jnp.asarray(img), interpret=True)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(r), np.asarray(r2))


def test_int_core_vs_f32_core_ties_only(rng):
    img = rng.integers(0, 256, (128, 128)).astype(np.float32)
    ci = np.asarray(hp_dct(jnp.asarray(img), interpret=True, int_core=True))
    cf = np.asarray(hp_dct(jnp.asarray(img), interpret=True, int_core=False))
    mm = int((ci != cf).sum())
    assert mm <= ci.size * 5e-3 and np.abs(ci - cf).max() <= 1.0, mm


def test_u8_retention(rng):
    img = rng.integers(0, 256, (64, 128)).astype(np.uint8)
    c, _ = hp_roundtrip_u8(jnp.asarray(img), retain_k=2, interpret=True)
    blocks = np.asarray(c).reshape(8, 8, 16, 8)
    for u in range(8):
        for v in range(8):
            if u + v >= 2:
                assert np.all(blocks[:, u, :, v] == 0)


def test_decode_precision_high_tier(rng):
    # bf16x3 serving tier: bounded deviation from the HIGHEST path.
    img = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    _, r_hi = hp_roundtrip_u8(jnp.asarray(img), interpret=True, decode_precision="highest")
    _, r_h = hp_roundtrip_u8(jnp.asarray(img), interpret=True, decode_precision="high")
    d = np.abs(np.asarray(r_hi).astype(int) - np.asarray(r_h).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 2e-3


@pytest.mark.parametrize("shape", [(128, 128), (64, 256), (256, 384)])
def test_butterfly_idct_matches_golden(rng, shape):
    # The VPU add/shift butterfly inverse: every product is x0/+-1/+-2
    # (exact in f32), so it must sit at least as close to the f64 golden
    # as the f32-HIGHEST matmul path.
    img = _img(rng, *shape)
    coeffs = golden_dct(img).astype(np.float32)
    r_bf = np.asarray(
        hp_idct(jnp.asarray(coeffs), interpret=True, decode_precision="butterfly")
    )
    g = golden_idct(coeffs)
    assert np.abs(r_bf - g).max() <= 1e-3


def test_butterfly_roundtrip_consistency(rng):
    img = _img(rng, 128, 256)
    c_hi, _ = hp_roundtrip(jnp.asarray(img), interpret=True, decode_precision="highest")
    c_bf, r_bf = hp_roundtrip(
        jnp.asarray(img), interpret=True, decode_precision="butterfly"
    )
    np.testing.assert_array_equal(np.asarray(c_hi), np.asarray(c_bf))
    r2 = hp_idct(c_bf, interpret=True, decode_precision="butterfly")
    np.testing.assert_allclose(np.asarray(r_bf), np.asarray(r2), atol=1e-4)


def test_butterfly_u8_paths(rng):
    img = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    c_hi, r_hi = hp_roundtrip_u8(jnp.asarray(img), interpret=True, decode_precision="highest")
    c_bf, r_bf = hp_roundtrip_u8(
        jnp.asarray(img), interpret=True, decode_precision="butterfly"
    )
    np.testing.assert_array_equal(np.asarray(c_hi), np.asarray(c_bf))
    # f32-exact adds: reconstruction may differ from HIGHEST only at
    # truncation boundaries, by at most 1 gray level on a vanishing fraction.
    d = np.abs(np.asarray(r_hi).astype(int) - np.asarray(r_bf).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    r_dec = hp_decode_u8(c_bf, interpret=True, decode_precision="butterfly")
    np.testing.assert_array_equal(np.asarray(r_dec), np.asarray(r_bf))


def test_butterfly_f32_core(rng):
    img = _img(rng, 64, 128)
    c, r = hp_roundtrip(
        jnp.asarray(img), interpret=True, int_core=False,
        decode_precision="butterfly",
    )
    np.testing.assert_allclose(
        np.asarray(r), golden_idct(np.asarray(c)), atol=1e-3
    )


def test_decode_precision_validates():
    import pytest as _pytest

    img = jnp.zeros((32, 128), jnp.uint8)
    with _pytest.raises(ValueError):
        hp_roundtrip_u8(img, interpret=True, decode_precision="fast")


def test_truncless_round_identity():
    """The encode rounds by adding +-0.5 and letting the f32->int convert
    truncate toward zero (hp_pallas._round_away).  Prove the
    identity densely across the representable coefficient range, including
    exact .5 boundaries and signed zeros."""
    z = np.concatenate([
        np.arange(-127.5, 128.0, 0.25, dtype=np.float32),
        np.array([-0.5, -0.0, 0.0, 0.5], np.float32),
    ])
    from tpudct.kernels.hp_pallas import _round_away

    zj = jnp.asarray(z) + jnp.copysign(jnp.float32(0.5), jnp.asarray(z))
    np.testing.assert_array_equal(
        np.asarray(jnp.trunc(zj).astype(jnp.int32)),
        np.asarray(_round_away(jnp.asarray(z))),
    )


def test_encode_u8_matches_roundtrip_coeffs(rng):
    """hp_encode_u8 must agree bit-for-bit with the fused roundtrip's
    coefficients — the interpret-mode twin of chip_smoke.py's split-path
    check, across q_scales that land products on .5 quantizer
    boundaries."""
    img = rng.integers(0, 256, (64, 256)).astype(np.uint8)
    for q_scale in (1.0, 1.25, 2.0):
        c_enc = hp_encode_u8(jnp.asarray(img), q_scale=q_scale, interpret=True)
        c_rt, _ = hp_roundtrip_u8(jnp.asarray(img), q_scale=q_scale, interpret=True)
        np.testing.assert_array_equal(np.asarray(c_enc), np.asarray(c_rt))
