"""Fractional-scale decode (ops/scaled.py, the djpeg -scale M/8 analog).

The contract under test: a 1/f scaled decode equals the FULL inverse
followed by an f x f box-filter average — per block,
P (T^T Yd T + 128) P^T == (P T^T) Yd (P T^T)^T + 128.  The reference
always reconstructs at full size (main_newAppr.cu:220-250); scaled
decode has no reference analog beyond the DC preview endpoint.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpudct.config import CodecConfig
from tpudct.models import get_pipeline
from tpudct.models.color import (
    decode_color,
    decode_color_scaled,
    encode_color,
)
from tpudct.ops.scaled import (
    FACTORS,
    pool_matrix,
    scaled_basis,
    scaled_decode,
    scaled_shape,
)
from tpudct.ops.transform import to_uint8
from tpudct.utils import serialize


def _box_pool(x, f):
    h, w = x.shape
    return np.asarray(x, np.float64).reshape(h // f, f, w // f, f).mean(
        axis=(1, 3)
    )


def test_pool_matrix_rows_sum_to_one():
    for f in FACTORS:
        p = pool_matrix(f)
        assert p.shape == (8 // f, 8)
        np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-7)


def test_pool_matrix_rejects_bad_factor():
    with pytest.raises(ValueError):
        pool_matrix(3)


def test_factor_one_basis_is_full_inverse():
    from tpudct.constants import get_transform

    b = scaled_basis(1, "haweel")
    np.testing.assert_allclose(
        b, get_transform("haweel").t.T.astype(np.float32), atol=1e-7
    )


# Shapes cover the lane-width sweep (multiples of 128), the 8-wide
# fallback, and the mixed case (one axis each).
@pytest.mark.parametrize("shape", [(128, 128), (40, 56), (128, 72)])
@pytest.mark.parametrize("transform", ["haweel", "dct", "wht"])
def test_scaled_equals_pooled_full_decode(rng, shape, transform):
    img = rng.integers(0, 256, shape).astype(np.float32)
    cfg = CodecConfig(q_scale=1.0, transform=transform)
    p = get_pipeline("batched")
    c = p.encode(jnp.asarray(img), cfg)
    full = np.asarray(p.idct(c, cfg))
    for f in FACTORS:
        s = np.asarray(scaled_decode(c, cfg, f))
        assert s.shape == (shape[0] // f, shape[1] // f)
        np.testing.assert_allclose(s, _box_pool(full, f), atol=1e-3)


def test_anisotropic_factors(rng):
    img = rng.integers(0, 256, (64, 64)).astype(np.float32)
    cfg = CodecConfig(q_scale=1.0)
    p = get_pipeline("batched")
    c = p.encode(jnp.asarray(img), cfg)
    full = np.asarray(p.idct(c, cfg), np.float64)
    s = np.asarray(scaled_decode(c, cfg, 2, f_cols=4))
    ref = full.reshape(32, 2, 16, 4).mean(axis=(1, 3))
    assert s.shape == (32, 16)
    np.testing.assert_allclose(s, ref, atol=1e-3)


def test_scale_eighth_matches_dc_preview(rng, tmp_path):
    """The f=8 endpoint must agree with the DC-only preview: for a
    flat-DC-row orthogonal T the other basis rows sum to zero, so the
    block box-average IS the preview's DC formula."""
    img = rng.integers(0, 256, (48, 80)).astype(np.float32)
    cfg = CodecConfig(q_scale=1.0)
    p = get_pipeline("batched")
    c = np.asarray(p.encode(jnp.asarray(img), cfg))
    data = serialize.coefficients_to_bytes(
        c, cfg.q_scale, orig_shape=img.shape, transform=cfg.transform,
        codec="spectral",  # prefix-decodable (any codec previews now)
    )
    pv = serialize.preview_from_bytes(data)
    s = np.asarray(to_uint8(scaled_decode(jnp.asarray(c), cfg, 8)))
    assert s.shape == pv.shape
    # identical math, different summation order: both trunc to u8, so a
    # value epsilon-below an integer may land 1 apart
    assert np.abs(s.astype(int) - pv.astype(int)).max() <= 1


def test_scaled_shape_ceil():
    assert scaled_shape(64, 8) == 8
    assert scaled_shape(65, 8) == 9
    assert scaled_shape(63, 2) == 32


@pytest.mark.parametrize("mode", ["420", "422", "444"])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_color_scaled_decode(rng, mode, factor):
    """Scaled color decode is the pooled unclipped float reconstruction;
    a smooth in-gamut gradient keeps RGB clipping out of the comparison
    so the u8 outputs agree to rounding."""
    h, w = 80, 96
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack(
        [64 + yy, 64 + xx, 64 + (yy + xx) / 2], axis=-1
    ) * (128.0 / (h + w))
    rgb = np.clip(rgb + 64, 0, 255).astype(np.float32)
    p = get_pipeline("batched")
    cfg = CodecConfig(q_scale=1.0)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg, subsample=mode)
    full = np.asarray(decode_color(p, planes, meta, cfg)).astype(np.float64)
    s = np.asarray(decode_color_scaled(p, planes, meta, cfg, factor))
    assert s.shape == (h // factor, w // factor, 3)
    ref = full.reshape(
        h // factor, factor, w // factor, factor, 3
    ).mean(axis=(1, 3))
    # full path rounds to u8 BEFORE the pool; in-gamut that is < 1 apart
    assert np.abs(s.astype(np.float64) - ref).max() <= 1.5


def test_color_scaled_factor_one_is_full_decode(rng):
    rgb = rng.integers(0, 256, (40, 40, 3)).astype(np.float32)
    p = get_pipeline("batched")
    cfg = CodecConfig(q_scale=1.0)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg, subsample="420")
    full = np.asarray(decode_color(p, planes, meta, cfg))
    s = np.asarray(decode_color_scaled(p, planes, meta, cfg, 1))
    np.testing.assert_array_equal(s, full)


# ---- CLI surface -----------------------------------------------------------


def test_cli_decode_scale_gray(rng, tmp_path):
    from tpudct.cli import main
    from tpudct.utils import imageio

    img = rng.integers(0, 256, (72, 104)).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_image(src, img)
    tdc = tmp_path / "c.tdc"
    assert main(["encode", "--pipeline", "batched", str(src), str(tdc)]) == 0
    out = tmp_path / "quarter.png"
    assert main(["decode", "--scale", "1/4", str(tdc), str(out)]) == 0
    dec = imageio.load_image(out)
    assert dec.shape == (18, 26)  # ceil(72/4), ceil(104/4)


def test_cli_decode_scale_color(rng, tmp_path):
    from tpudct.cli import main
    from tpudct.utils import imageio

    rgb = rng.integers(0, 256, (64, 48, 3)).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_image(src, rgb)
    tdcc = tmp_path / "c.tdcc"
    assert main(["encode", "--color", "--pipeline", "batched",
                 str(src), str(tdcc)]) == 0
    out = tmp_path / "half.png"
    assert main(["decode", "--scale", "1/2", str(tdcc), str(out)]) == 0
    dec = imageio.load_image(out, force_gray=False)
    assert dec.shape == (32, 24, 3)


def test_cli_scale_rejects_combinations(rng, tmp_path):
    from tpudct.cli import main
    from tpudct.utils import imageio

    img = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_image(src, img)
    tdc = tmp_path / "c.tdc"
    assert main(["encode", "--pipeline", "batched", str(src), str(tdc)]) == 0
    out = tmp_path / "o.png"
    assert main(["decode", "--scale", "1/2", "--rows", "0:8",
                 str(tdc), str(out)]) != 0


# ---- djpeg drop-in: decode works straight on .jpg inputs -------------------

from tpudct.utils import jpegcoef  # noqa: E402

_needs_native = pytest.mark.skipif(
    not jpegcoef.coef_io_available(),
    reason="coefficient-level libjpeg access needs the native library",
)


@_needs_native
def test_cli_decode_jpg_input_gray(rng, tmp_path, capsys):
    from tpudct.cli import main
    from tpudct.utils import imageio

    img = (rng.integers(0, 9, (64, 96)) * 28).astype(np.uint8)
    src = tmp_path / "in.jpg"
    imageio.save_jpeg(src, img, quality=95)
    out = tmp_path / "full.png"
    assert main(["decode", str(src), str(out)]) == 0
    dec = imageio.load_image(out)
    assert dec.shape == (64, 96)
    # our IDCT of libjpeg's own coefficients: within a couple of gray
    # levels of the (lossy-compressed) source
    ref = imageio.load_jpeg(src)
    assert np.abs(dec.astype(int) - ref.astype(int)).max() <= 2
    # the user-facing message names the .jpg, not the internal temp file
    assert "in.jpg" in capsys.readouterr().out

    q = tmp_path / "q.png"
    assert main(["decode", "--scale", "1/4", str(src), str(q)]) == 0
    assert imageio.load_image(q).shape == (16, 24)


@_needs_native
def test_cli_decode_jpg_input_color(rng, tmp_path):
    from tpudct.cli import main
    from tpudct.utils import imageio

    rgb = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    src = tmp_path / "in.jpg"
    imageio.save_image(src, rgb, quality=95)
    out = tmp_path / "half.png"
    assert main(["decode", "--scale", "1/2", str(src), str(out)]) == 0
    assert imageio.load_image(out, force_gray=False).shape == (24, 32, 3)


@_needs_native
def test_cli_decode_jpg_input_preview(rng, tmp_path):
    from tpudct.cli import main
    from tpudct.utils import imageio

    img = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    src = tmp_path / "in.jpg"
    imageio.save_jpeg(src, img, quality=95)
    out = tmp_path / "pv.png"
    assert main(["decode", "--preview", str(src), str(out)]) == 0
    assert imageio.load_image(out).shape == (8, 8)


def test_scaled_decode_u8_fast_path(rng):
    """Fast-path scaled decode (fused int8 full decode + exact integer box
    pool): bit-deterministic vs its own contract (pool of the ROUNDED
    full decode), and within the documented sub-LSB delta of the f32
    einsum path."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.ops.scaled import box_pool_u8, scaled_decode, scaled_decode_u8

    p = get_pipeline("hp")
    cfg = CodecConfig()
    # natural-statistics content: the contract delta vs the f32 path is
    # clamping of [0,255]-overshoots, absent on smooth images (on noise
    # content it reaches the overshoot magnitude — documented)
    yy, xx = np.mgrid[0:64, 0:256].astype(np.float32)
    img = np.clip(128 + 80 * np.sin(yy / 9) * np.cos(xx / 13), 10, 245).astype(np.uint8)
    c = p.encode_u8(jnp.asarray(img), cfg)
    for f in (2, 4, 8):
        fast = np.asarray(scaled_decode_u8(p, c, cfg, f))
        # contract: exactly the box average of the clamped+rounded decode
        ref_pool = np.asarray(box_pool_u8(p.decode_u8(c, cfg), f))
        np.testing.assert_array_equal(fast, ref_pool)
        # within 1 LSB of the f32 contract where nothing clips (the
        # codec's u8 conversion is the reference-faithful C truncation,
        # so each pooled pixel sits up to 1.0 below the f32 value)
        f32_path = np.asarray(scaled_decode(jnp.asarray(c, jnp.float32), cfg, f))
        d = fast - f32_path
        assert d.max() <= 0.01 and d.min() >= -1.0, (f, d.min(), d.max())


def test_box_pool_u8_exactness(rng):
    from tpudct.ops.scaled import box_pool_u8

    x = rng.integers(0, 256, (32, 64), dtype=np.uint8)
    for fr, fc in ((2, 2), (4, 2), (8, 8), (1, 4)):
        got = np.asarray(box_pool_u8(x, fr, fc))
        ref = x.astype(np.float64).reshape(
            32 // fr, fr, 64 // fc, fc
        ).mean(axis=(1, 3))
        np.testing.assert_allclose(got, ref, atol=0)  # integer-exact


def test_cli_scale_fast_path_engages(tmp_path, capsys):
    """decode --scale rides the u8 fast path for eligible streams — either
    the fused scaled kernel or the composed decode_u8 + pool (spied on
    both) — and produces the right geometry."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.cli import main
    from tpudct.kernels import hp_pallas
    from tpudct.utils import imageio, serialize

    img = (np.random.default_rng(9).integers(0, 256, (100, 130))).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_image(src, img)
    tdc = tmp_path / "x.tdc"
    out = tmp_path / "half.png"
    assert main(["encode", str(src), str(tdc)]) == 0
    p = get_pipeline("hp")
    calls = []
    orig_dec = p.decode_u8
    orig_fused = hp_pallas.hp_scaled_decode_u8
    p.decode_u8 = lambda x, cfg: calls.append(("composed", tuple(x.shape))) or orig_dec(x, cfg)
    hp_pallas.hp_scaled_decode_u8 = (
        lambda c, *a, **k: calls.append(("fused", tuple(c.shape))) or orig_fused(c, *a, **k)
    )
    try:
        assert main(["decode", "--scale", "1/2", str(tdc), str(out)]) == 0
    finally:
        del p.decode_u8
        hp_pallas.hp_scaled_decode_u8 = orig_fused
    assert calls, "u8 fast path did not engage for an eligible stream"
    # the padded 128x256 map satisfies w % 256 == 0, so the fused kernel
    # specifically should have taken it
    assert calls[0][0] == "fused", calls
    rec = imageio.load_image(str(out))
    assert rec.shape == (50, 65)


def test_fused_scaled_kernel_matches_composed(rng):
    """hp_scaled_decode_u8 (one kernel) must equal the composed
    decode_u8 + box_pool_u8 path bit-exactly, every factor pair."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.kernels import hp_pallas
    from tpudct.ops.scaled import box_pool_u8

    p = get_pipeline("hp")
    cfg = CodecConfig()
    img = rng.integers(0, 256, (64, 1024), dtype=np.uint8)
    c = p.encode_u8(jnp.asarray(img), cfg)
    for fr, fc in ((2, 2), (4, 4), (8, 8), (1, 2), (2, 1), (4, 8)):
        assert hp_pallas.supports_scaled_u8(64, 1024, fr, fc)
        fused = np.asarray(hp_pallas.hp_scaled_decode_u8(
            c, fr, fc, interpret=True
        ))
        composed = np.asarray(box_pool_u8(p.decode_u8(c, cfg), fr, fc))
        assert fused.shape == (64 // fr, 1024 // fc)
        np.testing.assert_array_equal(fused, composed)


def test_fused_scaled_kernel_gate():
    from tpudct.kernels import hp_pallas

    assert hp_pallas.supports_scaled_u8(64, 128, 2, 2)       # masked edges
    assert not hp_pallas.supports_scaled_u8(64, 132, 2, 2)   # w % 8 != 0
    assert not hp_pallas.supports_scaled_u8(64, 1024, 3, 2)  # bad factor
    assert hp_pallas.supports_scaled_u8(64, 1024, 8, 8)
    assert not hp_pallas.supports_scaled_u8(60, 1024, 2, 2)  # not u8 geometry


# ---------------------------------------------------------------------------
# General M/8 scales (round 3): area_matrix / scaled_decode_m8
# ---------------------------------------------------------------------------


def _area_resample_ref(x, m_r, m_c):
    """Independent reference for the M/8 contract: replicate each pixel
    m times per axis (the piecewise-constant signal on a 1/m grid), then
    an exact 8x8 box average — identical windows to area_matrix by
    construction (unit pixels at m/8 == 1/m-subpixels in 8-windows)."""
    x = np.asarray(x, np.float64)
    up = np.repeat(np.repeat(x, m_r, axis=0), m_c, axis=1)
    h, w = up.shape
    return up.reshape(h // 8, 8, w // 8, 8).mean(axis=(1, 3))


def test_area_matrix_properties():
    from tpudct.ops.scaled import M_RANGE, area_matrix

    for m in M_RANGE:
        a = area_matrix(m)
        assert a.shape == (m, 8)
        np.testing.assert_allclose(a.sum(axis=1), 1.0, atol=1e-6)
        assert (a >= 0).all()
    # m | 8 degenerates to the exact box-pool matrix
    for m in (1, 2, 4, 8):
        np.testing.assert_array_equal(area_matrix(m), pool_matrix(8 // m))
    # m = 16 is exact 2x nearest replication
    a16 = area_matrix(16)
    np.testing.assert_array_equal(a16, np.repeat(np.eye(8, dtype=np.float32), 2, axis=0))
    with pytest.raises(ValueError):
        area_matrix(0)
    with pytest.raises(ValueError):
        area_matrix(17)


@pytest.mark.parametrize("m", [3, 5, 6, 7, 9, 12, 16])
def test_scaled_decode_m8_matches_area_resample(rng, m):
    """scaled_decode_m8 == exact area-resample of the full f32 decode."""
    from tpudct.ops.scaled import scaled_decode_m8

    p = get_pipeline("batched")
    cfg = CodecConfig()
    img = rng.integers(0, 256, (40, 64)).astype(np.float32)
    c = p.dct(jnp.asarray(img), cfg)
    full = np.asarray(p.idct(c, cfg), np.float64)
    got = np.asarray(scaled_decode_m8(c, cfg, m))
    ref = _area_resample_ref(full, m, m)
    assert got.shape == (40 * m // 8, 64 * m // 8)
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_scaled_decode_m8_anisotropic(rng):
    from tpudct.ops.scaled import scaled_decode_m8

    p = get_pipeline("batched")
    cfg = CodecConfig()
    img = rng.integers(0, 256, (16, 32)).astype(np.float32)
    c = p.dct(jnp.asarray(img), cfg)
    full = np.asarray(p.idct(c, cfg), np.float64)
    got = np.asarray(scaled_decode_m8(c, cfg, 3, m_cols=6))
    np.testing.assert_allclose(got, _area_resample_ref(full, 3, 6), atol=5e-3)


def test_scaled_shape_m8():
    from tpudct.ops.scaled import scaled_shape_m8

    assert scaled_shape_m8(100, 3) == 38   # ceil(300/8)
    assert scaled_shape_m8(64, 8) == 64
    assert scaled_shape_m8(7, 16) == 14
    assert scaled_shape_m8(100, 4) == 50


def test_parse_scale():
    from tpudct.cli import _parse_scale

    assert _parse_scale("3/8") == 3
    assert _parse_scale("16/8") == 16
    assert _parse_scale("1/2") == 4
    assert _parse_scale("1/4") == 2
    assert _parse_scale("1/8") == 1
    assert _parse_scale("3/4") == 6
    assert _parse_scale("2/1") == 16
    for bad in ("0/8", "17/8", "3/7", "x", "8"):
        with pytest.raises(ValueError):
            _parse_scale(bad)


@pytest.mark.parametrize("m", [3, 6])
def test_cli_scale_m8_gray(tmp_path, m):
    from tpudct.cli import main
    from tpudct.utils import imageio

    img = np.random.default_rng(4).integers(0, 256, (50, 70)).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_image(src, img)
    tdc = tmp_path / "x.tdc"
    out = tmp_path / "s.png"
    assert main(["encode", str(src), str(tdc)]) == 0
    assert main(["decode", "--scale", f"{m}/8", str(tdc), str(out)]) == 0
    rec = imageio.load_image(str(out))
    assert rec.shape == (-(-50 * m // 8), -(-70 * m // 8))


@pytest.mark.parametrize("mode", ["420", "422", "444"])
def test_color_scaled_m8(rng, mode):
    """M/8 color decode: right geometry and close to the area-resample of
    the full color decode (clamp/round per-plane ordering differs, so a
    few-LSB tolerance; smooth content keeps clamping out of play)."""
    p = get_pipeline("batched")
    cfg = CodecConfig()
    yy, xx = np.mgrid[0:48, 0:64]
    rgbf = np.stack(
        [128 + 60 * np.sin(xx / 9), 128 + 50 * np.cos(yy / 11),
         128 + 40 * np.sin((xx + yy) / 13)], axis=-1)
    rgb = np.clip(rgbf, 0, 255).astype(np.uint8)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg, subsample=mode)
    m = 3
    got = np.asarray(decode_color_scaled(p, planes, meta, cfg, m=m))
    assert got.shape == (48 * m // 8, 64 * m // 8, 3)
    full = np.asarray(decode_color(p, planes, meta, cfg), np.float64)
    ref = np.stack(
        [_area_resample_ref(full[..., k], m, m) for k in range(3)], axis=-1
    )
    assert np.abs(got.astype(np.float64) - ref).max() <= 3.0


def test_color_scaled_m8_upscale_gate(rng):
    p = get_pipeline("batched")
    cfg = CodecConfig()
    rgb = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg, subsample="420")
    with pytest.raises(ValueError, match="M <= 8"):
        decode_color_scaled(p, planes, meta, cfg, m=9)
    planes4, meta4 = encode_color(p, jnp.asarray(rgb), cfg, subsample="444")
    up = np.asarray(decode_color_scaled(p, planes4, meta4, cfg, m=12))
    assert up.shape == (24, 24, 3)


def test_cli_scale_pads_to_fused_geometry(tmp_path):
    """A ragged size (300) must ride the fused kernel on its 8-aligned
    coefficient map (304x304): the kernel masks its edges, so nothing
    pads to a kernel grid."""
    from tpudct.cli import main
    from tpudct.kernels import hp_pallas
    from tpudct.utils import imageio

    img = np.random.default_rng(3).integers(0, 256, (300, 300)).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_image(src, img)
    tdc = tmp_path / "x.tdc"
    out = tmp_path / "q.png"
    assert main(["encode", str(src), str(tdc)]) == 0
    calls = []
    orig = hp_pallas.hp_scaled_decode_u8
    hp_pallas.hp_scaled_decode_u8 = (
        lambda c, *a, **k: calls.append(tuple(c.shape)) or orig(c, *a, **k)
    )
    try:
        assert main(["decode", "--scale", "1/4", str(tdc), str(out)]) == 0
    finally:
        hp_pallas.hp_scaled_decode_u8 = orig
    assert calls == [(304, 304)], calls  # the 8-aligned map itself
    rec = imageio.load_image(str(out))
    assert rec.shape == (75, 75)
    # the masked edge must not change any cropped pixel: compare with the
    # composed path on a (32, 128)-padded map
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.ops.scaled import box_pool_u8
    from tpudct.ops.transform import to_uint8
    from tpudct.utils import serialize

    coeffs, q_scale, _k, (h, w), transform, q_table = serialize.load_coefficients(
        str(tdc), with_orig_shape=True, with_transform=True, with_q_table=True,
    )
    p = get_pipeline("hp")
    cfg = CodecConfig(q_scale=q_scale, transform=transform, q_table=q_table)
    hc, wc = coeffs.shape
    cmin = jnp.pad(jnp.asarray(coeffs, jnp.int8), ((0, -hc % 32), (0, -wc % 128)))
    ref = np.asarray(to_uint8(box_pool_u8(p.decode_u8(cmin, cfg), 4)))[:75, :75]
    np.testing.assert_array_equal(rec, ref)


def test_fused_scaled_kernel_custom_geometry(rng):
    """User band_rows/tile_cols below the pool alignment must land on the
    minimal valid tiles, not crash (review: the shrink loops underflowed
    to a modulo-by-zero)."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.kernels import hp_pallas
    from tpudct.ops.scaled import box_pool_u8, scaled_decode_u8

    p = get_pipeline("hp")
    img = rng.integers(0, 256, (64, 2048), dtype=np.uint8)
    c = p.encode_u8(jnp.asarray(img), CodecConfig())
    for cfg in (
        CodecConfig(tile_cols=512, interpret=True),
        CodecConfig(band_rows=32, interpret=True),
        CodecConfig(band_rows=32, tile_cols=256, interpret=True),
    ):
        fused = np.asarray(scaled_decode_u8(p, c, cfg, 8))
        composed = np.asarray(box_pool_u8(p.decode_u8(c, cfg), 8, 8))
        np.testing.assert_array_equal(fused, composed)


def test_scaled_u8_honors_decode_precision(rng):
    """Non-butterfly decode_precision must bypass the fused kernel (it
    hardwires the butterfly inverse) and stay bit-identical to the
    composed decode_u8 + pool under the SAME config."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.kernels import hp_pallas
    from tpudct.ops.scaled import box_pool_u8, scaled_decode_u8

    p = get_pipeline("hp")
    img = rng.integers(0, 256, (64, 512), dtype=np.uint8)
    for prec in ("high", "highest"):
        cfg = CodecConfig(decode_precision=prec, interpret=True)
        c = p.encode_u8(jnp.asarray(img), cfg)
        orig = hp_pallas.hp_scaled_decode_u8
        hp_pallas.hp_scaled_decode_u8 = lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("fused kernel must not engage at non-butterfly precision")
        )
        try:
            got = np.asarray(scaled_decode_u8(p, c, cfg, 2))
        finally:
            hp_pallas.hp_scaled_decode_u8 = orig
        ref = np.asarray(box_pool_u8(p.decode_u8(c, cfg), 2, 2))
        np.testing.assert_array_equal(got, ref)


def test_cli_scale_eight_eighths_is_full_decode(rng, tmp_path):
    """--scale 8/8 (and alias 1/1) is the plain full decode."""
    from tpudct.cli import main
    from tpudct.utils import imageio

    img = rng.integers(0, 256, (40, 72)).astype(np.uint8)
    src = tmp_path / "in.png"
    imageio.save_image(src, img)
    tdc = tmp_path / "c.tdc"
    assert main(["encode", str(src), str(tdc)]) == 0
    full = tmp_path / "full.png"
    scaled = tmp_path / "s88.png"
    assert main(["decode", str(tdc), str(full)]) == 0
    assert main(["decode", "--scale", "8/8", str(tdc), str(scaled)]) == 0
    np.testing.assert_array_equal(
        imageio.load_image(full), imageio.load_image(scaled)
    )


def test_fused_scaled_kernel_u8_output_bit_identical(rng):
    """out_u8=True stores uint8 in the kernel epilogue; must equal
    to_uint8 of the f32 output bit-for-bit at every factor pair (the
    exactness proof: pooled sums are exact integer f32 and 1/(fr*fc) is a
    power of two, so the truncating i32 cast IS to_uint8's trunc+clip)."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.kernels import hp_pallas
    from tpudct.ops.transform import to_uint8

    p = get_pipeline("hp")
    cfg = CodecConfig()
    img = rng.integers(0, 256, (64, 1024), dtype=np.uint8)
    c = p.encode_u8(jnp.asarray(img), cfg)
    for fr, fc in ((2, 2), (8, 8), (1, 2), (2, 1), (4, 8)):
        f32 = hp_pallas.hp_scaled_decode_u8(c, fr, fc, interpret=True)
        u8 = np.asarray(hp_pallas.hp_scaled_decode_u8(
            c, fr, fc, interpret=True, out_u8=True
        ))
        assert u8.dtype == np.uint8
        np.testing.assert_array_equal(u8, np.asarray(to_uint8(f32)))


def test_scaled_decode_u8_out_u8_fallback_matches(rng):
    """ops.scaled.scaled_decode_u8(out_u8=True): the composed fallback
    (to_uint8(box_pool_u8(...))) and the fused kernel agree bit-exactly,
    so the dispatch layer's output is path-independent."""
    import dataclasses

    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.ops.scaled import scaled_decode_u8

    p = get_pipeline("hp")
    cfg = CodecConfig()
    img = rng.integers(0, 256, (64, 512), dtype=np.uint8)
    c = p.encode_u8(jnp.asarray(img), cfg)
    fused = np.asarray(scaled_decode_u8(p, c, cfg, 2, out_u8=True))
    # force the composed fallback by requesting a non-butterfly tier
    hcfg = dataclasses.replace(cfg, decode_precision="highest")
    # highest-tier decode_u8 differs from butterfly only at tie pixels;
    # compare each against ITS OWN f32 form instead of across tiers
    f32_fused = np.asarray(scaled_decode_u8(p, c, cfg, 2))
    np.testing.assert_array_equal(
        fused, np.clip(np.trunc(f32_fused), 0, 255).astype(np.uint8)
    )
    comp_u8 = np.asarray(scaled_decode_u8(p, c, hcfg, 2, out_u8=True))
    comp_f32 = np.asarray(scaled_decode_u8(p, c, hcfg, 2))
    np.testing.assert_array_equal(
        comp_u8, np.clip(np.trunc(comp_f32), 0, 255).astype(np.uint8)
    )
    assert fused.dtype == comp_u8.dtype == np.uint8
