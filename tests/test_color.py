"""Color extension tests: YCbCr conversion, 4:2:0 resampling, the chroma
quantization table, the color codec driver, .tdcc serialization and the
CLI surface.  Beyond reference parity: the reference collapses RGB to
luminance at load (utils.cu:70-72) and has no color path at all."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from tpudct import CodecConfig, get_pipeline
from tpudct.models.color import decode_color, encode_color, roundtrip_color
from tpudct.utils import color, serialize


def _smooth_rgb(h=128, w=128):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack(
        [128 + 100 * np.sin(yy / 20), 128 + 100 * np.cos(xx / 25), (yy + xx) / 3],
        axis=-1,
    ).astype(np.float32)


def _psnr(a, b):
    mse = ((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean()
    return 10 * np.log10(255.0**2 / mse)


# ---- color space ----------------------------------------------------------


def test_upsample_equals_naive_repeat(rng):
    """The broadcast-reshape upsample forms (chosen to avoid a gather;
    jnp.repeat is a measured ~342 ms gather at 8192²) must be value-exact
    nearest replication, including odd-crop edges."""
    for h, w in ((8, 8), (9, 13), (64, 96), (17, 31)):
        x = rng.uniform(0, 255, ((h + 1) // 2, (w + 1) // 2)).astype(np.float32)
        ref = np.repeat(np.repeat(x, 2, 0), 2, 1)[:h, :w]
        np.testing.assert_array_equal(np.asarray(color.upsample_420(x, h, w)), ref)
        x2 = rng.uniform(0, 255, (h, (w + 1) // 2)).astype(np.float32)
        ref2 = np.repeat(x2, 2, 1)[:h, :w]
        np.testing.assert_array_equal(np.asarray(color.upsample_422(x2, h, w)), ref2)


def test_ycbcr_inverse_identity(rng):
    rgb = rng.uniform(0, 255, (32, 48, 3)).astype(np.float32)
    y, cb, cr = color.rgb_to_ycbcr(rgb)
    back = np.asarray(color.ycbcr_to_rgb(y, cb, cr))
    assert np.abs(back - rgb).max() < 1e-3


def test_ycbcr_known_points():
    # Full-range JFIF: black -> (0,128,128), white -> (255,128,128),
    # pure red luma = 0.299*255.
    s = lambda a: float(np.asarray(a).reshape(()))
    y, cb, cr = color.rgb_to_ycbcr(np.zeros((1, 1, 3), np.float32))
    assert s(y) == 0.0 and abs(s(cb) - 128) < 1e-4 and abs(s(cr) - 128) < 1e-4
    y, cb, cr = color.rgb_to_ycbcr(np.full((1, 1, 3), 255.0, np.float32))
    assert abs(s(y) - 255.0) < 1e-3
    red = np.zeros((1, 1, 3), np.float32)
    red[..., 0] = 255.0
    y, _cb, cr = color.rgb_to_ycbcr(red)
    assert abs(s(y) - 0.299 * 255) < 1e-3
    # Pure red maps to Cr = 128 + 0.5*255 = 255.5 pre-clamp (ITU-T T.871
    # leaves clamping to the 8-bit cast; the codec clamps at output).
    assert abs(s(cr) - 255.5) < 1e-3


def test_downsample_upsample_shapes():
    for h, w in ((16, 16), (17, 16), (16, 17), (15, 13)):
        x = np.arange(h * w, dtype=np.float32).reshape(h, w)
        d = np.asarray(color.downsample_420(x))
        assert d.shape == ((h + 1) // 2, (w + 1) // 2)
        u = np.asarray(color.upsample_420(d, h, w))
        assert u.shape == (h, w)


def test_downsample_is_2x2_mean():
    x = np.array([[0.0, 4.0], [8.0, 12.0]], np.float32)
    assert float(color.downsample_420(x)[0, 0]) == 6.0


# ---- chroma quantization table --------------------------------------------


def test_chroma_table_coarser_than_luma(rng):
    img = rng.integers(0, 256, (64, 64)).astype(np.float32)
    x = jnp.asarray(img)
    for name in ("batched", "fast", "hp"):
        p = get_pipeline(name)
        _, rl = p.roundtrip(x, CodecConfig(interpret=True))
        _, rc = p.roundtrip(x, CodecConfig(interpret=True, q_table="chroma"))
        ml = ((np.asarray(rl).astype(float) - img) ** 2).mean()
        mc = ((np.asarray(rc).astype(float) - img) ** 2).mean()
        assert mc > ml, (name, ml, mc)


def test_unknown_q_table_raises():
    from tpudct.constants import get_q_table

    with pytest.raises(KeyError):
        get_q_table("nope")


def test_u8_kernel_path_honors_q_table(rng):
    """The fused u8 kernels must quantize against QC when asked — a silent
    fall-through to Q would decode color streams wrongly."""
    img = rng.integers(0, 256, (64, 128)).astype(np.uint8)
    p = get_pipeline("hp")
    cl = CodecConfig(interpret=True)
    cc = CodecConfig(interpret=True, q_table="chroma")
    c_l, _ = p.roundtrip_u8(jnp.asarray(img), cl)
    c_c, _ = p.roundtrip_u8(jnp.asarray(img), cc)
    assert not np.array_equal(np.asarray(c_l), np.asarray(c_c))


# ---- codec driver ----------------------------------------------------------


@pytest.mark.parametrize("pipeline", ["batched", "hp"])
@pytest.mark.parametrize("subsample", [True, False])
def test_color_roundtrip_quality(pipeline, subsample):
    rgb = _smooth_rgb()
    p = get_pipeline(pipeline)
    cfg = CodecConfig(interpret=True)
    planes, meta, rec = roundtrip_color(p, jnp.asarray(rgb), cfg, subsample=subsample)
    rec = np.asarray(rec)
    assert rec.dtype == np.uint8 and rec.shape == rgb.shape
    assert _psnr(rec, rgb) > (30 if subsample else 33)
    ch, cw = meta["chroma_shape"]
    assert np.asarray(planes["cb"]).shape[0] >= ch


def test_color_444_beats_420_on_chroma_detail():
    rgb = _smooth_rgb()
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)
    _, _, r420 = roundtrip_color(p, jnp.asarray(rgb), cfg, subsample=True)
    _, _, r444 = roundtrip_color(p, jnp.asarray(rgb), cfg, subsample=False)
    assert _psnr(r444, rgb) > _psnr(r420, rgb)


def test_color_odd_sizes():
    rgb = _smooth_rgb(67, 93)
    p = get_pipeline("batched")
    planes, meta, rec = roundtrip_color(p, jnp.asarray(rgb), CodecConfig(interpret=True))
    assert np.asarray(rec).shape == (67, 93, 3)
    assert meta["chroma_shape"] == (34, 47)


def test_color_cross_pipeline_agreement():
    """Same color math through different compute strategies: identical up
    to the documented .5-tie equivalence class.  A coefficient tie flip
    (+-1, e.g. against a chroma Q entry of 99) spreads over its 8x8 block
    at the IDCT, so agreement is asserted as 'almost all pixels equal-ish,
    none wildly off' rather than bitwise."""
    rgb = _smooth_rgb()
    cfg = CodecConfig(interpret=True)
    pa, _, ra = roundtrip_color(get_pipeline("batched"), jnp.asarray(rgb), cfg)
    pb, _, rb = roundtrip_color(get_pipeline("hp"), jnp.asarray(rgb), cfg)
    for k in ("y", "cb", "cr"):
        cdiff = np.abs(np.asarray(pa[k]) - np.asarray(pb[k]))
        assert cdiff.max() <= 1.0, k            # only .5-tie flips
        assert (cdiff > 0).mean() < 0.02, k     # and they are rare
    # Each flipped coefficient perturbs its whole 8x8 block a little at
    # the IDCT; pixel output stays close in aggregate.
    diff = np.abs(np.asarray(ra).astype(int) - np.asarray(rb).astype(int))
    assert diff.mean() < 1.0 and diff.max() <= 32


def test_color_retention_sweep_monotone():
    rgb = _smooth_rgb()
    p = get_pipeline("batched")
    prev = None
    for k in (6, 8, 10, None):
        cfg = CodecConfig(interpret=True, retain_k=k)
        _, _, rec = roundtrip_color(p, jnp.asarray(rgb), cfg)
        q = _psnr(rec, rgb)
        assert prev is None or q >= prev - 0.05, (k, q, prev)
        prev = q


# ---- serialization ---------------------------------------------------------


def test_tdcc_roundtrip(tmp_path):
    rgb = _smooth_rgb(72, 88)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True, retain_k=8)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg)
    f = tmp_path / "c.tdcc"
    n = serialize.save_color(
        f, {k: np.asarray(v) for k, v in planes.items()}, meta,
        cfg.q_scale, cfg.retain_k, cfg.transform,
    )
    assert n == f.stat().st_size
    planes2, meta2 = serialize.load_color(f)
    assert meta2["orig_shape"] == (72, 88)
    assert meta2["retain_k"] == 8 and meta2["transform"] == "haweel"
    for k in planes:
        assert np.array_equal(np.asarray(planes[k]), planes2[k])
    rec = decode_color(p, planes2, meta2, cfg)
    assert _psnr(rec, rgb) > 30


def test_partial_color_coefficients_progressive(tmp_path, capsys):
    """Progressive color decode: n_planes=64 reproduces the full parse
    bit-exactly, MSE is monotone in n, and the CLI drives it end-to-end
    (the color analog of the grayscale --planes path)."""
    from tpudct.cli import main
    from tpudct.utils import imageio

    rgb = _smooth_rgb(64, 96)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg)
    np_planes = {k: np.asarray(v) for k, v in planes.items()}
    data = serialize.color_to_bytes(np_planes, meta, codec="spectral")

    full_planes, full_meta = serialize.bytes_to_color(data)
    p64, m64 = serialize.partial_color_coefficients(data, n_planes=64)
    assert m64 == full_meta
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(p64[k], full_planes[k])

    ref = np.asarray(decode_color(p, full_planes, full_meta, cfg))
    mses = []
    for n in (1, 4, 16, 64):
        pl, m = serialize.partial_color_coefficients(data, n_planes=n)
        rec = np.asarray(decode_color(p, pl, m, cfg)).astype(np.float64)
        mses.append(((rec - ref.astype(np.float64)) ** 2).mean())
    assert mses[0] >= mses[1] >= mses[2] >= mses[3] == 0.0

    # interleaved plane codecs decode whole and mask: identical result
    raw = serialize.color_to_bytes(np_planes, meta, codec="raw")
    pl4, m4 = serialize.partial_color_coefficients(raw, 4)
    ref4, _ = serialize.partial_color_coefficients(data, 4)
    assert m4 == full_meta
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(pl4[k], ref4[k])

    # CLI flow
    tdcc = tmp_path / "c.tdcc"
    tdcc.write_bytes(data)
    out = tmp_path / "p4.png"
    assert main(["decode", str(tdcc), str(out), "--planes", "4",
                 "--pipeline", "batched"]) == 0
    assert imageio.load_image(out, force_gray=False).shape == (64, 96, 3)


@pytest.mark.parametrize("mode,h,rows", [
    ("420", 96, "21:75"), ("422", 96, "21:75"), ("444", 96, "21:75"),
    # padded luma height 8-mod-16 with a TAIL range: the 4:2:0 chroma
    # slice must take whole blocks (regression: y1//2 off the block grid
    # made decode_color concatenate a half-cb/half-cr 8-row block)
    ("420", 40, "33:40"), ("420", 40, "0:9"),
])
def test_color_roi_decode_matches_full(tmp_path, mode, h, rows, capsys):
    """decode --rows on a .tdcc must equal the same rows of the full
    decode (replication upsampling is local, so a block-row slice decode
    is exact) — for every chroma mode, on an unaligned range."""
    from tpudct.cli import main
    from tpudct.utils import imageio

    rgb = _smooth_rgb(h, 64).astype(np.uint8)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)
    from tpudct.models.color import decode_color, encode_color

    planes, meta = encode_color(
        p, jnp.asarray(rgb, jnp.float32), cfg,
        subsample={"420": "420", "422": "422", "444": False}[mode],
    )
    tdcc = tmp_path / "c.tdcc"
    serialize.save_color(tdcc, {k: np.asarray(v) for k, v in planes.items()},
                         meta, codec="spectral")
    full = tmp_path / "full.png"
    roi = tmp_path / "roi.png"
    assert main(["decode", str(tdcc), str(full), "--pipeline", "batched"]) == 0
    assert main(["decode", str(tdcc), str(roi), "--rows", rows,
                 "--pipeline", "batched"]) == 0
    ra, rb = (int(v) for v in rows.split(":"))
    np.testing.assert_array_equal(
        imageio.load_image(roi, force_gray=False),
        imageio.load_image(full, force_gray=False)[ra:rb],
    )


def test_tdcc_every_entropy_stage_bit_exact():
    """All entropy codecs (incl. the rANS stage) must round-trip every
    color plane bit-exactly through the .tdcc container; auto must never
    store a larger stream than any explicit stage."""
    from tpudct.utils.entropy import native_entropy_available, rans_available

    rgb = _smooth_rgb(64, 80)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg)
    np_planes = {k: np.asarray(v) for k, v in planes.items()}
    sizes = {}
    codecs = ["auto", "spectral", "xz", "raw"]
    if native_entropy_available():
        codecs.append("huffman")
    if rans_available():
        codecs.append("rans")
    for codec in codecs:
        data = serialize.color_to_bytes(
            np_planes, meta, cfg.q_scale, cfg.retain_k, cfg.transform,
            codec=codec,
        )
        sizes[codec] = len(data)
        planes2, meta2 = serialize.bytes_to_color(data)
        assert meta2["orig_shape"] == meta["orig_shape"], codec
        for k in np_planes:
            assert np.array_equal(np_planes[k], planes2[k]), (codec, k)
    assert sizes["auto"] <= min(v for k, v in sizes.items() if k != "auto")


def test_tdcc_truncated_raises(tmp_path):
    rgb = _smooth_rgb(40, 40)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg)
    data = serialize.color_to_bytes(
        {k: np.asarray(v) for k, v in planes.items()}, meta
    )
    with pytest.raises(ValueError):
        serialize.bytes_to_color(data[: len(data) - 8])
    with pytest.raises(ValueError):
        serialize.bytes_to_color(b"JUNK" + data[4:])


def test_gray_tdc_not_color():
    data = serialize.coefficients_to_bytes(np.zeros((8, 8), np.float32))
    assert not serialize.is_color_stream(data)


# ---- CLI -------------------------------------------------------------------


def test_cli_color_run_encode_decode(tmp_path, capsys):
    from tpudct.cli import main
    from tpudct.utils import imageio

    rgb = _smooth_rgb(64, 64).astype(np.uint8)
    src = tmp_path / "in.jpg"
    imageio.save_jpeg(src, rgb, quality=98)

    out = tmp_path / "out.jpg"
    tdcc = tmp_path / "c.tdcc"
    rc = main(["run", "--color", "--pipeline", "batched", str(src), str(out),
               "--coeffs", str(tdcc)])
    assert rc == 0 and out.exists() and tdcc.exists()
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["color"] is True and rep["psnr_db"] > 25

    back = imageio.load_jpeg(out, force_gray=False)
    assert back.shape == (64, 64, 3)

    dec = tmp_path / "dec.jpg"
    assert main(["decode", str(tdcc), str(dec)]) == 0
    img = imageio.load_jpeg(dec, force_gray=False)
    assert img.shape == (64, 64, 3)
    assert _psnr(img, rgb) > 22  # JPEG re-encode on top of the codec pass


def test_cli_color_no_subsample(tmp_path, capsys):
    from tpudct.cli import main
    from tpudct.utils import imageio

    rgb = _smooth_rgb(56, 56).astype(np.uint8)
    src = tmp_path / "in.jpg"
    imageio.save_jpeg(src, rgb, quality=98)
    tdcc = tmp_path / "c.tdcc"
    assert main(["encode", "--color", "--no-subsample", str(src), str(tdcc)]) == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["color"] is True
    _planes, meta = serialize.load_color(tdcc)
    assert meta["subsample"] is False
    assert meta["chroma_shape"] == (56, 56)


# ---- the u8 color stages (utils.color.split_u8 / merge_u8) ------------------


def test_color_pallas_kernels_match_xla(rng):
    """The codec's u8 split/merge vs the float reference helpers."""
    rgb = rng.integers(0, 256, (3, 128, 256)).astype(np.uint8)
    x = jnp.asarray(rgb)
    y1, cb1, cr1 = color.split_u8(x, "420")
    y2, cb2, cr2 = color.ycbcr_split_420_u8(x)
    # pool-then-transform vs transform-then-pool: identical up to f32
    # rounding order (documented .5-tie class) -> at most +-1, rare.
    for a, b, n in ((y1, y2, "y"), (cb1, cb2, "cb"), (cr1, cr2, "cr")):
        d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, n
    m1 = color.merge_u8(y1, cb1, cr1, "420")
    m2 = color.ycbcr_merge_420_u8(y1, cb1, cr1, 128, 256)
    d = np.abs(np.asarray(m1).astype(int) - np.asarray(m2).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_u8_color_roundtrip_quality_and_agreement():
    from tpudct.models.color import roundtrip_color_u8, supports_color_u8

    rgb = _smooth_rgb(128, 256).astype(np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    assert supports_color_u8(p, cfg, 128, 256)
    planes, meta, rec = roundtrip_color_u8(p, jnp.asarray(rgb), cfg)
    rec = np.asarray(rec)
    assert rec.shape == (128, 256, 3) and rec.dtype == np.uint8
    assert _psnr(rec, rgb) > 30
    for k in ("y", "cb", "cr"):
        assert np.asarray(planes[k]).dtype == np.int8
    # Agrees with the f32 path: the u8 path quantizes YCbCr planes to u8
    # pre-codec (like a real JPEG encoder), so small plane-level diffs
    # propagate — bounded, not bitwise.
    _, _, recf = roundtrip_color(p, jnp.asarray(rgb, jnp.float32), cfg)
    d = np.abs(np.asarray(recf).astype(int) - rec.astype(int))
    assert d.mean() < 2.0


def test_u8_color_planar_and_interleaved_agree():
    from tpudct.models.color import roundtrip_color_u8

    rgb = _smooth_rgb(64, 256).astype(np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    _, _, r1 = roundtrip_color_u8(p, jnp.asarray(rgb), cfg)
    _, _, r2 = roundtrip_color_u8(p, jnp.moveaxis(jnp.asarray(rgb), -1, 0), cfg)
    np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))


def test_u8_color_rejects_unsupported():
    from tpudct.models.color import encode_color_u8

    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    with pytest.raises(ValueError):
        encode_color_u8(p, jnp.zeros((64, 256, 3), jnp.float32), cfg)  # not u8
    with pytest.raises(ValueError):  # int8-unsafe q_scale
        encode_color_u8(p, jnp.zeros((64, 256, 3), jnp.uint8),
                        CodecConfig(interpret=True, q_scale=0.25))
    batched = get_pipeline("batched")
    with pytest.raises(ValueError):
        encode_color_u8(batched, jnp.zeros((64, 256, 3), jnp.uint8), cfg)


def test_u8_color_ragged_size_rides_fused_path():
    """Kernel padding (VERDICT r2 #1) applies to color too: a ragged size
    pads to the (16, 16) grid internally, coefficient planes come back at
    the 8-aligned TRUE plane shapes (container-format parity with the f32
    path), and the recon crops to the original size."""
    from tpudct.models.color import (
        decode_color, decode_color_auto, encode_color_u8, roundtrip_color_auto,
    )

    rgb = _smooth_rgb(100, 130).astype(np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color_u8(p, jnp.asarray(rgb), cfg)
    assert meta["orig_shape"] == (100, 130)
    assert meta["chroma_shape"] == (50, 65)
    assert tuple(planes["y"].shape) == (104, 136)   # padded_shape(100, 130)
    assert tuple(planes["cb"].shape) == (56, 72)    # padded_shape(50, 65)
    # auto dispatch picks the u8 path for the ragged size...
    calls = []
    orig = p.encode_u8
    p.encode_u8 = lambda x, c: calls.append(tuple(x.shape)) or orig(x, c)
    try:
        planes2, meta2, rec = roundtrip_color_auto(p, jnp.asarray(rgb), cfg)
    finally:
        del p.encode_u8
    assert calls and calls[0] == (112, 144)  # luma padded to the 16-grid
    rec = np.asarray(rec)
    assert rec.shape == (100, 130, 3) and rec.dtype == np.uint8
    assert _psnr(rec, rgb) > 30
    # ...and the u8-decode of the stream agrees with the f32 decode
    recf = np.asarray(decode_color(p, planes, meta, cfg))
    d = np.abs(recf.astype(int) - rec.astype(int))
    assert d.mean() < 2.0
    # decode_color_auto takes the u8 path on these planes
    rec_auto = np.asarray(decode_color_auto(p, planes, meta, cfg))
    np.testing.assert_array_equal(rec_auto, rec)


def test_u8_color_ragged_tdcc_roundtrip(tmp_path):
    from tpudct.models.color import decode_color_auto, encode_color_auto

    rgb = _smooth_rgb(100, 130).astype(np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color_auto(p, rgb, cfg)
    f = tmp_path / "x.tdcc"
    serialize.save_color(f, planes, meta, cfg.q_scale, cfg.retain_k, cfg.transform)
    planes2, meta2 = serialize.load_color(f)
    assert meta2["orig_shape"] == (100, 130)
    rec = np.asarray(decode_color_auto(p, planes2, meta2, cfg))
    assert rec.shape == (100, 130, 3)
    assert _psnr(rec, rgb) > 30
    # preview still crops to the true 1/8-scale size (plane headers carry
    # the TRUE dims, not the kernel-padded ones)
    pv = serialize.preview_color_from_bytes(f.read_bytes())
    assert pv.shape == (13, 17, 3)


def test_u8_color_tdcc_serializes():
    from tpudct.models.color import decode_color_u8, encode_color_u8

    rgb = _smooth_rgb(64, 256).astype(np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color_u8(p, jnp.asarray(rgb), cfg)
    data = serialize.color_to_bytes(
        {k: np.asarray(v) for k, v in planes.items()}, meta
    )
    planes2, meta2 = serialize.bytes_to_color(data)
    rec = decode_color_u8(p, planes2, meta2, cfg)
    assert _psnr(np.asarray(rec), rgb) > 30


def test_color_kernels_reject_misaligned_shapes():
    from tpudct.models.color import supports_color_u8

    p, cfg = get_pipeline("hp"), CodecConfig()
    assert supports_color_u8(p, cfg, 32, 256)
    assert not supports_color_u8(p, cfg, 24, 256)  # 4:2:0 chroma not 8-aligned
    assert not supports_color_u8(p, cfg, 64, 328)
    with pytest.raises(ValueError):
        color.merge_u8(
            jnp.zeros((64, 320), jnp.uint8),
            jnp.zeros((32, 96), jnp.uint8),
            jnp.zeros((32, 96), jnp.uint8), "420")


def test_tdcc_inconsistent_plane_headers_rejected():
    from tpudct.utils.serialize import (
        _HEADERC, _MAGICC, bytes_to_color, coefficients_to_bytes,
    )
    import struct

    c = np.zeros((8, 8), np.float32)
    y = coefficients_to_bytes(c, transform="haweel", q_table="luma")
    cb = coefficients_to_bytes(c, transform="haweel", q_table="chroma")
    cr = coefficients_to_bytes(c, transform="dct", q_table="chroma")  # divergent
    blob = struct.pack(_HEADERC, _MAGICC, 3, 1)
    for plane in (y, cb, cr):
        blob += struct.pack("<I", len(plane)) + plane
    with pytest.raises(ValueError):
        bytes_to_color(blob)


def test_color_auto_dispatch_handles_both_layouts():
    """Auto dispatch must never misread planar (3, H, W) as interleaved on
    the f32 fallback, and must keep encode/decode on the same path."""
    from tpudct.models.color import (
        decode_color_auto,
        encode_color_auto,
        roundtrip_color_auto,
    )

    rgb = _smooth_rgb(64, 200).astype(np.uint8)  # 200 % 256 != 0 -> f32 path
    planar = np.moveaxis(rgb, -1, 0)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    pi, mi = encode_color_auto(p, jnp.asarray(rgb), cfg)
    pp, mp = encode_color_auto(p, jnp.asarray(planar), cfg)
    assert mi["orig_shape"] == mp["orig_shape"] == (64, 200)
    for k in pi:
        np.testing.assert_array_equal(np.asarray(pi[k]), np.asarray(pp[k]))
    rec = decode_color_auto(p, pi, mi, cfg)
    assert _psnr(np.asarray(rec), rgb) > 28

    # aligned geometry, f32 dtype: must take the f32 path end-to-end (no
    # int8 cast of f32-path planes)
    big = np.clip(_smooth_rgb(64, 256) * 2.0, -50, 400)  # out-of-range f32
    _pl, _m, r = roundtrip_color_auto(p, jnp.asarray(big, jnp.float32), cfg)
    assert np.asarray(r).dtype == np.uint8  # no wraparound crash/garbage path


def test_ssim_tiny_image_no_nan(rng):
    from tpudct.utils.metrics import ssim

    x = rng.integers(0, 256, (4, 5)).astype(np.float32)
    v = float(ssim(x, x))
    assert abs(v - 1.0) < 1e-6


def test_color_codec_owns_table_assignment():
    """A caller-set cfg.q_table must not leak into the color planes: Y is
    always coded against Q (luma), chroma against QC — matching what the
    .tdcc headers record (they hardcode the convention)."""
    rgb = _smooth_rgb(64, 64)
    p = get_pipeline("batched")
    a = encode_color(p, jnp.asarray(rgb), CodecConfig(interpret=True))
    b = encode_color(p, jnp.asarray(rgb), CodecConfig(interpret=True, q_table="chroma"))
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(np.asarray(a[0][k]), np.asarray(b[0][k]))


def test_tdcc_honors_recorded_plane_tables():
    """Plane q tables are read from the stream, not assumed: a .tdcc whose
    Y plane was coded against the chroma table decodes against the chroma
    table (the mechanism imported JPEGs use to carry their own tables,
    utils/jpegcoef.py) — while divergent Cb/Cr tables are rejected (the
    fused chroma pass dequantizes both against one table)."""
    import struct

    from tpudct.models.color import decode_color
    from tpudct.utils.serialize import (
        _HEADERC, _MAGICC, bytes_to_color, color_to_bytes,
    )

    rgb = _smooth_rgb(64, 64)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color(p, jnp.asarray(rgb), cfg)
    np_planes = {k: np.asarray(v) for k, v in planes.items()}

    # override the recorded luma table: parse must surface it and decode
    # must dequantize Y against it
    data = color_to_bytes(np_planes, {**meta, "y_q_table": "chroma"})
    pl, m = bytes_to_color(data)
    assert m["y_q_table"] == "chroma" and m["c_q_table"] == "chroma"
    rec_chroma_y = np.asarray(decode_color(p, pl, m, cfg))
    rec_luma_y = np.asarray(decode_color(p, pl, {**m, "y_q_table": "luma"}, cfg))
    assert not np.array_equal(rec_chroma_y, rec_luma_y)  # the table matters

    # divergent chroma tables: rejected at parse
    c = np.zeros((8, 8), np.float32)
    y = serialize.coefficients_to_bytes(c, q_table="luma")
    cb = serialize.coefficients_to_bytes(c, q_table="chroma")
    cr = serialize.coefficients_to_bytes(c, q_table="luma")
    blob = struct.pack(_HEADERC, _MAGICC, 3, 1)
    for plane in (y, cb, cr):
        blob += struct.pack("<I", len(plane)) + plane
    with pytest.raises(ValueError, match="share a q_table"):
        bytes_to_color(blob)


def test_decode_auto_rejects_wide_coefficients():
    """Streams whose coefficients exceed int8 (out-of-range f32 input) must
    take the f32 decode, not wrap through the int8 cast."""
    from tpudct.models.color import decode_color_auto, encode_color

    # constant 800 gray: Y DC = round(8*(800-128)/16) = 336, far past int8.
    # Encode with the pure-f32 `batched` pipeline (hp's exact int8 core is
    # documented as u8-domain-only and would wrap the out-of-range input).
    big = np.full((64, 256, 3), 800.0, np.float32)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)
    planes, meta = encode_color(p, jnp.asarray(big), cfg)
    assert max(np.abs(np.asarray(v)).max() for v in planes.values()) > 127
    rec = decode_color_auto(p, planes, meta, cfg)  # must not wrap
    assert np.asarray(rec).shape == (64, 256, 3)


def test_streamed_color_matches_whole_image():
    """Band-streamed color codec == whole-image color codec, bitwise
    (conversion pixel-local, 4:2:0 2x2-local, blocks band-local)."""
    import jax.numpy as jnp
    import numpy as np

    from tpudct import CodecConfig, get_pipeline
    from tpudct.models.color import roundtrip_color_u8
    from tpudct.utils.streaming import roundtrip_color_u8_streamed

    rng = np.random.default_rng(21)
    rgb = rng.integers(0, 256, (3, 192, 256), dtype=np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    planes0, meta0, rec0 = roundtrip_color_u8(p, jnp.asarray(rgb), cfg)
    planes1, meta1, rec1 = roundtrip_color_u8_streamed(p, rgb, cfg, band_rows=64)
    assert meta1 == meta0
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(planes1[k], np.asarray(planes0[k]))
    np.testing.assert_array_equal(rec1, np.asarray(rec0))


def test_color_422_mode():
    """4:2:2 chroma: quality sits between 4:4:4 and 4:2:0 on chroma-rich
    content, the mode round-trips through the .tdcc container (flag byte
    2), and legacy flag 1 still reads as '420'."""
    import struct

    import jax.numpy as jnp
    import numpy as np

    from tpudct import CodecConfig, get_pipeline
    from tpudct.models.color import decode_color, encode_color, roundtrip_color
    from tpudct.utils import serialize

    rng = np.random.default_rng(13)
    base = rng.integers(0, 256, (64, 64)).astype(np.float32)
    # chroma-rich: distinct channels with horizontal AND vertical structure
    rgb = np.stack([base, np.roll(base, 7, 0), 255 - base], -1)
    p = get_pipeline("batched")
    cfg = CodecConfig(interpret=True)

    def mse(mode):
        _pl, _m, rec = roundtrip_color(p, jnp.asarray(rgb), cfg, subsample=mode)
        return ((np.asarray(rec).astype(np.float64) - rgb) ** 2).mean()

    m444, m422, m420 = mse(False), mse("422"), mse("420")
    assert m444 <= m422 <= m420, (m444, m422, m420)

    planes, meta = encode_color(p, jnp.asarray(rgb), cfg, subsample="422")
    assert meta["subsample"] == "422"
    assert meta["chroma_shape"] == (64, 32)
    blob = serialize.color_to_bytes(
        {k: np.asarray(v) for k, v in planes.items()}, meta, codec="spectral"
    )
    assert blob[5] == 2  # subsample byte after magic + n_planes
    planes2, meta2 = serialize.bytes_to_color(blob)
    assert meta2["subsample"] == "422"
    rec1 = np.asarray(decode_color(p, planes, meta, cfg))
    rec2 = np.asarray(decode_color(p, planes2, meta2, cfg))
    np.testing.assert_array_equal(rec1, rec2)

    # legacy flag byte 1 -> "420"
    legacy = bytearray(
        serialize.color_to_bytes(
            {k: np.asarray(v) for k, v in
             encode_color(p, jnp.asarray(rgb), cfg, subsample=True)[0].items()},
            encode_color(p, jnp.asarray(rgb), cfg, subsample=True)[1],
            codec="spectral",
        )
    )
    assert legacy[5] == 1
    _pl, m = serialize.bytes_to_color(bytes(legacy))
    assert m["subsample"] == "420"

    # 422 color preview: horizontal-only chroma upsample
    pv = serialize.preview_color_from_bytes(blob)
    assert pv.shape == (8, 8, 3)


@pytest.mark.parametrize("mode,cshape", [("422", (128, 128)), (False, (128, 256))])
def test_u8_color_422_444_roundtrip(mode, cshape):
    """The other two chroma modes ride the u8 fast path too (4:2:0-only
    before round 2's kernel extension): fused split/merge kernels + the
    stacked-chroma codec, agreeing with the f32 path within the
    documented plane-quantization class."""
    from tpudct.models.color import (
        roundtrip_color,
        roundtrip_color_u8,
        supports_color_u8,
    )

    rgb = _smooth_rgb(128, 256).astype(np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    assert supports_color_u8(p, cfg, 128, 256, mode)
    planes, meta, rec = roundtrip_color_u8(p, jnp.asarray(rgb), cfg, subsample=mode)
    rec = np.asarray(rec)
    assert rec.shape == (128, 256, 3) and rec.dtype == np.uint8
    assert meta["subsample"] == mode
    assert tuple(np.asarray(planes["cb"]).shape) == cshape
    assert _psnr(rec, rgb) > 30
    _, _, recf = roundtrip_color(p, jnp.asarray(rgb, jnp.float32), cfg, subsample=mode)
    d = np.abs(np.asarray(recf).astype(int) - rec.astype(int))
    assert d.mean() < 2.0
    # 4:4:4 subsamples nothing: the u8 path must beat the 4:2:0 PSNR on
    # chroma-rich content
    if mode is False:
        _, _, rec420 = roundtrip_color_u8(p, jnp.asarray(rgb), cfg)
        assert _psnr(rec, rgb) >= _psnr(np.asarray(rec420), rgb) - 0.1


def test_u8_color_auto_dispatch_all_modes():
    """encode/decode_color_auto route every chroma mode through the u8
    path when eligible and fall back for ineligible geometry."""
    from tpudct.models.color import (
        decode_color_auto,
        encode_color_auto,
        roundtrip_color_auto,
    )

    rgb = _smooth_rgb(128, 256).astype(np.uint8)
    p = get_pipeline("hp")
    cfg = CodecConfig(interpret=True)
    for mode in ("420", "422", False):
        planes, meta = encode_color_auto(p, jnp.asarray(rgb), cfg, subsample=mode)
        assert np.asarray(planes["y"]).dtype == np.int8, mode  # u8 path taken
        rec = decode_color_auto(p, planes, meta, cfg)
        _, _, rec2 = roundtrip_color_auto(p, jnp.asarray(rgb), cfg, subsample=mode)
        np.testing.assert_array_equal(np.asarray(rec), np.asarray(rec2))


def test_u8_kernels_422_444_match_utils_class():
    """Codec split/merge vs the float reference for 4:2:2 and 4:4:4 (the
    4:2:0 analog of test above): within the pool-then-transform f32 tie
    class (±1)."""
    from tpudct.utils import color

    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.integers(0, 256, (3, 128, 256), dtype=np.uint8))
    r, g, b = (jnp.asarray(x[i], jnp.float32) for i in range(3))

    # 4:4:4: pure transform, no resampling
    y4, cb4, cr4 = color.split_u8(x, False)
    yr, cbr, crr = color.ycbcr_from_rgb_planes(r, g, b)
    for a, bref in ((y4, yr), (cb4, cbr), (cr4, crr)):
        d = np.abs(np.asarray(a).astype(int)
                   - np.asarray(jnp.clip(jnp.round(bref), 0, 255)).astype(int))
        assert d.max() <= 1

    # 4:2:2: lane-direction pooling only
    y2, cb2, cr2 = color.split_u8(x, "422")
    np.testing.assert_array_equal(np.asarray(y2), np.asarray(y4))
    cbd = color.downsample_422(cbr)
    d = np.abs(np.asarray(cb2).astype(int)
               - np.asarray(jnp.clip(jnp.round(cbd), 0, 255)).astype(int))
    assert d.max() <= 1

    # merges invert their splits to within the quantized-u8 class
    m4 = color.merge_u8(y4, cb4, cr4, False)
    assert np.abs(np.asarray(m4).astype(int) - np.asarray(x).astype(int)).max() <= 2
    m2 = color.merge_u8(y2, cb2, cr2, "422")
    assert m2.shape == x.shape


# ---- stacked bulk dispatch (color) -----------------------------------------


def test_color_batch_encode_decode_bit_identical(rng):
    """encode/decode_color_batch_auto == per-frame auto helpers, bitwise,
    across mixed/ragged sizes, all chroma modes, and a float frame that
    falls back per-frame."""
    import numpy as np

    from tpudct.models.color import (
        decode_color_auto,
        decode_color_batch_auto,
        encode_color_auto,
        encode_color_batch_auto,
    )

    p = get_pipeline("hp")
    cfg = CodecConfig()
    shapes = [(100, 300), (97, 300), (64, 128), (100, 300)]
    rgbs = [rng.integers(0, 256, (*s, 3)).astype(np.uint8) for s in shapes]
    rgbs.append(rng.integers(0, 256, (40, 200, 3)).astype(np.float32))
    for mode in ("420", "422", False):
        got = encode_color_batch_auto(p, rgbs, cfg, subsample=mode)
        for rgb, (planes, meta) in zip(rgbs, got):
            p1, m1 = encode_color_auto(p, rgb, cfg, subsample=mode)
            assert m1["orig_shape"] == meta["orig_shape"]
            for k in ("y", "cb", "cr"):
                np.testing.assert_array_equal(
                    np.asarray(p1[k]), np.asarray(planes[k]))
        items = [(planes, meta, cfg) for planes, meta in got]
        dec = decode_color_batch_auto(p, items)
        for (planes, meta, icfg), r in zip(items, dec):
            np.testing.assert_array_equal(
                np.asarray(decode_color_auto(p, planes, meta, icfg)), r)


def test_color_batch_single_split_dispatch(rng, monkeypatch):
    """Same-width u8 frames must produce exactly ONE luma encode_u8 call
    (the whole chunk stacks)."""
    import numpy as np

    from tpudct.models import color as mcolor

    p = get_pipeline("hp")
    cfg = CodecConfig()
    rgbs = [rng.integers(0, 256, (40 + 8 * i, 250, 3), dtype=np.uint8)
            for i in range(3)]
    calls = []
    orig = p.encode_u8
    monkeypatch.setattr(
        type(p), "encode_u8",
        lambda self, x, c: calls.append((x.shape, c.q_table)) or orig(x, c),
    )
    mcolor.encode_color_batch_auto(p, rgbs, cfg)
    # one luma launch + one stacked-chroma launch for the whole chunk
    assert len(calls) == 2
    assert {qt for _, qt in calls} == {"luma", "chroma"}
    total_hk = sum(-(-(40 + 8 * i) // 16) * 16 for i in range(3))
    assert calls[0][0] == (total_hk, 256)


def test_color_deadzone_composes(rng):
    """cfg.deadzone composes with the color path (round 5): the u8 gate
    demotes to the f32 plane encode (which rides the einsum quantizer),
    payloads shrink, and the stream decodes through the unchanged color
    decode path."""
    import jax.numpy as jnp

    from tpudct.models.color import (
        color_kernel_shape, decode_color_auto, encode_color_auto,
        supports_color_u8,
    )
    from tpudct.utils import serialize

    hp = get_pipeline("hp")
    rgb = rng.integers(0, 256, (128, 256, 3), dtype=np.uint8)
    cfg0 = CodecConfig(interpret=True)
    cfgd = CodecConfig(interpret=True, deadzone=0.35)
    assert supports_color_u8(hp, cfg0, *color_kernel_shape(128, 256), "420")
    assert not supports_color_u8(hp, cfgd, *color_kernel_shape(128, 256), "420")
    pl0, m0 = encode_color_auto(hp, jnp.asarray(rgb), cfg0)
    pld, md = encode_color_auto(hp, jnp.asarray(rgb), cfgd)
    b0 = len(serialize.color_to_bytes(
        {k: np.asarray(v) for k, v in pl0.items()}, m0, codec="spectral"))
    bd = len(serialize.color_to_bytes(
        {k: np.asarray(v) for k, v in pld.items()}, md, codec="spectral"))
    assert bd < b0
    rec = np.asarray(decode_color_auto(hp, pld, md, CodecConfig(interpret=True)))
    assert rec.shape == (128, 256, 3) and rec.dtype == np.uint8
