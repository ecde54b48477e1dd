"""Metrics + serialization tests."""

import numpy as np
import pytest

from tpudct.utils import metrics, serialize


def test_mse_psnr_peen_basics(rng):
    x = rng.integers(0, 256, size=(64, 64)).astype(np.float32)
    assert float(metrics.mse(x, x)) == 0.0
    assert float(metrics.peen(x, x)) == 0.0
    y = x + 1.0
    assert abs(float(metrics.mse(x, y)) - 1.0) < 1e-6
    assert abs(float(metrics.psnr(x, y)) - 10 * np.log10(255.0**2)) < 1e-3
    # PEEN normalizes by input energy.
    expected_peen = 100.0 * (64 * 64) / float((x.astype(np.float64) ** 2).sum())
    assert abs(float(metrics.peen(x, y)) - expected_peen) < 1e-4


def test_compression_factor_increases_with_truncation(rng):
    from tpudct import CodecConfig, get_pipeline
    import jax.numpy as jnp

    img = rng.integers(0, 256, size=(128, 128)).astype(np.float32)
    p = get_pipeline("batched")
    factors = []
    for k in [None, 10, 6]:
        c, _ = p.roundtrip(jnp.asarray(img), CodecConfig(retain_k=k))
        factors.append(metrics.compression_factor(img.astype(np.uint8), np.asarray(c)))
    assert factors[0] < factors[1] < factors[2], factors
    assert factors[0] > 1.0  # quantization alone must win over raw


def test_compression_factor_non_block_aligned(rng):
    # quality_report is public API: a non-8-multiple coefficient map must
    # fall back to the raw-stream denominator, not raise from a reshape.
    img = rng.integers(0, 256, (60, 60)).astype(np.uint8)
    c = rng.integers(-50, 50, (60, 60)).astype(np.int16)
    f = metrics.compression_factor(img, c)
    assert np.isfinite(f) and f > 0


def test_quality_report_keys(rng):
    img = rng.integers(0, 256, size=(64, 64)).astype(np.uint8)
    rec = img.copy()
    c = np.zeros((64, 64), np.float32)
    rep = metrics.quality_report(img, rec, c)
    assert set(rep) == {"mse", "psnr_db", "peen_pct", "ssim",
                        "compression_factor", "jpeg_factor"}
    # identical recon => the reference's re-encode model gives factor ~1
    assert 0.9 < rep["jpeg_factor"] < 1.1


def test_jpeg_factor_tracks_reference_model(rng):
    """The reference's factor (README.md:69) is size(jpeg(original)) /
    size(jpeg(reconstruction)) at quality 100 (main_cublass.cu:152): a
    coarsely quantized reconstruction re-encodes SMALLER, so the factor
    must rise as quantization gets harsher."""
    img = rng.integers(0, 256, (128, 128)).astype(np.uint8)
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline

    p = get_pipeline("batched")
    facs = []
    for q in (0.5, 2.0, 8.0):
        _, rec = p.roundtrip(jnp.asarray(img, jnp.float32), CodecConfig(q_scale=q))
        facs.append(metrics.jpeg_compression_factor(img, np.asarray(rec)))
    assert facs[0] < facs[1] < facs[2], facs
    assert facs[0] > 1.0


def test_serialize_roundtrip(tmp_path, rng):
    c = rng.integers(-100, 100, size=(64, 128)).astype(np.float32)
    path = tmp_path / "x.tdc"
    n = serialize.save_coefficients(path, c, q_scale=2.0, retain_k=8)
    assert n == path.stat().st_size
    back, q_scale, k = serialize.load_coefficients(path)
    np.testing.assert_array_equal(back, c)
    assert q_scale == 2.0 and k == 8


def test_serialize_rejects_garbage(tmp_path):
    with pytest.raises(ValueError):
        serialize.bytes_to_coefficients(b"JUNKJUNKJUNKJUNKJUNKJUNKJUNK")


def test_serialize_rejects_int16_overflow():
    # The round-1 silent-corruption repro: 40000.0 narrowed to -25536.
    # Must raise, never wrap (reachable via encode --q-scale 0.001).
    c = np.zeros((8, 8), np.float32)
    c[0, 0] = 40000.0
    with pytest.raises(ValueError, match="int16"):
        serialize.coefficients_to_bytes(c)
    # Boundary values still round-trip exactly.
    c[0, 0] = 32767.0
    c[0, 1] = -32767.0
    back, _, _ = serialize.bytes_to_coefficients(serialize.coefficients_to_bytes(c))
    np.testing.assert_array_equal(back, c)


def test_huffman_codec_roundtrip_and_auto(rng):
    """JPEG-grade Huffman entropy stage (utils/entropy.py): bit-exact
    through the container, native and pure-Python decoders agree, and
    'auto' never stores a larger payload than spectral+zlib."""
    import zlib

    from tpudct.utils import entropy

    c = rng.integers(-90, 90, (64, 64)).astype(np.float32)
    c[rng.random((64, 64)) < 0.8] = 0.0  # sparse, like real coefficients

    blob = serialize.coefficients_to_bytes(c, codec="huffman")
    back, _, _ = serialize.bytes_to_coefficients(blob)
    np.testing.assert_array_equal(back, c)

    if entropy.native_entropy_available():
        stream = entropy.huff_encode(c.astype(np.int16))
        np.testing.assert_array_equal(
            entropy._py_decode(stream, 64, 64),
            entropy.huff_decode(stream, 64, 64),
        )

    auto = serialize.coefficients_to_bytes(c, codec="auto")
    spec = serialize.coefficients_to_bytes(c, codec="spectral")
    assert len(auto) <= len(spec)
    back_a, _, _ = serialize.bytes_to_coefficients(auto)
    np.testing.assert_array_equal(back_a, c)


def test_huffman_codec_extreme_values():
    # Full int16 range: AC size category 15, DC delta size up to 17.
    c = np.zeros((16, 24), np.float32)
    c[0, 0] = 32767.0
    c[8, 8] = -32767.0
    c[0, 9] = 255.0
    c[7, 23] = -1.0
    blob = serialize.coefficients_to_bytes(c, codec="huffman")
    back, _, _ = serialize.bytes_to_coefficients(blob)
    np.testing.assert_array_equal(back, c)

    from tpudct.utils import entropy

    stream = entropy.huff_encode(c.astype(np.int16))
    np.testing.assert_array_equal(entropy._py_decode(stream, 16, 24), c)


def test_huffman_decoder_survives_garbage(rng):
    """Adversarial robustness: arbitrary bytes through the native C
    decoder must produce a clean ValueError (or decode), never crash or
    read out of bounds — this is the persistence format's attack surface."""
    from tpudct.utils import entropy

    if not entropy.native_entropy_available():
        pytest.skip("native entropy codec unavailable")
    c = np.zeros((16, 16), np.float32)
    good = bytearray(entropy.huff_encode(c.astype(np.int16)))
    for trial in range(200):
        data = bytearray(good)
        # mutate a few random bytes (keep version byte sometimes)
        for _ in range(int(rng.integers(1, 8))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        try:
            entropy.huff_decode(bytes(data), 16, 16)
        except ValueError:
            pass
    for trial in range(100):
        n = int(rng.integers(0, 400))
        data = bytes([1]) + rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        try:
            entropy.huff_decode(data, 16, 16)
        except ValueError:
            pass


def test_huffman_truncated_raises():
    c = np.arange(64, dtype=np.float32).reshape(8, 8)
    blob = serialize.coefficients_to_bytes(c, codec="huffman")
    with pytest.raises(ValueError):
        serialize.bytes_to_coefficients(blob[:-3])
    # A bitstream claiming more bits than the payload carries must raise
    # from the decoder itself (native -4 / python EOF), not mis-decode.
    from tpudct.utils import entropy

    stream = bytearray(entropy.huff_encode(c.astype(np.int16)))
    with pytest.raises(ValueError):
        entropy.huff_decode(bytes(stream[:-2]), 8, 8)


def test_progressive_partial_decode(rng):
    """Spectral streams decode progressively: plane prefixes give monotone
    quality; all 64 planes equal the full decode; DC-only preview equals
    the reconstruction's block means; and a truncated FILE still yields
    the preview."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.benchmark import photographic_image

    img = photographic_image(128)
    p = get_pipeline("batched")
    cfg = CodecConfig()
    c = np.asarray(p.encode(jnp.asarray(img), cfg))
    blob = serialize.coefficients_to_bytes(c, orig_shape=img.shape, codec="spectral")

    full, _, _ = serialize.bytes_to_coefficients(blob)
    p64 = serialize.partial_coefficients(blob, n_planes=64)
    np.testing.assert_array_equal(p64["coeffs"], full)

    mses = []
    for n in (1, 4, 16, 64):
        part = serialize.partial_coefficients(blob, n_planes=n)
        rec = np.asarray(p.idct(jnp.asarray(part["coeffs"]), cfg))
        mses.append(((np.clip(np.trunc(rec), 0, 255) - img) ** 2).mean())
    assert mses[0] >= mses[1] >= mses[2] >= mses[3]
    assert mses[3] < 0.5 * mses[0]  # AC planes carry real signal here

    pv = serialize.preview_from_bytes(blob)
    assert pv.shape == (16, 16) and pv.dtype == np.uint8
    rec_full = np.asarray(p.idct(jnp.asarray(full), cfg))
    means = rec_full.reshape(16, 8, 16, 8).mean(axis=(1, 3))
    assert np.abs(pv.astype(np.float64) - means).max() <= 1.5

    # a truncated download: keep only enough compressed bytes for the DC
    # plane (half the stream is plenty here) — preview still works
    np.testing.assert_array_equal(
        serialize.preview_from_bytes(blob[: len(blob) // 2]), pv
    )

    # interleaved whole-stream codecs have no truncatable prefix; they
    # decode whole and mask — the progressive RESULT is identical to the
    # spectral stream's at every n (decode-and-mask contract)
    for codec in ("huffman", "rans", "raw"):
        ib = serialize.coefficients_to_bytes(c, orig_shape=img.shape, codec=codec)
        for n in (1, 4, 64):
            np.testing.assert_array_equal(
                serialize.partial_coefficients(ib, n_planes=n)["coeffs"],
                serialize.partial_coefficients(blob, n_planes=n)["coeffs"],
            )
        np.testing.assert_array_equal(serialize.preview_from_bytes(ib), pv)


def test_color_preview_matches_downsampled_original():
    """DC-only color thumbnail ≈ the 8x-box-downsampled original (DC IS
    the block mean; color conversion is the only other step)."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.benchmark import photographic_image
    from tpudct.models.color import encode_color

    g = photographic_image(128)
    rgb = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1)
    p = get_pipeline("batched")
    planes, meta = encode_color(p, jnp.asarray(rgb), CodecConfig())
    blob = serialize.color_to_bytes(
        {k: np.asarray(v) for k, v in planes.items()}, meta, codec="spectral"
    )
    pv = serialize.preview_color_from_bytes(blob).astype(np.float64)
    assert pv.shape == (16, 16, 3)
    box = rgb.reshape(16, 8, 16, 8, 3).mean(axis=(1, 3))
    # DC quantization (Q00=16 luma / 17 chroma) + rounding bound the mean;
    # the max is looser because each 4:2:0 chroma DC covers a 16x16 source
    # region and upsamples nearest — sharp chroma edges (this image rolls
    # channels) locally deviate by a few DC steps.
    assert np.abs(pv - box).mean() < 6.0
    assert np.abs(pv - box).max() < 40.0
    """Fuzz extreme q_scale x transform through encode -> bytes -> decode:
    every coefficient either serializes exactly or raises — no silent
    corruption anywhere in the chain."""
    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 64)).astype(np.float32)
    p = get_pipeline("batched")
    for transform in ("haweel", "dct"):
        for qs in (0.001, 0.01, 0.25, 64.0):
            cfg = CodecConfig(q_scale=qs, transform=transform)
            c = np.asarray(p.encode(jnp.asarray(img), cfg))
            try:
                blob = serialize.coefficients_to_bytes(
                    c, q_scale=qs, transform=transform
                )
            except ValueError:
                assert np.abs(c).max() > 32767.0, (transform, qs)
                continue
            back, q_out, _ = serialize.bytes_to_coefficients(blob)
            np.testing.assert_array_equal(back, c)
            assert q_out == np.float32(qs)


def test_serialized_decode_end_to_end(tmp_path, rng):
    """Encode -> .tdc file -> decode with a different pipeline."""
    from tpudct import CodecConfig, get_pipeline
    import jax.numpy as jnp

    img = rng.integers(0, 256, size=(128, 128)).astype(np.float32)
    cfg = CodecConfig(retain_k=8)
    c = get_pipeline("fast").encode(jnp.asarray(img), cfg)
    serialize.save_coefficients(tmp_path / "x.tdc", np.asarray(c), retain_k=8)
    back, q_scale, k = serialize.load_coefficients(tmp_path / "x.tdc")
    rec = get_pipeline("batched").idct(jnp.asarray(back), CodecConfig(q_scale=q_scale))
    m = float(metrics.mse(img, np.clip(np.trunc(np.asarray(rec)), 0, 255)))
    # Decodes to the same quality ballpark as a direct roundtrip.
    _, direct = get_pipeline("batched").roundtrip(jnp.asarray(img), cfg)
    md = float(metrics.mse(img, np.asarray(direct)))
    assert abs(m - md) / md < 0.05


def test_truncated_tdc_raises_value_error(rng, tmp_path):
    # A stream cut mid-payload must surface the module's own ValueError,
    # not a raw zlib.error (the bulk-encoder recovery catches ValueError).
    import pytest

    from tpudct.utils import serialize

    c = rng.integers(-40, 40, (32, 32)).astype(np.float32)
    data = serialize.coefficients_to_bytes(c)
    with pytest.raises(ValueError):
        serialize.bytes_to_coefficients(data[: len(data) - 10])


def test_ssim_bounds(rng):
    from tpudct.utils.metrics import ssim

    x = rng.integers(0, 256, (64, 64)).astype(np.float32)
    assert abs(float(ssim(x, x)) - 1.0) < 1e-6
    noisy = np.clip(x + rng.normal(0, 25, x.shape), 0, 255).astype(np.float32)
    v = float(ssim(x, noisy))
    assert 0.0 < v < 1.0
    # more distortion -> lower ssim
    worse = np.clip(x + rng.normal(0, 80, x.shape), 0, 255).astype(np.float32)
    assert float(ssim(x, worse)) < v


# ---- spectral entropy codec (v4 .tdc streams) ------------------------------


def test_spectral_pack_unpack_exact(rng):
    from tpudct.utils.serialize import _spectral_pack, _spectral_unpack

    c = rng.integers(-100, 100, (64, 128)).astype(np.int16)
    np.testing.assert_array_equal(_spectral_unpack(_spectral_pack(c), 64, 128), c)


def test_spectral_pack_matches_naive_reference(rng):
    """The cache-blocked pack (fast path at gigapixel scale) must emit
    the BYTE-IDENTICAL stream of the straightforward per-plane packer —
    the on-disk format is deployed and must never drift."""
    from tpudct.utils.serialize import _BS, _ZIGZAG, _spectral_pack

    def naive_pack(c):
        h, w = c.shape
        b = c.reshape(h // _BS, _BS, w // _BS, _BS).transpose(1, 3, 0, 2)
        dc = b[0, 0].astype(np.int32).ravel()
        dcd = np.diff(dc, prepend=np.int32(0))
        flags = 0
        if np.abs(dcd.astype(np.int64)).max(initial=0) < 32768:
            dc_bytes = dcd.astype(np.int16).tobytes()
        else:
            flags |= 2  # _DCRAW
            dc_bytes = dc.astype(np.int16).tobytes()
        ac = np.concatenate([b[u, v].ravel() for (u, v) in _ZIGZAG[1:]])
        if np.abs(ac.astype(np.int32)).max(initial=0) < 128:
            ac_bytes = ac.astype(np.int8).tobytes()
        else:
            flags |= 1  # _AC16
            ac_bytes = ac.tobytes()
        return bytes([flags]) + dc_bytes + ac_bytes

    cases = [
        rng.integers(-100, 100, (64, 128)).astype(np.int16),  # int8 AC
        rng.integers(-3000, 3000, (32, 40)).astype(np.int16),  # int16 AC
        np.full((8, 8), -32768, np.int16),  # int16 min edge
    ]
    dcraw = np.zeros((16, 16), np.int16)
    dcraw[0::8, 0::8] = [[-30000, 30000], [30000, -30000]]  # DC delta escape
    cases.append(dcraw)
    for c in cases:
        assert _spectral_pack(c) == naive_pack(c)


def test_spectral_escape_paths_exact(rng):
    """Wide AC values / overflowing DC deltas flip the escape flags and
    still roundtrip bit-exactly."""
    from tpudct.utils.serialize import _spectral_pack, _spectral_unpack

    c = rng.integers(-3000, 3000, (32, 32)).astype(np.int16)  # AC > int8
    np.testing.assert_array_equal(_spectral_unpack(_spectral_pack(c), 32, 32), c)
    c = np.zeros((16, 16), np.int16)
    c[0::8, 0::8] = [[-30000, 30000], [30000, -30000]]  # DC delta > int16
    np.testing.assert_array_equal(_spectral_unpack(_spectral_pack(c), 16, 16), c)


def test_spectral_smaller_than_raw_on_real_coefficients(rng):
    from tpudct import CodecConfig, get_pipeline
    import jax.numpy as jnp

    from tpudct.benchmark import synthetic_image

    img = synthetic_image(512)
    c = np.asarray(get_pipeline("batched").encode(jnp.asarray(img), CodecConfig()))
    spectral = serialize.coefficients_to_bytes(c, codec="spectral")
    raw = serialize.coefficients_to_bytes(c, codec="raw")
    assert len(spectral) < 0.8 * len(raw)
    for blob in (spectral, raw):
        back, _q, _k = serialize.bytes_to_coefficients(blob)
        np.testing.assert_array_equal(back, c.astype(np.float32))


def test_legacy_v3_stream_still_loads(rng):
    """Pre-q_table streams (TDC3, raw int16 payload) must keep decoding."""
    import struct
    import zlib

    c = rng.integers(-50, 50, (16, 24)).astype(np.int16)
    payload = zlib.compress(c.tobytes(), 6)
    blob = struct.pack(
        "<4sIIIIfi8sI", b"TDC3", 16, 24, 10, 20, 1.5, 8, b"haweel\x00\x00",
        len(payload),
    ) + payload
    back, q, k, (oh, ow), tname = serialize.bytes_to_coefficients(
        blob, with_orig_shape=True, with_transform=True
    )
    np.testing.assert_array_equal(back, c.astype(np.float32))
    assert (q, k, oh, ow, tname) == (1.5, 8, 10, 20, "haweel")


def test_unknown_codec_rejected(rng):
    c = rng.integers(-5, 5, (8, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        serialize.coefficients_to_bytes(c, codec="arithmetic")
    blob = bytearray(serialize.coefficients_to_bytes(c))
    # corrupt the codec byte (offset: 4+4*4+4+4+8+8 = 44)
    blob[44] = 77
    with pytest.raises(ValueError):
        serialize.bytes_to_coefficients(bytes(blob))


def test_zigzag_matches_itu_t81_prefix():
    from tpudct.utils.serialize import zigzag_order

    # ITU-T T.81 Figure 5, first 10 positions.
    assert zigzag_order()[:10] == [
        (0, 0), (0, 1), (1, 0), (2, 0), (1, 1),
        (0, 2), (0, 3), (1, 2), (2, 1), (3, 0),
    ]


def test_spectral_int16_min_roundtrips():
    # np.abs(int16 -32768) wraps; the fit check must widen first.
    from tpudct.utils.serialize import _spectral_pack, _spectral_unpack

    c = np.zeros((8, 16), np.int16)
    c[0, 9] = -32768  # an AC position
    np.testing.assert_array_equal(_spectral_unpack(_spectral_pack(c), 8, 16), c)


def test_structured_image_small_sizes():
    from tpudct.benchmark import structured_image

    for s in (64, 72, 80, 96):
        img = structured_image(s)
        assert img.shape == (s, s) and img.dtype == np.float32


def test_bench_host_entropy_rows():
    """bench --host-entropy: a row per available codec, every decode
    asserted bit-exact inside (the function raises otherwise), auto's
    payload never larger than any explicit stage's."""
    from tpudct.benchmark import bench_host_entropy

    rows = bench_host_entropy(64, reps=1)
    by = {r["codec"]: r for r in rows}
    assert {"spectral", "raw", "auto"} <= set(by)
    for r in rows:
        assert r["bytes"] > 0 and r["encode_ms"] >= 0 and r["decode_ms"] >= 0
    assert by["auto"]["bytes"] <= min(
        r["bytes"] for c, r in by.items() if c != "auto"
    )
    with pytest.raises(ValueError):
        bench_host_entropy(64, image="nope")


def test_rans_codec_roundtrip_and_fallback(rng):
    """rANS entropy stage (.tdc codec 3, utils/entropy.py): bit-exact
    through the container, native and pure-Python decoders agree, and
    real coefficient maps come out smaller than the Huffman stage
    (sub-bit symbol costs + positional AC contexts)."""
    from tpudct.utils import entropy

    if not entropy.rans_available():
        pytest.skip("native rans codec unavailable")

    c = rng.integers(-90, 90, (64, 64)).astype(np.float32)
    c[rng.random((64, 64)) < 0.8] = 0.0  # sparse, like real coefficients

    blob = serialize.coefficients_to_bytes(c, codec="rans")
    back, _, _ = serialize.bytes_to_coefficients(blob)
    np.testing.assert_array_equal(back, c)

    stream = entropy.rans_encode(c.astype(np.int16))
    np.testing.assert_array_equal(
        entropy._py_rans_decode(stream, 64, 64),
        entropy.rans_decode(stream, 64, 64),
    )

    # auto must never store a larger payload than any explicit stage
    auto = serialize.coefficients_to_bytes(c, codec="auto")
    assert len(auto) <= len(blob)
    assert len(auto) <= len(serialize.coefficients_to_bytes(c, codec="spectral"))
    assert len(auto) <= len(serialize.coefficients_to_bytes(c, codec="huffman"))


def test_rans_v4_interleaved_stream(rng):
    """The opt-in 4-way-interleaved v4 stream (round 5): bit-exact
    roundtrip through both the native and pure-Python decoders, for
    single- and multi-band layouts, with only the flags byte plus three
    extra seeds per band of size cost over the serial stream.  (v4 is
    NOT the default — the interleaved decoder measured slower on a
    1-core host.)"""
    from tpudct.utils import entropy

    if not entropy.rans_available():
        pytest.skip("native rans codec unavailable")
    c = rng.integers(-90, 90, (96, 64)).astype(np.int16)
    c[rng.random((96, 64)) < 0.8] = 0
    for bands in (1, 3):
        v4 = entropy.rans_encode(c, bands, interleave=4)
        serial = entropy.rans_encode(c, bands, interleave=1)
        assert v4[0] == 4 and serial[0] in (2, 3)
        # three extra 4-byte seeds per band + the flags byte, minus the
        # entropy those seeds absorb from the renorm stream (~9 B/band)
        assert abs(len(v4) - len(serial)) <= 1 + 16 * bands
        np.testing.assert_array_equal(entropy.rans_decode(v4, 96, 64), c)
        np.testing.assert_array_equal(
            entropy._py_rans_decode(v4, 96, 64), c
        )
    with pytest.raises(ValueError, match="interleave"):
        entropy.rans_encode(c, 1, interleave=3)


def test_rans_beats_huffman_on_dct_statistics(rng):
    """The positional contexts must pay on DCT-shaped data: large DC,
    band-dependent AC magnitudes (this is the structural edge over a
    single-table Huffman coder; measured 4-9% on the benchmark images)."""
    from tpudct.utils import entropy

    if not entropy.rans_available():
        pytest.skip("native rans codec unavailable")
    h = w = 256
    c = np.zeros((h, w), np.int16)
    # synthetic DCT-like block statistics: decaying AC energy by band
    for by in range(h // 8):
        for bx in range(w // 8):
            c[by * 8, bx * 8] = rng.integers(-400, 400)
            for u in range(8):
                for v in range(8):
                    if u + v == 0:
                        continue
                    scale = 12.0 / (1 + 2 * (u + v))
                    if rng.random() < 0.25 + 0.6 / (1 + u + v):
                        c[by * 8 + u, bx * 8 + v] = int(
                            np.clip(rng.normal(0, scale), -127, 127)
                        )
    r = entropy.rans_encode(c)
    hstream = entropy.huff_encode(c)
    assert len(r) < len(hstream)
    np.testing.assert_array_equal(entropy.rans_decode(r, h, w), c)


def test_xz_codec_roundtrip_and_progressive(rng):
    """xz entropy stage (.tdc codec 4): the spectral reorder compressed
    with lzma — bit-exact through the container, progressive prefix
    decode works exactly like the spectral codec (both are
    spectral-ordered), and auto never stores a larger payload."""
    c = rng.integers(-90, 90, (64, 64)).astype(np.float32)
    c[rng.random((64, 64)) < 0.8] = 0.0

    blob = serialize.coefficients_to_bytes(c, codec="xz")
    assert serialize.inspect_stream(blob)["codec"] == "xz"
    back, _, _ = serialize.bytes_to_coefficients(blob)
    np.testing.assert_array_equal(back, c)

    # progressive: n_planes=64 == full decode; small-n prefixes zero the
    # unrequested zig-zag planes, identically to the spectral codec
    spec = serialize.coefficients_to_bytes(c, codec="spectral")
    full = serialize.partial_coefficients(blob, n_planes=64)
    np.testing.assert_array_equal(full["coeffs"], c)
    for n in (1, 4, 16):
        np.testing.assert_array_equal(
            serialize.partial_coefficients(blob, n_planes=n)["coeffs"],
            serialize.partial_coefficients(spec, n_planes=n)["coeffs"],
        )

    # highly repetitive content: xz must beat spectral+zlib (the
    # cross-block-LZ regime it exists for), and auto must pick it up
    tile = rng.integers(-40, 40, (8, 8)).astype(np.float32)
    rep = np.tile(tile, (16, 16))
    xz = serialize.coefficients_to_bytes(rep, codec="xz")
    assert len(xz) < len(serialize.coefficients_to_bytes(rep, codec="spectral"))
    assert len(serialize.coefficients_to_bytes(rep, codec="auto")) <= len(xz)

    # corrupt payload raises ValueError, not a raw lzma error
    bad = bytearray(blob)
    bad[-8] ^= 0xFF
    with pytest.raises(ValueError):
        serialize.bytes_to_coefficients(bytes(bad))


def test_rans_multiband_parity(rng):
    """Stream v2 bands: every band count must decode bit-exactly, native
    (pthread-per-band) and pure-Python (sequential) decoders must agree,
    and the multi-band overhead must stay tiny (global tables + one
    8-byte length entry and a DC-prediction reset per band)."""
    from tpudct.utils import entropy

    if not entropy.rans_available():
        pytest.skip("native rans codec unavailable")
    h, w = 128, 64  # 16 block rows -> up to 16 bands
    c = rng.integers(-80, 80, (h, w)).astype(np.int16)
    c[rng.random((h, w)) < 0.7] = 0
    sizes = {}
    for bands in (1, 2, 3, 4, 16):
        stream = entropy.rans_encode(c, bands=bands)
        assert stream[1] == bands  # header n_bands
        sizes[bands] = len(stream)
        np.testing.assert_array_equal(entropy.rans_decode(stream, h, w), c)
        np.testing.assert_array_equal(entropy._py_rans_decode(stream, h, w), c)
    assert sizes[16] - sizes[1] < 16 * 24 + 256  # bounded per-band overhead
    with pytest.raises(ValueError):
        entropy.rans_encode(c, bands=17)
    # bands are clamped to the block-row count
    small = rng.integers(-10, 10, (8, 16)).astype(np.int16)
    s = entropy.rans_encode(small, bands=16)
    assert s[1] == 1
    np.testing.assert_array_equal(entropy.rans_decode(s, 8, 16), small)


def test_rans_extreme_values_and_int16_min():
    from tpudct.utils import entropy

    if not entropy.rans_available():
        pytest.skip("native rans codec unavailable")
    c = np.zeros((16, 24), np.int16)
    c[0, 0] = 32767
    c[8, 8] = -32767
    c[0, 9] = 255
    c[7, 23] = -1
    stream = entropy.rans_encode(c)
    np.testing.assert_array_equal(entropy.rans_decode(stream, 16, 24), c)
    np.testing.assert_array_equal(entropy._py_rans_decode(stream, 16, 24), c)

    # -32768 has magnitude category 16 — unrepresentable in the 4-bit AC
    # size field; both encoders must refuse rather than emit a stream
    # that cannot decode (unreachable via serialize.py, which validates
    # |c| <= 32767 first — this guards the direct entropy API).
    c[3, 3] = -32768
    with pytest.raises(ValueError):
        entropy.rans_encode(c)
    with pytest.raises(ValueError):
        entropy.huff_encode(c)


def test_rans_decoder_survives_garbage(rng):
    """Adversarial robustness of codec 3, native AND pure-Python: mutated
    and random streams must ValueError or decode, never crash; whenever
    BOTH decoders accept a stream they must agree (fallback parity)."""
    from tpudct.utils import entropy

    if not entropy.rans_available():
        pytest.skip("native rans codec unavailable")
    c = rng.integers(-30, 30, (16, 16)).astype(np.int16)
    c[rng.random((16, 16)) < 0.7] = 0
    good = bytearray(entropy.rans_encode(c))
    for trial in range(200):
        data = bytearray(good)
        for _ in range(int(rng.integers(1, 8))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        native = err_n = None
        try:
            native = entropy.rans_decode(bytes(data), 16, 16)
        except ValueError as e:
            err_n = e
        try:
            py = entropy._py_rans_decode(bytes(data), 16, 16)
        except ValueError:
            py = None
        if native is not None and py is not None:
            np.testing.assert_array_equal(native, py)
        del err_n
    for trial in range(100):
        n = int(rng.integers(0, 400))
        data = bytes([2]) + rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        try:
            entropy.rans_decode(data, 16, 16)
        except ValueError:
            pass
        try:
            entropy._py_rans_decode(data, 16, 16)
        except ValueError:
            pass


# ---- banded codec (the distributed-checkpoint payload, VERDICT r2 #6) ------


def test_banded_codec_roundtrip_all_inners(rng):
    c = rng.integers(-90, 90, (128, 64)).astype(np.int16)
    for spec in ("banded", "banded:4", "banded:4:rans", "banded:3:spectral",
                 "banded:16:raw", "banded:2:xz", "banded:2:huffman"):
        if "rans" in spec or "huffman" in spec:
            from tpudct.utils import entropy
            if not entropy.native_entropy_available():
                continue
        blob = serialize.coefficients_to_bytes(c, codec=spec)
        back = serialize.bytes_to_coefficients(blob)[0]
        np.testing.assert_array_equal(np.asarray(back, np.int16), c)


def test_banded_codec_deterministic_and_validated(rng):
    c = rng.integers(-90, 90, (64, 64)).astype(np.int16)
    assert serialize.coefficients_to_bytes(c, codec="banded:4") == \
        serialize.coefficients_to_bytes(c, codec="banded:4")
    with pytest.raises(ValueError):  # nesting refused
        serialize.coefficients_to_bytes(c, codec="banded:2:banded")
    with pytest.raises(ValueError):  # more bands than block rows
        serialize.coefficients_to_bytes(c, codec="banded:999")
    # truncation detected
    blob = serialize.coefficients_to_bytes(c, codec="banded:4")
    with pytest.raises(ValueError):
        serialize.bytes_to_coefficients(blob[:-3])


def test_banded_large_segments_use_sampled_auto(rng, monkeypatch):
    """A banded segment above _AUTO_SAMPLE_MIN must pick its inner stage
    from the sampled estimator, never the exact trial loop (round 4:
    segments sat just under the whole-map exact threshold and were
    brute-forcing every stage per band — 13.7 s vs 2.3 s at 8192²).
    Small segments keep the exact trials (cheap there)."""
    big = rng.integers(-90, 90, (1024, 1024)).astype(np.int16)  # 1M coeffs

    def _boom(*a, **k):
        raise AssertionError("exact trials ran on a large banded segment")

    monkeypatch.setattr(serialize, "_exact_auto", _boom)
    blob = serialize.coefficients_to_bytes(big, codec="banded:1")
    back = serialize.bytes_to_coefficients(blob)[0]
    np.testing.assert_array_equal(np.asarray(back, np.int16), big)
    monkeypatch.undo()

    # determinism across calls (the sample is shape-deterministic)
    assert blob == serialize.coefficients_to_bytes(big, codec="banded:1")

    # small segments still take the exact loop
    small = rng.integers(-90, 90, (64, 64)).astype(np.int16)
    called = []
    real = serialize._exact_auto
    monkeypatch.setattr(
        serialize, "_exact_auto", lambda *a, **k: called.append(1) or real(*a, **k)
    )
    serialize.coefficients_to_bytes(small, codec="banded:1")
    assert called


def test_banded_inspect_reports_segments(rng):
    c = rng.integers(-90, 90, (64, 64)).astype(np.int16)
    blob = serialize.coefficients_to_bytes(c, codec="banded:4:spectral")
    info = serialize.inspect_stream(blob)
    assert info["codec"] == "banded" and info["segments"] == 4
    assert info["segment_codecs"] == ["spectral"] * 4


def test_banded_rows_split():
    assert serialize.banded_rows(128, 8) == [16] * 8
    assert serialize.banded_rows(88, 3) == [32, 32, 24]  # block-balanced
    assert sum(serialize.banded_rows(1032, 16)) == 1032


def test_banded_typo_codecs_rejected(rng):
    c = rng.integers(-50, 50, (16, 16)).astype(np.int16)
    for bad in ("banded2", "bandedraw", "bandit"):
        with pytest.raises(ValueError, match="unknown codec"):
            serialize.coefficients_to_bytes(c, codec=bad)


def test_auto_exact_is_the_trial_loop(rng):
    """codec='auto-exact' runs every stage and keeps the smallest; decode
    bit-exact."""
    c = rng.integers(-90, 90, (64, 64)).astype(np.float32)
    c[rng.random((64, 64)) < 0.8] = 0.0
    blob = serialize.coefficients_to_bytes(c, codec="auto-exact")
    for stage in ("spectral", "raw", "xz"):
        assert len(blob) <= len(
            serialize.coefficients_to_bytes(c, codec=stage)
        )
    back, _, _ = serialize.bytes_to_coefficients(blob)
    np.testing.assert_array_equal(back, c)


def test_auto_small_maps_stay_exact(monkeypatch, rng):
    """Below the 4M-coefficient threshold 'auto' IS the exact trial loop:
    the sampled estimator must never run there."""
    def _boom(*a, **k):
        raise AssertionError("predictive path ran on a small map")

    monkeypatch.setattr(serialize, "_predictive_auto", _boom)
    c = rng.integers(-30, 30, (64, 64)).astype(np.float32)
    blob = serialize.coefficients_to_bytes(c, codec="auto")
    back, _, _ = serialize.bytes_to_coefficients(blob)
    np.testing.assert_array_equal(back, c)


def test_auto_predictive_path(monkeypatch, rng):
    """Above the threshold 'auto' estimates on a sample and runs only the
    winner: decode stays bit-exact and the chosen stage is within 10% of
    the exact trial loop's pick (estimation may tip only near-ties)."""
    from tpudct.benchmark import photographic_image

    monkeypatch.setattr(serialize, "_AUTO_EXACT_MAX", 0)
    img = photographic_image(128)
    # quantized-DCT-statistics map without a device: host einsum
    from tpudct.benchmark import _host_dct_quant
    from tpudct.config import CodecConfig

    c = np.ascontiguousarray(
        _host_dct_quant(img, CodecConfig()).transpose(0, 2, 1, 3)
    ).reshape(128, 128).astype(np.float32)
    blob = serialize.coefficients_to_bytes(c, codec="auto")
    back, _, _ = serialize.bytes_to_coefficients(blob)
    np.testing.assert_array_equal(back, c)
    exact = serialize.coefficients_to_bytes(c, codec="auto-exact")
    assert len(blob) <= 1.10 * len(exact)


def test_auto_sample_deterministic_and_block_aligned():
    c = np.arange(512 * 256, dtype=np.int16).reshape(512, 256)
    s1 = serialize._auto_sample(c)
    s2 = serialize._auto_sample(c)
    np.testing.assert_array_equal(s1, s2)
    assert s1.shape[0] % 8 == 0 and s1.shape[1] == 256
    # the sample is a subset of whole block rows of c
    assert s1.shape[0] <= c.shape[0]
    # tiny maps sample to themselves (estimates degenerate to exact sizes)
    tiny = np.ones((8, 8), np.int16)
    np.testing.assert_array_equal(serialize._auto_sample(tiny), tiny)


def test_auto_predictive_inside_banded_segments(monkeypatch, rng):
    """banded:N:auto segments go predictive on big slabs too, and the
    banded stream stays bit-exact + byte-deterministic."""
    monkeypatch.setattr(serialize, "_AUTO_EXACT_MAX", 0)
    c = rng.integers(-60, 60, (128, 64)).astype(np.float32)
    c[rng.random((128, 64)) < 0.7] = 0.0
    b1 = serialize.coefficients_to_bytes(c, codec="banded:4:auto")
    b2 = serialize.coefficients_to_bytes(c, codec="banded:4:auto")
    assert b1 == b2
    back, _, _ = serialize.bytes_to_coefficients(b1)
    np.testing.assert_array_equal(back, c)


def test_bd_rate_known_shifts():
    """BD metrics on analytically known curves: a uniform -10% rate shift
    reads as BD-rate = -10%; identical curves read as 0; a +1 dB PSNR
    shift reads as BD-PSNR = +1."""
    from tpudct.benchmark import bd_psnr_db, bd_rate_pct

    psnr = np.array([30.0, 33.0, 36.0, 39.0, 42.0])
    rate = np.array([1e4, 2e4, 4e4, 8e4, 1.6e5])
    anchor = list(zip(rate, psnr))
    assert abs(bd_rate_pct(anchor, anchor)) < 1e-9
    shifted = list(zip(rate * 0.9, psnr))
    assert abs(bd_rate_pct(anchor, shifted) - (-10.0)) < 1e-6
    assert abs(bd_psnr_db(anchor, anchor)) < 1e-9
    better = list(zip(rate, psnr + 1.0))
    assert abs(bd_psnr_db(anchor, better) - 1.0) < 1e-6
    with pytest.raises(ValueError, match=">= 4"):
        bd_rate_pct(anchor[:3], anchor[:3])
    with pytest.raises(ValueError, match="overlap"):
        bd_rate_pct(anchor, [(r, p + 50.0) for r, p in anchor])


def test_curve_cli_prints_bd_summary(capsys):
    from tpudct.cli import main

    rc = main(["curve", "--qualities", "20,40,60,80,90", "--image", "photo"])
    assert rc == 0
    import json as _json

    lines = [
        _json.loads(l) for l in capsys.readouterr().out.strip().splitlines()
    ]
    assert len(lines) == 6
    summary = lines[-1]
    assert "bd_rate_pct_vs_libjpeg" in summary and summary["points"] == 5
    assert summary["transform"] == "haweel"


def test_rans_v3_six_band_contexts(rng):
    """Stream v3 (6 AC band contexts): real DCT-statistics maps pick v3
    and shrink 1.5-3.5% vs the v2 layout; tiny maps stay v2 (the three
    extra tables would cost more than the model gain); both versions
    decode bit-exactly through the native AND pure-Python decoders."""
    from tpudct.benchmark import _host_dct_quant, photographic_image
    from tpudct.config import CodecConfig
    from tpudct.utils import entropy

    if not entropy.rans_available():
        pytest.skip("native rans codec unavailable")
    img = photographic_image(256)
    c = np.ascontiguousarray(
        _host_dct_quant(img, CodecConfig()).transpose(0, 2, 1, 3)
    ).reshape(256, 256).astype(np.int16)
    blob = entropy.rans_encode(c)
    assert blob[0] == 3  # rich-enough map: v3 chosen
    np.testing.assert_array_equal(entropy.rans_decode(blob, 256, 256), c)
    np.testing.assert_array_equal(entropy._py_rans_decode(blob, 256, 256), c)
    tiny = np.zeros((16, 16), np.int16)
    tiny[0, 0] = 5
    b2 = entropy.rans_encode(tiny)
    assert b2[0] == 2  # near-empty map: extra tables never pay
    np.testing.assert_array_equal(entropy.rans_decode(b2, 16, 16), tiny)
    np.testing.assert_array_equal(entropy._py_rans_decode(b2, 16, 16), tiny)


def test_zero_high_planes_paths_agree(rng):
    """The sparse small-n rebuild and the masked-multiply forms of
    _zero_high_planes must agree at every n (round 5: n <= 8 rebuilds
    sparsely — one strided copy per kept position)."""
    c = rng.integers(-300, 300, (64, 128)).astype(np.int16)
    for n in (1, 3, 8, 9, 20, 63, 64):
        got = serialize._zero_high_planes(c.copy(), n)
        mask = np.zeros((8, 8), np.int16)
        for (u, v) in serialize._ZIGZAG[:n]:
            mask[u, v] = 1
        ref = c.copy().reshape(8, 8, 16, 8) * mask[None, :, None, :]
        np.testing.assert_array_equal(got, ref.reshape(64, 128), err_msg=str(n))
