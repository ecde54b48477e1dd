"""JPEG I/O tests — native C codec (csrc) and PIL fallback."""

import os

import numpy as np
import pytest

from tpudct.utils import imageio


@pytest.fixture
def gray(rng):
    return rng.integers(0, 256, size=(64, 48)).astype(np.uint8)


def test_native_backend_builds():
    # g++/make are baked into this image; the native path must come up.
    assert imageio.native_backend_available()


def test_roundtrip_native(tmp_path, gray):
    p = tmp_path / "img.jpg"
    imageio.save_jpeg(p, gray, quality=100)
    back = imageio.load_jpeg(p)
    assert back.shape == gray.shape and back.dtype == np.uint8
    # Quality-100 JPEG is lossy but close.
    assert np.abs(back.astype(int) - gray.astype(int)).mean() < 6.0


def test_lossless_on_smooth_image(tmp_path):
    img = np.tile(np.arange(64, 192, 2, dtype=np.uint8), (64, 1))
    p = tmp_path / "s.jpg"
    imageio.save_jpeg(p, img, quality=100)
    back = imageio.load_jpeg(p)
    assert np.abs(back.astype(int) - img.astype(int)).max() <= 3


def test_encode_bytes_matches_file(tmp_path, gray):
    p = tmp_path / "img.jpg"
    imageio.save_jpeg(p, gray, quality=90)
    data = imageio.encode_jpeg_bytes(gray, quality=90)
    assert abs(len(data) - os.path.getsize(p)) < 64  # same codec, same tables


def test_pil_fallback_agrees(tmp_path, gray, monkeypatch):
    p = tmp_path / "img.jpg"
    imageio.save_jpeg(p, gray, quality=100)
    native = imageio.load_jpeg(p)
    monkeypatch.setattr(imageio, "_lib", None)
    monkeypatch.setattr(imageio, "_lib_tried", True)
    assert not imageio.native_backend_available()
    pil = imageio.load_jpeg(p)
    # Same file, two decoders: IDCT rounding may differ by a couple LSBs.
    assert np.abs(native.astype(int) - pil.astype(int)).max() <= 2


def test_decode_missing_file_raises(tmp_path):
    with pytest.raises(Exception):
        imageio.load_jpeg(tmp_path / "nope.jpg")


def test_save_accepts_rgb_rejects_other_shapes(tmp_path):
    p = tmp_path / "x.jpg"
    imageio.save_jpeg(p, np.zeros((8, 8, 3), np.uint8))
    assert imageio.load_jpeg(p, force_gray=False).shape == (8, 8, 3)
    with pytest.raises(ValueError):
        imageio.save_jpeg(tmp_path / "y.jpg", np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        imageio.save_jpeg(tmp_path / "z.jpg", np.zeros((4,), np.uint8))


def test_load_jpeg_batch_matches_sequential(tmp_path, rng):
    from tpudct.utils import imageio

    paths = []
    for i, shape in enumerate([(64, 48), (32, 32), (80, 96)]):
        img = rng.integers(0, 256, shape).astype("uint8")
        p = tmp_path / f"b{i}.jpg"
        imageio.save_jpeg(p, img)
        paths.append(p)
    batch = imageio.load_jpeg_batch(paths, n_threads=3)
    seq = [imageio.load_jpeg(p) for p in paths]
    assert len(batch) == len(seq)
    for b, s in zip(batch, seq):
        np.testing.assert_array_equal(b, s)


def test_load_jpeg_batch_raises_on_missing(tmp_path, rng):
    import pytest

    from tpudct.utils import imageio

    img = rng.integers(0, 256, (32, 32)).astype("uint8")
    good = tmp_path / "ok.jpg"
    imageio.save_jpeg(good, img)
    if not imageio.native_backend_available():
        pytest.skip("native codec unavailable")
    with pytest.raises(IOError):
        imageio.load_jpeg_batch([good, tmp_path / "missing.jpg"])


def test_save_image_png_is_lossless(tmp_path, gray):
    """Extension-dispatched save: .png must round-trip the exact pixels
    (the .jpg path is quality-100 — near-lossless only)."""
    p = tmp_path / "out.png"
    imageio.save_image(str(p), gray)
    back = imageio.load_image(str(p))
    np.testing.assert_array_equal(back, gray)
    rgb = np.stack([gray, gray // 2, 255 - gray], axis=-1)
    p3 = tmp_path / "rgb.png"
    imageio.save_image(str(p3), rgb)
    np.testing.assert_array_equal(imageio.load_image(str(p3), force_gray=False), rgb)


def test_save_image_jpg_routes_native(tmp_path, gray):
    pj = tmp_path / "out.jpg"
    imageio.save_image(str(pj), gray, quality=100)
    pj2 = tmp_path / "ref.jpg"
    imageio.save_jpeg(str(pj2), gray, quality=100)
    assert pj.read_bytes() == pj2.read_bytes()


def test_load_image_png_gray_conversion(tmp_path, gray):
    rgb = np.stack([gray] * 3, axis=-1)
    p = tmp_path / "in.png"
    imageio.save_image(str(p), rgb)
    g = imageio.load_image(str(p))
    assert g.ndim == 2 and g.shape == gray.shape


def test_save_image_refuses_lossy_nonjpeg(tmp_path, gray):
    """Formats PIL would save lossy by default (.webp q80, .gif quantized)
    are refused rather than silently breaking the lossless promise."""
    with pytest.raises(ValueError, match="unsupported output extension"):
        imageio.save_image(str(tmp_path / "x.webp"), gray)
    with pytest.raises(ValueError, match="unsupported output extension"):
        imageio.save_image(str(tmp_path / "x.gif"), gray)


def test_native_loaders_race_free(monkeypatch):
    """Many threads asking for the native coders at once all get them:
    threads that arrived while the first one built the library used to
    see "no library" and pick another entropy stage (save_sharded then
    wrote bytes that depended on thread timing)."""
    import sys
    import threading

    from tpudct.utils import entropy

    monkeypatch.setattr(imageio, "_elib", None)
    monkeypatch.setattr(imageio, "_elib_tried", False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        seen = []
        threads = [threading.Thread(target=lambda: seen.append(entropy.native_entropy_available()))
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert seen == [True] * 32
