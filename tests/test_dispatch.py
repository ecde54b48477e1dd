"""Unified dispatch gate: ragged (camera) sizes must ride the fused kernels.

VERDICT r2 items 1-2: previously a 4032-wide photo silently dropped to the
~6x-slower einsum fallback (the fused kernels need w % 128 == 0 but padding
stopped at 8-multiples), and `encode` staged f32 unconditionally.  These
tests pin the shared gate's decisions, the block-locality guarantee that
makes kernel padding safe, and that every CLI-facing helper actually
engages the u8 kernels for ragged sizes.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpudct import CodecConfig, get_pipeline
from tpudct.models.dispatch import (
    choose_gray_path,
    decode_gray_auto,
    encode_gray_auto,
    roundtrip_gray_auto,
)

CFG = CodecConfig()


def _ragged(rng, h=40, w=250):
    return rng.integers(0, 256, (h, w)).astype(np.uint8)


# ---- path decisions (pure metadata, including full camera sizes) -----------


@pytest.mark.parametrize("shape", [(4000, 2992), (1000, 700), (4032, 3024),
                                   (512, 512), (60, 100), (8, 8)])
def test_camera_sizes_choose_u8(shape):
    assert choose_gray_path(get_pipeline("hp"), *shape, CFG) == "u8"


def test_int8_unsafe_q_scale_chooses_f32():
    # max quantized |coefficient| ~97.2/q_scale for haweel/luma: q_scale
    # below ~0.77 overflows int8, so the f32 Pallas path must take over.
    assert choose_gray_path(get_pipeline("hp"), 1000, 700, CodecConfig(q_scale=0.25)) == "f32"


def test_no_integer_core_transform_chooses_f32():
    assert choose_gray_path(get_pipeline("hp"), 1000, 700, CodecConfig(transform="dct")) == "f32"


def test_non_hp_pipeline_chooses_general():
    assert choose_gray_path(get_pipeline("batched"), 1000, 700, CFG) == "general"


def test_float_input_demotes_to_f32(rng):
    # Float pixels may sit outside [0, 255]; casting to uint8 would wrap.
    p = get_pipeline("hp")
    img = _ragged(rng).astype(np.float32)
    calls = []
    orig = p.roundtrip
    p.roundtrip = lambda x, cfg: calls.append(x.dtype) or orig(x, cfg)
    try:
        roundtrip_gray_auto(p, img, CFG)
    finally:
        del p.roundtrip
    assert calls and calls[0] == jnp.float32


# ---- engagement: the fused u8 path actually runs for ragged sizes ----------


def test_roundtrip_engages_u8_kernels(rng):
    p = get_pipeline("hp")
    img = _ragged(rng)
    calls = []
    orig = p.roundtrip_u8
    p.roundtrip_u8 = lambda x, cfg: calls.append(tuple(x.shape)) or orig(x, cfg)
    try:
        c, r = roundtrip_gray_auto(p, img, CFG)
    finally:
        del p.roundtrip_u8
    # padded to the 8x8 block grid only (the kernels mask their edges)
    assert calls == [(40, 256)]
    assert r.shape == (40, 250) and r.dtype == np.uint8
    # coefficient map cropped back to the 8-aligned container shape
    assert tuple(c.shape) == (40, 256)


def test_encode_engages_u8_kernels(rng):
    p = get_pipeline("hp")
    img = _ragged(rng)
    calls = []
    orig = p.encode_u8
    p.encode_u8 = lambda x, cfg: calls.append(tuple(x.shape)) or orig(x, cfg)
    try:
        c, (h, w) = encode_gray_auto(p, img, CFG)
    finally:
        del p.encode_u8
    assert calls == [(40, 256)] and (h, w) == (40, 250)
    assert np.asarray(c).dtype == np.int8


def test_decode_engages_u8_kernels(rng):
    p = get_pipeline("hp")
    c, (h, w) = encode_gray_auto(p, _ragged(rng), CFG)
    calls = []
    orig = p.decode_u8
    p.decode_u8 = lambda x, cfg: calls.append(tuple(x.shape)) or orig(x, cfg)
    try:
        rec = decode_gray_auto(p, c, CFG, (h, w))
    finally:
        del p.decode_u8
    # the 8-aligned (40, 256) map needs no kernel-grid padding
    assert calls == [(40, 256)]
    assert rec.shape == (40, 250)


# ---- correctness of the padding scheme --------------------------------------


def test_kernel_padding_is_block_local(rng):
    """Two different valid kernel paddings must agree bit-exactly on the
    original region — the 8x8 transform never crosses block edges, which
    is what makes padding to the kernel grid safe at all."""
    p = get_pipeline("hp")
    img = _ragged(rng)
    pad_a = np.pad(img, ((0, 24), (0, 6)), mode="edge")   # 64 x 256
    pad_b = np.pad(img, ((0, 56), (0, 134)), mode="edge")  # 96 x 384
    ca, ra = p.roundtrip_u8(jnp.asarray(pad_a), CFG)
    cb, rb = p.roundtrip_u8(jnp.asarray(pad_b), CFG)
    np.testing.assert_array_equal(np.asarray(ra)[:40, :250], np.asarray(rb)[:40, :250])
    np.testing.assert_array_equal(np.asarray(ca)[:40, :256], np.asarray(cb)[:40, :256])


def test_ragged_matches_einsum_path(rng):
    """The kernel-padded u8 result must sit inside the documented +-1
    quantizer-tie equivalence class of the einsum path on the same image."""
    img = _ragged(rng, 52, 300)
    c_u8, _ = encode_gray_auto(get_pipeline("hp"), img, CFG)
    c_gen, _ = encode_gray_auto(get_pipeline("batched"), img, CFG)
    a, b = np.asarray(c_u8, np.float64), np.asarray(c_gen, np.float64)
    assert a.shape == b.shape == (56, 304)
    assert np.abs(a - b).max() <= 1.0
    assert (a != b).mean() <= 5e-3


def test_decode_roundtrip_through_container(rng, tmp_path):
    """encode_gray_auto -> .tdc -> decode_gray_auto recovers the u8-path
    reconstruction bit-exactly (the full CLI encode/decode contract)."""
    from tpudct.utils import serialize

    p = get_pipeline("hp")
    img = _ragged(rng, 100, 130)
    c, (h, w) = encode_gray_auto(p, img, CFG)
    f = tmp_path / "x.tdc"
    serialize.save_coefficients(f, np.asarray(c), CFG.q_scale, CFG.retain_k,
                                orig_shape=(h, w), transform=CFG.transform,
                                q_table=CFG.q_table)
    coeffs, q_scale, _k, (h2, w2), transform, q_table = serialize.load_coefficients(
        f, with_orig_shape=True, with_transform=True, with_q_table=True)
    assert (h2, w2) == (100, 130)
    rec = decode_gray_auto(p, coeffs,
                           CodecConfig(q_scale=q_scale, transform=transform,
                                       q_table=q_table), (h2, w2))
    _, rec_direct = roundtrip_gray_auto(p, img, CFG)
    np.testing.assert_array_equal(rec, rec_direct)


def test_f32_path_rides_pallas_for_ragged(rng):
    """With an int8-unsafe q_scale the ragged image still reaches the f32
    Pallas kernel (128-lane padding), not the einsum fallback."""
    from tpudct.kernels import hp_pallas

    p = get_pipeline("hp")
    cfg = CodecConfig(q_scale=0.25)
    img = _ragged(rng).astype(np.float32)
    seen = []
    orig = p.roundtrip
    def spy(x, c):
        seen.append(hp_pallas.supports(*x.shape))
        return orig(x, c)
    p.roundtrip = spy
    try:
        _, r = roundtrip_gray_auto(p, img, cfg)
    finally:
        del p.roundtrip
    assert seen == [True]  # padded shape satisfies the f32 kernel gate
    assert r.shape == (40, 250)


def test_roundtrip_padded_traceable_and_dtype_preserving(rng):
    """Pipeline.roundtrip_padded must stay jit-traceable (public API since
    round 1) and must not downcast f64 inputs on the general path."""
    import jax

    p = get_pipeline("batched")
    img = rng.integers(0, 256, (60, 100)).astype(np.float32)
    c, r = jax.jit(lambda x: p.roundtrip_padded(x, CFG))(jnp.asarray(img))
    assert r.shape == (60, 100) and r.dtype == jnp.uint8
    # f64 stays f64 through padding (x64 is off on this mesh, so just
    # assert no crash and correct shapes for the general path)
    c2, r2 = p.roundtrip_padded(jnp.asarray(img), CFG)
    np.testing.assert_array_equal(np.asarray(r), np.asarray(r2))


# ---- stacked bulk dispatch (batch/unbatch ride ONE launch per chunk) --------


def test_stacked_encode_bit_identical(rng):
    """encode_gray_batch_auto == per-image encode_gray_auto, bitwise, across
    mixed sizes, mixed widths (separate stacking groups), duplicate shapes,
    and a float image that demotes to the f32 path."""
    from tpudct.models.dispatch import encode_gray_batch_auto

    p = get_pipeline("hp")
    shapes = [(100, 300), (97, 300), (40, 40), (64, 128), (100, 300)]
    imgs = [rng.integers(0, 256, s).astype(np.uint8) for s in shapes]
    imgs.append(rng.normal(128.0, 40.0, (120, 200)).astype(np.float32))
    got = encode_gray_batch_auto(p, imgs, CFG)
    for img, (c, hw) in zip(imgs, got):
        c1, hw1 = encode_gray_auto(p, img, CFG)
        assert hw == hw1
        np.testing.assert_array_equal(np.asarray(c1), c)


def test_stacked_decode_bit_identical(rng):
    """decode_gray_batch_auto == per-stream decode_gray_auto, including a
    stream with a different config (its own stacking group) and a non-u8
    (f32-valued) coefficient map."""
    from tpudct.models.dispatch import (
        decode_gray_batch_auto, encode_gray_batch_auto)

    p = get_pipeline("hp")
    imgs = [rng.integers(0, 256, s).astype(np.uint8)
            for s in [(100, 300), (56, 300), (200, 80)]]
    enc = encode_gray_batch_auto(p, imgs, CFG)
    items = [(c, CFG, hw) for c, hw in enc]
    cfg2 = CodecConfig(q_scale=2.0)
    c2, hw2 = encode_gray_auto(p, imgs[0], cfg2)
    items.append((np.asarray(c2), cfg2, hw2))
    cfgf = CodecConfig(q_scale=0.25)  # int8-unsafe -> f32 kernel path
    cf, hwf = encode_gray_auto(p, imgs[1], cfgf)
    items.append((np.asarray(cf), cfgf, hwf))
    got = decode_gray_batch_auto(p, items)
    for (c, cfg, hw), r in zip(items, got):
        assert r.dtype == np.uint8 and r.shape == tuple(hw)
        np.testing.assert_array_equal(decode_gray_auto(p, c, cfg, hw), r)


def test_stacked_chunking_invariant(rng):
    """A tiny max_pixels forces multi-chunk launches; results must not
    change (chunk boundaries land on 32-row-aligned image seams)."""
    from tpudct.models.dispatch import (
        decode_gray_batch_auto, encode_gray_batch_auto)

    p = get_pipeline("hp")
    imgs = [rng.integers(0, 256, (64, 256), dtype=np.uint8).astype(np.uint8)
            for _ in range(5)]
    full = encode_gray_batch_auto(p, imgs, CFG)
    tiny = encode_gray_batch_auto(p, imgs, CFG, max_pixels=40_000)
    for (a, _), (b, _) in zip(full, tiny):
        np.testing.assert_array_equal(a, b)
    items = [(c, CFG, hw) for c, hw in full]
    d_full = decode_gray_batch_auto(p, items)
    d_tiny = decode_gray_batch_auto(p, items, max_pixels=40_000)
    for a, b in zip(d_full, d_tiny):
        np.testing.assert_array_equal(a, b)


def test_stacked_single_dispatch(rng, monkeypatch):
    """Same-width uint8 images must produce exactly ONE encode_u8 call."""
    from tpudct.models import dispatch

    p = get_pipeline("hp")
    imgs = [rng.integers(0, 256, (40 + 8 * i, 250), dtype=np.uint8)
            for i in range(4)]
    calls = []
    orig = p.encode_u8
    monkeypatch.setattr(
        type(p), "encode_u8",
        lambda self, x, cfg: calls.append(x.shape) or orig(x, cfg),
    )
    dispatch.encode_gray_batch_auto(p, imgs, CFG)
    assert len(calls) == 1
    # every padded height is an 8-multiple; the stack is their sum
    assert calls[0] == (sum(-(-(40 + 8 * i) // 8) * 8 for i in range(4)), 256)


def test_stacked_scaled_decode_bit_identical(rng):
    """decode_gray_scaled_batch_auto == per-stream decode_gray_scaled_auto
    for every numerator class: fused integer factors, the full-decode
    degenerate (m=8), fractional einsum numerators, and a u8-ineligible
    stream that falls back per item."""
    from tpudct.models.dispatch import (
        decode_gray_scaled_auto, decode_gray_scaled_batch_auto)

    p = get_pipeline("hp")
    items = []
    for s in [(100, 300), (97, 300), (64, 128)]:
        c, hw = encode_gray_auto(p, rng.integers(0, 256, s).astype(np.uint8), CFG)
        items.append((np.asarray(c), CFG, hw))
    cf = CodecConfig(q_scale=0.25)  # int8-unsafe -> per-item fallback
    c3, hw3 = encode_gray_auto(p, rng.integers(0, 256, (56, 300)).astype(np.uint8), cf)
    items.append((np.asarray(c3), cf, hw3))
    for m in (1, 2, 4, 8, 3, 12):
        got = decode_gray_scaled_batch_auto(p, items, m)
        for (c, icfg, hw), r in zip(items, got):
            np.testing.assert_array_equal(
                decode_gray_scaled_auto(p, c, icfg, hw, m), r)


def test_stacked_decode_clamps_oversized_orig_shape(rng):
    """A claimed orig_shape larger than the coefficient map must NEVER
    read the next stacked frame's pixels (review r3: cross-file leakage).
    The stacked decoders clamp to the frame's slab, matching the per-item
    NumPy-crop behavior; the serializer refuses such streams at parse."""
    from tpudct.models.dispatch import decode_gray_batch_auto

    p = get_pipeline("hp")
    a = rng.integers(0, 256, (64, 256)).astype(np.uint8)
    b = rng.integers(0, 256, (64, 256)).astype(np.uint8)
    ca, _ = encode_gray_auto(p, a, CFG)
    cb, _ = encode_gray_auto(p, b, CFG)
    # frame 0 lies: claims 96 rows but its map covers 64
    items = [(np.asarray(ca), CFG, (96, 256)), (np.asarray(cb), CFG, (64, 256))]
    got = decode_gray_batch_auto(p, items)
    ref0 = decode_gray_auto(p, np.asarray(ca), CFG, (96, 256))
    assert got[0].shape[0] <= 64  # never fabricates rows from frame 1
    np.testing.assert_array_equal(got[0], ref0)
    np.testing.assert_array_equal(
        got[1], decode_gray_auto(p, np.asarray(cb), CFG, (64, 256))
    )


def test_serializer_refuses_oversized_orig_shape(rng):
    """Stream-level guard for the same class: a header claiming more
    pixels than the coefficient map holds is corrupt and must refuse."""
    from tpudct.utils import serialize

    p = get_pipeline("hp")
    c, _ = encode_gray_auto(p, rng.integers(0, 256, (64, 256)).astype(np.uint8), CFG)
    data = serialize.coefficients_to_bytes(
        np.asarray(c), 1.0, None, orig_shape=(96, 256)
    )
    with pytest.raises(ValueError, match="orig_shape"):
        serialize.bytes_to_coefficients(data, with_orig_shape=True)
