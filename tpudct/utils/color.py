"""Color-space conversion and chroma resampling for the color extension.

The reference is strictly grayscale — its loader converts RGB to luminance
at decode time (utils.cu:70-72) and nothing downstream can represent a
second channel.  This module supplies the standard JPEG color model on top
of the same blockwise codec: full-range BT.601 RGB <-> YCbCr (ITU-T T.871)
plus 4:2:0 chroma resampling, so a color image codes as one luma plane at
full resolution and two chroma planes at quarter resolution against the
chroma quantization table (constants.QC).

Everything is jit-friendly jnp math on whole planes: the 2x2 pooling is
strided slices, the 2x upsampling a broadcast-reshape (no gather), so XLA
fuses each stage into one pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# ITU-T T.871 (JPEG full-range) BT.601 luma coefficients.
_KR, _KG, _KB = 0.299, 0.587, 0.114


def ycbcr_from_rgb_planes(r, g, b):
    """Plane-wise BT.601 forward transform (f32 in, f32 out, unclamped).

    The ONE copy of the affine equations — the interleaved API, the u8
    planar helpers and the Pallas color kernels all call this, so a
    formula change can never desynchronize them."""
    y = _KR * r + _KG * g + _KB * b
    cb = 128.0 + (b - y) * (0.5 / (1.0 - _KB))
    cr = 128.0 + (r - y) * (0.5 / (1.0 - _KR))
    return y, cb, cr


def rgb_from_ycbcr_planes(y, cb, cr):
    """Plane-wise BT.601 inverse transform (f32 in, f32 out, unclamped)."""
    cbc, crc = cb - 128.0, cr - 128.0
    r = y + (2.0 - 2.0 * _KR) * crc
    b = y + (2.0 - 2.0 * _KB) * cbc
    g = (y - _KR * r - _KB * b) / _KG
    return r, g, b


def rgb_to_ycbcr(rgb):
    """(H, W, 3) RGB (any float/int dtype, 0..255) -> (y, cb, cr) f32 planes.

    Full-range JFIF mapping: Y in [0, 255], Cb/Cr in [0, 255] centered at
    128 — so every plane feeds the codec's existing level-shift (-128)
    unchanged."""
    x = jnp.asarray(rgb, jnp.float32)
    return ycbcr_from_rgb_planes(x[..., 0], x[..., 1], x[..., 2])


def ycbcr_to_rgb(y, cb, cr):
    """Inverse of :func:`rgb_to_ycbcr`; returns (H, W, 3) f32, unclamped.

    Callers clamp/cast (ops.transform.to_uint8 semantics) after
    reconstruction, matching the codec's own output stage."""
    r, g, b = rgb_from_ycbcr_planes(
        jnp.asarray(y, jnp.float32),
        jnp.asarray(cb, jnp.float32),
        jnp.asarray(cr, jnp.float32),
    )
    return jnp.stack([r, g, b], axis=-1)


def downsample_420(plane):
    """(H, W) -> (ceil(H/2), ceil(W/2)) by 2x2 mean pooling (JPEG 4:2:0).

    Odd trailing row/column is edge-replicated before pooling so every
    output sample averages a full 2x2 window."""
    x = jnp.asarray(plane, jnp.float32)
    h, w = x.shape
    if h % 2:
        x = jnp.concatenate([x, x[-1:, :]], axis=0)
    if w % 2:
        x = jnp.concatenate([x, x[:, -1:]], axis=1)
    # Strided slices on both axes — measured 2x faster than the
    # (H/2, 2, W) reshape-mean row form, 40x faster than the block view.
    x = (x[0::2] + x[1::2]) * 0.5
    return (x[:, 0::2] + x[:, 1::2]) * 0.5


def _repeat_rows2(x):
    """Row-doubling via broadcast+reshape: (H, W) -> (2H, W).

    NOT jnp.repeat(axis=0) — interleave-repeat lowers to a gather measured
    at ~342 ms per plane at 8192² (CLAUDE.md).  Broadcasting a middle axis
    keeps the minor (lane) dim intact, so this form is a free relayout."""
    h, w = x.shape
    return jnp.broadcast_to(x[:, None, :], (h, 2, w)).reshape(2 * h, w)


def upsample_420(plane, h: int, w: int):
    """(h2, w2) -> (h, w) by 2x2 nearest replication (box upsample), the
    exact adjoint of :func:`downsample_420`'s pooling grid; crops the
    replicated edge when h or w is odd.

    Column replication rides the same broadcast-reshape form through a
    transpose pair — the trailing-axis interleave alternatives are the
    documented catastrophes (jnp.repeat = gather; a trailing 2-dim
    broadcast pads 64x and OOMs at 8192², CLAUDE.md)."""
    x = jnp.asarray(plane, jnp.float32)
    x = _repeat_rows2(x)                    # rows: free broadcast-reshape
    x = _repeat_rows2(x.T).T                # cols: same form, transposed
    return x[:h, :w]


def downsample_422(plane):
    """(H, W) -> (H, ceil(W/2)) by horizontal 2x mean pooling (JPEG 4:2:2:
    chroma halved horizontally only — the broadcast-studio compromise
    between 4:4:4 and 4:2:0)."""
    x = jnp.asarray(plane, jnp.float32)
    if x.shape[1] % 2:
        x = jnp.concatenate([x, x[:, -1:]], axis=1)
    return (x[:, 0::2] + x[:, 1::2]) * 0.5


def upsample_422(plane, h: int, w: int):
    """(h, w2) -> (h, w) by horizontal nearest replication (adjoint of
    :func:`downsample_422`); broadcast-reshape through a transpose pair
    instead of the gather-lowering jnp.repeat (see upsample_420)."""
    x = jnp.asarray(plane, jnp.float32)
    return _repeat_rows2(x.T).T[:h, :w]


# ---- u8-native planar split/merge of the band-sharded paths -----------------
#
# What parallel/sharding.py's color steps run (transform, then pool, then
# one rounding).  The codec's own u8 stages below (split_u8/merge_u8) pool
# first and use fixed-point luma: the two agree within +-1 at rounding
# ties, and each decides the bytes of the containers its path writes
# (save_color_sharded vs encode --color), so neither replaces the other
# without changing one container format.  Planar (3, H, W) layout keeps
# every op a whole-plane elementwise/strided form.


def ycbcr_split_420_u8(rgb_planar_u8, subsample: bool = True):
    """(3, H, W) uint8 RGB -> (y_u8 (H, W), cb_u8, cr_u8 (H/2, W/2)).

    Fused color conversion + 4:2:0 pooling + rounding in one XLA graph:
    chroma is pooled in float BEFORE the single u8 rounding, exactly like
    a libjpeg encoder's downsampled path.  Requires even H, W when
    subsampling (the codec's u8 fast path needs stricter alignment
    anyway; models/color.py gates and falls back)."""
    from tpudct.ops.rounding import round_half_away

    y, cb, cr = ycbcr_from_rgb_planes(
        rgb_planar_u8[0].astype(jnp.float32),
        rgb_planar_u8[1].astype(jnp.float32),
        rgb_planar_u8[2].astype(jnp.float32),
    )
    to_u8 = lambda v: jnp.clip(round_half_away(v), 0.0, 255.0).astype(jnp.uint8)
    if subsample:
        cb, cr = downsample_420(cb), downsample_420(cr)
    return to_u8(y), to_u8(cb), to_u8(cr)


def ycbcr_merge_420_u8(y_u8, cb_u8, cr_u8, h: int, w: int, subsample: bool = True):
    """(y, cb, cr) uint8 planes -> (3, H, W) uint8 RGB (inverse of
    :func:`ycbcr_split_420_u8`, nearest-neighbor chroma upsampling)."""
    from tpudct.ops.rounding import round_half_away

    y = jnp.asarray(y_u8[:h, :w], jnp.float32)
    cb = jnp.asarray(cb_u8, jnp.float32)
    cr = jnp.asarray(cr_u8, jnp.float32)
    if subsample:
        cb, cr = upsample_420(cb, h, w), upsample_420(cr, h, w)
    else:
        cb, cr = cb[:h, :w], cr[:h, :w]
    r, g, b = rgb_from_ycbcr_planes(y, cb, cr)
    rgb = jnp.stack([r, g, b], axis=0)
    return jnp.clip(round_half_away(rgb), 0.0, 255.0).astype(jnp.uint8)


# ---- the codec's u8 color stages ---------------------------------------------
#
# What encode_color_u8 / decode_color_u8 (models/color.py) run: whole-plane
# XLA that fuses into one pass per stage.  The arithmetic is pinned (it
# decides .tdcc bytes): chroma pools the level-shifted INTEGER channels
# first (exact) and color-transforms the pooled planes — the mean commutes
# with the affine map, so this sits in the same +-1 tie class as
# :func:`ycbcr_split_420_u8`'s transform-then-pool order; luma is 16-bit
# fixed point; the merge rounds with the truncating add form.

_POOL = {  # chroma mode -> (row factor, column factor)
    "420": (2, 2),
    "422": (1, 2),
    False: (1, 1),
}


def _luma_fx(ri, gi, bi):
    """BT.601 luma in 16-bit fixed point: round(.299r + .587g + .114b) with
    integer weights summing exactly to 65536 — an integer in [0, 255].
    Differs from the f32 form by +-1 at rounding boundaries."""
    return ((19595 * ri + 38470 * gi + 7471 * bi + 32768) >> 16).astype(jnp.uint8)


def _to_u8_round(z):
    """clip(round_half_away(z), 0, 255) -> u8, clip first (z >= 0 after the
    clip, so the round is floor + compare)."""
    zp = jnp.minimum(jnp.maximum(z, 0.0), 255.0)
    f = jnp.floor(zp)
    return (f + (zp - f >= 0.5).astype(jnp.float32)).astype(jnp.uint8)


def _to_u8_trunc(z):
    """clip + round-half-away as ONE truncating add-form cast, trunc(clip(z)
    + 0.5).  Agrees with the compare form on the BT.601 inverse's whole
    256^3 (y, cb, cr) input domain (merge outputs depend only on that
    triple: chroma upsampling is replication)."""
    zp = jnp.minimum(jnp.maximum(z, 0.0), 255.0)
    return (zp + jnp.float32(0.5)).astype(jnp.int32).astype(jnp.uint8)


def _pool_shifted(ch_i32, fr: int, fc: int):
    """Mean of (fr, fc) windows of an integer channel, via exact integer
    sums of the level-shifted values."""
    s = ch_i32 - 128
    if fr == 2:
        s = s[0::2] + s[1::2]
    if fc == 2:
        s = s[:, 0::2] + s[:, 1::2]
    return s.astype(jnp.float32) * (1.0 / (fr * fc)) + 128.0


def _upsample(x, fr: int, fc: int):
    """Nearest replication by (fr, fc)."""
    h, w = x.shape
    return jnp.broadcast_to(x[:, None, :, None], (h, fr, w, fc)).reshape(h * fr, w * fc)


@functools.partial(jax.jit, static_argnames=("mode",))
def split_u8(rgb_planar_u8, mode="420"):
    """(3, H, W) u8 RGB -> (y (H, W), cb, cr) u8; chroma at (H/fr, W/fc)
    for the mode's factors.  H and W must divide by the factors."""
    fr, fc = _POOL[mode]
    ri, gi, bi = (rgb_planar_u8[k].astype(jnp.int32) for k in range(3))
    _y, cb, cr = ycbcr_from_rgb_planes(
        *(_pool_shifted(c, fr, fc) for c in (ri, gi, bi))
    )
    return _luma_fx(ri, gi, bi), _to_u8_round(cb), _to_u8_round(cr)


@functools.partial(jax.jit, static_argnames=("mode",))
def merge_u8(y_u8, cb_u8, cr_u8, mode="420"):
    """Inverse of :func:`split_u8` -> (3, H, W) u8 RGB (nearest chroma
    upsampling; the -128 chroma shift applies at chroma resolution)."""
    fr, fc = _POOL[mode]
    h, w = y_u8.shape
    if cb_u8.shape != (h // fr, w // fc) or cr_u8.shape != cb_u8.shape:
        raise ValueError(
            f"chroma planes must be ({h // fr}, {w // fc}) for a ({h}, {w}) "
            f"luma plane, got {cb_u8.shape} / {cr_u8.shape}"
        )
    shifted = lambda c: _upsample(c.astype(jnp.int32) - 128, fr, fc).astype(jnp.float32)
    y = y_u8.astype(jnp.float32)
    cbc, crc = shifted(cb_u8), shifted(cr_u8)
    r = y + (2.0 - 2.0 * _KR) * crc
    b = y + (2.0 - 2.0 * _KB) * cbc
    g = (y - _KR * r - _KB * b) / _KG
    return jnp.stack([_to_u8_trunc(r), _to_u8_trunc(g), _to_u8_trunc(b)])
