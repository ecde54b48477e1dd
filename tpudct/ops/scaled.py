"""Fractional-scale decode: quantized coefficients -> (H/f, W/f) image.

The reference world's analog is djpeg's ``-scale M/8`` (decode a JPEG
straight to a smaller raster without ever materializing the full image);
the reference repo itself always reconstructs at full size
(main_newAppr.cu:220-250, main_cublass.cu:245-263).  tpudct already has
the 1/8 endpoint as the DC-only preview (utils/serialize.py
preview_from_bytes); this module fills in every djpeg numerator M/8
(M = 1..16, scaled_decode_m8) — with one exact contract:

    scaled decode at m/8  ==  full inverse transform, then an exact
                              area-average resample to m outputs per
                              8 source pixels (integer m/8: the f x f
                              box-filter average)

Per 8x8 block, with T the (orthogonal) transform and Yd the dequantized
coefficients, the full inverse is ``T^T Yd T + 128``; pooling rows with
the (m, 8) averaging matrix P (m = 8/f, each row f entries of 1/f) gives

    P (T^T Yd T + 128) P^T  =  (P T^T) Yd (P T^T)^T + 128

because P's rows sum to 1.  So the whole scaled decode is the ordinary
blockwise bilinear form with the rectangular basis ``B = P T^T`` — one
(m, 8) matrix per axis, valid for EVERY registry transform (libjpeg's
scaled IDCT is instead a spectral truncation specific to the true DCT
basis; the box-average contract is the transform-agnostic equivalent,
and it is exact rather than an ideal-low-pass approximation).

Factors may differ per axis (``f_rows != f_cols``): subsampled chroma
planes need e.g. a (1/2, 1/4) decode so a 4:2:2 stream scales without
an upsample-then-downsample round trip (models/color.py
decode_color_scaled).  Factor 1 degenerates to the full inverse
(B = T^T), so the same code path covers "no scaling on this axis".

Like ops/transform.py the sweeps run as 128-wide GEMMs when the axis is a
multiple of 128 (``kron(I_16, B)`` is a (16m, 128) operand) and fall back
to the 8-wide einsum for small/ragged planes.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from tpudct.constants import get_transform
from tpudct.ops.quant import dequantize
from tpudct.ops.transform import level_unshift

_LANE = 128
_BS = 8

#: scale factors with an exact block-aligned pooling (8 % f == 0)
FACTORS = (1, 2, 4, 8)


#: djpeg-parity numerators for --scale M/8 (M > 8 = block-local upscale)
M_RANGE = tuple(range(1, 17))


def pool_matrix(f: int) -> np.ndarray:
    """(8/f, 8) box-average matrix: row i averages entries i*f .. i*f+f-1."""
    if f not in FACTORS:
        raise ValueError(f"scale factor must be one of {FACTORS}, got {f}")
    m = _BS // f
    p = np.zeros((m, _BS), np.float32)
    for i in range(m):
        p[i, i * f : (i + 1) * f] = 1.0 / f
    return p


def area_matrix(m: int) -> np.ndarray:
    """(m, 8) exact area-average matrix for an 8 -> m resample (M/8 scale).

    Output pixel i covers the source interval [i*8/m, (i+1)*8/m); the
    weight of source pixel j is its overlap length times m/8, so every
    row sums to 1 (the property the level-shift commutation and the
    B = P @ T^T factorization rely on — module docstring).  For m | 8
    this IS pool_matrix(8/m) (integer window boundaries, same exact
    binary-fraction weights); for other m the boundary pixels split
    fractionally (exact area resampling, the transform-agnostic analog
    of djpeg's scaled IDCT); for m > 8 windows are sub-pixel and the
    matrix replicates/splits source pixels (m = 16 is exact 2x nearest
    replication)."""
    if m not in M_RANGE:
        raise ValueError(f"scale numerator must be in 1..16, got {m}")
    if _BS % m == 0:
        return pool_matrix(_BS // m)
    p = np.zeros((m, _BS), np.float64)
    for i in range(m):
        lo = i * _BS / m
        hi = (i + 1) * _BS / m
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), _BS)):
            p[i, j] = max(0.0, min(hi, j + 1) - max(lo, j))
    return (p * (m / _BS)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def scaled_basis_m(m: int, transform: str = "haweel") -> np.ndarray:
    """B = P @ T^T, the (m, 8) per-block synthesis basis (m=8: plain T^T)."""
    t = get_transform(transform).t.astype(np.float64)
    return (area_matrix(m).astype(np.float64) @ t.T).astype(np.float32)


def scaled_basis(f: int, transform: str = "haweel") -> np.ndarray:
    """Factor-f box form of :func:`scaled_basis_m` (f=1: plain T^T)."""
    if f not in FACTORS:
        raise ValueError(f"scale factor must be one of {FACTORS}, got {f}")
    return scaled_basis_m(_BS // f, transform)


@functools.lru_cache(maxsize=64)
def _lane_basis(m: int, transform: str = "haweel") -> np.ndarray:
    """(16 * m, 128) block-diagonal form for lane-width sweeps."""
    return np.kron(
        np.eye(_LANE // _BS, dtype=np.float32), scaled_basis_m(m, transform)
    )


def _col_sweep(x, m: int, transform: str):
    """Contract the minor axis: (H, W) -> (H, W*m/8)."""
    h, w = x.shape
    if w % _LANE == 0:
        bd = jnp.asarray(_lane_basis(m, transform), x.dtype)
        y = jnp.matmul(
            x.reshape(h * (w // _LANE), _LANE), bd.T, precision="highest"
        )
        return y.reshape(h, (w // _LANE) * bd.shape[0])
    b = jnp.asarray(scaled_basis_m(m, transform), x.dtype)
    g = x.reshape(h, w // _BS, _BS)
    y = jnp.einsum("abk,lk->abl", g, b, precision="highest")
    return y.reshape(h, (w // _BS) * b.shape[0])


def _row_sweep(x, m: int, transform: str):
    """Contract the major axis: (H, W) -> (H*m/8, W)."""
    h, w = x.shape
    if h % _LANE == 0:
        bd = jnp.asarray(_lane_basis(m, transform), x.dtype)
        y = jnp.einsum(
            "ij,ajw->aiw", bd, x.reshape(h // _LANE, _LANE, w),
            precision="highest",
        )
        return y.reshape((h // _LANE) * bd.shape[0], w)
    b = jnp.asarray(scaled_basis_m(m, transform), x.dtype)
    y = jnp.einsum(
        "ij,ajw->aiw", b, x.reshape(h // _BS, _BS, w), precision="highest"
    )
    return y.reshape((h // _BS) * b.shape[0], w)


def scaled_idct2_blocks_m(
    y, m_rows: int, m_cols: int, transform: str = "haweel"
):
    """Blockwise ``B_r @ Y_b @ B_c^T`` on an (H, W) DEQUANTIZED map.

    Returns the (H * m_r/8, W * m_c/8) level-SHIFTED reconstruction (no
    +128); callers add the level shift (it commutes with the resampling
    because P's rows sum to 1 — see module docstring).
    """
    h, w = y.shape
    if h % _BS or w % _BS:
        raise ValueError(
            f"coefficient map {h}x{w} not divisible into 8x8 blocks"
        )
    return _row_sweep(_col_sweep(y, m_cols, transform), m_rows, transform)


def scaled_idct2_blocks(
    y, f_rows: int, f_cols: int, transform: str = "haweel"
):
    """Integer-factor form of :func:`scaled_idct2_blocks_m` (f in 1,2,4,8)."""
    return scaled_idct2_blocks_m(y, _BS // f_rows, _BS // f_cols, transform)


def scaled_decode_m8(coeffs, cfg, m_rows: int, m_cols: int | None = None):
    """Quantized (H, W) coefficient map -> (H*m/8, W*m/8) reconstruction.

    The general M/8 scale (djpeg ``-scale M/8``, M = 1..16): exact
    area-average (M < 8) / area-resample (M > 8) of the full decode,
    computed directly in the transform domain with the rectangular basis
    — the full image is never materialized.  M = 8 degenerates to the
    plain full inverse.  ``m_cols`` overrides the column numerator for
    anisotropic chroma scaling (models/color.py)."""
    mc = m_rows if m_cols is None else m_cols
    yd = dequantize(
        jnp.asarray(coeffs, jnp.float32), cfg.q_scale, cfg.q_table
    )
    return level_unshift(scaled_idct2_blocks_m(yd, m_rows, mc, cfg.transform))


def scaled_decode(coeffs, cfg, factor: int, f_cols: int | None = None):
    """Quantized (H, W) coefficient map -> (H/f, W/f) float reconstruction.

    ``cfg`` supplies q_scale / q_table / transform exactly as the full
    decode does (models/base.py Pipeline.idct contract); ``factor``
    applies to rows (and columns unless ``f_cols`` overrides — chroma
    planes of subsampled color streams scale anisotropically).  The
    result equals ``box_pool(pipeline.idct(coeffs, cfg), factor)`` up to
    f32 summation order; quantize to uint8 with ops.transform.to_uint8.
    """
    fc = factor if f_cols is None else f_cols
    if factor not in FACTORS or fc not in FACTORS:
        raise ValueError(f"scale factors must be in {FACTORS}, got "
                         f"({factor}, {fc}); use scaled_decode_m8 for M/8")
    return scaled_decode_m8(coeffs, cfg, _BS // factor, _BS // fc)


def scaled_shape(orig: int, f: int) -> int:
    """Output length of a 1/f-scaled axis of pre-padding length ``orig``.

    ceil(orig / f): the last scaled pixel may average edge-padded source
    pixels (pad_to_blocks edge-replicates, so the average stays a local
    image statistic, same as every block-codec edge).
    """
    return -(-orig // f)


def scaled_shape_m8(orig: int, m: int) -> int:
    """Output length of an M/8-scaled axis: ceil(orig * m / 8)."""
    return -(-orig * m // _BS)


def box_pool_u8(x_u8, f_rows: int, f_cols: int | None = None):
    """Exact f x f box average of a uint8 raster -> float32.

    Strided integer adds (window sums are exact integers), then the
    power-of-two 1/(f_r*f_c) multiply, exact.  Requires dims divisible by
    the factors (8x8-aligned maps always are)."""
    fc = f_rows if f_cols is None else f_cols
    h, w = x_u8.shape
    if h % f_rows or w % fc:
        raise ValueError(
            f"box_pool_u8 needs dims divisible by the factors, got "
            f"{h}x{w} at ({f_rows}, {fc})"
        )
    x = jnp.asarray(x_u8, jnp.int32)
    s = x[:, 0::fc]
    for j in range(1, fc):
        s = s + x[:, j::fc]
    r = s[0::f_rows]
    for i in range(1, f_rows):
        r = r + s[i::f_rows]
    return r.astype(jnp.float32) * jnp.float32(1.0 / (f_rows * fc))


def scaled_decode_u8(pipeline, coeffs_i8, cfg, factor: int,
                     f_cols: int | None = None, out_u8: bool = False):
    """Fast-path fractional-scale decode: int8 full decode + exact integer
    box pooling of its uint8 output -> (H/f, W/fc) float32
    (``out_u8=True``: uint8, truncated in-kernel — bit-identical to
    to_uint8 of the f32 result; the gray dispatch path uses it, while the
    color path keeps f32 so the fractional averages feed the YCbCr merge
    unrounded).

    CONTRACT DELTA vs :func:`scaled_decode`: this is the box average of
    the CLAMPED, ROUNDED full decode (the u8 image a viewer actually
    sees — i.e. "shrink the decoded picture"), while scaled_decode
    averages the UNCLAMPED f32 reconstruction ("decode at lower
    resolution").  They differ by the codec's per-pixel u8 conversion —
    C-truncation, the reference-faithful cast (utils.cu:18-24), < 1.0
    per pixel — plus clamping wherever the reconstruction overshoots
    [0, 255]: bounded by 1 LSB on natural images (overshoot is a
    ringing-edge phenomenon), up to the overshoot magnitude on
    adversarial noise content.  For thumbnailing — the use --scale
    exists for — the clamped semantic is the faithful one.  Requires an
    8x8-aligned map; callers fall back to scaled_decode otherwise.

    At the butterfly decode tier this runs as ONE fused kernel
    (kernels.hp_pallas.hp_scaled_decode_u8) that never stores the
    full-size raster; the composed decode_u8 + box_pool_u8 form is the
    bit-identical fallback for the other tiers."""
    from tpudct.kernels import hp_pallas

    fc = factor if f_cols is None else f_cols
    c = jnp.asarray(coeffs_i8, jnp.int8)
    h, w = c.shape
    # the fused kernel hardwires the butterfly inverse; any other
    # EFFECTIVE decode_precision (models.hp_appr._decode_prec: butterfly
    # needs the transform's integer core, else it falls back to
    # "highest") must compose with decode_u8 (which honors it) so the
    # two forms stay bit-identical under EVERY config
    eff_butterfly = (
        cfg.decode_precision == "butterfly"
        and get_transform(cfg.transform).has_integer_core
    )
    if eff_butterfly and hp_pallas.supports_scaled_u8(
        h, w, factor, fc, cfg.q_scale, cfg.transform, cfg.q_table
    ):
        return hp_pallas.hp_scaled_decode_u8(
            c, factor, fc, q_scale=cfg.q_scale, q_table=cfg.q_table,
            band_rows=cfg.band_rows, tile_cols=cfg.tile_cols,
            interpret=cfg.interpret, transform=cfg.transform, out_u8=out_u8,
        )
    rec = pipeline.decode_u8(c, cfg)
    pooled = box_pool_u8(rec, factor, fc)
    if out_u8:
        from tpudct.ops.transform import to_uint8

        return to_uint8(pooled)
    return pooled
