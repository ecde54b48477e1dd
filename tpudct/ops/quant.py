"""Quantization, dequantization and zonal coefficient retention.

Reference semantics:
  quantize:   C = round(A / Q[ty, tx])   per in-block position
              (divide_matrices, utils_kernels.cu:34-44; CUDA round() is
              half-away-from-zero — see tpudct.ops.rounding)
  dequantize: C = A * Q[ty, tx]          (multiply_matrices, utils_kernels.cu:47-57)

NOTE deliberately not replicated: main.cu:399-409 contains an inline variant
indexing ``B[tx*dim+ty]`` (transposed Q) — a latent inconsistency in the
legacy sandbox file, not the shipped behavior.

Retention: the README's k=6..10 accuracy sweep (README.md:62-69) has no code
in the reference (computed externally).  Here it is a zonal (anti-diagonal)
mask applied to quantized coefficients: keep (u, v) iff u + v < k.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from tpudct.constants import BLOCK_SIZE, get_q_table
from tpudct.ops.rounding import round_half_away


def _q_for(x, q_scale: float, q_table: str = "luma"):
    return jnp.asarray(get_q_table(q_table) * np.float32(q_scale), x.dtype)


def _rowwise(x, tile8x8, op):
    """Apply ``op(x, tile)`` with an (8, 8) tile broadcast per block position,
    WITHOUT the (H/8, 8, W/8, 8) block-grid view: the (H/8, 8, W) view
    keeps the minor dimension intact — the reshape is free — and the tile
    becomes a cheap (8, W) row pattern."""
    h, w = x.shape
    row = jnp.tile(tile8x8, (1, w // BLOCK_SIZE))  # (8, W)
    g = x.reshape(h // BLOCK_SIZE, BLOCK_SIZE, w)
    return op(g, row).reshape(h, w)


def quantize(y, q_scale: float = 1.0, q_table: str = "luma",
             deadzone: float = 0.5):
    """round_half_away(Y / Q) with Q broadcast per 8x8 block position.

    deadzone < 0.5 switches the AC positions to the deadzone rule
    sign(y)·floor(|y|/Q + deadzone) — near-edge magnitudes fall toward
    zero, trading distortion for cheaper entropy symbols (CodecConfig.
    deadzone documents the measured BD-rate); DC keeps round-half-away
    (delta-coded and dense — a deadzone there only shifts block means).
    Dequantization is unchanged either way."""
    q = _q_for(y, q_scale, q_table)
    if deadzone == 0.5:
        return _rowwise(y, q, lambda g, row: round_half_away(g / row))
    if not 0.0 < deadzone < 0.5:
        raise ValueError(f"deadzone must be in (0, 0.5], got {deadzone}")
    h, w = y.shape
    qrow = jnp.tile(q, (1, w // BLOCK_SIZE))
    dc = np.zeros((BLOCK_SIZE, BLOCK_SIZE), bool)
    dc[0, 0] = True
    dcrow = jnp.tile(jnp.asarray(dc), (1, w // BLOCK_SIZE))
    g = y.reshape(h // BLOCK_SIZE, BLOCK_SIZE, w) / qrow
    a = jnp.abs(g)
    f = jnp.floor(a)
    rha = f + (a - f >= 0.5).astype(a.dtype)  # compare form, see rounding.py
    dz = jnp.floor(a + jnp.asarray(deadzone, a.dtype))
    return (jnp.sign(g) * jnp.where(dcrow, rha, dz)).reshape(h, w)


def dequantize(c, q_scale: float = 1.0, q_table: str = "luma"):
    """C * Q, exact inverse scaling of :func:`quantize`'s division."""
    q = _q_for(c, q_scale, q_table)
    return _rowwise(c, q, lambda g, row: g * row)


def q_scale_for_quality(quality: int) -> float:
    """IJG libjpeg quality (1..100) -> quantization-table scale factor.

    The standard mapping from jcparam.c (jpeg_quality_scaling): scale =
    5000/q for q < 50 else 200 - 2q, divided by 100 — so quality 50 is the
    unscaled table (q_scale == 1.0, the reference's 'Standard Q'), higher
    quality divides it, lower multiplies.  Beyond parity: the reference has
    no quality knob at all (hardcoded table).

    libjpeg clamps each SCALED TABLE ENTRY to >= 1 rather than the scale
    itself; with a scalar scale the equivalent guard is a floor that keeps
    quality=100 from producing a zero table (division by zero at
    quantization) — 0.01 == one IJG step below quality 100."""
    q = min(100, max(1, int(quality)))
    return max((5000.0 / q if q < 50 else 200.0 - 2.0 * q) / 100.0, 0.01)


def retention_mask(k: int | None, bs: int = BLOCK_SIZE) -> np.ndarray:
    """Zonal mask: keep coefficient (u, v) iff u + v < k. k=None keeps all."""
    if k is None:
        return np.ones((bs, bs), dtype=np.float32)
    u = np.arange(bs)[:, None]
    v = np.arange(bs)[None, :]
    return ((u + v) < k).astype(np.float32)


def apply_retention(c, k: int | None):
    """Zero out truncated coefficients in an (H, W) quantized-coefficient map."""
    if k is None:
        return c
    m = jnp.asarray(retention_mask(k), c.dtype)
    return _rowwise(c, m, lambda g, row: g * row)
