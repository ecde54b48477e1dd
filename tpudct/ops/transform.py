"""Blockwise 2-D transform and level shift.

Semantics (identical across all four reference pipelines):
  forward:  Y_b = T @ (X_b - 128) @ T.T        (e.g. main_newAppr.cu:177-211)
  inverse:  X_b = T.T @ Y_b @ T + 128          (main_newAppr.cu:220-250)
  output:   clamp to [0, 255], cast to uint8    (convertToUnsignedChar, utils.cu:18-24)

T is orthogonal, so the inverse uses the transpose exactly.  The whole-image
formulation here operates on the (H//8, 8, W//8, 8) block-grid view: one
einsum = one batched contraction over every block, the replacement for both the per-block GEMM loop (main_cublass.cu:225-243) and
the block-diagonal whole-image GEMM (main_cublass_2.cu:228-235).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from tpudct.constants import LEVEL_SHIFT, block_diag_T, get_transform
from tpudct.ops.blocks import as_block_grid, from_block_grid

_LANE = 128


@functools.lru_cache(maxsize=8)
def _bdt_lane(transform: str = "haweel") -> np.ndarray:
    """(128, 128) block-diag T: 16 blocks per MXU-shaped contraction."""
    return block_diag_T(_LANE // 8, t=get_transform(transform).t).astype(np.float32)


def level_shift(x):
    """x - 128 (sub_matrix_scalar, utils_kernels.cu:8-18).

    Integer inputs are coerced to f32 first: a uint8 pixel 5 would
    otherwise wrap to 133 (mod-256) and silently corrupt coefficients."""
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    return x - jnp.asarray(LEVEL_SHIFT, x.dtype)


def level_unshift(x):
    """x + 128 (add_matrix_scalar, utils_kernels.cu:21-31)."""
    return x + jnp.asarray(LEVEL_SHIFT, x.dtype)


def to_uint8(x):
    """Clamp [0,255] and cast (convertToUnsignedChar, utils.cu:18-24)."""
    return jnp.clip(round_free(x), 0.0, 255.0).astype(jnp.uint8)


def round_free(x):
    # The reference casts with C truncation after clamp (utils.cu:22:
    # `(unsigned char)value` truncates); matching that exactly.
    return jnp.trunc(x)


def _lane_transform(x, bdt_np, inverse: bool):
    """Blockwise 2-D transform as two MXU-shaped GEMM sweeps.

    Column sweep: one (H·W/128, 128) x (128, 128) GEMM.  Row sweep: a
    batched (128, 128) x (128, W) GEMM per 128-row band.  A single 4D
    einsum of the same math compiles ~10x slower on XLA (measured 22 ms vs
    ~2 ms at 8192² f32); explicit 2D shapes give the compiler GEMMs it
    already knows how to tile."""
    h, w = x.shape
    bdt = jnp.asarray(bdt_np, x.dtype)
    tr, tc = (bdt.T, bdt) if inverse else (bdt, bdt.T)
    # columns: per 128-col tile, X @ tc
    y = jnp.matmul(
        x.reshape(h * (w // _LANE), _LANE), tc, precision="highest"
    ).reshape(h, w)
    # rows: per 128-row band, tr @ Y
    y = jnp.einsum(
        "ij,ajw->aiw", tr, y.reshape(h // _LANE, _LANE, w), precision="highest"
    )
    return y.reshape(h, w)


def dct2_blocks(x, t=None, transform: str = "haweel"):
    """Forward blockwise transform on an (H, W) image (no level shift/quant).

    Y[bi, i, bj, l] = sum_{j,k} T[i,j] X[bi, j, bj, k] T[l,k]

    `transform` selects a registry entry (constants.TRANSFORMS); an explicit
    `t` array overrides it (and takes the 8-wide fallback path).

    When the image tiles by 128 in both dims, the contraction runs as
    128-wide GEMMs with blockdiag_16(T) — identical math (the zeros
    contribute nothing) in shapes GEMM libraries tile well: cublasDCTv2's
    block-diagonal idea (upgrade_T_matrix, utils_kernels.cu:60-69) without
    its O(N³) zero-FLOPs.
    """
    # precision="highest" everywhere: a default-precision f32 matmul may
    # run in TF32 (or bf16 passes), which costs ~1.0 absolute error on
    # coefficients ~1000 — enough to corrupt quantizer decisions.  The
    # reference computes in true f32.
    h, w = x.shape
    if t is None and h % _LANE == 0 and w % _LANE == 0:
        return _lane_transform(x, _bdt_lane(transform), inverse=False)
    t = get_transform(transform).t if t is None else t
    t = jnp.asarray(t, x.dtype)
    g = as_block_grid(x)
    y = jnp.einsum("ij,ajbk,lk->aibl", t, g, t, precision="highest")
    return from_block_grid(y)


def idct2_blocks(y, t=None, transform: str = "haweel"):
    """Inverse blockwise transform: X_b = T.T @ Y_b @ T."""
    h, w = y.shape
    if t is None and h % _LANE == 0 and w % _LANE == 0:
        return _lane_transform(y, _bdt_lane(transform), inverse=True)
    t = get_transform(transform).t if t is None else t
    t = jnp.asarray(t, y.dtype)
    g = as_block_grid(y)
    x = jnp.einsum("ji,ajbk,kl->aibl", t, g, t, precision="highest")
    return from_block_grid(x)
