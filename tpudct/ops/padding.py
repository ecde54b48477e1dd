"""Padding to block multiples.

The reference simply mis-handles images whose sides aren't multiples of 8
(its grids round down and the tail pixels are never transformed; e.g. the
grid arithmetic at main_newAppr.cu:261-264 assumes divisibility).  Here
arbitrary sizes are supported by edge-replicate padding — the standard
JPEG approach, which minimizes artificial high-frequency energy at the
boundary — plus exact cropping on decode.
"""

from __future__ import annotations

import jax.numpy as jnp

from tpudct.constants import BLOCK_SIZE


def padded_shape(h: int, w: int, bs: int = BLOCK_SIZE):
    return ((h + bs - 1) // bs * bs, (w + bs - 1) // bs * bs)


def pad_to_blocks(x, bs: int = BLOCK_SIZE):
    """Edge-replicate pad an (H, W) image up to block multiples.

    Returns (padded, (h, w)) with the original size for later cropping.
    """
    h, w = x.shape
    ph, pw = padded_shape(h, w, bs)
    if (ph, pw) == (h, w):
        return x, (h, w)
    return jnp.pad(x, ((0, ph - h), (0, pw - w)), mode="edge"), (h, w)


def pad_coeffs_to_blocks(c, bs: int = BLOCK_SIZE):
    """Zero-pad a quantized-coefficient map up to block multiples.

    All-zero 8x8 coefficient blocks decode to the constant level shift
    (+128), so a zero-padded map decodes block-identically to the
    unpadded one on the original region and the pad is cropped away.
    Returns (padded, (h, w)).
    """
    h, w = c.shape
    ph, pw = padded_shape(h, w, bs)
    if (ph, pw) == (h, w):
        return c, (h, w)
    return jnp.pad(c, ((0, ph - h), (0, pw - w))), (h, w)


def crop(x, h: int, w: int):
    """Crop back to the pre-padding size."""
    return x[:h, :w]
