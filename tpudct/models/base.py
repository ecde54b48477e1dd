"""Pipeline interface and registry.

Every pipeline exposes the uniform signature the reference uses for all four
variants (``dct_all_blocks(img, ...)`` / ``idct_all_blocks(img, ...)``, e.g.
main_cublass.cu:36-37, main_newAppr.cu:23-24): an (H, W) float image in,
an (H, W) quantized-coefficient map out, and the mirror for the inverse.
Coefficients stay in image layout (blocks in place) exactly like the
reference's device buffers, which makes serialization and cross-variant
equivalence checks trivial.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict

import jax

from tpudct.config import CodecConfig
from tpudct.ops.quant import apply_retention
from tpudct.ops.transform import to_uint8

_REGISTRY: Dict[str, "Pipeline"] = {}


class Pipeline(abc.ABC):
    """A codec compute strategy. Stateless; all methods are jit-compatible."""

    name: str = "?"

    @abc.abstractmethod
    def dct(self, image, cfg: CodecConfig):
        """(H, W) float image -> (H, W) quantized coefficients.

        Includes level shift (-128), blockwise T X T^T and quantization —
        the same phase the reference times as "DCT" (main_newAppr.cu:266-287).
        """

    @abc.abstractmethod
    def idct(self, coeffs, cfg: CodecConfig):
        """(H, W) quantized coefficients -> (H, W) float reconstruction.

        Includes dequantization, blockwise T^T Y T and level unshift (+128).
        """

    # ---- shared drivers -------------------------------------------------

    def encode(self, image, cfg: CodecConfig):
        """dct + optional zonal retention (the README k-sweep).

        Integer images are coerced to f32 (uint8 would wrap at the level
        shift); pipelines with integer-native paths re-narrow internally."""
        import jax.numpy as jnp

        if not jnp.issubdtype(image.dtype, jnp.floating):
            image = image.astype(jnp.float32)
        return apply_retention(self.dct(image, cfg), cfg.retain_k)

    def roundtrip(self, image, cfg: CodecConfig):
        """image -> (coefficients, uint8 reconstruction)."""
        c = self.encode(image, cfg)
        return c, to_uint8(self.idct(c, cfg))

    def roundtrip_batch(self, images, cfg: CodecConfig):
        """(B, H, W) batch pass.

        8x8 blocks are independent, so a batch is just a taller image: the
        (B, H, W) stack folds to (B*H, W), runs through the single-image
        path (one kernel launch for the whole batch — the answer
        to 'more images' is 'a bigger grid', exactly like the reference's
        scaling axis being image size, SURVEY.md §5), and unfolds.
        """
        b, h, w = images.shape
        c, r = self.roundtrip(images.reshape(b * h, w), cfg)
        return c.reshape(b, h, w), r.reshape(b, h, w)

    def roundtrip_channels(self, image_hwc, cfg: CodecConfig):
        """(H, W, C) multi-channel pass (beyond parity: the reference forces
        grayscale at load, utils.cu:70-72).

        Channels are coded independently — they ride the batch axis as
        extra rows (see roundtrip_batch), one kernel launch for all C
        planes.  Returns ((C, H, W) coefficients, (H, W, C) uint8 recon).
        """
        import jax.numpy as jnp

        h, w, ch = image_hwc.shape
        planes = jnp.moveaxis(image_hwc, -1, 0)  # (C, H, W)
        c, r = self.roundtrip_batch(planes, cfg)
        return c, jnp.moveaxis(r, 0, -1)

    def roundtrip_padded(self, image, cfg: CodecConfig):
        """Arbitrary-size pass: edge-pad, run the fastest eligible path,
        crop back.

        Returns (coeffs at the 8-aligned padded shape, recon_cropped_u8).
        The reference silently leaves tail pixels untransformed for
        non-multiple sizes (grid round-down, main_newAppr.cu:261-264);
        here they are handled — and padding goes all the way to the fused
        kernels' tile grid so ragged sizes keep the fast path
        (models/dispatch.py owns the gate).
        """
        from tpudct.models.dispatch import roundtrip_gray_jax

        return roundtrip_gray_jax(self, image, cfg)

    def jit_roundtrip(self, cfg: CodecConfig) -> Callable:
        """One compiled graph for the full codec pass."""
        return jax.jit(lambda x: self.roundtrip(x, cfg))


def register(p: Pipeline, *aliases: str) -> Pipeline:
    for n in (p.name, *aliases):
        _REGISTRY[n] = p
    return p


def get_pipeline(name: str) -> Pipeline:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(set(_REGISTRY))}") from None


def available_pipelines():
    return sorted({p.name for p in _REGISTRY.values()})
