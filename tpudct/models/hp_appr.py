"""`hp`: flagship pipeline backed by the fused Pallas kernels.

Re-design of main_newAppr.cu's HpApprDCT (kernels at main_newAppr.cu:177-250,
wrappers :252-332).  See tpudct.kernels.hp_pallas for the kernel
formulation (exact integer core, u8-native variants).  How the kernels run
(compiled on the GPU, interpreted on the CPU) is decided by
tpudct.kernels.resolve_interpret.  The u8 entry points take any 8x8-aligned
plane; the float entry points (dct, roundtrip) run the kernel only at
widths that are multiples of F32_ENCODE_WIDTH and the mathematically
identical `batched` einsum path otherwise (see there).
"""

from __future__ import annotations

from tpudct.config import CodecConfig
from tpudct.kernels import hp_pallas
from tpudct.models.base import Pipeline, register
from tpudct.models.batched import BatchedPipeline

_batched = BatchedPipeline()


#: The float entry points run the kernel only on planes whose width is a
#: multiple of this, and the `batched` einsum encode on the others.  The
#: kernel's integer core truncates float pixels to integers, so the choice
#: shows in the coefficients of float planes (the color path below the u8
#: gate, ``run --corners``): this rule fixed the bytes of those containers,
#: and keeping it keeps them.  models/dispatch.py pads its float path to it.
F32_ENCODE_WIDTH = 128


def _int_core(cfg: CodecConfig) -> bool:
    """exact_int_core, demoted when the transform has no integer core
    (e.g. the exact 'dct' — f32 kernels only)."""
    from tpudct.constants import get_transform

    return cfg.exact_int_core and get_transform(cfg.transform).has_integer_core


def _kernel_encodes(image, cfg: CodecConfig) -> bool:
    """Whether dct/roundtrip run the kernel on this float plane."""
    h, w = image.shape
    return (
        hp_pallas.supports(h, w)
        and w % F32_ENCODE_WIDTH == 0
        # deadzone quantization (encode-side rate knob) rides the einsum
        # quantizer; the fused kernels bake the 0.5 rule
        and cfg.deadzone == 0.5
    )


def _decode_prec(cfg: CodecConfig) -> str:
    """butterfly needs the integer core's bf16-exact Ts; transforms without
    one decode at 'highest' (the reference-faithful f32 tier)."""
    from tpudct.constants import get_transform

    if (
        cfg.decode_precision == "butterfly"
        and not get_transform(cfg.transform).has_integer_core
    ):
        return "highest"
    return cfg.decode_precision


class HpApprPipeline(Pipeline):
    name = "hp"

    def dct(self, image, cfg: CodecConfig):
        import jax.numpy as jnp

        if not jnp.issubdtype(image.dtype, jnp.floating):
            image = image.astype(jnp.float32)
        if not _kernel_encodes(image, cfg):
            return _batched.dct(image, cfg)
        return hp_pallas.hp_dct(
            image,
            q_scale=cfg.q_scale,
            q_table=cfg.q_table,
            band_rows=cfg.band_rows,
            tile_cols=cfg.tile_cols,
            interpret=cfg.interpret,
            int_core=_int_core(cfg),
            transform=cfg.transform,
        )

    def idct(self, coeffs, cfg: CodecConfig):
        h, w = coeffs.shape
        if not hp_pallas.supports(h, w):
            return _batched.idct(coeffs, cfg)
        return hp_pallas.hp_idct(
            coeffs,
            q_scale=cfg.q_scale,
            q_table=cfg.q_table,
            band_rows=cfg.band_rows,
            tile_cols=cfg.tile_cols,
            interpret=cfg.interpret,
            decode_precision=_decode_prec(cfg),
            transform=cfg.transform,
        )

    def roundtrip(self, image, cfg: CodecConfig):
        """Single fully fused kernel when supported (see hp_pallas)."""
        import jax.numpy as jnp

        from tpudct.ops.transform import to_uint8

        if not jnp.issubdtype(image.dtype, jnp.floating):
            image = image.astype(jnp.float32)
        if not _kernel_encodes(image, cfg):
            return super().roundtrip(image, cfg)
        c, r = hp_pallas.hp_roundtrip(
            image,
            q_scale=cfg.q_scale,
            q_table=cfg.q_table,
            retain_k=cfg.retain_k,
            band_rows=cfg.band_rows,
            tile_cols=cfg.tile_cols,
            interpret=cfg.interpret,
            int_core=_int_core(cfg),
            decode_precision=_decode_prec(cfg),
            transform=cfg.transform,
        )
        return c, to_uint8(r)

    # ---- u8-native fast path (no reference analog: the reference stages
    # everything through f32 on the host, utils.cu:10-15) ----------------

    def encode_u8(self, image_u8, cfg: CodecConfig):
        """uint8 image -> int8 coefficient map."""
        h, w = image_u8.shape
        if not hp_pallas.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
            bound = hp_pallas._max_coeff(cfg.transform, cfg.q_table)
            why = (
                f"transform {cfg.transform!r} has no integer core"
                if bound == float("inf")
                else f"q_scale>={bound / 127.0:.2f} for int8 coefficients"
            )
            raise ValueError(
                f"u8 path needs h%8==0, w%8==0 and {why} "
                f"(got {h}x{w}, q_scale={cfg.q_scale}, transform={cfg.transform})"
            )
        return hp_pallas.hp_encode_u8(
            image_u8, q_scale=cfg.q_scale, q_table=cfg.q_table, retain_k=cfg.retain_k,
            band_rows=cfg.band_rows, tile_cols=cfg.tile_cols,
            interpret=cfg.interpret, transform=cfg.transform,
        )

    def decode_u8(self, coeffs_i8, cfg: CodecConfig):
        """int8 coefficient map -> uint8 reconstruction."""
        h, w = coeffs_i8.shape
        if not hp_pallas.supports(h, w):
            raise ValueError(
                f"u8 decode path needs h%8==0 and w%8==0, got {h}x{w}; "
                "use idct() + to_uint8 for other shapes"
            )
        return hp_pallas.hp_decode_u8(
            coeffs_i8, q_scale=cfg.q_scale, q_table=cfg.q_table,
            band_rows=cfg.band_rows, tile_cols=cfg.tile_cols,
            interpret=cfg.interpret,
            decode_precision=_decode_prec(cfg),
            transform=cfg.transform,
        )

    def roundtrip_u8(self, image_u8, cfg: CodecConfig):
        """Fully fused u8-native pass: uint8 -> (int8 coeffs, uint8 recon)."""
        h, w = image_u8.shape
        if hp_pallas._max_coeff(cfg.transform, cfg.q_table) / cfg.q_scale > 127.0:
            # int8 coefficients would wrap around (or the transform has no
            # integer core) — refuse rather than silently corrupt.
            raise ValueError(
                f"transform={cfg.transform} has no integer core; use roundtrip()"
                if hp_pallas._max_coeff(cfg.transform, cfg.q_table)
                == float("inf")
                else f"q_scale={cfg.q_scale} with transform={cfg.transform} "
                "does not fit int8 coefficients; use roundtrip()"
            )
        if not hp_pallas.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
            import jax.numpy as jnp

            c, r = self.roundtrip(jnp.asarray(image_u8, jnp.float32), cfg)
            return c.astype(jnp.int8), r
        return hp_pallas.hp_roundtrip_u8(
            image_u8, q_scale=cfg.q_scale, q_table=cfg.q_table, retain_k=cfg.retain_k,
            band_rows=cfg.band_rows, tile_cols=cfg.tile_cols,
            interpret=cfg.interpret,
            decode_precision=_decode_prec(cfg),
            transform=cfg.transform,
        )


register(HpApprPipeline())
