"""`cublas`: per-block sequential contraction (the slow baseline).

Faithful *strategy* analog of main_cublass.cu, which loops on the host over
every 8x8 block issuing two cublasSgemm calls each (main_cublass.cu:225-243 —
2,097,152 GEMM launches at 8192^2).  The JAX analog of a serialized per-block
schedule is ``lax.scan`` over the block batch: one compiled step, executed
once per block in sequence.  It exists for benchmark comparability (the
reference's >96% improvement claim is measured against exactly this shape of
schedule, README.md:60); use `batched` or `hp` for real work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpudct.config import CodecConfig
from tpudct.constants import get_q_table, get_transform
from tpudct.models.base import Pipeline, register
from tpudct.ops.blocks import blockify, deblockify
from tpudct.ops.rounding import round_half_away
from tpudct.ops.transform import level_shift, level_unshift


class CublasLikePipeline(Pipeline):
    name = "cublas"

    def dct(self, image, cfg: CodecConfig):
        if cfg.deadzone != 0.5:
            raise ValueError(
                "deadzone quantization rides the hp/batched quantizer; "
                f"pipeline {self.name!r} implements the reference's "
                "round-half-away rule only"
            )
        h, w = image.shape
        t = jnp.asarray(get_transform(cfg.transform).t, image.dtype)
        q = jnp.asarray(get_q_table(cfg.q_table), image.dtype) * jnp.asarray(cfg.q_scale, image.dtype)
        xb = blockify(level_shift(image))

        dot = lambda a, b: jax.lax.dot(a, b, precision=jax.lax.Precision.HIGHEST)

        def step(carry, b):
            # Two chained 8x8 GEMMs per block, like the two cublasSgemm
            # calls at main_cublass.cu:234-241.
            y = dot(dot(t, b), t.T)
            return carry, round_half_away(y / q)

        _, yb = jax.lax.scan(step, 0, xb)
        return deblockify(yb, h, w)

    def idct(self, coeffs, cfg: CodecConfig):
        h, w = coeffs.shape
        t = jnp.asarray(get_transform(cfg.transform).t, coeffs.dtype)
        q = jnp.asarray(get_q_table(cfg.q_table), coeffs.dtype) * jnp.asarray(cfg.q_scale, coeffs.dtype)
        cb = blockify(coeffs)

        dot = lambda a, b: jax.lax.dot(a, b, precision=jax.lax.Precision.HIGHEST)

        def step(carry, b):
            # Mirror of main_cublass.cu:302-309 (transpose order swapped).
            x = dot(dot(t.T, b * q), t)
            return carry, x

        _, xb = jax.lax.scan(step, 0, cb)
        return level_unshift(deblockify(xb, h, w))


register(CublasLikePipeline())
