"""`fast`: Haweel integer core in int8 (fastApprDCT re-design).

main_fastAppr.cu ports Haweel-2016 to the GPU with a thread-per-block-row
kernel (main_fastAppr.cu:164-228) but still multiplies by the *float* T.
This design instead exploits the factorization T = D @ Ts
(constants.py): the core contraction ``Ts @ Xb @ Ts.T`` runs entirely in
int8 -> int32 — the true "multiplierless" add/shift spirit, since
Ts entries are {0, +-1, +-2} — and the row norms fold into a single
rank-one float scale ``outer(d, d)`` fused with quantization.

Exactness: level-shifted pixels fit int8 ([-128, 127]); |Ts Xb Ts^T| <=
12 * 12 * 128 = 18432, comfortably inside int32 (and exact — integer
arithmetic, no accumulation-order sensitivity at all, unlike the float
reference).
"""

from __future__ import annotations

import jax.numpy as jnp

from tpudct.config import CodecConfig
from tpudct.constants import BLOCK_SIZE, block_diag_Ts, get_q_table, get_transform
from tpudct.models.base import Pipeline, register
from tpudct.ops.blocks import as_block_grid, from_block_grid
from tpudct.ops.rounding import round_half_away
from tpudct.ops.transform import level_unshift

_LANE = 128


def _core(cfg: CodecConfig):
    """(Ts, d, lane-sized block-diag Ts) for the configured transform.

    The fast pipeline IS the integer-core strategy: transforms without one
    (exact "dct") are rejected — use `batched`/`hp` for those."""
    tr = get_transform(cfg.transform)
    if not tr.has_integer_core:
        raise ValueError(
            f"transform {tr.name!r} has no integer core; the fast pipeline "
            "requires one (use 'batched' or 'hp')"
        )
    return tr.ts, tr.d, block_diag_Ts(_LANE // BLOCK_SIZE, tr.ts)


class FastApprPipeline(Pipeline):
    name = "fast"

    def dct(self, image, cfg: CodecConfig):
        if cfg.deadzone != 0.5:
            raise ValueError(
                "deadzone quantization rides the hp/batched quantizer; "
                f"pipeline {self.name!r} implements the reference's "
                "round-half-away rule only"
            )
        h, w = image.shape
        _ts, _d, _bdts = _core(cfg)
        # All scale math in f32 regardless of input dtype: casting the
        # fractional row norms to an INTEGER input's dtype would zero them
        # (verified: uint8 input silently produced an all-zero map).
        x = jnp.asarray(image, jnp.float32)
        d = jnp.asarray(_d, jnp.float32)
        q = jnp.asarray(get_q_table(cfg.q_table), jnp.float32) * jnp.float32(cfg.q_scale)
        scale8 = (d[:, None] * d[None, :]) / q

        def _i8(g):
            # Level shift + narrow.  rint, not truncate: non-integral f32
            # pixels (the color path's YCbCr planes) otherwise bias the
            # whole pipeline -0.28 gray levels (truncation is one-sided).
            # u8-domain values always fit int8 after the shift.
            return jnp.rint(g - 128.0).astype(jnp.int8)

        if h % _LANE == 0 and w % _LANE == 0:
            ts = jnp.asarray(_bdts, jnp.int8)
            g = _i8(x.reshape(h // _LANE, _LANE, w // _LANE, _LANE))
            core = jnp.einsum(
                "ij,ajbk,lk->aibl", ts, g, ts, preferred_element_type=jnp.int32
            )
            scale = jnp.tile(scale8, (_LANE // BLOCK_SIZE, _LANE // BLOCK_SIZE))
            y = core.astype(jnp.float32) * scale.reshape(1, _LANE, 1, _LANE)
            return round_half_away(y.reshape(h, w))
        ts = jnp.asarray(_ts, jnp.int8)
        g = _i8(as_block_grid(x))
        core = jnp.einsum(
            "ij,ajbk,lk->aibl", ts, g, ts, preferred_element_type=jnp.int32
        )
        y = core.astype(jnp.float32) * scale8.reshape(1, BLOCK_SIZE, 1, BLOCK_SIZE)
        return round_half_away(from_block_grid(y))

    def idct(self, coeffs, cfg: CodecConfig):
        # Inverse is not integer (coeffs * Q * d scaling is float); use the
        # factored form X = Ts^T @ (D Y D * Q) @ Ts for the same MXU path.
        h, w = coeffs.shape
        _ts, _d, _bdts = _core(cfg)
        c = jnp.asarray(coeffs, jnp.float32)  # int coefficient maps: exact
        d = jnp.asarray(_d, jnp.float32)
        q = jnp.asarray(get_q_table(cfg.q_table), jnp.float32) * jnp.float32(cfg.q_scale)
        scale8 = (d[:, None] * d[None, :]) * q
        if h % _LANE == 0 and w % _LANE == 0:
            ts = jnp.asarray(_bdts, jnp.float32)
            scale = jnp.tile(scale8, (_LANE // BLOCK_SIZE, _LANE // BLOCK_SIZE))
            g = c.reshape(h // _LANE, _LANE, w // _LANE, _LANE)
            g = g * scale.reshape(1, _LANE, 1, _LANE)
            x = jnp.einsum("ji,ajbk,kl->aibl", ts, g, ts, precision="highest")
            return level_unshift(x.reshape(h, w))
        ts = jnp.asarray(_ts, jnp.float32)
        g = as_block_grid(c) * scale8.reshape(1, BLOCK_SIZE, 1, BLOCK_SIZE)
        # Ts entries are small integers — exactly representable in bf16 — but
        # the scaled coefficients are not; keep full f32 (see transform.py).
        x = jnp.einsum("ji,ajbk,kl->aibl", ts, g, ts, precision="highest")
        return level_unshift(from_block_grid(x))


register(FastApprPipeline())
