"""`batched` (alias `cublas2`): whole-image batched contraction.

Plain-XLA equivalent of main_cublass_2.cu's strategy — one device-wide
operation per transform instead of per-block launches.  Where the reference
expands T to an N x N block-diagonal matrix and runs two O(N^3) whole-image
GEMMs over mostly zeros (main_cublass_2.cu:225-235, upgrade_T_matrix
utils_kernels.cu:60-69), this version contracts the (H//8, 8, W//8, 8)
block-grid view with the 8x8 T directly: identical math, O(N^2 * 8) FLOPs,
and XLA fuses level shift + quantize into the same HBM pass.
"""

from __future__ import annotations

from tpudct.config import CodecConfig
from tpudct.models.base import Pipeline, register
from tpudct.ops.quant import dequantize, quantize
from tpudct.ops.transform import dct2_blocks, idct2_blocks, level_shift, level_unshift


class BatchedPipeline(Pipeline):
    name = "batched"

    def dct(self, image, cfg: CodecConfig):
        return quantize(
            dct2_blocks(level_shift(image), transform=cfg.transform),
            cfg.q_scale, cfg.q_table, deadzone=cfg.deadzone,
        )

    def idct(self, coeffs, cfg: CodecConfig):
        return level_unshift(
            idct2_blocks(
                dequantize(coeffs, cfg.q_scale, cfg.q_table), transform=cfg.transform
            )
        )


register(BatchedPipeline(), "cublas2")
