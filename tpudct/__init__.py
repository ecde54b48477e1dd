"""tpudct — blockwise approximate-DCT image codec framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CUDA codebase GerryDps/CUDA-DCT-IDCT (JPEG-style lossy grayscale compression
via the Haweel-2016 signed 8x8 approximate DCT).  Four pipeline families
compute the identical math with different compute strategies (see
`tpudct.models`), mirroring the reference's four binaries
(reference: main_cublass.cu, main_cublass_2.cu, main_fastAppr.cu,
main_newAppr.cu) — each re-designed in JAX/XLA/Pallas rather than
translated from CUDA.

Public API
----------
- constants:  T (Haweel approximate DCT), Q (JPEG luminance), BLOCK_SIZE
- config:     CodecConfig
- models:     get_pipeline("cublas" | "cublas2" | "batched" | "fast" | "hp")
- ops:        blockify / deblockify / dct2 / idct2 / quantize / dequantize
- parallel:   band meshes, sharded roundtrip, distributed metrics
- utils:      JPEG I/O, PEEN/MSE/compression metrics, timing, serialization
"""

from tpudct.constants import BLOCK_SIZE, T, Q, haweel_integer_core, haweel_row_norms
from tpudct.config import CodecConfig
from tpudct.models import get_pipeline, available_pipelines

__version__ = "0.2.0"

__all__ = [
    "BLOCK_SIZE",
    "T",
    "Q",
    "haweel_integer_core",
    "haweel_row_norms",
    "CodecConfig",
    "get_pipeline",
    "available_pipelines",
    "__version__",
]
