"""Runtime configuration.

The reference has no runtime config at all — block size is a compile-time
``#define BLOCK_SIZE 8`` re-defined per TU (utils_kernels.cuh:4,
main_cublass.cu:31), T/Q are hardcoded literals and argv carries only two
filenames (main_cublass.cu:41-44) or one size (benchmark_newAppr.cu:35-38).
Here a single frozen dataclass drives every pipeline, the CLI, the
benchmarks and the sharded paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Configuration for one codec run.

    Attributes:
      transform: which 8x8 transform to run (constants.TRANSFORMS).
        "haweel" (default) = the reference's exact matrix; "rdct" = the
        derived rounded-DCT {0,+-1} approximation (PAPERS.md family);
        "dct" = the exact DCT-II (quality ceiling; f32 paths only — no
        integer core exists, so `fast` rejects it and hp uses its f32
        kernel with "highest" decode). Beyond parity: the reference
        hardcodes one transform in 9 translation units.
      q_scale: multiplier applied to the JPEG luminance table Q (1.0 = the
        reference's "Standard Q" column, README.md:67-69).
      q_table: which base quantization table to scale: "luma" (default;
        the reference's only table) or "chroma" (ITU-T T.81 Table K.2,
        used by the color extension for Cb/Cr planes).
      retain_k: optional zonal coefficient retention. Keeps coefficient
        (u, v) iff u + v < retain_k (anti-diagonal / zonal mask), the codec
        analog of the README's k=6..10 sweep (README.md:62-69; the reference
        computed these externally — no retention code exists in-repo).
        None = keep all 64 (the "Standard Q" configuration).
      interpret: force Pallas kernels into interpreter mode (an explicit
        override for tests; otherwise tpudct.kernels.resolve_interpret
        decides: compiled on "gpu", interpreted on "cpu").
      exact_int_core: run the hp forward transform as the exact integer
        Haweel contraction (Ts X Ts^T with fp16 operands and f32
        accumulation — every value is an integer below 2^11, so exact;
        meant for integral pixel values, i.e. u8-sourced images — the
        codec's domain; float pixels are truncated to integers, see
        models/hp_appr.py F32_ENCODE_WIDTH). False runs T itself in IEEE
        f32 (the reference's GEMM inputs). On integral pixels the two
        differ only at true .5 quantizer ties.
      decode_precision: inverse-transform strategy.
        "butterfly" (default) = exact inverse against the integer core:
        the row norms fold into the dequant multiply and each f32 operand
        splits exactly into three bf16 digits, so every product against
        Ts in {0,+-1,+-2} is exact and only the f32 accumulation rounds
        (<= 1e-3 gray levels vs f64).
        "highest" = T itself as IEEE f32 dots, the reference's f32 GEMM
        inputs — the cross-checking tier.
        "high" = accepted for compatibility; computed as "butterfly".
      band_rows: rows per kernel program (a power of two >= 16).
        None (default) = hp_pallas.DEFAULT_TILE.
      tile_cols: columns per kernel program (a power of two >= 16);
        None (default) = hp_pallas.DEFAULT_TILE.  The row operands are
        tile_cols x tile_cols each: above 128 the roundtrip kernels need
        more shared memory than an H100 has (compile error).
    """

    # NOTE: the 8x8 block edge is structural (constants.BLOCK_SIZE), not a
    # config knob — every transform, kernel and container assumes it; a
    # former block_size field was dead and misleading, so it was removed.
    transform: str = "haweel"
    q_scale: float = 1.0
    q_table: str = "luma"
    retain_k: Optional[int] = None
    #: AC quantizer rounding offset (round 5): 0.5 = round-half-away (the
    #: reference rule, bit-parity default); theta < 0.5 = deadzone
    #: quantization — AC magnitudes round at |y|/Q + theta, so near-edge
    #: coefficients fall toward zero, trading distortion for cheaper rANS
    #: symbols (a rate-distortion trade measured on the host, independent
    #: of the accelerator).  DC always rounds half-away (it is
    #: delta-coded and dense; a DC deadzone buys nothing and shifts block
    #: means).  Encode-side only: dequantization is unchanged, so streams
    #: decode identically everywhere and the header needs no new field.
    #: Non-default values ride the einsum quantizer (hp/batched fall back;
    #: the fused u8 kernels bake the 0.5 rule and demote via dispatch).
    deadzone: float = 0.5
    interpret: bool = False
    exact_int_core: bool = True
    decode_precision: str = "butterfly"
    band_rows: Optional[int] = None
    tile_cols: Optional[int] = None
