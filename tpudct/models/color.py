"""JPEG-style color codec on top of any grayscale pipeline.

The reference cannot represent color at all — its loader collapses RGB to
luminance (utils.cu:70-72) and every kernel takes one plane.  This module
composes the existing blockwise codec into the standard JPEG color model:

  RGB -> full-range BT.601 YCbCr (utils/color.py)
  Y   : full resolution, luminance table Q      (the reference's only mode)
  Cb, Cr: 4:2:0 (default) / 4:2:2 / 4:4:4, chrominance table QC (ITU-T
          T.81 Table K.2), both planes coded through ONE batched kernel
          launch

Every plane rides the same pipeline object (`cublas` / `batched` / `fast` /
`hp`), so the color path inherits whatever compute strategy and decode tier
the caller picked.  Plane layout, padding and retention behave exactly as
in the grayscale path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from tpudct.config import CodecConfig
from tpudct.models.base import Pipeline
from tpudct.ops.padding import crop, pad_to_blocks, padded_shape
from tpudct.ops.rounding import round_half_away
from tpudct.utils.color import (
    downsample_420,
    downsample_422,
    merge_u8,
    rgb_to_ycbcr,
    split_u8,
    upsample_420,
    upsample_422,
    ycbcr_to_rgb,
)

PLANES = ("y", "cb", "cr")


def _fits_i8(v) -> bool:
    """Whether a coefficient plane's VALUES fit int8 (the fused u8 decode
    casts to int8; out-of-range values from the f32 encode path on
    out-of-[0,255] pixels would wrap).  int8/narrow-int streams are
    in-range by construction — checking the dtype avoids a full
    device->host transfer per plane for in-memory serving callers holding
    device arrays.  Only float planes need the value scan."""
    dt = np.dtype(getattr(v, "dtype", np.float32))
    if dt in (np.dtype(np.int8), np.dtype(np.uint8)):
        return True
    from tpudct.utils.serialize import _abs_bound

    return bool(_abs_bound(np.asarray(v)) <= 127)


def normalize_subsample(subsample) -> "str | bool":
    """Normalize the subsample parameter: True/'420' -> '420' (the JPEG
    default), '422' -> '422', False/None/'444' -> False (full-res
    chroma).  Strings join bools so the original boolean API keeps
    working."""
    if subsample in (True, "420", 420):
        return "420"
    if subsample in ("422", 422):
        return "422"
    if subsample in (False, None, "444", 444):
        return False
    raise ValueError(f"unknown chroma subsampling {subsample!r}; use 420|422|444")


_DOWN = {"420": downsample_420, "422": downsample_422}
_UP = {"420": upsample_420, "422": upsample_422}


def _luma_cfg(cfg: CodecConfig, name: str = "luma") -> CodecConfig:
    """The color codec OWNS table assignment (Y vs Q, Cb/Cr vs QC) — a
    caller-set cfg.q_table is normalized away so the serialized headers
    always match the math.  Streams carrying their own tables (imported
    JPEGs, utils/jpegcoef.py) override via meta["y_q_table"]/["c_q_table"]."""
    return dataclasses.replace(cfg, q_table=name)


def _chroma_cfg(cfg: CodecConfig, name: str = "chroma") -> CodecConfig:
    return dataclasses.replace(cfg, q_table=name)


def encode_color(
    p: Pipeline, rgb, cfg: CodecConfig, subsample: bool = True
) -> Tuple[dict, dict]:
    """(H, W, 3) RGB -> ({plane: coefficient map}, meta).

    Coefficient maps keep the padded plane shapes (block-aligned); `meta`
    records everything decode needs: the RGB size, per-plane pre-padding
    sizes and the subsampling flag."""
    mode = normalize_subsample(subsample)
    y, cb, cr = rgb_to_ycbcr(rgb)
    h, w = y.shape
    if mode:
        cb, cr = _DOWN[mode](cb), _DOWN[mode](cr)
    ch, cw = cb.shape

    yp, _ = pad_to_blocks(y)
    cy = p.encode(yp, _luma_cfg(cfg))

    ccfg = _chroma_cfg(cfg)
    cbp, _ = pad_to_blocks(cb)
    crp, _ = pad_to_blocks(cr)
    cc = p.encode(jnp.concatenate([cbp, crp], axis=0), ccfg)
    ph = cbp.shape[0]
    meta = {
        "orig_shape": (h, w),
        "chroma_shape": (ch, cw),
        "subsample": mode,
    }
    return {"y": cy, "cb": cc[:ph], "cr": cc[ph:]}, meta


def decode_color(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig):
    """Inverse of :func:`encode_color`: coefficient planes -> (H, W, 3) u8."""
    h, w = meta["orig_shape"]
    ch, cw = meta["chroma_shape"]

    lcfg = _luma_cfg(cfg, meta.get("y_q_table", "luma"))
    y = crop(p.idct(jnp.asarray(planes["y"], jnp.float32), lcfg), h, w)

    ccfg = _chroma_cfg(cfg, meta.get("c_q_table", "chroma"))
    cc = p.idct(
        jnp.concatenate(
            [jnp.asarray(planes["cb"], jnp.float32),
             jnp.asarray(planes["cr"], jnp.float32)], axis=0
        ),
        ccfg,
    )
    ph = planes["cb"].shape[0]
    cb = crop(cc[:ph], ch, cw)
    cr = crop(cc[ph:], ch, cw)
    mode = normalize_subsample(meta["subsample"])
    if mode:
        cb, cr = _UP[mode](cb, h, w), _UP[mode](cr, h, w)

    rgb = ycbcr_to_rgb(y, cb, cr)
    return jnp.clip(round_half_away(rgb), 0.0, 255.0).astype(jnp.uint8)


def decode_color_scaled(
    p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig,
    factor: int | None = None, *, m: int | None = None,
):
    """Fractional-scale color decode: coefficient planes -> (H/f, W/f, 3) u8.

    The djpeg ``-scale M/8`` analog for .tdcc streams (ops/scaled.py has
    the contract: exact box-average of the full reconstruction).  Chroma
    planes scale ANISOTROPICALLY so subsampling composes with the scale
    instead of round-tripping through an upsample: a 4:2:0 plane at 1/f
    luma scale needs only a 1/(f/2) decode of the stored half-resolution
    data (pool_f ∘ upsample_2 == pool_{f/2}), and at f=2 the chroma plane
    is simply decoded at its native resolution — the scaled output IS the
    stored chroma grid.  ceil-division makes every plane land on the luma
    scaled shape exactly (ceil(ceil(h/a)/b) == ceil(h/(ab))).

    The `p` argument is used only at factor == 1 (full decode): fractional
    scales are pipeline-INDEPENDENT by construction — the rectangular
    scaled basis (ops/scaled.py) is its own einsum formulation, not a
    strategy of any registered pipeline, so `--pipeline` has no effect on
    `decode --scale` (docs/API.md notes the same).

    Pass either ``factor`` (integer 1/f scale, f in 1,2,4,8 — rides the
    u8/fused fast paths) or ``m`` (general M/8 numerator, M = 1..16 —
    ops.scaled.scaled_decode_m8's exact area-resample contract).
    Subsampled chroma composes with M/8 by doubling the numerator on the
    subsampled axes (area averages of a nearest-upsampled signal equal
    area averages of the stored plane at 2M/8 — piecewise-constant
    refinement preserves the integral), so subsampled modes support
    M <= 8 (the chroma numerator caps at 16); 4:4:4 takes all 16.
    """
    from tpudct.ops.scaled import (
        scaled_decode, scaled_decode_m8, scaled_shape, scaled_shape_m8,
    )

    if factor is not None and m is not None:
        raise ValueError("pass either factor or m, not both")
    if factor is None and m is None:
        raise ValueError("pass factor (1/f) or m (M/8)")
    if m is not None and 8 % m == 0:
        factor, m = 8 // m, None
    h, w = meta["orig_shape"]
    mode = normalize_subsample(meta["subsample"])
    lcfg = _luma_cfg(cfg, meta.get("y_q_table", "luma"))
    ccfg = _chroma_cfg(cfg, meta.get("c_q_table", "chroma"))
    if m is not None:
        # General M/8 path (einsum sweeps; the integer factors below keep
        # the u8/fused fast paths).
        m_r = 2 * m if mode == "420" else m
        m_c = 2 * m if mode in ("420", "422") else m
        if max(m_r, m_c) > 16:
            raise ValueError(
                f"M/8 color decode with {mode} chroma supports M <= 8 "
                f"(chroma numerator {max(m_r, m_c)} > 16); use a 4:4:4 "
                "stream for upscale numerators"
            )
        hs, ws = scaled_shape_m8(h, m), scaled_shape_m8(w, m)
        y = scaled_decode_m8(
            jnp.asarray(planes["y"], jnp.float32), lcfg, m
        )[:hs, :ws]
        cc = scaled_decode_m8(
            jnp.concatenate(
                [jnp.asarray(planes["cb"], jnp.float32),
                 jnp.asarray(planes["cr"], jnp.float32)], axis=0
            ),
            ccfg, m_r, m_cols=m_c,
        )
        phs = planes["cb"].shape[0] * m_r // 8
        cb = cc[:phs][:hs, :ws]
        cr = cc[phs:][:hs, :ws]
        rgb = ycbcr_to_rgb(y, cb, cr)
        return jnp.clip(round_half_away(rgb), 0.0, 255.0).astype(jnp.uint8)
    if factor == 1:
        return decode_color(p, planes, meta, cfg)
    hs, ws = scaled_shape(h, factor), scaled_shape(w, factor)
    f_r = factor // 2 if mode == "420" else factor
    f_c = factor // 2 if mode in ("420", "422") else factor

    # Fast path: ONE fused kernel per plane pass (decode + exact integer
    # box pool; ops.scaled.scaled_decode_u8 documents the clamp/truncate
    # contract delta).  The planes are 8x8-aligned coefficient maps, which
    # is all the kernel needs.  Any ineligible plane drops the WHOLE
    # stream to the f32 sweeps so the planes stay consistent.
    def _u8_ok(plane, pcfg):
        from tpudct.kernels import hp_pallas
        from tpudct.utils.serialize import _abs_bound

        return (
            hasattr(p, "decode_u8")
            and hp_pallas.supports_u8(
                *np.shape(plane), pcfg.q_scale, pcfg.transform, pcfg.q_table,
            )
            and _abs_bound(np.asarray(plane)) <= 127
        )

    if _u8_ok(planes["y"], lcfg) and all(
        _u8_ok(planes[k], ccfg) for k in ("cb", "cr")
    ):
        from tpudct.ops.scaled import scaled_decode_u8

        y = scaled_decode_u8(
            p, jnp.asarray(planes["y"], jnp.int8), lcfg, factor
        )[:hs, :ws]
        cb8 = jnp.asarray(planes["cb"], jnp.int8)
        cr8 = jnp.asarray(planes["cr"], jnp.int8)
        cc = scaled_decode_u8(
            p, jnp.concatenate([cb8, cr8], axis=0), ccfg, f_r, f_c
        )
        phs = cb8.shape[0] // f_r
        cb = cc[:phs][:hs, :ws]
        cr = cc[phs:][:hs, :ws]
    else:
        y = scaled_decode(
            jnp.asarray(planes["y"], jnp.float32), lcfg, factor
        )[:hs, :ws]
        cc = scaled_decode(
            jnp.concatenate(
                [jnp.asarray(planes["cb"], jnp.float32),
                 jnp.asarray(planes["cr"], jnp.float32)], axis=0
            ),
            ccfg, f_r, f_cols=f_c,
        )
        phs = planes["cb"].shape[0] // f_r
        cb = cc[:phs][:hs, :ws]
        cr = cc[phs:][:hs, :ws]

    rgb = ycbcr_to_rgb(y, cb, cr)
    return jnp.clip(round_half_away(rgb), 0.0, 255.0).astype(jnp.uint8)


def roundtrip_color(
    p: Pipeline, rgb, cfg: CodecConfig, subsample: bool = True
) -> Tuple[dict, dict, "jnp.ndarray"]:
    """Full color pass: returns (coefficient planes, meta, RGB u8 recon)."""
    planes, meta = encode_color(p, rgb, cfg, subsample=subsample)
    return planes, meta, decode_color(p, planes, meta, cfg)


# ---- u8-native fast path ----------------------------------------------------


def _layout(rgb) -> tuple:
    """Classify a 3-channel image's layout WITHOUT converting/transferring it.

    Returns ("planar" | "interleaved", h, w).  Ambiguous (3, W, 3) arrays
    classify as interleaved (channels-last wins), matching every producer
    in this codebase."""
    shape = tuple(rgb.shape)
    if len(shape) != 3:
        raise ValueError(f"expected a 3-channel image, got shape {shape}")
    if shape[-1] == 3:
        return "interleaved", shape[0], shape[1]
    if shape[0] == 3:
        return "planar", shape[1], shape[2]
    raise ValueError(f"expected 3 channels, got shape {shape}")


def _planar_u8(rgb):
    """Accept (H, W, 3) interleaved or (3, H, W) planar uint8; return planar."""
    layout, _h, _w = _layout(rgb)
    rgb = jnp.asarray(rgb)
    if rgb.dtype != jnp.uint8:
        raise ValueError(f"u8 color path needs uint8 input, got {rgb.dtype}")
    return rgb if layout == "planar" else jnp.moveaxis(rgb, -1, 0)


def _interleaved_f32(rgb):
    """Accept either layout; return (H, W, 3) f32 for the general path."""
    layout, _h, _w = _layout(rgb)
    rgb = jnp.asarray(rgb, jnp.float32)
    return rgb if layout == "interleaved" else jnp.moveaxis(rgb, 0, -1)


# u8 color path alignment: 4:2:0 halves both dims, and the halves must stay
# 8x8-aligned for the codec
_ALIGN = 16

# stacked-chroma (cb|cr vertically) codec geometry per mode, as a function
# of the luma (h, w): 420 -> (h, w/2); 422 -> (2h, w/2); 444 -> (2h, w)
_CHROMA_STACK = {
    "420": lambda h, w: (h, w // 2),
    "422": lambda h, w: (2 * h, w // 2),
    False: lambda h, w: (2 * h, w),
}


def supports_color_u8(
    p: Pipeline, cfg: CodecConfig, h: int, w: int, subsample="420"
) -> bool:
    """Gate for the fused u8 color path: the pipeline must expose the
    u8-native codec (hp), the dims must tile by 16 (so every chroma mode's
    planes stay 8x8-aligned; the two chroma planes ride the codec stacked
    vertically), and the coefficients must fit int8 against BOTH
    quantization tables."""
    from tpudct.kernels import hp_pallas

    ch, cw = _CHROMA_STACK[normalize_subsample(subsample)](h, w)
    return (
        hasattr(p, "encode_u8")
        and cfg.deadzone == 0.5  # the fused kernels bake the 0.5 rule;
        #                          deadzone encodes ride the f32 path
        and h > 0 and w > 0
        and h % _ALIGN == 0
        and w % _ALIGN == 0
        and hp_pallas.supports_u8(h, w, cfg.q_scale, cfg.transform, "luma")
        and hp_pallas.supports_u8(ch, cw, cfg.q_scale, cfg.transform, "chroma")
    )


def _chroma_plane_shape(mode, h, w):
    """TRUE chroma plane dims for a luma (h, w) — ceil-division so odd
    (unaligned) sizes are covered; equals the old floor form when aligned."""
    return {
        "420": (-(-h // 2), -(-w // 2)),
        "422": (h, -(-w // 2)),
        False: (h, w),
    }[mode]


def color_kernel_shape(h: int, w: int):
    """Padding for the fused u8 color path: both dims to multiples of 16
    (the supports_color_u8 alignment, valid for every chroma mode)."""
    return (max(_ALIGN, -(-h // _ALIGN) * _ALIGN), max(_ALIGN, -(-w // _ALIGN) * _ALIGN))


def encode_color_u8(p: Pipeline, rgb_u8, cfg: CodecConfig, subsample: bool = True):
    """u8-native color encode: uint8 RGB -> int8 coefficient planes.

    4x less HBM traffic than the f32 path end-to-end (u8 color split +
    the codec's fused int8 kernels).  Any image size: edge-replicate pads
    to the kernel grid (:func:`color_kernel_shape`) and crops the
    coefficient planes back to the 8-aligned shapes of the TRUE plane
    dims, so the serialized container is format-identical to the f32
    path's.  Requires :func:`supports_color_u8` on the padded dims.
    All three chroma modes (4:2:0 / 4:2:2 / 4:4:4) have fused kernels;
    chroma planes stack vertically through ONE codec launch."""
    x = _planar_u8(rgb_u8)
    _c, h, w = x.shape
    mode = normalize_subsample(subsample)
    hk, wk = color_kernel_shape(h, w)
    if not supports_color_u8(p, cfg, hk, wk, mode):
        raise ValueError(
            f"u8 color path unsupported for {h}x{w} subsample={subsample} "
            "(needs hp pipeline and an int8-safe q_scale); use encode_color"
        )
    if (hk, wk) != (h, w):
        x = jnp.pad(x, ((0, 0), (0, hk - h), (0, wk - w)), mode="edge")
    y, cb, cr = split_u8(x, mode)
    cy = p.encode_u8(y, _luma_cfg(cfg))
    cc = p.encode_u8(jnp.concatenate([cb, cr], axis=0), _chroma_cfg(cfg))
    ph = cb.shape[0]
    ch, cw = _chroma_plane_shape(mode, h, w)
    y8 = padded_shape(h, w)
    c8 = padded_shape(ch, cw)
    meta = {
        "orig_shape": (h, w),
        "chroma_shape": (ch, cw),
        "subsample": mode,
    }
    return {
        "y": cy[: y8[0], : y8[1]],
        "cb": cc[:ph][: c8[0], : c8[1]],
        "cr": cc[ph:][: c8[0], : c8[1]],
    }, meta


def decode_color_u8(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig):
    """Inverse of :func:`encode_color_u8` -> (H, W, 3) uint8 interleaved.

    Accepts planes at the 8-aligned shapes of the true plane dims (what
    encode_color_u8 AND encode_color both produce); zero-pads them up to
    the kernel grid (all-zero blocks decode to the neutral 128 level in
    every channel) and crops the merged RGB back to ``orig_shape``."""
    h, w = meta["orig_shape"]
    mode = normalize_subsample(meta["subsample"])
    y8 = padded_shape(h, w)
    c8 = padded_shape(*_chroma_plane_shape(mode, h, w))
    if (
        tuple(jnp.asarray(planes["y"]).shape) != y8
        or tuple(jnp.asarray(planes["cb"]).shape) != c8
        or tuple(jnp.asarray(planes["cr"]).shape) != c8
    ):
        raise ValueError(
            f"u8 decode expects 8-aligned planes: y is "
            f"{jnp.asarray(planes['y']).shape} (want {y8}), cb/cr are "
            f"{jnp.asarray(planes['cb']).shape}/"
            f"{jnp.asarray(planes['cr']).shape} (want {c8}); "
            "use decode_color for other paddings"
        )
    hk, wk = color_kernel_shape(h, w)
    chk, cwk = _chroma_plane_shape(mode, hk, wk)  # exact: hk/wk are aligned
    yk = jnp.pad(
        jnp.asarray(planes["y"], jnp.int8),
        ((0, hk - y8[0]), (0, wk - y8[1])),
    )
    cbk = jnp.pad(
        jnp.asarray(planes["cb"], jnp.int8),
        ((0, chk - c8[0]), (0, cwk - c8[1])),
    )
    crk = jnp.pad(
        jnp.asarray(planes["cr"], jnp.int8),
        ((0, chk - c8[0]), (0, cwk - c8[1])),
    )
    y = p.decode_u8(yk, _luma_cfg(cfg))
    cc = p.decode_u8(jnp.concatenate([cbk, crk], axis=0), _chroma_cfg(cfg))
    rgb = merge_u8(y, cc[:chk], cc[chk:], mode)
    return jnp.moveaxis(rgb, 0, -1)[:h, :w]


def roundtrip_color_u8(p: Pipeline, rgb_u8, cfg: CodecConfig, subsample=True):
    """Fused u8 color pass: uint8 RGB -> (int8 coefficient planes, meta,
    uint8 RGB reconstruction).  Any chroma mode (default 4:2:0)."""
    planes, meta = encode_color_u8(p, rgb_u8, cfg, subsample=subsample)
    return planes, meta, decode_color_u8(p, planes, meta, cfg)


# ---- auto-dispatch (the canonical entry points for callers with u8 data) ----


def _u8_eligible(p: Pipeline, rgb, cfg: CodecConfig, subsample: bool) -> bool:
    # Inspect dtype/shape without jnp.asarray: that would device-transfer a
    # numpy input just to look at metadata (and again on the real path).
    dt = getattr(rgb, "dtype", None)  # nested lists etc. -> f32 path
    if dt is None or np.dtype(dt) != np.uint8:
        return False
    try:
        _layout_name, h, w = _layout(rgb)
    except ValueError:
        return False
    # gate on the kernel-padded dims: encode_color_u8 pads internally, so
    # ragged (camera) sizes ride the fused path too
    return supports_color_u8(
        p, cfg, *color_kernel_shape(h, w), normalize_subsample(subsample)
    )


def encode_color_auto(p: Pipeline, rgb, cfg: CodecConfig, subsample: bool = True):
    """Encode through the fused u8 path when the input/geometry allow it,
    else the general f32 path.  The single dispatch point for the CLI and
    any caller holding u8 pixels; accepts either (H, W, 3) or (3, H, W)."""
    if _u8_eligible(p, rgb, cfg, subsample):
        return encode_color_u8(p, rgb, cfg, subsample=subsample)
    return encode_color(p, _interleaved_f32(rgb), cfg, subsample=subsample)


def decode_color_auto(p: Pipeline, planes: dict, meta: dict, cfg: CodecConfig):
    """Decode through the fused u8 path when the stream geometry allows it.

    Safe for streams from EITHER encode path: besides the geometry/q_scale
    gate, the ACTUAL plane values are checked against int8 (`_fits_i8`) —
    the f32 path accepts out-of-[0,255] pixels whose coefficients can
    exceed the theoretical u8-pixel bound, and casting those would wrap."""
    h, w = meta["orig_shape"]
    mode = normalize_subsample(meta["subsample"])
    if (
        # the fused u8 kernels bake the standard tables; per-stream custom
        # tables (imported JPEGs) take the general f32 path
        meta.get("y_q_table", "luma") == "luma"
        and meta.get("c_q_table", "chroma") == "chroma"
        and supports_color_u8(p, cfg, *color_kernel_shape(h, w), mode)
        and tuple(planes["y"].shape) == padded_shape(h, w)
        and tuple(planes["cb"].shape)
        == padded_shape(*_chroma_plane_shape(mode, h, w))
        and all(_fits_i8(v) for v in planes.values())
    ):
        return decode_color_u8(p, planes, meta, cfg)
    return decode_color(p, planes, meta, cfg)


def roundtrip_color_auto(p: Pipeline, rgb, cfg: CodecConfig, subsample: bool = True):
    """Path-consistent roundtrip: the decode uses the SAME path the encode
    chose (mixing them is unsafe in-memory — f32-path planes from
    out-of-[0,255] pixels can exceed int8).  Returns (planes, meta, rgb u8
    interleaved)."""
    if _u8_eligible(p, rgb, cfg, subsample):
        return roundtrip_color_u8(p, rgb, cfg, subsample=subsample)
    x = _interleaved_f32(rgb)
    planes, meta = encode_color(p, x, cfg, subsample=subsample)
    return planes, meta, decode_color(p, planes, meta, cfg)


# ---- stacked bulk dispatch (color twin of models/dispatch.py helpers) ------
#
# 8x8 blocks are independent and the chroma resampling windows are 2-row
# local, so same-padded-width RGB frames stack as ONE taller planar image
# through the fused split/codec/merge kernels (every padded height is a
# 64-multiple — seams never split a pooling window or an 8-row block).
# Bulk CLI jobs (`batch --color` / `unbatch` over .tdcc) previously paid
# per-image dispatch overhead; a stacked chunk pays it once.

from tpudct.models.dispatch import _STACK_MAX_PIXELS  # noqa: E402 — one cap


def encode_color_batch_auto(
    p: Pipeline, rgbs, cfg: CodecConfig, subsample: bool = True,
    max_pixels: int = _STACK_MAX_PIXELS,
):
    """Bulk color encode: ONE split + luma-codec + chroma-codec dispatch
    per same-width chunk of u8-eligible frames.

    Takes a list of RGB images (either layout); returns ``[(planes, meta),
    ...]`` in input order, each bit-identical to
    :func:`encode_color_auto` on that frame alone.  Frames that fail the
    u8 gate (float pixels, int8-unsafe config) fall back per-frame.
    """
    from tpudct.models.dispatch import _chunk, _stack_groups

    mode = normalize_subsample(subsample)
    results: list = [None] * len(rgbs)
    metas = []  # (idx, padded_planar_np, h, w) for eligible frames
    for i, rgb in enumerate(rgbs):
        if not _u8_eligible(p, rgb, cfg, subsample):
            results[i] = encode_color_auto(p, rgb, cfg, subsample=subsample)
            continue
        layout, h, w = _layout(rgb)
        x = np.asarray(rgb)
        if layout == "interleaved":
            x = np.moveaxis(x, -1, 0)
        hk, wk = color_kernel_shape(h, w)
        if (hk, wk) != (h, w):
            x = np.pad(x, ((0, 0), (0, hk - h), (0, wk - w)), mode="edge")
        metas.append((i, x, h, w))
    if not metas:
        return results

    keys = [x.shape[2] for _, x, _, _ in metas]
    sizes = [x.size for _, x, _, _ in metas]
    for _wk, indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            stacked = (
                metas[chunk[0]][1]
                if len(chunk) == 1
                else np.concatenate([metas[j][1] for j in chunk], axis=1)
            )
            y, cb, cr = split_u8(jnp.asarray(stacked), mode)
            cy = np.asarray(p.encode_u8(y, _luma_cfg(cfg)))
            ph = cb.shape[0]
            cc = np.asarray(
                p.encode_u8(jnp.concatenate([cb, cr], axis=0), _chroma_cfg(cfg))
            )
            ccb, ccr = cc[:ph], cc[ph:]
            y0 = c0 = 0
            for j in chunk:
                i, x, h, w = metas[j]
                hk, wk = x.shape[1], x.shape[2]
                chk, _cwk = _chroma_plane_shape(mode, hk, wk)
                ch, cw = _chroma_plane_shape(mode, h, w)
                y8, c8 = padded_shape(h, w), padded_shape(ch, cw)
                meta = {
                    "orig_shape": (h, w),
                    "chroma_shape": (ch, cw),
                    "subsample": mode,
                }
                results[i] = ({
                    "y": cy[y0 : y0 + y8[0], : y8[1]].copy(),
                    "cb": ccb[c0 : c0 + c8[0], : c8[1]].copy(),
                    "cr": ccr[c0 : c0 + c8[0], : c8[1]].copy(),
                }, meta)
                y0 += hk
                c0 += chk
    return results


def decode_color_batch_auto(
    p: Pipeline, items, max_pixels: int = _STACK_MAX_PIXELS
):
    """Bulk color decode: ONE luma-codec + chroma-codec + merge dispatch
    per same-width/same-config chunk of u8-eligible streams.

    Takes ``[(planes, meta, cfg), ...]``; returns interleaved (H, W, 3)
    uint8 NumPy frames in input order, each bit-identical to
    :func:`decode_color_auto` on that stream alone (ineligible streams
    fall back per-item).
    """
    from tpudct.models.dispatch import _chunk, _stack_groups

    results: list = [None] * len(items)
    metas = []  # (idx, ypad, cbpad, crpad, mode, cfg, h, w)
    for i, (planes, meta, cfg) in enumerate(items):
        h, w = meta["orig_shape"]
        mode = normalize_subsample(meta["subsample"])
        y8 = padded_shape(h, w)
        c8 = padded_shape(*_chroma_plane_shape(mode, h, w))
        if not (
            meta.get("y_q_table", "luma") == "luma"
            and meta.get("c_q_table", "chroma") == "chroma"
            and supports_color_u8(p, cfg, *color_kernel_shape(h, w), mode)
            and tuple(np.shape(planes["y"])) == y8
            and tuple(np.shape(planes["cb"])) == c8
            and tuple(np.shape(planes["cr"])) == c8
            and all(_fits_i8(v) for v in planes.values())
        ):
            results[i] = np.asarray(decode_color_auto(p, planes, meta, cfg))
            continue
        hk, wk = color_kernel_shape(h, w)
        chk, cwk = _chroma_plane_shape(mode, hk, wk)
        yp = np.pad(np.asarray(planes["y"], np.int8),
                    ((0, hk - y8[0]), (0, wk - y8[1])))
        cbp = np.pad(np.asarray(planes["cb"], np.int8),
                     ((0, chk - c8[0]), (0, cwk - c8[1])))
        crp = np.pad(np.asarray(planes["cr"], np.int8),
                     ((0, chk - c8[0]), (0, cwk - c8[1])))
        metas.append((i, yp, cbp, crp, mode, cfg, h, w))
    if not metas:
        return results

    keys = [(yp.shape[1], mode, cfg)
            for _, yp, _, _, mode, cfg, _, _ in metas]
    sizes = [yp.size * 3 for _, yp, _, _, _, _, _, _ in metas]
    for (_wk, mode, cfg), indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            ys = np.concatenate([metas[j][1] for j in chunk], axis=0)
            cbs = np.concatenate([metas[j][2] for j in chunk], axis=0)
            crs = np.concatenate([metas[j][3] for j in chunk], axis=0)
            y = p.decode_u8(jnp.asarray(ys), _luma_cfg(cfg))
            cc = p.decode_u8(
                jnp.concatenate([jnp.asarray(cbs), jnp.asarray(crs)], axis=0),
                _chroma_cfg(cfg),
            )
            ph = cbs.shape[0]
            rgb = np.asarray(
                jnp.moveaxis(merge_u8(y, cc[:ph], cc[ph:], mode), 0, -1)
            )
            y0 = 0
            for j in chunk:
                i, yp, _, _, _, _, h, w = metas[j]
                results[i] = rgb[y0 : y0 + h, :w].copy()
                y0 += yp.shape[0]
    return results
