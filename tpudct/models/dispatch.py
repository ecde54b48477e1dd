"""Unified gray-plane dispatch: one gate for the u8 / f32-Pallas / einsum paths.

The reference runs its fast kernel on every input it accepts (grid setup at
main_newAppr.cu:261-264 assumes divisibility and just runs); here the fused
kernels take any 8x8-aligned plane (hp_pallas.supports/supports_u8), so
arbitrary-size images pad to the block grid (the f32 path's columns to
F32_ENCODE_WIDTH, see _f32_shape) and never drop to the batched einsum
fallback.

This module is the single decision point the CLI (`run`/`encode`/`decode`/
`batch`) and library callers share:

- encode: edge-replicate pad to the block grid (block-local transform =>
  pixels in the original region are unaffected), run the fastest eligible
  path, then crop the coefficient map to the 8-aligned shape — the
  serialized container carries no kernel-geometry artifacts.
- decode: zero-pad the coefficient map to the block grid (all-zero blocks
  decode to the constant +128 level shift), decode fused, crop.

The gate lives in one place because hand-rolled copies in cli.py drifted (`encode` staged f32
unconditionally — 2x device time and 4x HBM traffic vs `run` on the same
image).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tpudct.config import CodecConfig
from tpudct.models.base import Pipeline
from tpudct.ops.padding import crop, pad_coeffs_to_blocks, pad_to_blocks, padded_shape
from tpudct.ops.transform import to_uint8



def choose_gray_path(p: Pipeline, h: int, w: int, cfg: CodecConfig) -> str:
    """Pure decision on statically-known metadata (no device work).

    Returns the path the auto helpers will take for an (h, w) gray plane:
    ``"u8"`` (fused int8 kernels), ``"f32"`` (f32 Pallas kernels via the
    pipeline's own internal gate), or ``"general"`` (the pipeline's default
    einsum path; also every non-hp pipeline).
    """
    from tpudct.kernels import hp_pallas

    if cfg.deadzone != 0.5:
        # encode-side deadzone rides the einsum quantizer only (the fused
        # u8/f32 kernels bake the 0.5 rounding rule); decode never sees
        # the knob, so this demotion affects encodes alone
        return "general"
    if hasattr(p, "roundtrip_u8"):
        if hp_pallas.supports_u8(
            *padded_shape(h, w),
            cfg.q_scale, cfg.transform, cfg.q_table,
        ):
            return "u8"
        if hp_pallas.supports(*padded_shape(h, w)):
            return "f32"
    return "general"


def _resolve_path(p: Pipeline, img, cfg: CodecConfig) -> str:
    """choose_gray_path + a dtype guard: the u8 kernels read pixels as
    uint8, so float inputs (which may sit outside [0, 255] — casting
    would wrap) demote to the f32 Pallas path."""
    h, w = np.shape(img)
    path = choose_gray_path(p, h, w, cfg)
    if path == "u8" and np.dtype(getattr(img, "dtype", np.float32)) != np.uint8:
        return "f32"
    return path


def _f32_shape(h: int, w: int):
    """The f32 path's padded shape: 8-aligned rows, and columns to the
    width at which the hp float entry points run the kernel
    (models/hp_appr.py F32_ENCODE_WIDTH: the encode that fixed the bytes
    of these containers)."""
    from tpudct.models.hp_appr import F32_ENCODE_WIDTH

    h8, w8 = padded_shape(h, w)
    return h8, -(-w8 // F32_ENCODE_WIDTH) * F32_ENCODE_WIDTH


def _pad_for(path: str, img):
    if path == "u8":
        return pad_to_blocks(jnp.asarray(img, jnp.uint8))
    if path == "f32":
        x = jnp.asarray(img, jnp.float32)
        h, w = x.shape
        ph, pw = _f32_shape(h, w)
        return jnp.pad(x, ((0, ph - h), (0, pw - w)), mode="edge"), (h, w)
    # general path: keep the caller's float dtype (f64 callers pad as f64,
    # exactly like the old Pipeline.roundtrip_padded; Pipeline.encode
    # coerces non-float inputs itself)
    x = jnp.asarray(img)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    return pad_to_blocks(x)


def _crop8(c, h: int, w: int):
    """Crop a padded coefficient map to the 8-aligned shape of (h, w):
    the on-disk container format."""
    return crop(c, *padded_shape(h, w))


def encode_gray_auto(p: Pipeline, img, cfg: CodecConfig):
    """Gray encode through the fastest eligible path.

    Accepts any (H, W) array-like; returns (coeffs, (h, w)) with `coeffs`
    at the 8-aligned padded shape (int8-valued when the u8 kernels ran,
    f32 otherwise) ready for `serialize.save_coefficients(...,
    orig_shape=(h, w))`.
    """
    h, w = np.shape(img)
    path = _resolve_path(p, img, cfg)
    x, _ = _pad_for(path, img)
    if path == "u8":
        c = p.encode_u8(x, cfg)
    else:
        c = p.encode(x, cfg)
    return _crop8(c, h, w), (h, w)


def decode_gray_auto(p: Pipeline, coeffs, cfg: CodecConfig, orig_shape) -> np.ndarray:
    """Decode a quantized-coefficient map to a cropped uint8 plane.

    Rides the fused int8 decode whenever the VALUES fit int8 (JPEG
    imports and legacy containers included).
    """
    from tpudct.kernels import hp_pallas
    from tpudct.utils.serialize import _abs_bound

    h, w = orig_shape
    hc, wc = np.shape(coeffs)
    if (
        hasattr(p, "decode_u8")
        and hp_pallas.supports_u8(
            *padded_shape(hc, wc),
            cfg.q_scale, cfg.transform, cfg.q_table,
        )
        and _abs_bound(np.asarray(coeffs)) <= 127
    ):
        cpad, _ = pad_coeffs_to_blocks(jnp.asarray(coeffs, jnp.int8))
        return np.asarray(p.decode_u8(cpad, cfg))[:h, :w]
    if hasattr(p, "decode_u8") and hp_pallas.supports(
        *padded_shape(hc, wc)
    ):
        cpad, _ = pad_coeffs_to_blocks(jnp.asarray(coeffs, jnp.float32))
        return np.asarray(to_uint8(p.idct(cpad, cfg)))[:h, :w]
    return np.asarray(to_uint8(p.idct(jnp.asarray(coeffs), cfg)))[:h, :w]


def decode_gray_scaled_auto(
    p: Pipeline, coeffs, cfg: CodecConfig, orig_shape, m: int
) -> np.ndarray:
    """M/8 fractional-scale decode of a quantized map -> cropped uint8.

    The scaled twin of :func:`decode_gray_auto` and the ONE copy of the
    scaled dispatch (CLI `decode --scale` and `unbatch --scale` share it):
    integer 8/M factors ride ops.scaled.scaled_decode_u8 (the fused
    kernel, or its bit-identical composed fallback); M = 8 is the plain full decode; other
    numerators take the exact area-resample einsum (scaled_decode_m8).
    """
    from tpudct.kernels import hp_pallas
    from tpudct.ops.scaled import (
        scaled_decode, scaled_decode_m8, scaled_decode_u8, scaled_shape_m8,
    )
    from tpudct.utils.serialize import _abs_bound

    h, w = orig_shape
    if m == 8:
        return decode_gray_auto(p, coeffs, cfg, orig_shape)
    hs, ws = scaled_shape_m8(h, m), scaled_shape_m8(w, m)
    if 8 % m:
        rec = scaled_decode_m8(jnp.asarray(coeffs), cfg, m)
        return np.asarray(to_uint8(rec))[:hs, :ws]
    fac = 8 // m
    hc, wc = np.shape(coeffs)
    if (
        hasattr(p, "decode_u8")
        and hp_pallas.supports_u8(
            *padded_shape(hc, wc),
            cfg.q_scale, cfg.transform, cfg.q_table,
        )
        and _abs_bound(np.asarray(coeffs)) <= 127
    ):
        cpad, _ = pad_coeffs_to_blocks(jnp.asarray(coeffs, jnp.int8))
        # out_u8: the truncation rides the kernel epilogue — no post-pass,
        # 4x less output traffic, bit-identical to to_uint8 of the f32 form
        return np.asarray(
            scaled_decode_u8(p, cpad, cfg, fac, out_u8=True)
        )[:hs, :ws]
    rec = scaled_decode(jnp.asarray(coeffs), cfg, fac)
    return np.asarray(to_uint8(rec))[:hs, :ws]


def roundtrip_gray_jax(p: Pipeline, img, cfg: CodecConfig):
    """Jit-traceable core of :func:`roundtrip_gray_auto`: the path choice
    reads only static metadata (shape/dtype), so the whole thing traces.

    Returns jnp arrays: (coeffs at the 8-aligned shape, uint8
    reconstruction cropped to the original (h, w))."""
    h, w = np.shape(img)
    path = _resolve_path(p, img, cfg)
    x, _ = _pad_for(path, img)
    if path == "u8":
        c, r = p.roundtrip_u8(x, cfg)
    else:
        c, r = p.roundtrip(x, cfg)
    return _crop8(c, h, w), r[:h, :w]


def roundtrip_gray_auto(p: Pipeline, img, cfg: CodecConfig):
    """Gray roundtrip through the fastest eligible path (host-level API).

    Returns (coeffs at the 8-aligned shape, uint8 reconstruction cropped
    to the original (h, w) as a NumPy array).  Inside jit, use
    :func:`roundtrip_gray_jax`.
    """
    c, r = roundtrip_gray_jax(p, img, cfg)
    return c, np.asarray(r)


# ---- stacked bulk dispatch -------------------------------------------------
#
# 8x8 blocks are independent and every kernel path tiles by row bands, so a
# set of same-width images is ONE taller image (models/base.py
# roundtrip_batch uses the same trick in the serving bench).  The bulk CLI
# commands (`batch`/`unbatch`) would otherwise dispatch per image and pay
# the per-launch and per-transfer overhead B times.  Stacking turns a chunk
# into one dispatch + one transfer each way, bit-identically (splits land
# on 8-row-aligned image boundaries, and the transform/quantization never
# cross an 8-row seam).

# Cap on pixels per stacked launch: 2x the 8192^2 headline working set,
# well inside one card's memory.
_STACK_MAX_PIXELS = 1 << 27


def _pad_np(path: str, img):
    """Host-side twin of :func:`_pad_for` (NumPy, no device touch): same
    alignment, same edge-replicate content, so stacked results are
    bit-identical to the per-image device path."""
    if path == "u8":
        x = np.asarray(img, np.uint8)
    elif path == "f32":
        x = np.asarray(img, np.float32)
    else:
        x = np.asarray(img)
        if not np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float32)
    h, w = x.shape
    ph, pw = _f32_shape(h, w) if path == "f32" else padded_shape(h, w)
    if (ph, pw) != (h, w):
        x = np.pad(x, ((0, ph - h), (0, pw - w)), mode="edge")
    return x


def _stack_groups(keys):
    """Group item indices by stacking key, input order preserved."""
    groups: dict = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return groups


def _chunk(indices, sizes, max_pixels: int):
    out, cur, acc = [], [], 0
    for i in indices:
        if cur and acc + sizes[i] > max_pixels:
            out.append(cur)
            cur, acc = [], 0
        cur.append(i)
        acc += sizes[i]
    if cur:
        out.append(cur)
    return out


def encode_gray_batch_auto(
    p: Pipeline, imgs, cfg: CodecConfig, max_pixels: int = _STACK_MAX_PIXELS
):
    """Bulk gray encode: ONE device dispatch per same-width chunk.

    Takes a list of (H_i, W_i) array-likes; returns a list of
    ``(coeffs_np, (h, w))`` in input order, each bit-identical to
    :func:`encode_gray_auto` on that image alone.  Images group by
    (path, padded width, dtype) and stack as a taller image per chunk
    (block rows never cross an image seam — every padded height is a
    multiple of the row alignment).
    """
    metas = []  # (path, padded, h, w)
    for img in imgs:
        h, w = np.shape(img)
        path = _resolve_path(p, img, cfg)
        metas.append((path, _pad_np(path, img), h, w))
    keys = [(path, x.shape[1], str(x.dtype)) for path, x, _, _ in metas]
    sizes = [x.size for _, x, _, _ in metas]
    results: list = [None] * len(imgs)
    for (path, _, _), indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            stacked = (
                metas[chunk[0]][1]
                if len(chunk) == 1
                else np.concatenate([metas[i][1] for i in chunk], axis=0)
            )
            rows = [metas[i][1].shape[0] for i in chunk]
            for i in chunk:  # free the padded copies; `stacked` has them
                metas[i] = (*metas[i][:1], None, *metas[i][2:])
            if path == "u8":
                c = p.encode_u8(jnp.asarray(stacked), cfg)
            else:
                c = p.encode(jnp.asarray(stacked), cfg)
            del stacked
            c = np.asarray(c)  # one transfer for the whole chunk
            r0 = 0
            for i, nrows in zip(chunk, rows):
                _, _, h, w = metas[i]
                h8, w8 = padded_shape(h, w)
                results[i] = (c[r0 : r0 + h8, :w8].copy(), (h, w))
                r0 += nrows
    return results


def decode_gray_batch_auto(
    p: Pipeline, items, max_pixels: int = _STACK_MAX_PIXELS
):
    """Bulk gray decode: ONE device dispatch per same-width/same-config chunk.

    Takes a list of ``(coeffs, cfg, (h, w))``; returns a list of cropped
    uint8 NumPy planes in input order, each bit-identical to
    :func:`decode_gray_auto` on that stream alone.  Streams group by
    (resolved path, padded width, config) — the config is baked into the
    fused kernels, so it is part of the stacking key.
    """
    from tpudct.kernels import hp_pallas
    from tpudct.utils.serialize import _abs_bound

    metas = []  # (path, padded_np, h, w)
    for coeffs, cfg, (h, w) in items:
        c = np.asarray(coeffs)
        hc, wc = c.shape
        if (
            hasattr(p, "decode_u8")
            and hp_pallas.supports_u8(
                *padded_shape(hc, wc),
                cfg.q_scale, cfg.transform, cfg.q_table,
            )
            and _abs_bound(c) <= 127
        ):
            path, dt = "u8", np.int8
        elif hasattr(p, "decode_u8") and hp_pallas.supports(
            *padded_shape(hc, wc)
        ):
            path, dt = "f32", np.float32
        else:
            path, dt = "general", None
        x = c.astype(dt) if dt is not None else c
        ph, pw = padded_shape(hc, wc)
        if (ph, pw) != (hc, wc):
            x = np.pad(x, ((0, ph - hc), (0, pw - wc)))
        metas.append((path, x, cfg, h, w))
    keys = [
        (path, x.shape[1], str(x.dtype), cfg)
        for path, x, cfg, _, _ in metas
    ]
    sizes = [x.size for _, x, _, _, _ in metas]
    results: list = [None] * len(items)
    for (path, _, _, cfg), indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            stacked = (
                metas[chunk[0]][1]
                if len(chunk) == 1
                else np.concatenate([metas[i][1] for i in chunk], axis=0)
            )
            shapes = [metas[i][1].shape for i in chunk]
            for i in chunk:  # free the padded copies; `stacked` has them
                metas[i] = (*metas[i][:1], None, *metas[i][2:])
            if path == "u8":
                r = p.decode_u8(jnp.asarray(stacked), cfg)
            else:
                r = to_uint8(p.idct(jnp.asarray(stacked), cfg))
            del stacked
            r = np.asarray(r)
            r0 = 0
            for i, (ph, pw) in zip(chunk, shapes):
                _, _, _, h, w = metas[i]
                # Clamp to this frame's slab (matches the per-item path's
                # NumPy-crop behavior if a caller hands an oversized
                # orig_shape) so a bad frame can never read its neighbor.
                results[i] = r[r0 : r0 + min(h, ph), : min(w, pw)].copy()
                r0 += ph
    return results


def decode_gray_scaled_batch_auto(
    p: Pipeline, items, m: int, max_pixels: int = _STACK_MAX_PIXELS
):
    """Bulk M/8 fractional-scale decode: ONE device dispatch per
    same-width/same-config chunk (the stacked twin of
    :func:`decode_gray_scaled_auto`, what `unbatch --scale` uses).

    Takes ``[(coeffs, cfg, (h, w)), ...]``; returns cropped uint8 planes
    in input order, each bit-identical to the per-stream helper.  Integer
    8/M factors ride the fused scaled kernel on stacked maps (pooling
    windows are f-row local and frame slabs are 8f-row aligned, so seams
    are invisible); other numerators stack through the area-resample
    einsum; streams failing the u8 gate fall back per item.
    """
    from tpudct.kernels import hp_pallas
    from tpudct.ops.scaled import (
        scaled_decode_m8, scaled_decode_u8, scaled_shape_m8,
    )
    from tpudct.utils.serialize import _abs_bound

    if m == 8:
        return decode_gray_batch_auto(p, items, max_pixels)

    results: list = [None] * len(items)
    metas = []  # (idx, padded_np, cfg, h, w, kind) kind in {"u8", "m8"}
    fac = None if 8 % m else 8 // m
    for i, (coeffs, cfg, (h, w)) in enumerate(items):
        c = np.asarray(coeffs)
        hc, wc = c.shape
        if fac is None:
            # fractional numerator: blockwise einsum, stack-safe at the
            # 8-aligned seams every stream already has
            metas.append((i, c, cfg, h, w, "m8"))
            continue
        if (
            hasattr(p, "decode_u8")
            and hp_pallas.supports_u8(
                *padded_shape(hc, wc),
                cfg.q_scale, cfg.transform, cfg.q_table,
            )
            and _abs_bound(c) <= 127
        ):
            x = c.astype(np.int8)
            ph, pw = padded_shape(hc, wc)
            if (ph, pw) != (hc, wc):
                x = np.pad(x, ((0, ph - hc), (0, pw - wc)))
            metas.append((i, x, cfg, h, w, "u8"))
        else:
            results[i] = decode_gray_scaled_auto(p, c, cfg, (h, w), m)
    if not metas:
        return results

    keys = [(kind, x.shape[1], str(x.dtype), cfg)
            for _, x, cfg, _, _, kind in metas]
    sizes = [x.size for _, x, _, _, _, _ in metas]
    for (kind, _, _, cfg), indices in _stack_groups(keys).items():
        for chunk in _chunk(indices, sizes, max_pixels):
            stacked = (
                metas[chunk[0]][1]
                if len(chunk) == 1
                else np.concatenate([metas[j][1] for j in chunk], axis=0)
            )
            shapes = [metas[j][1].shape for j in chunk]
            for j in chunk:  # free the padded copies; `stacked` has them
                metas[j] = (metas[j][0], None, *metas[j][2:])
            if kind == "u8":
                # in-kernel u8 store (see decode_gray_scaled_auto)
                rec = scaled_decode_u8(
                    p, jnp.asarray(stacked), cfg, fac, out_u8=True
                )
                row_div = fac
            else:
                rec = to_uint8(scaled_decode_m8(jnp.asarray(stacked), cfg, m))
                row_div = None
            del stacked
            r = np.asarray(rec)
            r0 = 0
            for j, (xh, xw) in zip(chunk, shapes):
                i, _, _, h, w, _ = metas[j]
                slab = xh // fac if row_div else xh // 8 * m
                ws_max = xw // fac if row_div else xw // 8 * m
                hs, ws = scaled_shape_m8(h, m), scaled_shape_m8(w, m)
                # Clamp to the frame's scaled slab (see the full-decode
                # twin above) so a bad orig_shape can't cross a seam.
                results[i] = r[
                    r0 : r0 + min(hs, slab), : min(ws, ws_max)
                ].copy()
                r0 += slab
    return results
