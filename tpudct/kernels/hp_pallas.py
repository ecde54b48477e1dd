"""HpApprDCT fused Pallas kernels (Triton route) — the codec's device hot path.

The reference kernel (main_newAppr.cu:177-211) maps one 8x8 thread block to
one 8x8 image block, stages T and the pixels in shared memory, and runs the
codec as six launches (level shift, DCT, quantize; dequantize, IDCT,
unshift).  Here one program owns a tile of ``band_rows x tile_cols`` pixels
and walks it in 16-row strips; each strip runs the WHOLE chain in registers:
one HBM read of the input, one write per output.

Formulation
-----------

* Two 8x8 blocks stacked are the smallest operand Triton's ``dot``
  accepts (16).  The forward transform of a (16, C) strip is
  ``blockdiag(Ts, Ts) @ X`` (both 8-row blocks at once) followed by
  ``X @ blockdiag(Ts^T, ..., Ts^T)`` (C x C): block-diagonal operands
  never mix two blocks.  Tall narrow tiles (128 x 32 by default: 8 strips
  of 16 rows, a 32-wide row operand) measured fastest on the card; a
  16x16 row operand on strips reshaped to (C, 16) was slower, the
  reshapes costing more than the smaller dot saves.

* ``T = diag(d) @ Ts`` with Ts in {0, +-1, +-2} (constants.py), so the
  forward contraction is integer arithmetic: level-shifted pixels are in
  [-128, 127], |Ts X| <= 12 * 128 = 1536 and |Ts X Ts^T| <= 18432.  fp16
  holds every integer up to 2048, so both contractions run as fp16 operands
  with f32 accumulation and are EXACT; the row norms, 1/Q, q_scale and the
  zonal retention mask fold into one f32 scale applied before rounding.

* The inverse operands are not integers after dequantization (Y * d_i *
  d_l is irrational).  ``butterfly`` (default) folds the row norms into the
  dequant multiply (X = Ts^T (Y . dd^T) Ts) and splits each f32 operand
  exactly into three bf16 digits; the products against Ts are exact and
  accumulate in f32 — f32-class accuracy (<= 1e-3 gray levels vs f64,
  tests/test_kernels.py).  ``highest`` runs T itself as IEEE f32 dots (the
  reference's f32 GEMM inputs).  ``high`` is computed as ``butterfly``: the
  lossy bf16x3 tier existed only to feed a bf16 matrix unit.

* Shapes need only 8x8 alignment: the strips are masked at the image edge
  (a partial 16-row strip or tile holds whole 8x8 blocks on both sides of
  the mask, and masked lanes load zeros), so no caller pads to a kernel
  grid.

Quantization uses true division semantics with half-away-from-zero rounding
to match CUDA round(A/Q) (utils_kernels.cu:42); the int path multiplies by
the exact f32 scale d_i*d_l/(Q*q_scale), whose ties differ from the f64
ideal only at true .5 boundaries.

``roundtrip_u8_xla`` is the same u8 codec written as plain XLA (whole-image
einsums, no kernel): the reference the kernels are tested and timed against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from tpudct.constants import BLOCK_SIZE, LEVEL_SHIFT, get_q_table, get_transform
from tpudct.kernels import resolve_interpret

STRIP = 2 * BLOCK_SIZE  # rows (and chunk width) one dot covers: two 8x8 blocks
_HIGHEST = jax.lax.Precision.HIGHEST
#: (band_rows, tile_cols) when the config leaves them None: the fastest of
#: a sweep of tiles at 8192x8192 on an H100 (``chip_smoke.py --tiles``).
DEFAULT_TILE = (128, 32)
_NUM_WARPS = 4


@functools.lru_cache(maxsize=8)
def _max_coeff(transform: str = "haweel", q_table: str = "luma") -> float:
    """Max |quantized coefficient| at q_scale=1 (see module docstring);
    gates the int8-coefficient variants.  inf when the transform has no
    integer core (the u8 paths then never engage)."""
    tr = get_transform(transform)
    if not tr.has_integer_core:
        return float("inf")
    row_abs = np.abs(tr.ts.astype(np.float64)).sum(axis=1) * tr.d  # sum|T_i| per row
    return float((np.outer(row_abs, row_abs) * 128.0 / get_q_table(q_table)).max())  # haweel/luma: ~97.2


def supports(h: int, w: int) -> bool:
    """Any 8x8-aligned, non-empty plane: the kernels mask their edges."""
    return h % BLOCK_SIZE == 0 and w % BLOCK_SIZE == 0 and h > 0 and w > 0


def supports_u8(h: int, w: int, q_scale: float = 1.0, transform: str = "haweel", q_table: str = "luma") -> bool:
    """u8/int8 variants additionally need an integer-core transform and
    coefficients that fit int8."""
    return supports(h, w) and _max_coeff(transform, q_table) / q_scale <= 127.0


def supports_scaled_u8(
    h: int, w: int, fr: int, fc: int, q_scale: float = 1.0,
    transform: str = "haweel", q_table: str = "luma",
) -> bool:
    """Gate for the fused scaled decode: the u8 decode gate plus pooling
    factors that divide the 8x8 block (windows never straddle blocks)."""
    return (
        supports_u8(h, w, q_scale, transform, q_table)
        and fr in (1, 2, 4, 8)
        and fc in (1, 2, 4, 8)
    )


def _tile(h: int, w: int, band_rows, tile_cols):
    """Resolve the program tile: powers of two >= 16, shrunk to the plane."""
    br, bc = DEFAULT_TILE
    br = br if band_rows is None else band_rows
    bc = bc if tile_cols is None else tile_cols
    for name, v in (("band_rows", br), ("tile_cols", bc)):
        if v < STRIP or v & (v - 1):
            raise ValueError(f"{name} must be a power of two >= {STRIP}, got {v}")
    fit = lambda n: max(STRIP, pl.next_power_of_2(n))
    return min(br, fit(h)), min(bc, fit(w))


# ---------------------------------------------------------------------------
# Constant operands: block-diagonal transforms (16x16 down the columns,
# tile-wide along the rows) and per-position tables as (16, tile width)
# ---------------------------------------------------------------------------


def _bd(m8, n: int = STRIP) -> np.ndarray:
    """blockdiag(m8, ..., m8), n x n."""
    return np.kron(np.eye(n // BLOCK_SIZE), np.asarray(m8, np.float64))


def _tile2(m8, width: int) -> np.ndarray:
    """An (8, 8) per-position table repeated to (16, width)."""
    return np.tile(np.asarray(m8, np.float64), (STRIP // BLOCK_SIZE, width // BLOCK_SIZE))


@functools.lru_cache(maxsize=64)
def _fwd_consts(q_scale: float, retain_k, transform: str, q_table: str, int_core: bool,
                width: int):
    """(rows operand, cols operand, scale) for the forward chain.

    int core: fp16 blockdiag(Ts) and blockdiag(Ts)^T, and the fused f32
    multiplier d_i d_l / (Q q_scale) * mask.  f32 core: blockdiag(T),
    its transpose, and (Q q_scale, mask) for the division form."""
    from tpudct.ops.quant import retention_mask

    tr = get_transform(transform)
    q8 = get_q_table(q_table)
    mask = retention_mask(retain_k)
    if int_core:
        if not tr.has_integer_core:
            raise ValueError(f"int core requested but {transform!r} has none")
        d = tr.d.astype(np.float64)
        scale = np.outer(d, d) / (q8 * q_scale) * mask
        return (_bd(tr.ts).astype(np.float16), _bd(tr.ts.T, width).astype(np.float16),
                _tile2(scale, width).astype(np.float32))
    t = tr.t.astype(np.float32)
    qt = _tile2(q8 * np.float32(q_scale), width).astype(np.float32)
    return (_bd(t).astype(np.float32), _bd(t.T, width).astype(np.float32), qt,
            _tile2(mask, width).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _inv_consts(q_scale: float, transform: str, q_table: str, precision: str,
                width: int):
    """(rows operand, cols operand, dequant table) for the inverse chain.

    butterfly: bf16 blockdiag(Ts)^T / blockdiag(Ts) with the row norms
    folded into the dequant table Q q_scale d_i d_l.  highest: f32
    blockdiag(T)^T / blockdiag(T) with Q q_scale."""
    tr = get_transform(transform)
    q8 = get_q_table(q_table) * np.float64(q_scale)
    if precision == "highest":
        t = tr.t.astype(np.float32)
        return (_bd(t.T).astype(np.float32), _bd(t, width).astype(np.float32),
                _tile2(get_q_table(q_table) * np.float32(q_scale), width).astype(np.float32))
    if not tr.has_integer_core:
        raise ValueError(f"butterfly decode needs an integer core; {transform!r} has none")
    d = tr.d.astype(np.float64)
    return (_bd(tr.ts.T).astype(jnp.bfloat16), _bd(tr.ts, width).astype(jnp.bfloat16),
            _tile2(q8 * np.outer(d, d), width).astype(np.float32))


# ---------------------------------------------------------------------------
# Strip math (shared by every kernel; operates on one (16, C) strip)
# ---------------------------------------------------------------------------


def _dot(a, b):
    prec = _HIGHEST if a.dtype == jnp.float32 else None
    return jnp.dot(a, b, precision=prec, preferred_element_type=jnp.float32)


def _rows(m16, x):
    """m16 @ x: the transform down each column of both 8-row blocks."""
    return _dot(m16, x.astype(m16.dtype))


def _cols(x, m):
    """x @ m, m tile-wide block-diagonal: the transform along each row."""
    return _dot(x.astype(m.dtype), m)


def _split3(a):
    """Exact 3-way bf16 decomposition of f32: a == a1 + a2 + a3."""
    a1 = a.astype(jnp.bfloat16)
    r1 = a - a1.astype(jnp.float32)
    a2 = r1.astype(jnp.bfloat16)
    a3 = (r1 - a2.astype(jnp.float32)).astype(jnp.bfloat16)
    return a1, a2, a3


def _round_away(z):
    """round-half-away-from-zero (CUDA round(), utils_kernels.cu:42) as an
    int32: z +- 0.5 truncated by the convert."""
    return jnp.where(z < 0, z - 0.5, z + 0.5).astype(jnp.int32)


def _fwd(x, consts, int_core: bool):
    """Pixel strip (any numeric dtype) -> int32 quantized coefficients."""
    if int_core:
        bl, br_, scale = consts
        # (x - 128) as int8, like the reference's u8 domain (integral input)
        xs = (x.astype(jnp.int32) - 128).astype(jnp.int8).astype(jnp.float32)
        y = _cols(_rows(bl, xs), br_)  # exact integers
        return _round_away(y * scale)
    bl, br_, qt, mask = consts
    y = _cols(_rows(bl, x.astype(jnp.float32) - LEVEL_SHIFT), br_)
    return _round_away(y / qt) * mask.astype(jnp.int32)


def _inv(coef, consts):
    """Quantized coefficient strip -> f32 reconstruction (unclamped)."""
    bl, br_, qt = consts
    m = coef.astype(jnp.float32) * qt
    if bl.dtype == jnp.float32:
        return _cols(_rows(bl, m), br_) + LEVEL_SHIFT
    u = sum(_rows(bl, p) for p in _split3(m))
    return sum(_cols(p, br_) for p in _split3(u)) + LEVEL_SHIFT


def _to_u8(x):
    """clamp + C-truncation cast (convertToUnsignedChar, utils.cu:18-24)."""
    return jnp.clip(x, 0.0, 255.0).astype(jnp.int32).astype(jnp.uint8)


def _pool(x, fr: int, fc: int):
    """Box average of the clamped, truncated decode over (fr, fc) windows:
    exact integer sums in f32 (<= 255 * 64 < 2^24), power-of-two divisor."""
    s, c = x.shape
    xi = jnp.clip(x, 0.0, 255.0).astype(jnp.int32).astype(jnp.float32)
    p = xi.reshape(s // fr, fr, c // fc, fc).sum(axis=3).sum(axis=1)
    return p * jnp.float32(1.0 / (fr * fc))


# ---------------------------------------------------------------------------
# The one kernel body and its pallas_call
# ---------------------------------------------------------------------------


def _kernel(in_ref, *refs, n_fwd, n_inv, outs, br, bc, h, w, fr, fc, int_core):
    """One program: a (br, bc) tile, walked in 16-row strips.

    ``outs`` names the outputs in order: "coef" (quantized coefficients),
    "recon" (reconstruction) or "pool" (box-pooled reconstruction)."""
    fwd_c = [r[...] for r in refs[:n_fwd]]
    inv_c = [r[...] for r in refs[n_fwd : n_fwd + n_inv]]
    out_refs = dict(zip(outs, refs[n_fwd + n_inv :]))
    i, j = pl.program_id(0), pl.program_id(1)
    c0 = j * bc
    col_ok = (c0 + jnp.arange(bc))[None, :] < w
    for s in range(br // STRIP):
        r0 = i * br + s * STRIP
        mask = ((r0 + jnp.arange(STRIP))[:, None] < h) & col_ok
        win = lambda ref: ref.at[pl.ds(r0, STRIP), pl.ds(c0, bc)]
        x = pltriton.load(win(in_ref), mask=mask, other=jnp.zeros((), in_ref.dtype))
        if n_fwd:
            coef = _fwd(x, fwd_c, int_core)
            if "coef" in out_refs:
                ref = out_refs["coef"]
                pltriton.store(win(ref), coef.astype(ref.dtype), mask=mask)
        else:
            coef = x
        if not n_inv:
            continue
        rec = _inv(coef, inv_c)
        if "recon" in out_refs:
            ref = out_refs["recon"]
            val = _to_u8(rec) if ref.dtype == jnp.uint8 else rec
            pltriton.store(win(ref), val, mask=mask)
        if "pool" in out_refs:
            ref = out_refs["pool"]
            p = _pool(rec, fr, fc)
            pr0 = i * (br // fr) + s * (STRIP // fr)
            pc0 = j * (bc // fc)
            pmask = (((pr0 + jnp.arange(STRIP // fr))[:, None] < h // fr)
                     & ((pc0 + jnp.arange(bc // fc))[None, :] < w // fc))
            val = p.astype(jnp.int32).astype(jnp.uint8) if ref.dtype == jnp.uint8 else p
            pltriton.store(
                ref.at[pl.ds(pr0, STRIP // fr), pl.ds(pc0, bc // fc)], val, mask=pmask
            )


def _run(name, x, fwd, inv, out_dtypes, *, int_core=True,
         band_rows=None, tile_cols=None, interpret=None, fr=1, fc=1):
    """fwd/inv: callables width -> constant operands (or None)."""
    h, w = x.shape
    if not supports(h, w):
        raise ValueError(f"kernel needs an 8x8-aligned plane, got {h}x{w}")
    br, bc = _tile(h, w, band_rows, tile_cols)
    fwd_consts = fwd(bc) if fwd else ()
    inv_consts = inv(bc) if inv else ()
    outs = tuple(out_dtypes)
    shapes = {"coef": (h, w), "recon": (h, w), "pool": (h // fr, w // fc)}
    consts = [jnp.asarray(c) for c in (*fwd_consts, *inv_consts)]
    kernel = functools.partial(
        _kernel, n_fwd=len(fwd_consts), n_inv=len(inv_consts), outs=outs,
        br=br, bc=bc, h=h, w=w, fr=fr, fc=fc, int_core=int_core,
    )
    out_shape = tuple(jax.ShapeDtypeStruct(shapes[k], dt) for k, dt in out_dtypes.items())
    res = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(h, br), pl.cdiv(w, bc)),
        out_shape=out_shape,
        backend="triton",
        name=name,
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=resolve_interpret(interpret),
    )(x, *consts)
    return res[0] if len(res) == 1 else res


def _prec(name: str):
    if name not in ("highest", "high", "butterfly"):
        raise ValueError(
            "decode_precision must be 'highest', 'high' or 'butterfly', "
            f"got {name!r}"
        )
    return "butterfly" if name == "high" else name


def _jit(*names):
    return functools.partial(jax.jit, static_argnames=names)


_TILE = ("band_rows", "tile_cols", "interpret")


@_jit("q_scale", "q_table", "int_core", "transform", *_TILE)
def hp_dct(image, q_scale: float = 1.0, q_table: str = "luma", band_rows=None,
           tile_cols=None, interpret=None, int_core: bool = True,
           transform: str = "haweel"):
    """(H, W) f32 image -> (H, W) f32 quantized coefficients, one kernel.

    int_core=True runs the exact integer Haweel contraction (requires
    integral pixel values, i.e. u8-sourced images — the codec's domain);
    False runs T itself in IEEE f32 (the reference's GEMM inputs)."""
    fc = functools.partial(_fwd_consts, q_scale, None, transform, q_table, int_core)
    return _run("hp_dct", image, fc, None, {"coef": jnp.float32}, int_core=int_core,
                band_rows=band_rows, tile_cols=tile_cols, interpret=interpret)


@_jit("q_scale", "q_table", "decode_precision", "transform", *_TILE)
def hp_idct(coeffs, q_scale: float = 1.0, q_table: str = "luma", band_rows=None,
            tile_cols=None, interpret=None, decode_precision: str = "butterfly",
            transform: str = "haweel"):
    """(H, W) f32 quantized coefficients -> (H, W) f32 reconstruction."""
    ic = functools.partial(_inv_consts, q_scale, transform, q_table, _prec(decode_precision))
    return _run("hp_idct", coeffs, None, ic, {"recon": jnp.float32},
                band_rows=band_rows, tile_cols=tile_cols, interpret=interpret)


@_jit("q_scale", "q_table", "retain_k", "int_core", "decode_precision", "transform", *_TILE)
def hp_roundtrip(image, q_scale: float = 1.0, q_table: str = "luma", retain_k=None,
                 band_rows=None, tile_cols=None, interpret=None, int_core: bool = True,
                 decode_precision: str = "butterfly", transform: str = "haweel"):
    """Fully fused codec pass: f32 image -> (f32 coefficients, f32 recon).
    One read of the image, one write per output; zonal retention rides
    the quantization scale (int core) or a mask multiply (f32 core)."""
    fc = functools.partial(_fwd_consts, q_scale, retain_k, transform, q_table, int_core)
    ic = functools.partial(_inv_consts, q_scale, transform, q_table, _prec(decode_precision))
    return _run("hp_roundtrip", image, fc, ic,
                {"coef": jnp.float32, "recon": jnp.float32}, int_core=int_core,
                band_rows=band_rows, tile_cols=tile_cols, interpret=interpret)


@_jit("q_scale", "q_table", "retain_k", "transform", *_TILE)
def hp_encode_u8(image_u8, q_scale: float = 1.0, q_table: str = "luma", retain_k=None,
                 band_rows=None, tile_cols=None, interpret=None,
                 transform: str = "haweel"):
    """(H, W) uint8 image -> (H, W) int8 quantized coefficients; valid
    whenever supports_u8 holds (coefficients provably fit int8)."""
    fc = functools.partial(_fwd_consts, q_scale, retain_k, transform, q_table, True)
    return _run("hp_encode_u8", image_u8, fc, None, {"coef": jnp.int8},
                band_rows=band_rows, tile_cols=tile_cols, interpret=interpret)


@_jit("q_scale", "q_table", "decode_precision", "transform", *_TILE)
def hp_decode_u8(coeffs_i8, q_scale: float = 1.0, q_table: str = "luma", band_rows=None,
                 tile_cols=None, interpret=None, decode_precision: str = "butterfly",
                 transform: str = "haweel"):
    """(H, W) int8 coefficients -> (H, W) uint8 reconstruction (fused
    dequant + inverse + unshift + clamp + cast)."""
    ic = functools.partial(_inv_consts, q_scale, transform, q_table, _prec(decode_precision))
    return _run("hp_decode_u8", coeffs_i8, None, ic, {"recon": jnp.uint8},
                band_rows=band_rows, tile_cols=tile_cols, interpret=interpret)


@_jit("q_scale", "q_table", "retain_k", "decode_precision", "transform", *_TILE)
def hp_roundtrip_u8(image_u8, q_scale: float = 1.0, q_table: str = "luma", retain_k=None,
                    band_rows=None, tile_cols=None, interpret=None,
                    decode_precision: str = "butterfly", transform: str = "haweel"):
    """Fully fused u8-native codec pass: uint8 image -> (int8 coefficients,
    uint8 reconstruction); 3 bytes of HBM traffic per pixel."""
    fc = functools.partial(_fwd_consts, q_scale, retain_k, transform, q_table, True)
    ic = functools.partial(_inv_consts, q_scale, transform, q_table, _prec(decode_precision))
    return _run("hp_roundtrip_u8", image_u8, fc, ic,
                {"coef": jnp.int8, "recon": jnp.uint8},
                band_rows=band_rows, tile_cols=tile_cols, interpret=interpret)


@_jit("fr", "fc", "q_scale", "q_table", "transform", "out_u8", *_TILE)
def hp_scaled_decode_u8(coeffs_i8, fr: int, fc: int, q_scale: float = 1.0,
                        q_table: str = "luma", band_rows=None, tile_cols=None,
                        interpret=None, transform: str = "haweel", out_u8: bool = False):
    """(H, W) int8 coefficients -> (H/fr, W/fc) scaled raster in ONE
    kernel: the butterfly decode with a box-pooling epilogue, so the
    full-size raster is never stored.  Bitwise identical to
    box_pool_u8(hp_decode_u8(c)) — the composed path (tests/test_scaled.py).

    out_u8=False returns the float32 box averages (the color path's
    contract — the fractional averages feed the YCbCr merge unrounded);
    out_u8=True truncates in the epilogue and stores uint8 — bit-identical
    to to_uint8 of the f32 output (the sums are exact integers and the
    divisor a power of two)."""
    h, w = coeffs_i8.shape
    if not supports_scaled_u8(h, w, fr, fc, q_scale, transform, q_table):
        raise ValueError(
            f"fused scaled decode needs the u8 gate and factors in (1, 2, 4, 8); "
            f"got {h}x{w} at ({fr}, {fc})"
        )
    ic = functools.partial(_inv_consts, q_scale, transform, q_table, "butterfly")
    return _run("hp_scaled_decode_u8", coeffs_i8, None, ic,
                {"pool": jnp.uint8 if out_u8 else jnp.float32},
                band_rows=band_rows, tile_cols=tile_cols, interpret=interpret,
                fr=fr, fc=fc)


# ---------------------------------------------------------------------------
# Plain-XLA reference of the u8 codec (no kernel)
# ---------------------------------------------------------------------------


def _blocks(x):
    h, w = x.shape
    return x.reshape(h // BLOCK_SIZE, BLOCK_SIZE, w // BLOCK_SIZE, BLOCK_SIZE)


def _unblocks(g):
    a, _, b, _ = g.shape
    return g.reshape(a * BLOCK_SIZE, b * BLOCK_SIZE)


@_jit("q_scale", "q_table", "retain_k", "transform")
def encode_u8_xla(image_u8, q_scale: float = 1.0, q_table: str = "luma",
                  retain_k=None, transform: str = "haweel"):
    """hp_encode_u8 as whole-image XLA: the integer-core einsum in f32
    (exact: every product and partial sum is an integer below 2^24)."""
    from tpudct.ops.quant import retention_mask

    tr = get_transform(transform)
    d = tr.d.astype(np.float64)
    scale = (np.outer(d, d) / (get_q_table(q_table) * q_scale)
             * retention_mask(retain_k)).astype(np.float32)
    ts = jnp.asarray(tr.ts, jnp.float32)
    x = _blocks(image_u8.astype(jnp.float32) - LEVEL_SHIFT)
    y = jnp.einsum("ij,ajbk,lk->aibl", ts, x, ts, precision=_HIGHEST)
    z = y * jnp.asarray(scale)[None, :, None, :]
    return _unblocks(_round_away(z).astype(jnp.int8))


@_jit("q_scale", "q_table", "transform")
def decode_u8_xla(coeffs_i8, q_scale: float = 1.0, q_table: str = "luma",
                  transform: str = "haweel"):
    """hp_decode_u8 (butterfly) as whole-image XLA: Ts^T (C . Q dd^T) Ts in
    f32 with exact products."""
    tr = get_transform(transform)
    d = tr.d.astype(np.float64)
    qdd = (get_q_table(q_table) * np.float64(q_scale) * np.outer(d, d)).astype(np.float32)
    ts = jnp.asarray(tr.ts, jnp.float32)
    m = _blocks(coeffs_i8.astype(jnp.float32)) * jnp.asarray(qdd)[None, :, None, :]
    x = jnp.einsum("ji,ajbk,kl->aibl", ts, m, ts, precision=_HIGHEST)
    return _to_u8(_unblocks(x) + LEVEL_SHIFT)


def roundtrip_u8_xla(image_u8, q_scale: float = 1.0, q_table: str = "luma",
                     retain_k=None, transform: str = "haweel"):
    """hp_roundtrip_u8 as plain XLA: (int8 coefficients, uint8 recon)."""
    c = encode_u8_xla(image_u8, q_scale, q_table, retain_k, transform)
    return c, decode_u8_xla(c, q_scale, q_table, transform)
