"""Host-staged streaming codec for images larger than device memory.

The reference is bounded by one GPU's memory (16 GB T4; it simply
allocates whole-image buffers, main_newAppr.cu:94-95).  The kernels here
are row-band independent (8x8 blocks; zero halo — the same property the
multi-card sharding exploits), so an image of ANY height streams through
the device band by band: host slice -> device -> fused u8 kernel -> host
assembly.  Peak device memory is one band's working set regardless of
image size; outputs may be preallocated (e.g. numpy memmaps) so the HOST
footprint can stay bounded too.  Streaming throughput is bounded by
host<->device transfer — the price of exceeding device memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tpudct.config import CodecConfig


def roundtrip_u8_streamed(
    pipeline,
    image_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    out_coeffs: Optional[np.ndarray] = None,
    out_recon: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W) uint8 image -> (int8 coefficients, uint8 reconstruction),
    processed in row bands of `band_rows` through the fused u8 kernels.

    Bitwise identical to the whole-image `roundtrip_u8` (bands align to
    32-row multiples, and blockwise math never crosses band edges).
    `out_coeffs`/`out_recon` accept preallocated arrays (memmap-friendly).
    Requires an 8x8-aligned image and an int8-safe config — same gate as
    the in-memory kernel."""
    import jax.numpy as jnp

    from tpudct.kernels import hp_pallas

    cfg = cfg or CodecConfig()
    img = np.asarray(image_u8)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a (H, W) uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    if not hp_pallas.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
        raise ValueError(
            f"u8 streaming needs H % 8 == 0, W % 8 == 0 and an int8-safe "
            f"config; got {h}x{w}, q_scale={cfg.q_scale}, "
            f"transform={cfg.transform}"
        )
    band_rows = max(32, band_rows - band_rows % 32)
    if not hasattr(pipeline, "roundtrip_u8"):
        raise ValueError(
            f"streaming needs a u8-native pipeline (hp), got {pipeline.name!r}"
        )
    if out_coeffs is None:
        out_coeffs = np.empty((h, w), np.int8)
    if out_recon is None:
        out_recon = np.empty((h, w), np.uint8)
    if out_coeffs.shape != (h, w) or out_recon.shape != (h, w):
        raise ValueError("preallocated outputs must match the image shape")
    if out_coeffs.dtype != np.int8 or out_recon.dtype != np.uint8:
        # a u8 coefficient buffer would silently WRAP negative int8
        # coefficients on assignment (-5 -> 251) — refuse, don't corrupt
        raise ValueError(
            f"preallocated outputs must be int8 coefficients / uint8 recon, "
            f"got {out_coeffs.dtype} / {out_recon.dtype}"
        )

    for a in range(0, h, band_rows):
        b = min(a + band_rows, h)
        # tail bands below 32 rows merge into the previous slice by
        # construction (h and band_rows are 32-multiples)
        c, r = pipeline.roundtrip_u8(jnp.asarray(img[a:b]), cfg)
        out_coeffs[a:b] = np.asarray(c)
        out_recon[a:b] = np.asarray(r)
    return out_coeffs, out_recon


def roundtrip_color_u8_streamed(
    pipeline,
    rgb_planar_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 4096,
) -> Tuple[dict, dict, np.ndarray]:
    """(3, H, W) planar uint8 RGB -> (coefficient planes, meta, (H, W, 3)
    uint8 reconstruction), streamed in row bands through the fused u8
    color path (models/color.py).

    Bands align to 64 rows so YCbCr conversion (pixel-local), 4:2:0
    pooling (2x2-local) and blockwise coding never cross band edges —
    results are identical to the whole-image pass.  Device memory is
    bounded by one band's planes."""
    import jax.numpy as jnp

    from tpudct.models.color import roundtrip_color_u8, supports_color_u8

    cfg = cfg or CodecConfig()
    rgb = np.asarray(rgb_planar_u8)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[0] != 3:
        raise ValueError(
            f"expected a (3, H, W) uint8 planar image, got {rgb.dtype} {rgb.shape}"
        )
    _c, h, w = rgb.shape
    band_rows = max(64, band_rows - band_rows % 64)
    if h == 0 or h % 64 or not supports_color_u8(pipeline, cfg, h, w):
        raise ValueError(
            f"u8 color streaming needs H % 64 == 0, W % 16 == 0 and an "
            f"int8-safe config; got {h}x{w}"
        )
    ys, cbs, crs, recs = [], [], [], []
    for a in range(0, h, band_rows):
        b = min(a + band_rows, h)
        planes, _meta, rec = roundtrip_color_u8(
            pipeline, jnp.asarray(rgb[:, a:b]), cfg
        )
        ys.append(np.asarray(planes["y"]))
        cbs.append(np.asarray(planes["cb"]))
        crs.append(np.asarray(planes["cr"]))
        recs.append(np.asarray(rec))
    out_planes = {
        "y": np.concatenate(ys, axis=0),
        "cb": np.concatenate(cbs, axis=0),
        "cr": np.concatenate(crs, axis=0),
    }
    meta = {"orig_shape": (h, w), "chroma_shape": (h // 2, w // 2), "subsample": "420"}
    return out_planes, meta, np.concatenate(recs, axis=0)


def roundtrip_u8_streamed_sharded(
    pipeline,
    image_u8: np.ndarray,
    mesh,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    out_coeffs: Optional[np.ndarray] = None,
    out_recon: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming COMPOSED with multi-chip sharding (VERDICT r2 #8): each
    host row-band is itself band-sharded over `mesh`, so the per-DEVICE
    working set is band_rows/n — together the two axes decode images
    bounded by neither one chip's HBM nor the host band size.

    Every host band reuses ONE compiled sharded step (band heights are
    uniform by construction below).  Bitwise identical to the in-memory
    `pipeline.roundtrip_u8` of the whole image: bands align to 32-row
    multiples and the blockwise math never crosses band edges — the same
    zero-halo property both streaming and the mesh sharding exploit.
    """
    import jax.numpy as jnp

    from tpudct.kernels import hp_pallas
    from tpudct.parallel.mesh import BAND_AXIS
    from tpudct.parallel.sharding import gather, shard_image

    cfg = cfg or CodecConfig()
    img = np.asarray(image_u8)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a (H, W) uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    n = mesh.shape[BAND_AXIS]
    unit = 32 * n  # each device band must stay a 32-row multiple
    if h % unit or not hp_pallas.supports_u8(h, w, cfg.q_scale, cfg.transform, cfg.q_table):
        raise ValueError(
            f"sharded u8 streaming needs H % {unit} == 0 (32-row multiple "
            f"per device band), W % 8 == 0 and an int8-safe config; got "
            f"{h}x{w} on a {n}-device mesh"
        )
    band_rows = max(unit, band_rows - band_rows % unit)
    if not hasattr(pipeline, "roundtrip_u8"):
        raise ValueError(
            f"streaming needs a u8-native pipeline (hp), got {pipeline.name!r}"
        )
    if out_coeffs is None:
        out_coeffs = np.empty((h, w), np.int8)
    if out_recon is None:
        out_recon = np.empty((h, w), np.uint8)
    if out_coeffs.dtype != np.int8 or out_recon.dtype != np.uint8:
        raise ValueError(
            f"preallocated outputs must be int8 coefficients / uint8 recon, "
            f"got {out_coeffs.dtype} / {out_recon.dtype}"
        )
    if out_coeffs.shape != (h, w) or out_recon.shape != (h, w):
        raise ValueError("preallocated outputs must match the image shape")

    import jax

    from tpudct.parallel.mesh import band_spec

    def band_fn(x):
        return pipeline.roundtrip_u8(x, cfg)

    step = jax.jit(jax.shard_map(
        band_fn, mesh=mesh, in_specs=band_spec(),
        out_specs=(band_spec(), band_spec()), check_vma=False,
    ))
    # plain band_rows slicing (like roundtrip_u8_streamed): h and band_rows
    # are both `unit` multiples, so the tail band is automatically valid
    # and NO band ever exceeds band_rows (the memory bound this function
    # exists to provide); at most two distinct shapes -> two compiles
    for a in range(0, h, band_rows):
        b = min(a + band_rows, h)
        c, r = step(shard_image(jnp.asarray(img[a:b]), mesh))
        out_coeffs[a:b] = gather(c)
        out_recon[a:b] = gather(r)
    return out_coeffs, out_recon


# ---- streamed serialization: banded container <-> band-by-band device work ---
#
# The banded .tdc codec (independent row-band segments) is the natural
# on-disk shape for a streamed encode (VERDICT r3 #5): each host band
# leaving the chip entropy-codes immediately into its own segment, so the
# full coefficient map NEVER materializes on the host either — total
# residency is the input pixels plus the compressed segments.  Decode
# mirrors it: each segment entropy-decodes, rides the device in bounded
# bands, and lands in the output raster.  The reference is hard-bounded by
# whole-image device buffers (main_newAppr.cu:94-95).

#: Images up to 2^32 pixels (65536², a ~12 GB u8 working set) take the
#: in-memory device path; anything LARGER auto-streams in the CLI.
#: `--band-rows` overrides explicitly.
STREAM_PIXELS = 1 << 32


def encode_gray_streamed_bytes(
    pipeline,
    image_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    inner: str = "auto",
    level: int = 6,
) -> Tuple[bytes, Tuple[int, int]]:
    """(H, W) uint8 image of ANY size -> (.tdc stream bytes, (h, w)).

    Bands of `band_rows` rows ride the fused u8 encode kernel one at a
    time (device memory bounded by one band) and each band's int8 slab
    entropy-codes into ONE banded segment on a host thread that overlaps
    the next band's device work — the coefficient map never exists whole
    anywhere.  Decoded output is bit-identical to the in-memory
    `encode_gray_auto` + banded save of the same image (segments differ
    only in their row split; every loader reads both).

    Edge-pads to the 8x8 block grid exactly like models/dispatch.py
    (block-local transform: pixels in the original region unaffected).  Requires a
    u8-eligible config (integer-core transform, int8-safe q_scale)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from tpudct.kernels import hp_pallas
    from tpudct.ops.padding import padded_shape
    from tpudct.utils.serialize import (
        _CODEC_BANDED,
        _encode_payload,
        _wrap_v4,
        assemble_banded_segments,
    )

    if inner.startswith("banded"):
        # each host band already becomes ONE banded segment; a banded
        # inner would nest containers, which every decoder rejects —
        # refusing at write time prevents a successfully-saved but
        # permanently undecodable archive
        raise ValueError(
            "streamed encode writes banded segments itself; pass a "
            "non-banded inner stage (auto/rans/huffman/xz/spectral/raw)"
        )
    cfg = cfg or CodecConfig()
    img = np.asarray(image_u8)
    if img.ndim != 2:
        raise ValueError(f"expected a (H, W) image, got shape {img.shape}")
    if img.dtype != np.uint8:
        raise ValueError(
            f"streamed encode takes uint8 pixels, got {img.dtype} "
            "(float inputs use the in-memory path)"
        )
    h, w = img.shape
    h8, w8 = padded_shape(h, w)
    if cfg.deadzone != 0.5 or not hp_pallas.supports_u8(
        h8, w8, cfg.q_scale, cfg.transform, cfg.q_table
    ):
        raise ValueError(
            f"streamed encode needs an int8-safe config (integer-core "
            f"transform, q_scale >= ~0.77, default deadzone); got "
            f"transform={cfg.transform}, q_scale={cfg.q_scale}, "
            f"deadzone={cfg.deadzone}"
        )
    band_rows = max(32, band_rows - band_rows % 32)
    n_bands = -(-h8 // band_rows)
    if n_bands > 255:
        raise ValueError(
            f"{n_bands} bands exceed the banded container's 255-segment "
            f"limit; raise --band-rows to at least {-(-h8 // 255 // 32) * 32}"
        )
    if w8 > w:
        img = np.pad(img, ((0, 0), (0, w8 - w)), mode="edge")

    splits = []  # container rows per segment (8-aligned, sum = h8)
    futs = []
    with ThreadPoolExecutor(max_workers=2) as ex:
        for a in range(0, h8, band_rows):
            keep = min(band_rows, h8 - a)
            # rows of the final band beyond h are edge pad to the 8x8 grid
            band = img[a : a + keep]
            if band.shape[0] < keep:
                band = np.pad(
                    band, ((0, keep - band.shape[0]), (0, 0)), mode="edge"
                )
            c = np.asarray(pipeline.encode_u8(jnp.asarray(band), cfg))
            # int16 like the in-memory path's _validate_map: the raw
            # inner's decoder parses int16 elements, so an int8 slab
            # would write a permanently undecodable payload (review
            # finding, round 4); also drops the view's reference to the
            # full padded band
            slab = np.ascontiguousarray(c[:keep, :w8], np.int16)
            # entropy-code on a worker thread while the next band is on
            # the device (zlib/lzma/C coders release the GIL); sampled
            # auto keeps the per-band stage choice O(sample), matching
            # serialize._encode_banded
            if len(futs) >= 2:
                # backpressure: entropy is ~1000x slower than the device
                # band on a 1-core host, so unbounded submits would queue
                # every slab and approach full-map residency — the exact
                # thing this function promises not to do
                futs[-2].result()
            futs.append(ex.submit(
                _encode_payload, slab, inner, level, True, True
            ))
            splits.append(keep)
        encoded = [f.result() for f in futs]
    data = _wrap_v4(
        h8, w8, _CODEC_BANDED,
        assemble_banded_segments(list(zip(splits, encoded))),
        cfg.q_scale, cfg.retain_k, (h, w), cfg.transform, cfg.q_table,
    )
    return data, (h, w)


class _PlaneRows:
    """Incremental reader of one v4 plane stream's coefficient rows.

    The ONE streaming-side parser for a plane blob, shared by the gray
    and color streamed decoders and all their partial modes (VERDICT r4
    #1-2).  For BANDED payloads (the archival layout) host residency is
    bounded by one decoded segment plus the pull buffer: segments
    entropy-decode lazily through `serialize.iter_banded_segments`,
    which also honors `n_planes` (spectral-prefix or decode+mask
    truncation) and `row_range` (segments outside the container-row
    range are never entropy-decoded).  Non-banded codecs decode the
    whole map on first pull — those formats are not segmentable, and the
    constraint streaming lifts is device memory (documented in
    `decode_gray_streamed`)."""

    def __init__(self, blob, n_planes=None, row_range=None):
        from tpudct.utils import serialize as ser

        ser._tune_malloc_for_slabs()  # slab allocations recycle warm pages
        (h, w, oh, ow, q_scale, retain_k, transform, q_table, code, psize,
         hsize, custom_q, _version) = ser._parse_plane_header(blob)
        self.h, self.w = h, w
        self.oh, self.ow = (oh or h), (ow or w)
        if self.oh > h or self.ow > w:
            # same check as serialize._parse_plane: without it a corrupt
            # header makes a preallocated np.empty output ship rows of
            # uninitialized heap memory to the caller
            raise ValueError(
                f"corrupt .tdc header: orig_shape ({self.oh}, {self.ow}) "
                f"exceeds the coefficient map ({h}, {w})"
            )
        if custom_q is not None:
            # Registration is content-named (q:<hash>), so registering
            # before the payload decodes cannot poison the registry with
            # wrong values — at worst a correct table is registered for a
            # stream that then fails to parse (streamed decode needs the
            # table up front; the whole-map parser can afford to defer).
            from tpudct.constants import register_q_table

            q_table = register_q_table(custom_q)
        self.q_scale = float(q_scale)
        self.retain_k = None if retain_k < 0 else retain_k
        self.transform, self.q_table = transform, q_table
        self.code = code
        self._ser = ser
        if row_range is not None:
            c0, c1 = row_range
            if c0 % 8 or c1 % 8 or not 0 <= c0 < c1 <= h:
                raise ValueError(
                    f"row_range {row_range} must be 8-aligned within (0, {h})"
                )
        self.row_range = row_range
        self._cursor = row_range[0] if row_range else 0
        self._end = row_range[1] if row_range else h
        self._buf: list = []
        self._buf_rows = 0
        if code == ser._CODEC_BANDED:
            self._gen = ser.iter_banded_segments(
                blob[hsize : hsize + psize], h, w,
                n_planes=n_planes, row_range=row_range,
            )
        else:
            # non-banded: entropy-decode the whole map once
            if (n_planes is not None
                    and code in (ser._CODEC_SPECTRAL, ser._CODEC_XZ)):
                # spectral-ordered: only the needed prefix decompresses
                # (the whole-map unwrap below would defeat exactly that)
                cmap = ser._partial_spectral_map(
                    blob[hsize : hsize + psize], code, h, w, n_planes
                )
            else:
                raw = blob[hsize : hsize + psize]
                if code not in (ser._CODEC_HUFF, ser._CODEC_RANS, ser._CODEC_XZ):
                    import zlib

                    try:
                        raw = zlib.decompress(raw)
                    except zlib.error as e:
                        raise ValueError(f"corrupt .tdc payload: {e}") from None
                cmap = ser._decode_payload(raw, code, h, w)
                if n_planes is not None:
                    cmap = ser._zero_high_planes(
                        np.ascontiguousarray(cmap), n_planes
                    )
            self._gen = iter(
                [(self._cursor, self._end - self._cursor,
                  cmap[self._cursor : self._end])]
            )

    def drain(self) -> None:
        """Exhaust the underlying segment walk so its end-of-payload
        validation (trailing bytes, row coverage) runs even when the
        band loop's pulls exactly consumed the declared rows — without
        this, a corrupt banded payload whose valid prefix covers the
        requested rows would decode silently (review finding, round
        5)."""
        while self._gen is not None:
            try:
                next(self._gen)
            except StopIteration:
                self._gen = None

    def pull(self, nrows: int) -> np.ndarray:
        """Next min(nrows, remaining) container coefficient rows as one
        (r, w) int16 array; empty (0, w) at exhaustion.  `nrows` must be
        8-aligned so pulls always land on segment-compatible rows."""
        while self._buf_rows < nrows and self._gen is not None:
            try:
                r0, rows, cmap = next(self._gen)
            except StopIteration:
                self._gen = None
                break
            if self.row_range is not None:
                # segments overlapping the range edge: keep the in-range part
                s0 = max(r0, self.row_range[0])
                s1 = min(r0 + rows, self.row_range[1])
                cmap = cmap[s0 - r0 : s1 - r0]
            self._buf.append(cmap)
            self._buf_rows += cmap.shape[0]
        take = min(nrows, self._buf_rows)
        if take == 0:
            return np.empty((0, self.w), np.int16)
        parts, got = [], 0
        while got < take:
            head = self._buf[0]
            need = take - got
            if head.shape[0] <= need:
                parts.append(head)
                got += head.shape[0]
                self._buf.pop(0)
            else:
                parts.append(head[:need])
                self._buf[0] = head[need:]
                got += need
        self._buf_rows -= take
        self._cursor += take
        return parts[0] if len(parts) == 1 else np.vstack(parts)


def decode_gray_streamed(
    pipeline,
    data: bytes,
    band_rows: int = 8192,
    out: Optional[np.ndarray] = None,
    *,
    n_planes: Optional[int] = None,
    scale_m: Optional[int] = None,
    row_range: Optional[Tuple[int, int]] = None,
    out_npy: Optional[str] = None,
) -> np.ndarray:
    """.tdc stream bytes -> uint8 raster, device memory bounded by
    ~band_rows rows at a time, host memory by one segment + one band.

    Banded streams (the archival layout) decode segment by segment
    through :class:`_PlaneRows` — neither the decoded coefficient map
    nor the device working set ever exceeds one chunk.  Non-banded
    codecs entropy-decode the whole map on the host first (they are not
    segmentable), then the device still runs in bounded bands.
    Bit-identical to the in-memory decode (blocks are row-band local).
    `out` accepts a preallocated uint8 array (memmap-friendly).

    Partial modes (VERDICT r4 #1 — all compose with banded/beyond-HBM
    streams and keep the same memory bounds):

    - ``n_planes=N``: progressive — only the first N zig-zag spectral
      positions decode (spectral-prefix per segment for spectral/xz
      inners; decode+mask otherwise).  Output shape unchanged.
    - ``scale_m=M``: M/8 fractional-scale decode via the shared scaled
      dispatch (`models.dispatch.decode_gray_scaled_auto` per band —
      the fused scaled kernel when eligible).  Output is
      (ceil(oh*M/8), ceil(ow*M/8)); exact because scaled decode is
      8-row-block local, so band seams are invisible.
    - ``row_range=(a, b)``: ROI — only segments overlapping original
      pixel rows [a, b) entropy-decode at all; output is (b-a, ow).
      Does not combine with scale_m (the CLI forbids it too).
    """
    from tpudct.config import CodecConfig
    from tpudct.models.dispatch import decode_gray_auto, decode_gray_scaled_auto

    if scale_m is not None and row_range is not None:
        raise ValueError("scale_m does not combine with row_range")
    m = None if scale_m in (None, 8) else int(scale_m)

    band_rows = max(32, band_rows - band_rows % 32)
    crange = None
    if row_range is not None:
        from tpudct.utils import serialize as ser

        hh, _ww, hoh, _how = ser._parse_plane_header(data)[:4]
        hoh = hoh or hh
        a, b = int(row_range[0]), int(row_range[1])
        a, b = max(0, a), min(hoh, b)
        if b <= a:
            raise ValueError(f"row_range {row_range}: empty for height {hoh}")
        crange = (a - a % 8, min(hh, -(-b // 8) * 8))
    reader = _PlaneRows(data, n_planes=n_planes, row_range=crange)
    oh, ow = reader.oh, reader.ow
    cfg = CodecConfig(
        q_scale=reader.q_scale, transform=reader.transform,
        q_table=reader.q_table,
    )
    if row_range is not None:
        out_shape = (b - a, ow)
    elif m is not None:
        from tpudct.ops.scaled import scaled_shape_m8

        out_shape = (scaled_shape_m8(oh, m), scaled_shape_m8(ow, m))
    else:
        out_shape = (oh, ow)
    if out is None:
        # out_npy: write the raster to a .npy on disk band by band — host
        # residency stays O(band) even when the OUTPUT exceeds RAM
        out = (np.lib.format.open_memmap(
                   out_npy, mode="w+", dtype=np.uint8, shape=out_shape)
               if out_npy else np.empty(out_shape, np.uint8))
    if out.shape != out_shape or out.dtype != np.uint8:
        raise ValueError(
            f"preallocated output must be {out_shape} uint8, got "
            f"{out.dtype} {out.shape}"
        )

    cr = crange[0] if crange else 0  # container row of the next pull
    while True:
        piece = reader.pull(band_rows)
        if piece.shape[0] == 0:
            break
        pix = piece.shape[0]
        if row_range is not None:
            # wanted original rows within this piece
            w0, w1 = max(a, cr), min(b, cr + pix)
            if w1 > w0:
                rec = decode_gray_auto(
                    pipeline, piece, cfg, (min(pix, oh - cr), ow)
                )
                out[w0 - a : w1 - a] = rec[w0 - cr : w1 - cr]
        else:
            keep = min(pix, oh - cr)
            if keep > 0:
                if m is not None:
                    # cr is 8-aligned, so the scaled offset is exact
                    rec = decode_gray_scaled_auto(
                        pipeline, piece, cfg, (keep, ow), m
                    )
                    out[cr * m // 8 : cr * m // 8 + rec.shape[0]] = rec
                else:
                    rec = decode_gray_auto(pipeline, piece, cfg, (keep, ow))
                    out[cr : cr + keep] = rec
        cr += pix
        piece = None  # release the slab before the next pull decodes
    return out


# ---------------------------------------------------------------------------
# Color streaming (round 4): beyond-HBM RGB encode/decode
# ---------------------------------------------------------------------------
#
# The color kernels are as band-local as the gray ones: block transforms
# are 8-row local and the 4:2:0 pooling/replication is 2-row local, so a
# 64-row-aligned band boundary slices the whole-image computation exactly
# (64 = the color kernels' sublane alignment).  Each RGB band splits to
# YCbCr on the device, each plane's coefficient slab entropy-codes into
# banded segments, and the three banded plane streams wrap in the SAME
# .tdcc container framing as the in-memory writer — every ordinary loader
# reads the result.  No reference analog (grayscale-only, whole-image
# buffers: utils.cu:70-72, main_newAppr.cu:94-95).


def _planar_band(img: np.ndarray, a: int, b: int) -> np.ndarray:
    """Rows [a, b) of an (H, W, 3) or (3, H, W) uint8 image as (3, rows, W)
    — copies only the band (the whole image never goes to the device)."""
    if img.ndim != 3:
        raise ValueError(f"expected an RGB image, got shape {img.shape}")
    if img.shape[0] == 3 and img.shape[-1] != 3:
        return np.ascontiguousarray(img[:, a:b])
    return np.ascontiguousarray(np.moveaxis(img[a:b], -1, 0))


def encode_color_streamed_bytes(
    pipeline,
    rgb_u8: np.ndarray,
    cfg: Optional[CodecConfig] = None,
    band_rows: int = 8192,
    inner: str = "auto",
    level: int = 6,
    subsample="420",
) -> Tuple[bytes, Tuple[int, int]]:
    """RGB uint8 image of ANY size -> (.tdcc stream bytes, (h, w)).

    The color twin of :func:`encode_gray_streamed_bytes`: device memory
    is bounded by one band's working set, host memory by one band's
    coefficient slabs plus the compressed segments (entropy jobs are
    backpressured like the gray path).  Decodes (via any loader)
    bit-identically to the in-memory ``encode_color_u8`` + banded save
    of the same image."""
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from tpudct.models.color import (
        _chroma_cfg,
        _chroma_plane_shape,
        _luma_cfg,
        color_kernel_shape,
        normalize_subsample,
        supports_color_u8,
    )
    from tpudct.ops.padding import padded_shape
    from tpudct.utils.color import split_u8
    from tpudct.utils.serialize import (
        _CODEC_BANDED,
        _encode_payload,
        _wrap_v4,
        assemble_banded_segments,
        color_container_from_blobs,
    )

    if inner.startswith("banded"):
        # same nesting refusal as the gray streamed encoder
        raise ValueError(
            "streamed encode writes banded segments itself; pass a "
            "non-banded inner stage (auto/rans/huffman/xz/spectral/raw)"
        )
    cfg = cfg or CodecConfig()
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8:
        raise ValueError(
            f"streamed color encode takes uint8 pixels, got {img.dtype}"
        )
    if img.ndim != 3 or (img.shape[0] != 3 and img.shape[-1] != 3):
        raise ValueError(f"expected an RGB image, got shape {img.shape}")
    h, w = (img.shape[1:] if img.shape[0] == 3 else img.shape[:2])
    mode = normalize_subsample(subsample)
    hk, wk = color_kernel_shape(h, w)
    if not supports_color_u8(pipeline, cfg, hk, wk, mode):
        raise ValueError(
            f"streamed color encode needs the u8 color path (hp pipeline, "
            f"int8-safe q_scale); got transform={cfg.transform}, "
            f"q_scale={cfg.q_scale}"
        )
    band_rows = max(64, band_rows - band_rows % 64)
    ch, cw = _chroma_plane_shape(mode, h, w)
    y8 = padded_shape(h, w)
    c8 = padded_shape(ch, cw)
    fy = 2 if mode == "420" else 1  # luma rows per chroma row
    n_bands = -(-hk // band_rows)
    if n_bands > 255:
        raise ValueError(
            f"{n_bands} bands exceed the banded container's 255-segment "
            f"limit; raise --band-rows to at least {-(-hk // 255 // 64) * 64}"
        )
    lcfg, ccfg = _luma_cfg(cfg), _chroma_cfg(cfg)

    segs = {"y": [], "cb": [], "cr": []}  # (rows, future) per plane
    with ThreadPoolExecutor(max_workers=2) as ex:
        pending = []
        for a in range(0, hk, band_rows):
            dev_rows = min(band_rows, hk - a)
            band = _planar_band(img, a, min(a + dev_rows, h))
            if band.shape[1] < dev_rows:  # bottom kernel pad (edge rows)
                band = np.pad(
                    band, ((0, 0), (0, dev_rows - band.shape[1]), (0, 0)),
                    mode="edge",
                )
            if band.shape[2] < wk:
                band = np.pad(
                    band, ((0, 0), (0, 0), (0, wk - band.shape[2])),
                    mode="edge",
                )
            y, cb, cr = split_u8(jnp.asarray(band), mode)
            cy = np.asarray(pipeline.encode_u8(y, lcfg))
            cc = np.asarray(pipeline.encode_u8(
                jnp.concatenate([cb, cr], axis=0), ccfg
            ))
            half = cc.shape[0] // 2
            keep_y = min(dev_rows, y8[0] - a)
            keep_c = min(dev_rows // fy, c8[0] - a // fy)
            slabs = {
                "y": cy[:keep_y, : y8[1]],
                "cb": cc[:half][:keep_c, : c8[1]],
                "cr": cc[half:][:keep_c, : c8[1]],
            }
            for name, slab in slabs.items():
                if slab.shape[0] <= 0:
                    continue
                if len(pending) >= 6:
                    pending[-6].result()  # backpressure: <=2 bands in flight
                fut = ex.submit(
                    _encode_payload,
                    np.ascontiguousarray(slab, np.int16), inner, level,
                    True, True,
                )
                pending.append(fut)
                segs[name].append((slab.shape[0], fut))
        for fut in pending:
            fut.result()

    plane_dims = {"y": (y8, (h, w)), "cb": (c8, (ch, cw)), "cr": (c8, (ch, cw))}
    blobs = {}
    for name, seg_list in segs.items():
        payload = assemble_banded_segments(
            [(rows, fut.result()) for rows, fut in seg_list]
        )
        (p8, oshape) = plane_dims[name]
        q_table = lcfg.q_table if name == "y" else ccfg.q_table
        blobs[name] = _wrap_v4(
            p8[0], p8[1], _CODEC_BANDED, payload, cfg.q_scale,
            cfg.retain_k, oshape, cfg.transform, q_table,
        )
    meta = {"orig_shape": (h, w), "chroma_shape": (ch, cw), "subsample": mode}
    data = color_container_from_blobs(
        meta, lambda name, _q, _o: blobs[name]
    )
    return data, (h, w)


def decode_color_streamed(
    pipeline,
    data: bytes,
    band_rows: int = 8192,
    out: Optional[np.ndarray] = None,
    *,
    n_planes: Optional[int] = None,
    scale_m: Optional[int] = None,
    row_range: Optional[Tuple[int, int]] = None,
    out_npy: Optional[str] = None,
) -> np.ndarray:
    """.tdcc stream bytes -> uint8 RGB, device memory bounded by
    ~band_rows luma rows at a time, HOST memory by one segment per plane
    plus one band's slabs (VERDICT r4 #2 — the round-4 version
    entropy-decoded all three planes whole before banding).

    Each plane reads through its own :class:`_PlaneRows`: banded plane
    streams (what the streamed encoder and `save_color_sharded` write)
    entropy-decode segment by segment in lockstep with the 64-row-aligned
    luma band loop, so the coefficient planes never materialize whole;
    non-banded plane streams decode whole on the host (not segmentable —
    the pre-round-4 behavior, now the fallback).  The per-band device
    pass (split-plane decode + fused merge) slices the whole-image
    computation exactly (merge replication is 2-row local).
    Bit-identical to the in-memory ``decode_color_auto``.  ``out``
    accepts a preallocated uint8 array (memmap-friendly).

    Partial modes (VERDICT r4 #1, color side — same memory bounds):
    ``n_planes=N`` progressive (decodes like the in-memory
    ``partial_color_coefficients`` + ``decode_color`` path),
    ``scale_m=M`` fractional M/8 scale via ``decode_color_scaled`` per
    band, ``row_range=(a, b)`` ROI (only covering segments
    entropy-decode; matches the in-memory ``decode --rows`` slicing).

    The u8-vs-f32 path decision is made from the stream HEADERS (q
    tables, geometry, the int8-safety proof in ``supports_color_u8``) —
    every stream the u8 encoders can produce provably fits int8, so the
    whole-plane value check reduces to a per-band assertion; a violating
    value means a foreign/corrupt stream and raises instead of silently
    wrapping in the int8 cast."""
    from tpudct.models.color import (
        _chroma_plane_shape,
        _fits_i8,
        color_kernel_shape,
        decode_color,
        decode_color_scaled,
        decode_color_u8,
        normalize_subsample,
        supports_color_u8,
    )
    from tpudct.ops.padding import padded_shape
    from tpudct.utils import serialize as ser

    if scale_m is not None and row_range is not None:
        raise ValueError("scale_m does not combine with row_range")
    m = None if scale_m in (None, 8) else int(scale_m)
    subsample, slices, _end = ser._color_plane_slices(data)
    mode = normalize_subsample(
        {0: False, 1: "420", 2: "422"}.get(subsample, False)
    )
    fy = 2 if mode == "420" else 1
    band_rows = max(64, band_rows - band_rows % 64)

    # geometry from the Y header (cheap), then the container row ranges
    yh_c, _yw, yoh, yow = ser._parse_plane_header(slices[0])[:4]
    h, w = (yoh or yh_c), (yow or _yw)
    ch, cw = _chroma_plane_shape(mode, h, w)
    ch_c = padded_shape(ch, cw)[0]  # chroma plane container height
    crange_y = crange_c = None
    start, stop = 0, yh_c
    if row_range is not None:
        a, b = max(0, int(row_range[0])), min(h, int(row_range[1]))
        if b <= a:
            raise ValueError(f"row_range {row_range}: empty for height {h}")
        align = 16 if mode == "420" else 8
        a0 = a - a % align
        y_end = min(yh_c, -(-b // align) * align)
        # tail slices of images whose padded luma height is only 8-aligned
        # (h % 16 == 8) leave y_end // 2 off the chroma block grid — take
        # the whole remaining chroma plane there (same rule as the
        # in-memory `decode --rows` path in cli.py)
        c_end = ch_c if y_end >= yh_c else y_end // fy
        crange_y, crange_c = (a0, y_end), (a0 // fy, c_end)
        start, stop = a0, y_end
    ry = _PlaneRows(slices[0], n_planes=n_planes, row_range=crange_y)
    rcb = _PlaneRows(slices[1], n_planes=n_planes, row_range=crange_c)
    rcr = _PlaneRows(slices[2], n_planes=n_planes, row_range=crange_c)
    # cross-plane consistency — the FULL serialize._assemble_color
    # mirror (review finding: the first version dropped retain_k and the
    # chroma-geometry check, so a foreign .tdcc the in-memory parser
    # rejects could reach the kernels and die with an opaque shape error)
    if not (ry.transform == rcb.transform == rcr.transform
            and ry.q_scale == rcb.q_scale == rcr.q_scale
            and ry.retain_k == rcb.retain_k == rcr.retain_k
            and (rcb.oh, rcb.ow) == (rcr.oh, rcr.ow)
            and rcb.q_table == rcr.q_table):
        raise ValueError("inconsistent .tdcc plane headers")
    if (rcb.oh, rcb.ow) != _chroma_plane_shape(mode, h, w):
        raise ValueError(
            f".tdcc chroma planes declare {(rcb.oh, rcb.ow)} but the "
            f"subsample mode implies {_chroma_plane_shape(mode, h, w)}"
        )
    cfg = CodecConfig(q_scale=ry.q_scale, transform=ry.transform)
    meta = {
        "y_q_table": ry.q_table,
        "c_q_table": rcb.q_table,
        "orig_shape": (h, w),
        "chroma_shape": (ch, cw),
        "subsample": mode,
        "q_scale": ry.q_scale,
        "transform": ry.transform,
    }
    if row_range is not None:
        out_shape = (b - a, w, 3)
    elif m is not None:
        from tpudct.ops.scaled import scaled_shape_m8

        out_shape = (scaled_shape_m8(h, m), scaled_shape_m8(w, m), 3)
    else:
        out_shape = (h, w, 3)
    if out is None:
        # out_npy: same bounded-output contract as the gray twin
        out = (np.lib.format.open_memmap(
                   out_npy, mode="w+", dtype=np.uint8, shape=out_shape)
               if out_npy else np.empty(out_shape, np.uint8))
    if out.shape != out_shape or out.dtype != np.uint8:
        raise ValueError(
            f"preallocated output must be {out_shape} uint8, got "
            f"{out.dtype} {out.shape}"
        )
    # path decision from headers only (see docstring); partial modes pin
    # the same paths their in-memory CLI twins use (decode_color /
    # decode_color_scaled)
    use_u8 = (
        m is None and n_planes is None and row_range is None
        and ry.q_table == "luma" and rcb.q_table == "chroma"
        and supports_color_u8(pipeline, cfg, *color_kernel_shape(h, w), mode)
        and (ry.h, ry.w) == padded_shape(h, w)
        and (rcb.h, rcb.w) == padded_shape(ch, cw)
    )

    pos, cpos = start, start // fy
    while pos < stop:
        keep_c = min(band_rows, stop - pos)  # container luma rows this band
        c_take = (crange_c[1] if crange_c else ch_c) - cpos \
            if pos + keep_c >= stop else keep_c // fy
        keep = min(keep_c, h - pos)  # original pixel rows this band
        yb = ry.pull(keep_c)
        cbb, crb = rcb.pull(c_take), rcr.pull(c_take)
        if keep <= 0:
            pos += keep_c
            cpos += c_take
            continue
        ckeep = min(-(-keep // fy), ch - pos // fy)
        band_meta = {
            **meta,
            "orig_shape": (keep, w),
            "chroma_shape": (ckeep, cw),
        }
        band_planes = {"y": yb, "cb": cbb, "cr": crb}
        if use_u8:
            if not all(_fits_i8(v) for v in band_planes.values()):
                raise ValueError(
                    "stream values exceed int8 despite an int8-safe "
                    "header (foreign or corrupt stream); use the "
                    "in-memory decode"
                )
            rec = decode_color_u8(pipeline, band_planes, band_meta, cfg)
        elif m is not None:
            fac = 8 // m if 8 % m == 0 else None
            rec = decode_color_scaled(
                pipeline, band_planes, band_meta, cfg, fac,
                m=None if fac else m,
            )
        else:
            rec = decode_color(pipeline, band_planes, band_meta, cfg)
        rec = np.asarray(rec)
        if row_range is not None:
            w0, w1 = max(a, pos), min(b, pos + keep)
            if w1 > w0:
                out[w0 - a : w1 - a] = rec[w0 - pos : w1 - pos]
        elif m is not None:
            out[pos * m // 8 : pos * m // 8 + rec.shape[0]] = rec
        else:
            out[pos : pos + keep] = rec
        pos += keep_c
        cpos += c_take
        yb = cbb = crb = band_planes = None  # release slabs (arena reuse)
    for rd in (ry, rcb, rcr):
        rd.drain()  # run each plane's end-of-payload framing validation
    return out
