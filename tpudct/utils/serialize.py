"""Coefficient-stream serialization (.tdc / .tdcc files).

The reference never persists its actual compressed payload — the quantized
coefficient matrix lives only in device memory and the sole artifact is a
quality-100 JPEG re-encode of the reconstruction (utils.cu:98-147;
SURVEY.md §5 "Checkpoint / resume: none").  That makes its compression
factor unmeasurable end-to-end.  This module adds the missing piece: a
self-describing container for the quantized (optionally zonally-truncated)
coefficients, entropy-coded, from which the image can be decoded by any
pipeline.

Plane format v4 (little-endian), used by grayscale .tdc and inside color
.tdcc containers:
  magic  b"TDC4"
  uint32 height, uint32 width          (of the coefficient map, padded)
  uint32 orig_h, uint32 orig_w         (pre-padding image size; 0,0 = same)
  float32 q_scale
  int32  retain_k (-1 = none)
  8s     transform name (NUL-padded ASCII; decode must use the same one)
  8s     quantization-table name ("luma" / "chroma", or a content-derived
         "q:xxxxxx" for a CUSTOM table — in that case the 64 float32 table
         values (256 bytes) follow the header directly, so the stream stays
         self-describing across processes; the loader re-registers them via
         constants.register_q_table)
  uint8  codec: 0 = raw (zlib over row-major int16)
                1 = spectral (see below)
                2 = huffman (JPEG-grade per-block coder, utils/entropy.py;
                    payload stored raw, not zlib-wrapped)
                3 = rans (same T.81 symbolization entropy-coded with a
                    static rANS + positional AC contexts, utils/entropy.py;
                    payload stored raw)
                4 = xz (the spectral reorder compressed with lzma instead
                    of zlib; payload stored raw.  Progressive prefix
                    decoding works like codec 1 — lzma decompresses
                    incrementally)
  uint32 payload_size, then payload (zlib-wrapped for codecs 0-1)

The default codec is "auto": the smallest entropy stage wins per file —
rans beats huffman 4-9% on measured coefficient maps (sub-bit symbol
costs + zig-zag-band contexts) and wins photographic statistics
outright, while the spectral reorder + lzma (xz) wins highly repetitive
content where cross-block LZ matches dominate (~26% under spectral+zlib
on the circuit board).  Decode is bit-exact in every case.

Up to 4M coefficients (2048²) "auto" runs every stage for real and keeps
the smallest (the exact trial loop).  Above that it switches to SAMPLED
RATE ESTIMATION (VERDICT r3 #1): each candidate entropy-codes a
deterministic ~1M-coefficient subset of evenly spaced block rows, the
per-byte rate extrapolates to the full map, and only the predicted
winner runs on the full map — auto then costs ~the winning single stage
instead of the sum of all four (the old loop measured 11.9 s at 8192²
on a 1-CPU host; the winner alone is ~0.9 s).  Estimation affects WHICH
codec is chosen, never correctness: the chosen stage is a real full
encode, bit-exact like any explicit --entropy choice.  The exact
trial-everything behavior stays available as codec "auto-exact".

The *spectral* codec reorders coefficients the way JPEG's entropy stage
does (progressive spectral selection, ITU-T T.81 §G): all DC terms first,
delta-coded across blocks in raster order, then one full plane per AC
position in zig-zag order.  Same-frequency coefficients correlate across
blocks and AC magnitudes provably fit int8 for the shipped transforms at
q_scale>=1 (kernels/hp_pallas._max_coeff), so the AC planes narrow to
int8 — measured 1.1-1.6x smaller .tdc files than raw zlib on the 512²+
benchmark images (near-parity on small smooth images), at identical
fidelity: decode is bit-exact either way, and escape flags widen the
stream when extreme q_scale values overflow the narrow types.

Legacy streams still load: v3 (b"TDC3", no q_table/codec — raw int16) and
v2 (b"TDC2", additionally no transform; decodes as "haweel").

Color streams (.tdcc): a b"TDCC" container holding one v4 plane stream per
YCbCr plane.  The plane headers carry their own pre-padding sizes: the Y
plane's is the RGB image size, the Cb/Cr planes' the (possibly
4:2:0-subsampled) chroma size.
"""

from __future__ import annotations

import os
import struct
import zlib

try:
    import lzma
except ImportError:  # CPython built without liblzma (no _lzma module):
    lzma = None      # the xz codec is unavailable; auto skips its trial.

import numpy as np

# exception tuples that must not reference lzma when it's absent
_TRIAL_ERRORS = (
    (ValueError, RuntimeError) if lzma is None
    else (ValueError, RuntimeError, lzma.LZMAError)
)
_STREAM_ERRORS = (
    (zlib.error, EOFError) if lzma is None
    else (zlib.error, lzma.LZMAError, EOFError)
)

_MAGIC2 = b"TDC2"
_HEADER2 = "<4sIIIIfiI"
_MAGIC3 = b"TDC3"
_HEADER3 = "<4sIIIIfi8sI"
_MAGIC4 = b"TDC4"
_HEADER4 = "<4sIIIIfi8s8sBI"
_MAGICC = b"TDCC"
_HEADERC = "<4sBB"  # magic, n_planes, subsample flag

_CODEC_RAW = 0
_CODEC_SPECTRAL = 1
_CODEC_HUFF = 2  # JPEG-grade per-block Huffman (utils/entropy.py); payload
#                  is the Huffman stream itself, NOT zlib-wrapped.
_CODEC_RANS = 3  # static rANS with positional contexts (utils/entropy.py);
#                  payload stored raw like huffman.
_CODEC_XZ = 4  # spectral reorder + lzma (stdlib): ~26% smaller than
#                spectral+zlib on repetitive content (circuit board), same
#                progressive-prefix property (lzma decompresses
#                incrementally).  Preset is size-aware (_xz_preset).
_CODEC_BANDED = 5  # horizontal row-band segments, each an independent
#                    inner-codec payload: the DISTRIBUTED checkpoint form
#                    (VERDICT r2 #6) — a band-sharded map serializes
#                    without ever gathering the map on one host (each host
#                    entropy-codes only its slab; only the compressed
#                    segments travel).  Layout after the v4 header:
#                      u8 n_segments
#                      per segment: u32le rows (8-multiple), u8 inner_code,
#                                   u32le payload_len, payload
#                    Inner payloads are byte-deterministic (rans pinned to
#                    1 stream-band) so every host assembles identical
#                    bytes regardless of process count or core count.
_CODECS = {
    "raw": _CODEC_RAW, "spectral": _CODEC_SPECTRAL, "huffman": _CODEC_HUFF,
    "rans": _CODEC_RANS, "xz": _CODEC_XZ,
}


def _xz_preset(n_elems: int) -> int:
    """lzma preset by map size: 9|EXTREME up to 1M coefficients (-7 to
    -10% on the repetitive content xz exists for — circuit 512²: 16,244
    vs 17,432 bytes at preset 6 — for ~250 ms), 6 up to 4M, 0 above —
    where preset 0 is both smaller AND faster than zlib-6 on the
    spectral stream (measured at 8192²: 24.09 MB / 5.9 s vs 24.46 MB /
    8.4 s) and rans wins such maps anyway."""
    if n_elems <= (1 << 20):
        return 9 | lzma.PRESET_EXTREME
    return 6 if n_elems <= (1 << 22) else 0

_BS = 8


def zigzag_order():
    """The 64 (u, v) block positions in JPEG zig-zag scan order (ITU-T
    T.81 Figure 5): anti-diagonals, alternating direction — (0,0), (0,1),
    (1,0), (2,0), (1,1), (0,2), ..."""
    return sorted(
        ((u, v) for u in range(_BS) for v in range(_BS)),
        key=lambda t: (t[0] + t[1], t[0] if (t[0] + t[1]) % 2 else t[1]),
    )


_ZIGZAG = zigzag_order()

# spectral stream flag bits
_AC16 = 1  # AC planes stored as int16 (int8 otherwise)
_DCRAW = 2  # DC stored raw int16 (delta-coded otherwise)


_ZZ_FLAT = np.array([u * _BS + v for (u, v) in _ZIGZAG], np.intp)


def _abs_bound(a: np.ndarray) -> float:
    """max(|a|) as a float, without temporaries.  An abs().max() chain
    materializes one or two full-size copies; at gigapixel scale the
    first-touch page faults on those allocations cost SECONDS on this
    host (measured 7 s for a 63-megapixel map's int32 temps) — a min/max
    pair reads the array twice and allocates nothing (~30 ms).  Exact
    for every int dtype incl. the int16 -32768 edge (float carries it),
    and NaN propagates for float inputs."""
    if a.size == 0:
        return 0.0
    return max(-float(a.min()), float(a.max()))

# Chunk length (in blocks) for the cache-blocked plane transposes below:
# 2^15 blocks x 64 coeffs x 2 B = 4 MB working tile, inside L2+L3 on the
# host CPUs here.  The naive (nb, 64) <-> (64, nb) copies are stride-128B
# gathers that measure ~15x slower at gigapixel scale (19 s -> ~1 s for
# _spectral_pack at 8192^2).
_PLANE_CHUNK = 1 << 15


def _spectral_pack(c: np.ndarray) -> bytes:
    """(H, W) int16 coefficient map -> spectral byte stream (pre-zlib)."""
    h, w = c.shape
    nbr, nbc = h // _BS, w // _BS
    nb = nbr * nbc
    # block-major (nb, 64) view of the map: one sequential-locality copy
    blk = np.ascontiguousarray(
        c.reshape(nbr, _BS, nbc, _BS).swapaxes(1, 2)
    ).reshape(nb, _BS * _BS)
    # plane-major (64, nb) in zig-zag order, via cache-blocked transpose
    planes = np.empty((_BS * _BS, nb), np.int16)
    for i in range(0, nb, _PLANE_CHUNK):
        planes[:, i : i + _PLANE_CHUNK] = blk[i : i + _PLANE_CHUNK, _ZZ_FLAT].T
    dc = planes[0].astype(np.int32)
    dcd = np.diff(dc, prepend=np.int32(0))
    flags = 0
    if _abs_bound(dcd) < 32768:
        dc_bytes = dcd.astype(np.int16).tobytes()
    else:  # delta overflows int16 (extreme q_scale): store DC raw
        flags |= _DCRAW
        dc_bytes = dc.astype(np.int16).tobytes()
    ac = planes[1:].reshape(-1)
    if _abs_bound(ac) < 128:
        ac_bytes = ac.astype(np.int8).tobytes()
    else:
        flags |= _AC16
        ac_bytes = ac.tobytes()
    return bytes([flags]) + dc_bytes + ac_bytes


def _spectral_unpack(raw: bytes, h: int, w: int) -> np.ndarray:
    """Inverse of :func:`_spectral_pack` -> (H, W) int16."""
    nb = (h // _BS) * (w // _BS)
    if len(raw) < 1 + 2 * nb:
        raise ValueError("truncated spectral payload")
    flags = raw[0]
    off = 1
    dc_raw = np.frombuffer(raw, np.int16, count=nb, offset=off)
    off += 2 * nb
    dc = (
        dc_raw.astype(np.int32)
        if flags & _DCRAW
        else np.cumsum(dc_raw.astype(np.int32))
    )
    ac_dtype = np.int16 if flags & _AC16 else np.int8
    need = nb * 63 * np.dtype(ac_dtype).itemsize
    if len(raw) < off + need:
        raise ValueError("truncated spectral payload")
    ac = np.frombuffer(raw, ac_dtype, count=nb * 63, offset=off).astype(np.int16)
    planes = np.empty((_BS * _BS, nb), np.int16)
    planes[0] = dc.astype(np.int16)
    planes[1:] = ac.reshape(63, nb)
    return _planes_to_map(planes, h, w)


def _planes_to_map(planes: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zig-zag plane-major (64, nb) -> (H, W) int16 coefficient map, via
    the same cache-blocked transpose as _spectral_pack (the naive
    per-plane scatter is a stride-128B write, ~10x slower at gigapixel
    scale)."""
    nb = (h // _BS) * (w // _BS)
    inv_zz = np.empty(_BS * _BS, np.intp)
    inv_zz[_ZZ_FLAT] = np.arange(_BS * _BS)
    blk = np.empty((nb, _BS * _BS), np.int16)
    for i in range(0, nb, _PLANE_CHUNK):
        blk[i : i + _PLANE_CHUNK] = planes[inv_zz, i : i + _PLANE_CHUNK].T
    return np.ascontiguousarray(
        blk.reshape(h // _BS, w // _BS, _BS, _BS).swapaxes(1, 2)
    ).reshape(h, w)


def banded_rows(h: int, n: int) -> list:
    """Deterministic row split for the banded codec: block-balanced, every
    segment an 8-multiple.  When h divides evenly into n 8-aligned bands
    (the shard_image contract) this is exactly the mesh band split, which
    is what makes the sharded save byte-identical to the single-host one."""
    hb = h // _BS
    if not 1 <= n <= min(255, hb):
        raise ValueError(f"bands must be in 1..min(255, {hb}), got {n}")
    per, extra = divmod(hb, n)
    return [(per + (i < extra)) * _BS for i in range(n)]


def assemble_banded_segments(segments) -> bytes:
    """[(rows, (code, payload)), ...] -> the banded codec's payload bytes.

    The ONE copy of the writer-side segment framing (count byte +
    per-segment ``<IBI`` headers), shared by `_encode_banded` and the
    gray/color streamed encoders — a framing change happens in one
    place, mirroring `_color_plane_slices` on the reader side."""
    parts = [bytes([len(segments)])]
    for rows, (code, payload) in segments:
        parts.append(struct.pack("<IBI", rows, code, len(payload)))
        parts.append(payload)
    return b"".join(parts)


def _encode_banded(c: np.ndarray, n: int, inner: str, level: int) -> bytes:
    """Segments encode on a thread pool: every inner stage (zlib, lzma,
    the native C coders) releases the GIL, so a multi-core host codes
    bands concurrently — the single-host mirror of the multi-host
    save_sharded parallelism.  Output bytes are order-deterministic
    (results are joined in band order regardless of completion order)."""
    from concurrent.futures import ThreadPoolExecutor

    h, _w = c.shape
    splits = banded_rows(h, n)
    starts = [sum(splits[:i]) for i in range(n)]

    def _one(i):
        return _encode_payload(
            c[starts[i] : starts[i] + splits[i]], inner, level,
            deterministic=True, sampled_auto=True,
        )

    if n == 1:
        encoded = [_one(0)]
    else:
        with ThreadPoolExecutor(max_workers=min(n, os.cpu_count() or 4)) as ex:
            encoded = list(ex.map(_one, range(n)))
    return assemble_banded_segments(list(zip(splits, encoded)))


def _parse_banded_spec(codec: str) -> tuple:
    """'banded' / 'banded:N' / 'banded:N:inner' -> (N or 0, inner)."""
    fields = codec.split(":")
    n = int(fields[1]) if len(fields) > 1 and fields[1] else 0
    inner = fields[2] if len(fields) > 2 else "auto"
    if inner.startswith("banded"):
        raise ValueError("banded segments cannot nest")
    return n, inner


def _exact_auto(c: np.ndarray, level: int, rans_bands: int) -> tuple:
    """The exact trial loop: run EVERY available entropy stage on the full
    map, keep the smallest (codec "auto-exact"; also "auto" up to 4M
    coefficients, where the trials are cheap).

    zlib/lzma and the native coders (ctypes calls) release the GIL, so on
    multi-core hosts the trials overlap and this costs ~max(stage) instead
    of sum(stage).  The 1-core CI host cannot overlap threads — there it
    is ≈ sum(stages), which is why large maps default to the sampled estimator instead."""
    from concurrent.futures import ThreadPoolExecutor

    from tpudct.utils import entropy

    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = []
        if entropy.native_entropy_available():
            futs.append((_CODEC_HUFF, ex.submit(entropy.huff_encode, c)))
        if entropy.rans_available():
            futs.append((_CODEC_RANS, ex.submit(
                entropy.rans_encode, c, rans_bands
            )))
        spec = _spectral_pack(c)
        if lzma is not None:
            futs.append((_CODEC_XZ, ex.submit(
                lzma.compress, spec, lzma.FORMAT_XZ, -1, _xz_preset(c.size)
            )))
        best = (_CODEC_SPECTRAL, zlib.compress(spec, level))
        for code_id, fut in futs:
            try:
                payload = fut.result()
            except _TRIAL_ERRORS:
                continue
            if len(payload) < len(best[1]):
                best = (code_id, payload)
    return best


# "auto" runs the exact trial loop up to this many coefficients (4M =
# 2048², where all four trials cost well under a second even single-core)
# and the sampled estimator above it.
_AUTO_EXACT_MAX = 1 << 22
# Sample budget for the estimator: ~1M coefficients of evenly spaced
# block rows — large enough that per-stream table overhead (rans/huffman
# frequency tables, ~1 KB) is <0.1% of the sample payload, small enough
# that all four trials cost ~0.15 s.
_AUTO_SAMPLE_ELEMS = 1 << 20
# Below this size even sampled_auto segments run the exact trials: the
# full trial loop on <512K coefficients costs ~0.1 s and the sample
# would cover a quarter of the band anyway.
_AUTO_SAMPLE_MIN = 1 << 19


def _auto_sample(c: np.ndarray) -> np.ndarray:
    """Deterministic sample of evenly spaced whole block rows
    (np.linspace over the block-row index — same rows for the same shape
    every time, so banded/sharded encodes of identical content make
    identical choices on every host).  The budget scales down with the
    map (1/16th of it, floored at 128K coefficients, capped at 1M): a
    4M-coefficient banded segment samples 256K, keeping the per-band
    trial cost a small fraction of coding the band once, while whole
    production-size maps keep the full 1M sample."""
    h, w = c.shape
    nb = h // _BS
    elems = min(_AUTO_SAMPLE_ELEMS, max(1 << 17, c.size >> 4))
    k = min(nb, max(1, -(-elems // (w * _BS))))
    idx = np.unique(np.linspace(0, nb - 1, k).astype(np.int64))
    return np.vstack([c[i * _BS : (i + 1) * _BS] for i in idx])


def _predictive_auto(c: np.ndarray, level: int, rans_bands: int) -> tuple:
    """Sampled rate estimation (VERDICT r3 #1): entropy-code the sample
    with every candidate, extrapolate bytes/coefficient to the full map,
    run ONLY the predicted winner for real.  The xz trial uses the FULL
    map's size-aware lzma preset so the estimate models the encode that
    would actually run.  Decode correctness is unconditional — whichever
    stage wins performs a real full encode."""
    from concurrent.futures import ThreadPoolExecutor

    from tpudct.utils import entropy

    s = _auto_sample(c)
    scale = c.size / s.size
    full_preset = _xz_preset(c.size)
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = []
        if entropy.native_entropy_available():
            futs.append((_CODEC_HUFF, ex.submit(entropy.huff_encode, s)))
        if entropy.rans_available():
            futs.append((_CODEC_RANS, ex.submit(entropy.rans_encode, s, 1)))
        spec = _spectral_pack(s)
        if lzma is not None:
            futs.append((_CODEC_XZ, ex.submit(
                lzma.compress, spec, lzma.FORMAT_XZ, -1, full_preset
            )))
        best_code, best_est = _CODEC_SPECTRAL, len(zlib.compress(spec, level)) * scale
        for code_id, fut in futs:
            try:
                est = len(fut.result()) * scale
            except _TRIAL_ERRORS:
                continue
            if est < best_est:
                best_code, best_est = code_id, est
    # the real encode of the predicted winner
    if best_code == _CODEC_HUFF:
        return best_code, entropy.huff_encode(c)
    if best_code == _CODEC_RANS:
        return best_code, entropy.rans_encode(c, rans_bands)
    full_spec = _spectral_pack(c)
    if best_code == _CODEC_XZ:
        return best_code, lzma.compress(
            full_spec, lzma.FORMAT_XZ, -1, full_preset
        )
    return _CODEC_SPECTRAL, zlib.compress(full_spec, level)


def _encode_payload(
    c: np.ndarray, codec: str, level: int, deterministic: bool = False,
    sampled_auto: bool = False,
) -> tuple:
    rans_bands = 1 if deterministic else 0
    if codec == "banded" or codec.startswith("banded:"):
        n, inner = _parse_banded_spec(codec)
        if n == 0:
            # same size heuristic as the rans stream bands: ~1 per 4 Mpix
            n = max(1, min(16, c.size >> 22, c.shape[0] // _BS))
        return _CODEC_BANDED, _encode_banded(c, n, inner, level)
    if codec == "auto" and sampled_auto and c.size > _AUTO_SAMPLE_MIN:
        # Banded/sharded/streamed segments: ALWAYS the sampled estimator.
        # A segment is typically ~4M coefficients — just under the
        # whole-map exact-trial threshold — so without this flag every
        # band of a large map would brute-force all four stages (measured
        # 13.7 s vs 0.44 s for the winning stage alone on a 1-CPU host at
        # 8192²).  Deterministic for fixed shape+content, so sharded and
        # single-host encodes of the same slab still emit identical bytes.
        return _predictive_auto(c, level, rans_bands)
    if codec == "auto-exact" or (codec == "auto" and c.size <= _AUTO_EXACT_MAX):
        return _exact_auto(c, level, rans_bands)
    if codec == "auto":
        return _predictive_auto(c, level, rans_bands)
    try:
        code = _CODECS[codec]
    except KeyError:
        raise ValueError(
            f"unknown codec {codec!r}; available: "
            f"{sorted(_CODECS) + ['auto', 'auto-exact', 'banded[:N[:inner]]']}"
        ) from None
    if code == _CODEC_HUFF:
        from tpudct.utils.entropy import huff_encode

        return code, huff_encode(c)
    if code == _CODEC_RANS:
        from tpudct.utils.entropy import rans_encode

        return code, rans_encode(c, rans_bands)
    if code == _CODEC_XZ:
        if lzma is None:
            raise ValueError(
                "the xz codec needs the stdlib lzma module (this CPython "
                "was built without liblzma); use another --entropy stage"
            )
        return code, lzma.compress(
            _spectral_pack(c), lzma.FORMAT_XZ, -1, _xz_preset(c.size)
        )
    raw = _spectral_pack(c) if code == _CODEC_SPECTRAL else c.tobytes()
    return code, zlib.compress(raw, level)


def _decode_payload(raw: bytes, code: int, h: int, w: int) -> np.ndarray:
    if code == _CODEC_HUFF:
        from tpudct.utils.entropy import huff_decode

        return huff_decode(raw, h, w)
    if code == _CODEC_RANS:
        from tpudct.utils.entropy import rans_decode

        return rans_decode(raw, h, w)
    if code == _CODEC_XZ:
        if lzma is None:
            raise ValueError(
                "this stream uses the xz codec but the stdlib lzma module "
                "is unavailable (CPython built without liblzma)"
            )
        try:
            return _spectral_unpack(lzma.decompress(raw), h, w)
        except lzma.LZMAError as e:
            raise ValueError(f"corrupt .tdc payload: {e}") from None
    if code == _CODEC_SPECTRAL:
        return _spectral_unpack(raw, h, w)
    if code == _CODEC_RAW:
        return np.frombuffer(raw, dtype=np.int16).reshape(h, w).copy()
    if code == _CODEC_BANDED:
        if len(raw) < 1:
            raise ValueError("corrupt .tdc banded payload: empty")
        n = raw[0]
        off = 1
        jobs = []  # (bytes, inner, rows)
        total = 0
        for _ in range(n):
            if len(raw) < off + 9:
                raise ValueError("corrupt .tdc banded payload: truncated header")
            rows, inner, plen = struct.unpack("<IBI", raw[off : off + 9])
            off += 9
            if inner == _CODEC_BANDED:
                raise ValueError("corrupt .tdc banded payload: nested segment")
            if rows % _BS or rows == 0 or total + rows > h:
                raise ValueError("corrupt .tdc banded payload: bad segment rows")
            if len(raw) < off + plen:
                raise ValueError("corrupt .tdc banded payload: truncated segment")
            jobs.append((raw[off : off + plen], inner, rows))
            off += plen
            total += rows
        if total != h or off != len(raw):
            raise ValueError("corrupt .tdc banded payload: coverage mismatch")

        def _seg(job):
            seg, inner, rows = job
            if inner in (_CODEC_RAW, _CODEC_SPECTRAL):
                # those two are zlib-wrapped by _encode_payload (the outer
                # unwrap in _parse_plane never sees inner segments)
                try:
                    seg = zlib.decompress(seg)
                except zlib.error as e:
                    raise ValueError(f"corrupt .tdc banded segment: {e}") from None
            return _decode_payload(seg, inner, rows, w)

        if len(jobs) == 1:
            return _seg(jobs[0])
        # segments decode on a thread pool — same GIL-release argument as
        # the encode side; order preserved by ex.map
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(len(jobs), os.cpu_count() or 4)
        ) as ex:
            return np.vstack(list(ex.map(_seg, jobs)))
    raise ValueError(f"unknown .tdc payload codec {code}")


# ---- single-plane (.tdc) API -----------------------------------------------


def _validate_map(coeffs) -> np.ndarray:
    """Shared container-entry validation -> contiguous int16 map."""
    cf = np.asarray(coeffs)
    if cf.ndim != 2:
        raise ValueError(f"expected a 2-D coefficient map, got shape {cf.shape}")
    # The container narrows to int16.  Quantized coefficients fit for every
    # sane config (|c| <= ~97/q_scale for the shipped transforms), but an
    # extreme q_scale (e.g. 0.001) CAN overflow — narrowing silently would
    # round-trip 40000.0 as -25536.0.  Refuse instead of corrupting.
    amax = _abs_bound(cf)
    if amax > 32767.0 or not np.isfinite(amax):
        raise ValueError(
            f"coefficient magnitude {amax} exceeds the .tdc int16 range "
            "(32767); raise q_scale or store the float map yourself"
        )
    c = np.ascontiguousarray(cf, dtype=np.int16)
    h, w = c.shape
    if h % _BS or w % _BS:
        raise ValueError(f"coefficient map {h}x{w} is not block-aligned")
    return c


def _wrap_v4(
    h: int, w: int, code: int, payload: bytes, q_scale: float, retain_k,
    orig_shape, transform: str, q_table: str,
) -> bytes:
    """The v4 header + custom-q-table block around an encoded payload (the
    one copy shared by the in-memory and the sharded writers)."""
    oh, ow = orig_shape if orig_shape is not None else (0, 0)
    tname = transform.encode("ascii")
    qblock = b""
    if q_table not in ("luma", "chroma"):
        # Custom table: store under its content-derived "q:" name and embed
        # the 64 float32 values so any process can decode the stream.
        from tpudct.constants import get_q_table, register_q_table

        qvals = np.ascontiguousarray(get_q_table(q_table), dtype=np.float32)
        q_table = register_q_table(qvals)
        qblock = qvals.tobytes()
        assert len(qblock) == 256
    qname = q_table.encode("ascii")
    if len(tname) > 8 or len(qname) > 8:
        raise ValueError("transform/q_table names exceed 8 bytes")
    header = struct.pack(
        _HEADER4, _MAGIC4, h, w, oh, ow, float(q_scale),
        -1 if retain_k is None else int(retain_k), tname, qname, code,
        len(payload),
    )
    return header + qblock + payload


def coefficients_to_bytes(
    coeffs, q_scale: float = 1.0, retain_k=None, level: int = 6,
    orig_shape=None, transform: str = "haweel", q_table: str = "luma",
    codec: str = "auto",
) -> bytes:
    c = _validate_map(coeffs)
    h, w = c.shape
    code, payload = _encode_payload(c, codec, level)
    return _wrap_v4(
        h, w, code, payload, q_scale, retain_k, orig_shape, transform, q_table
    )


def _read_custom_q_table(data: bytes, hsize: int) -> tuple:
    """Read + validate the 256-byte embedded f32 table that follows the v4
    header when the stored q-table name is a content-derived "q:xxxxxx".
    Returns (table, header size including the block).  Registration is the
    CALLER's job, after the rest of the stream parses — a corrupt payload
    must not leave side effects in the process-global registry."""
    if len(data) < hsize + 256:
        raise ValueError("truncated .tdc custom q-table block")
    tbl = np.frombuffer(data[hsize : hsize + 256], np.float32).reshape(8, 8)
    if not np.isfinite(tbl).all() or (tbl <= 0).any():
        raise ValueError("corrupt .tdc custom q-table block")
    return tbl, hsize + 256


def _parse_plane_header(data: bytes) -> tuple:
    """Magic-dispatched plane header parse (v4/v3/v2), payload untouched ->
    (h, w, oh, ow, q_scale, retain_k, transform, q_table, code, psize,
    hsize, custom_q, version).  The ONE copy of the container-version
    dispatch, shared by the real parser (`_parse_plane`) and the
    header-only inspector (`_inspect_plane`) so a future format revision
    cannot leave the two disagreeing.  For v4 streams carrying a custom
    q-table the embedded values are returned (NOT registered — callers
    register only after their payload decode succeeds) and hsize covers
    the 256-byte table block."""
    custom_q, version = None, 4
    if len(data) >= 4 and data[:4] == _MAGIC4:
        hsize = struct.calcsize(_HEADER4)
        if len(data) < hsize:
            raise ValueError("truncated .tdc coefficient stream")
        (_m, h, w, oh, ow, q_scale, retain_k, tname, qname, code, psize) = (
            struct.unpack(_HEADER4, data[:hsize])
        )
        transform = tname.rstrip(b"\x00").decode("ascii")
        q_table = qname.rstrip(b"\x00").decode("ascii")
        if q_table.startswith("q:"):
            custom_q, hsize = _read_custom_q_table(data, hsize)
    elif len(data) >= 4 and data[:4] == _MAGIC3:
        hsize = struct.calcsize(_HEADER3)
        if len(data) < hsize:
            raise ValueError("truncated .tdc coefficient stream")
        (_m, h, w, oh, ow, q_scale, retain_k, tname, psize) = struct.unpack(
            _HEADER3, data[:hsize]
        )
        transform = tname.rstrip(b"\x00").decode("ascii")
        q_table, code, version = "luma", _CODEC_RAW, 3
    elif len(data) >= 4 and data[:4] == _MAGIC2:
        hsize = struct.calcsize(_HEADER2)
        if len(data) < hsize:
            raise ValueError("truncated .tdc coefficient stream")
        (_m, h, w, oh, ow, q_scale, retain_k, psize) = struct.unpack(
            _HEADER2, data[:hsize]
        )
        transform, q_table, code, version = "haweel", "luma", _CODEC_RAW, 2
    else:
        raise ValueError("not a .tdc coefficient stream")
    if len(data) < hsize + psize:
        raise ValueError("truncated .tdc coefficient stream")
    return (h, w, oh, ow, q_scale, retain_k, transform, q_table, code,
            psize, hsize, custom_q, version)


def _parse_plane(data: bytes) -> tuple:
    """Parse one plane stream (v4/v3/v2) -> (plane dict, bytes consumed)."""
    (h, w, oh, ow, q_scale, retain_k, transform, q_table, code, psize,
     hsize, custom_q, _version) = _parse_plane_header(data)
    raw = data[hsize : hsize + psize]
    if code not in (_CODEC_HUFF, _CODEC_RANS, _CODEC_XZ, _CODEC_BANDED):  # only codecs 0-1 are zlib-wrapped
        try:
            raw = zlib.decompress(raw)
        except zlib.error as e:
            raise ValueError(f"corrupt .tdc payload: {e}") from None
    coeffs = _decode_payload(raw, code, h, w)
    if (oh and oh > h) or (ow and ow > w):
        # The stored map must cover the original image (it is written at
        # the 8-aligned shape or larger); a header claiming more pixels
        # than the map holds is corrupt, and downstream croppers (incl.
        # the stacked bulk decoders) rely on orig <= map.
        raise ValueError(
            f"corrupt .tdc: orig_shape ({oh}, {ow}) exceeds the "
            f"coefficient map ({h}, {w})"
        )
    if custom_q is not None:
        # Register only now, after the whole stream parsed — a corrupt
        # payload must not leave entries in the process-global registry.
        from tpudct.constants import register_q_table

        q_table = register_q_table(custom_q)
    plane = {
        "coeffs": coeffs.astype(np.float32),
        "orig_shape": (oh or h, ow or w),
        "q_scale": float(q_scale),
        "retain_k": None if retain_k < 0 else retain_k,
        "transform": transform,
        "q_table": q_table,
    }
    return plane, hsize + psize


def bytes_to_coefficients(
    data: bytes, with_orig_shape: bool = False, with_transform: bool = False,
    with_q_table: bool = False,
):
    plane, _used = _parse_plane(data)
    out = (plane["coeffs"], plane["q_scale"], plane["retain_k"])
    if with_orig_shape:
        out = (*out, plane["orig_shape"])
    if with_transform:
        out = (*out, plane["transform"])
    if with_q_table:
        out = (*out, plane["q_table"])
    return out


def save_coefficients(
    path: str, coeffs, q_scale: float = 1.0, retain_k=None, orig_shape=None,
    transform: str = "haweel", codec: str = "auto", q_table: str = "luma",
) -> int:
    """Write a .tdc file; returns bytes written (the measurable payload)."""
    data = coefficients_to_bytes(
        coeffs, q_scale, retain_k, orig_shape=orig_shape, transform=transform,
        codec=codec, q_table=q_table,
    )
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_coefficients(
    path: str, with_orig_shape: bool = False, with_transform: bool = False,
    with_q_table: bool = False,
):
    """Read a .tdc file -> (float32 coefficient map, q_scale, retain_k
    [, original (h, w)][, transform name][, q_table name])."""
    with open(path, "rb") as f:
        return bytes_to_coefficients(
            f.read(), with_orig_shape, with_transform, with_q_table
        )


# ---- progressive decode -----------------------------------------------------


def _zero_high_planes(c: np.ndarray, n_planes: int) -> np.ndarray:
    """Zero every zig-zag position >= n_planes of an (H, W) int16 map.

    The masking twin of the spectral codec's plane truncation, for
    payloads that are NOT spectral-ordered (rans/huffman/raw banded
    segments): those must entropy-decode whole, but the progressive
    contract — only the first N zig-zag planes survive — is then a pure
    block-position mask.  Small n rebuilds sparsely (fresh zeros + one
    strided copy per kept position — n/64 of the elements move) instead
    of the whole-map masked multiply, which read+wrote all 64/64 just to
    keep a DC plane (~0.2 s per 268 MB segment in the archive-scale
    preview).  May return the input (mutated in place) OR a new array;
    callers own the result either way."""
    n_planes = max(1, min(int(n_planes), 64))
    if n_planes >= 64:
        return c
    h, w = c.shape
    if n_planes <= 8:
        out = np.zeros((h, w), c.dtype)
        for (u, v) in _ZIGZAG[:n_planes]:
            out[u::_BS, v::_BS] = c[u::_BS, v::_BS]
        return out
    mask = np.zeros((_BS, _BS), np.int16)
    for (u, v) in _ZIGZAG[:n_planes]:
        mask[u, v] = 1
    c.reshape(h // _BS, _BS, w // _BS, _BS)[:] *= mask[None, :, None, :]
    return c


def _partial_spectral_map(
    payload, code: int, h: int, w: int, n_planes: int
) -> np.ndarray:
    """Compressed spectral/xz payload -> (h, w) int16 map holding only the
    first `n_planes` zig-zag planes (rest zero), decompressing only the
    needed PREFIX of the payload (zlib.decompressobj / LZMADecompressor).

    The one copy of the prefix-decode core, shared by the whole-stream
    progressive parser (`partial_coefficients`) and the per-segment
    banded walker (`iter_banded_segments`) — which is what makes the
    banded archival layout progressively decodable too (VERDICT r4 #1).
    Also works on truncated payloads as long as the needed prefix is
    present (partially-downloaded files)."""
    if code == _CODEC_XZ and lzma is None:
        raise ValueError(
            "this stream uses the xz codec but the stdlib lzma module "
            "is unavailable (CPython built without liblzma)"
        )
    n_planes = max(1, min(int(n_planes), 64))
    nb = (h // _BS) * (w // _BS)
    data = memoryview(payload)
    d = (lzma.LZMADecompressor() if code == _CODEC_XZ
         else zlib.decompressobj())
    out = bytearray()
    pos = 0
    # flags byte + DC int16 plane; AC item size depends on the flags, so
    # fetch the first byte, then extend the budget.
    try:
        while len(out) < 1 and pos < len(data):
            out += d.decompress(data[pos : pos + 65536])
            pos += 65536
        if not out:
            raise ValueError("truncated spectral payload")
        flags = out[0]
        ac_item = 2 if flags & _AC16 else 1
        need = 1 + 2 * nb + (n_planes - 1) * nb * ac_item
        while len(out) < need and pos < len(data):
            out += d.decompress(data[pos : pos + 65536])
            pos += 65536
    except _STREAM_ERRORS as e:
        # EOFError: LZMADecompressor refuses input after stream end —
        # reaching it with len(out) < need means a short payload.
        raise ValueError(f"corrupt .tdc payload: {e}") from None
    if len(out) < need:
        raise ValueError(
            f"stream holds fewer than {n_planes} spectral planes"
        )
    raw = bytes(out[:need])

    dc_raw = np.frombuffer(raw, np.int16, count=nb, offset=1)
    dc = (
        dc_raw.astype(np.int32)
        if flags & _DCRAW
        else np.cumsum(dc_raw.astype(np.int32))
    )
    planes = np.zeros((_BS * _BS, nb), np.int16)
    planes[0] = dc.astype(np.int16)
    ac_dtype = np.int16 if flags & _AC16 else np.int8
    off = 1 + 2 * nb
    for i in range(n_planes - 1):
        plane = np.frombuffer(raw, ac_dtype, count=nb, offset=off + i * nb * ac_item)
        planes[i + 1] = plane.astype(np.int16)  # zig-zag plane i+1
    return _planes_to_map(planes, h, w)


_MALLOC_TUNED = False


def _tune_malloc_for_slabs() -> None:
    """glibc returns >128 KB allocations to the OS on free (mmap/munmap),
    so every decoded segment slab pays first-touch page faults on THIS
    host — measured ~3 s per 268 MB slab, the dominant cost of
    segment-at-a-time decode at archive scale (4.3-Gpix preview: ~100 s
    of its 120 s).  Raising
    M_MMAP_THRESHOLD / M_TRIM_THRESHOLD keeps the arena, so successive
    slab allocations recycle warm pages (measured 3.7× on the segment
    walk).  Process-global and sticky by design — the cost is retaining
    roughly one slab's worth of arena; no-op off glibc."""
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return
    _MALLOC_TUNED = True
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:  # non-glibc platforms: nothing to tune
        pass


def iter_banded_segments(
    raw, h: int, w: int, *, n_planes=None, row_range=None
):
    """Walk a banded payload one segment at a time -> yields
    ``(r0, rows, int16 map)`` with host residency bounded by ONE decoded
    segment — the streaming reader that makes the archival (banded)
    layout partially decodable (VERDICT r4 #1).

    ``row_range=(a, b)`` (container pixel rows) SKIPS segments outside
    the half-open range without entropy-decoding them (headers still walk
    and validate, so corruption anywhere in the framing is caught);
    ``n_planes`` keeps only the first N zig-zag spectral positions per
    segment — prefix decompression for spectral/xz inner stages, full
    decode + position mask for the interleaved ones (rans/huffman/raw).
    Raises the same corrupt-payload taxonomy as `_decode_payload`'s
    banded branch."""
    _tune_malloc_for_slabs()
    raw = bytes(raw) if not isinstance(raw, (bytes, bytearray)) else raw
    if len(raw) < 1:
        raise ValueError("corrupt .tdc banded payload: empty")
    n = raw[0]
    off = 1
    r0 = 0
    for _ in range(n):
        if len(raw) < off + 9:
            raise ValueError("corrupt .tdc banded payload: truncated header")
        rows, inner, plen = struct.unpack("<IBI", raw[off : off + 9])
        off += 9
        if inner == _CODEC_BANDED:
            raise ValueError("corrupt .tdc banded payload: nested segment")
        if rows % _BS or rows == 0 or r0 + rows > h:
            raise ValueError("corrupt .tdc banded payload: bad segment rows")
        if len(raw) < off + plen:
            raise ValueError("corrupt .tdc banded payload: truncated segment")
        seg = raw[off : off + plen]
        off += plen
        if row_range is not None and (
            r0 + rows <= row_range[0] or r0 >= row_range[1]
        ):
            r0 += rows  # outside the ROI: header walked, payload untouched
            continue
        if n_planes is not None and inner in (_CODEC_SPECTRAL, _CODEC_XZ):
            # spectral-ordered inners: only the needed prefix decompresses
            cmap = _partial_spectral_map(seg, inner, rows, w, n_planes)
        else:
            if inner in (_CODEC_RAW, _CODEC_SPECTRAL):
                try:
                    seg = zlib.decompress(seg)
                except zlib.error as e:
                    raise ValueError(
                        f"corrupt .tdc banded segment: {e}"
                    ) from None
            cmap = _decode_payload(seg, inner, rows, w)
            if n_planes is not None:
                cmap = _zero_high_planes(cmap, n_planes)
        yield r0, rows, cmap
        # release our reference BEFORE decoding the next segment: holding
        # it forces malloc to EXTEND the arena for the next slab instead
        # of reusing this one's pages (two slabs transiently live), which
        # re-pays first-touch page faults every segment — measured
        # ~2.5 s/segment at archive scale vs ~0.4 s with top-chunk reuse
        cmap = None
        r0 += rows
    if r0 != h or off != len(raw):
        raise ValueError("corrupt .tdc banded payload: coverage mismatch")


def restage_banded_plane(blob: bytes, inner: str, level: int = 6) -> bytes:
    """Re-code a BANDED v4 plane stream with a new inner entropy stage,
    ONE SEGMENT RESIDENT AT A TIME (round 5): each segment
    entropy-decodes, re-codes with `inner` (``"auto"`` = the per-segment
    sampled estimator, like the writers), and the stream re-wraps with
    every header field — including an embedded custom q table — carried
    over.  Source row splits are preserved, so the result is what the
    original writer would have produced with the new stage.

    This is the bounded-memory archival-upgrade path: restaging a
    beyond-HBM banded archive through the whole-map restage would
    materialize its multi-GB coefficient map; this never holds more than
    one decoded segment.  Raises ValueError for non-banded streams
    (callers fall back to the whole-map restage) and for a banded
    `inner` (segments cannot nest)."""
    if inner.startswith("banded"):
        raise ValueError("banded segments cannot nest")
    (h, w, oh, ow, q_scale, retain_k, transform, q_table, code, psize,
     hsize, custom_q, version) = _parse_plane_header(blob)
    if version != 4 or code != _CODEC_BANDED:
        raise ValueError(
            "streamed restage needs a banded v4 stream (this one is "
            f"codec {code}, v{version}); use the whole-map restage"
        )
    segments = []
    for _r0, rows, cmap in iter_banded_segments(
        blob[hsize : hsize + psize], h, w
    ):
        segments.append((rows, _encode_payload(
            cmap, inner, level, deterministic=True, sampled_auto=True
        )))
        cmap = None  # release before the next segment decodes (arena reuse)
    if custom_q is not None:
        # register only now, AFTER the whole payload validated (the walk
        # above raises on corruption) — the same no-side-effects-on-
        # corrupt-streams invariant _parse_plane keeps; _wrap_v4 re-embeds
        # the table by its registered name
        from tpudct.constants import register_q_table

        q_table = register_q_table(custom_q)
    return _wrap_v4(
        h, w, _CODEC_BANDED, assemble_banded_segments(segments),
        q_scale, None if retain_k < 0 else retain_k,
        (oh, ow) if (oh or ow) else None, transform, q_table,
    )


def restage_banded_color(data: bytes, inner: str, level: int = 6) -> bytes:
    """Per-plane :func:`restage_banded_plane` over a .tdcc container,
    re-framed through the ONE writer-side framing copy
    (:func:`color_container_from_blobs`) so the container layout cannot
    drift.  Raises ValueError when any plane is not a banded v4 stream
    (callers fall back to the whole-map restage)."""
    subsample, slices, _end = _color_plane_slices(data)
    blobs = {}
    hdrs = []
    for name, sl in zip(("y", "cb", "cr"), slices):
        blobs[name] = restage_banded_plane(bytes(sl), inner, level)
        hdrs.append(_parse_plane_header(sl))
    (yh, yw, yoh, yow, _qs, _rk, _tr, y_qt) = hdrs[0][:8]
    (ch_, cw_, coh, cow, _q2, _r2, _t2, c_qt) = hdrs[1][:8]
    meta = {
        "orig_shape": (yoh or yh, yow or yw),
        "chroma_shape": (coh or ch_, cow or cw_),
        "subsample": {0: False, 1: "420", 2: "422"}.get(subsample, False),
        "y_q_table": y_qt,
        "c_q_table": c_qt,
    }
    return color_container_from_blobs(meta, lambda name, _q, _o: blobs[name])


def _parse_header_v4(data: bytes) -> tuple:
    """Parse just the v4 header -> (fields..., header size, custom_q).  For
    streams carrying a custom q-table the embedded values are returned (NOT
    yet registered — the caller registers after its payload decode succeeds)
    and the header size covers the 256-byte table block."""
    hsize = struct.calcsize(_HEADER4)
    if len(data) < hsize or data[:4] != _MAGIC4:
        raise ValueError("not a v4 .tdc coefficient stream")
    (_m, h, w, oh, ow, q_scale, retain_k, tname, qname, code, psize) = (
        struct.unpack(_HEADER4, data[:hsize])
    )
    custom_q = None
    if qname.rstrip(b"\x00").decode("ascii").startswith("q:"):
        custom_q, hsize = _read_custom_q_table(data, hsize)
    return h, w, oh, ow, q_scale, retain_k, tname, qname, code, psize, hsize, custom_q


_CODEC_NAMES = {v: k for k, v in _CODECS.items()}
_CODEC_NAMES[_CODEC_BANDED] = "banded"


def _inspect_plane(data: bytes) -> tuple:
    """One plane's header fields WITHOUT touching the payload -> (info
    dict, bytes consumed).  Accepts every container version v2-v4."""
    (h, w, oh, ow, q_scale, retain_k, transform, q_table, code, psize,
     hsize, custom_q, version) = _parse_plane_header(data)
    info = {
        "version": version,
        "shape": [h, w],
        "orig_shape": [oh or h, ow or w],
        "q_scale": float(q_scale),
        "retain_k": None if retain_k < 0 else retain_k,
        "transform": transform,
        "q_table": "custom (embedded)" if custom_q is not None else q_table,
        "codec": _CODEC_NAMES.get(code, f"unknown ({code})"),
        "header_bytes": hsize,
        "payload_bytes": psize,
        "raw_bytes": h * w,  # the u8 image this map covers
    }
    if code == _CODEC_RANS and psize >= 6:
        pay = data[hsize : hsize + 6]
        if pay[0] in (2, 3):
            info["rans_bands"] = pay[1]
    if code == _CODEC_BANDED and psize >= 1:
        pay = data[hsize : hsize + psize]
        info["segments"] = pay[0]
        inners, off = [], 1
        for _ in range(pay[0]):
            if len(pay) < off + 9:
                break
            _rows, inner, plen = struct.unpack("<IBI", pay[off : off + 9])
            inners.append(_CODEC_NAMES.get(inner, f"unknown ({inner})"))
            off += 9 + plen
        info["segment_codecs"] = inners
    return info, hsize + psize


def inspect_stream(data: bytes) -> dict:
    """Structured header inspection of a .tdc / .tdcc stream WITHOUT
    decoding any payload — the stream-introspection analog of ffprobe
    (reference analog: none; it has no bitstream at all).  Exposed as
    CLI `inspect`."""
    if is_color_stream(data):
        subsample, slices, end = _color_plane_slices(data)
        planes = []
        for name, s in zip(("y", "cb", "cr"), slices):
            info, used = _inspect_plane(s)
            if used != len(s):
                raise ValueError("corrupt .tdcc plane length")
            info["plane"] = name
            planes.append(info)
        rep = {
            "container": "tdcc (color)",
            "subsample": {0: "4:4:4", 1: "4:2:0", 2: "4:2:2"}.get(
                subsample, f"unknown ({subsample})"
            ),
            "total_bytes": end,
            "planes": planes,
        }
    else:
        info, used = _inspect_plane(data)
        end = used
        rep = {"container": "tdc (grayscale)", "total_bytes": used, **info}
    # trailing TDCM chunk (utils/jpegcoef.py): JPEG APPn/COM segments
    # captured at coefficient-level import, spliced back on export
    tail = data[end:]
    if len(tail) >= 8 and tail[:4] == b"TDCM":
        (n,) = struct.unpack("<I", tail[4:8])
        if len(tail) >= 8 + n:
            rep["jpeg_metadata_bytes"] = n
    return rep


def partial_coefficients(data: bytes, n_planes: int = 1) -> dict:
    """Progressive decode: reconstruct a coefficient map from only the
    first `n_planes` zig-zag spectral planes (1 = DC only, 64 = all).

    The spectral codec stores the DC plane first, then one full plane per
    AC position in zig-zag order (the on-disk analog of JPEG progressive
    spectral selection, ITU-T T.81 §G) — so a PREFIX of the payload is a
    valid low-frequency approximation.  Decompression stops as soon as
    enough bytes are available (zlib.decompressobj / LZMADecompressor),
    which means this also works on a truncated/partially-downloaded file
    as long as the needed prefix arrived.  BANDED streams (the archival
    layout) decode segment by segment — spectral/xz inner segments keep
    the prefix property per segment, interleaved inners (rans/huffman/
    raw) decode whole and mask, one segment resident at a time (VERDICT
    r4 #1; for bounded OUTPUT memory too, use
    streaming.decode_gray_streamed(n_planes=...)).  Whole-stream
    interleaved payloads (huffman/rans/raw) have no truncatable prefix,
    so they take the same decode-whole-and-mask contract the banded
    walker applies to interleaved inner segments: no byte or memory
    savings (the full payload decodes), but the progressive result is
    identical — every .tdc answers preview/--planes.

    Returns the same plane dict shape as the internal parser: coeffs
    (float32, unrequested planes zero), orig_shape, q_scale, retain_k,
    transform, q_table, plus n_planes."""
    (h, w, oh, ow, q_scale, retain_k, tname, qname, code, psize, hsize,
     custom_q) = _parse_header_v4(data)
    n_planes = max(1, min(int(n_planes), 64))
    if code == _CODEC_BANDED:
        coeffs = np.zeros((h, w), np.int16)
        for r0, rows, cmap in iter_banded_segments(
            data[hsize : hsize + psize], h, w, n_planes=n_planes
        ):
            coeffs[r0 : r0 + rows] = cmap
            cmap = None  # release before the next segment decodes (arena reuse)
    elif code in (_CODEC_SPECTRAL, _CODEC_XZ):
        coeffs = _partial_spectral_map(
            memoryview(data)[hsize:], code, h, w, n_planes
        )
    else:
        # Interleaved whole-stream codecs (rans/huffman/raw): decode
        # whole, then mask to the requested zig-zag prefix — the same
        # contract the banded walker applies to interleaved inner
        # segments above.
        raw = data[hsize : hsize + psize]
        if code in (_CODEC_RAW, _CODEC_SPECTRAL):  # zlib-wrapped pair
            try:
                raw = zlib.decompress(raw)
            except zlib.error as e:
                raise ValueError(f"corrupt .tdc payload: {e}") from None
        coeffs = _zero_high_planes(_decode_payload(raw, code, h, w), n_planes)
    transform = tname.rstrip(b"\x00").decode("ascii")
    if custom_q is not None:
        from tpudct.constants import register_q_table

        qname = register_q_table(custom_q).encode("ascii")
    return {
        "coeffs": coeffs.astype(np.float32),
        "orig_shape": (oh or h, ow or w),
        "q_scale": float(q_scale),
        "retain_k": None if retain_k < 0 else retain_k,
        "transform": transform,
        "q_table": qname.rstrip(b"\x00").decode("ascii"),
        "n_planes": n_planes,
    }


def _dc_to_mean_u8(dc, transform: str, q_table: str, q_scale: float):
    """DC coefficient values -> uint8 block means (the 1/8-scale pixel).

    For any transform whose first row is a constant vector r0·1 (every
    shipped transform), the DC coefficient is round(r0²·Σ(x-128) /
    (Q00·q_scale)), so the block mean is DC·Q00·q_scale/(64·r0²) + 128
    (haweel: r0² = 1/8 → DC·Q00·q_scale/8 + 128)."""
    from tpudct.constants import get_q_table, get_transform

    row0 = get_transform(transform).t[0]
    if not np.allclose(row0, row0[0]):
        raise ValueError(f"transform {transform!r} has no flat DC row")
    q00 = float(get_q_table(q_table)[0, 0]) * q_scale
    mean = np.asarray(dc, np.float64) * q00 / (64.0 * float(row0[0] ** 2)) + 128.0
    return np.clip(np.trunc(mean), 0, 255).astype(np.uint8)


def preview_from_bytes(data: bytes) -> np.ndarray:
    """Instant 1/8-scale thumbnail from ANY .tdc stream: DC-only decode,
    no transform and no device work (math in :func:`_dc_to_mean_u8`).
    Spectral/xz streams decompress only the DC prefix and banded streams
    walk one segment at a time; interleaved codecs (rans/huffman/raw)
    entropy-decode whole and keep the DC terms.

    Banded streams (the archival layout) walk one segment at a time and
    keep only each segment's DC terms, so host residency is one decoded
    segment plus the (H/8, W/8) thumbnail — a beyond-HBM archive
    thumbnails without ever materializing its coefficient map (VERDICT
    r4 #1)."""
    (h, w, oh, ow, q_scale, _rk, tname, qname, code, psize, hsize,
     custom_q) = _parse_header_v4(data)
    transform = tname.rstrip(b"\x00").decode("ascii")
    if custom_q is not None:
        from tpudct.constants import register_q_table

        q_table = register_q_table(custom_q)
    else:
        q_table = qname.rstrip(b"\x00").decode("ascii")
    oh, ow = (oh or h), (ow or w)
    if code == _CODEC_BANDED:
        dc = np.empty((h // _BS, w // _BS), np.int16)
        for r0, rows, cmap in iter_banded_segments(
            data[hsize : hsize + psize], h, w, n_planes=1
        ):
            dc[r0 // _BS : (r0 + rows) // _BS] = cmap[::_BS, ::_BS]
            cmap = None  # release before the next segment decodes (arena reuse)
    else:
        p = partial_coefficients(data, n_planes=1)
        dc = p["coeffs"][::_BS, ::_BS]
    return _dc_to_mean_u8(dc, transform, q_table, float(q_scale))[
        : (oh + _BS - 1) // _BS, : (ow + _BS - 1) // _BS
    ]


def preview_color_from_bytes(data: bytes) -> np.ndarray:
    """Instant RGB thumbnail from ANY .tdcc stream: DC-only decode of
    all three planes, host arithmetic only (per-plane codec contract as
    in :func:`preview_from_bytes`).

    Returns (H/8, W/8, 3) uint8.  The Y plane previews at 1/8 scale;
    4:2:0 chroma DC planes land at 1/16 scale and upsample 2x nearest
    (exactly the resolution hierarchy a progressive JPEG viewer uses)."""
    from tpudct.utils.color import rgb_from_ycbcr_planes

    subsample, slices, _end = _color_plane_slices(data)
    y, cb, cr = (
        preview_from_bytes(s).astype(np.float64) for s in slices
    )
    if subsample == 1:  # 4:2:0
        cb = cb.repeat(2, 0).repeat(2, 1)
        cr = cr.repeat(2, 0).repeat(2, 1)
    elif subsample == 2:  # 4:2:2 — horizontal only
        cb = cb.repeat(2, 1)
        cr = cr.repeat(2, 1)
    h, w = y.shape
    cb, cr = cb[:h, :w], cr[:h, :w]
    # pad if the chroma preview rounds one pixel short of the luma grid
    if cb.shape != y.shape:
        cb = np.pad(cb, ((0, h - cb.shape[0]), (0, w - cb.shape[1])), mode="edge")
        cr = np.pad(cr, ((0, h - cr.shape[0]), (0, w - cr.shape[1])), mode="edge")
    r, g, b = rgb_from_ycbcr_planes(y, cb, cr)
    rgb = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


# ---- color (.tdcc) containers ---------------------------------------------


# subsample byte: 0 = 4:4:4 (none), 1 = 4:2:0 (legacy bool True), 2 = 4:2:2
_SUB_CODE = {False: 0, True: 1, "420": 1, "422": 2}


def color_container_from_blobs(meta: dict, plane_blob) -> bytes:
    """Assemble a .tdcc container from per-plane stream blobs.

    The ONE copy of the writer-side framing (header pack + plane order +
    q-table defaulting + per-plane length walk), shared by
    :func:`color_to_bytes` and the distributed
    `parallel.sharding.save_color_sharded` — their byte-identity
    contract holds structurally instead of only by test.
    ``plane_blob(name, q_table, orig_shape) -> bytes`` supplies each
    plane's .tdc stream."""
    h, w = meta["orig_shape"]
    yq = meta.get("y_q_table", "luma")
    cq = meta.get("c_q_table", "chroma")
    parts = [struct.pack(_HEADERC, _MAGICC, 3, _SUB_CODE[meta["subsample"]])]
    for name, q_table, oshape in (
        ("y", yq, (h, w)),
        ("cb", cq, meta["chroma_shape"]),
        ("cr", cq, meta["chroma_shape"]),
    ):
        blob = plane_blob(name, q_table, oshape)
        parts.append(struct.pack("<I", len(blob)))
        parts.append(blob)
    return b"".join(parts)


def color_to_bytes(
    planes: dict, meta: dict, q_scale: float = 1.0, retain_k=None,
    transform: str = "haweel", level: int = 6, codec: str = "auto",
) -> bytes:
    """Serialize models.color.encode_color output to a .tdcc stream.

    Plane q tables default to the (luma, chroma, chroma) convention;
    streams carrying their own tables (imported JPEGs, utils/jpegcoef.py)
    override via meta["y_q_table"] / meta["c_q_table"] (registered names —
    custom "q:..." names embed their 256-byte blocks per plane)."""
    return color_container_from_blobs(
        meta,
        lambda name, q_table, oshape: coefficients_to_bytes(
            planes[name], q_scale, retain_k, level=level, orig_shape=oshape,
            transform=transform, q_table=q_table, codec=codec,
        ),
    )


def is_tdc_stream(data: bytes) -> bool:
    """True when `data` starts with any grayscale .tdc container magic
    (current v4 or the legacy v2/v3 loaders' magics)."""
    return len(data) >= 4 and data[:4] in (_MAGIC2, _MAGIC3, _MAGIC4)


def is_color_stream(data: bytes) -> bool:
    return len(data) >= 4 and data[:4] == _MAGICC


def _color_plane_slices(data: bytes) -> tuple:
    """Walk the .tdcc container framing -> (subsample byte, [3 plane-stream
    slices], end offset).  The ONE copy of the header check + per-plane
    length walk, shared by the full parser, the progressive parser, the
    preview and the inspector — a framing change happens in one place."""
    hsize = struct.calcsize(_HEADERC)
    if not is_color_stream(data) or len(data) < hsize:
        raise ValueError("not a .tdcc color stream")
    (_m, n_planes, subsample) = struct.unpack(_HEADERC, data[:hsize])
    if n_planes != 3:
        raise ValueError(f"expected 3 planes, got {n_planes}")
    off = hsize
    slices = []
    for _ in range(3):
        if len(data) < off + 4:
            raise ValueError("truncated .tdcc color stream")
        (blen,) = struct.unpack("<I", data[off : off + 4])
        off += 4
        if len(data) < off + blen:
            raise ValueError("truncated .tdcc color stream")
        slices.append(data[off : off + blen])
        off += blen
    return subsample, slices, off


def bytes_to_color(data: bytes) -> tuple:
    """Parse a .tdcc stream -> ({plane: f32 coeffs}, meta).

    meta carries orig_shape / chroma_shape / subsample (decode geometry)
    plus q_scale / retain_k / transform (codec configuration, uniform
    across planes by construction)."""
    subsample, slices, _end = _color_plane_slices(data)
    parsed = []
    for s in slices:
        plane, used = _parse_plane(s)
        if used != len(s):
            raise ValueError("corrupt .tdcc plane length")
        parsed.append(plane)
    return _assemble_color(parsed, subsample)


def _assemble_color(parsed: list, subsample: int) -> tuple:
    """Cross-plane consistency checks + (planes, meta) assembly, shared by
    the full parser (`bytes_to_color`) and the progressive one
    (`partial_color_coefficients`)."""
    y, cb, cr = parsed
    same = lambda k: y[k] == cb[k] == cr[k]
    if not (same("transform") and same("q_scale") and same("retain_k")
            and cb["orig_shape"] == cr["orig_shape"]):
        raise ValueError("inconsistent .tdcc plane headers")
    if cb["q_table"] != cr["q_table"]:
        # decode_color dequantizes Cb and Cr in one fused pass against a
        # single table; divergent chroma tables would silently use the
        # wrong one for half the pass.
        raise ValueError(
            ".tdcc chroma planes must share a q_table, got "
            f"({cb['q_table']}, {cr['q_table']})"
        )
    planes = {"y": y["coeffs"], "cb": cb["coeffs"], "cr": cr["coeffs"]}
    meta = {
        "y_q_table": y["q_table"],
        "c_q_table": cb["q_table"],
        "orig_shape": y["orig_shape"],
        "chroma_shape": cb["orig_shape"],
        "subsample": {0: False, 1: "420", 2: "422"}.get(subsample, False),
        "q_scale": y["q_scale"],
        "retain_k": y["retain_k"],
        "transform": y["transform"],
    }
    return planes, meta


def partial_color_coefficients(data: bytes, n_planes: int = 1) -> tuple:
    """Progressive color decode: ({plane: f32 coeffs}, meta) from only the
    first `n_planes` zig-zag spectral planes of EACH .tdcc plane stream
    (the color analog of `partial_coefficients`; same per-codec contract
    per plane — prefix decode for spectral/xz/banded, decode-and-mask
    for interleaved codecs).  Feed the result to
    models.color.decode_color."""
    subsample, slices, _end = _color_plane_slices(data)
    return _assemble_color(
        [partial_coefficients(s, n_planes) for s in slices], subsample
    )


def save_color(
    path: str, planes: dict, meta: dict, q_scale: float = 1.0, retain_k=None,
    transform: str = "haweel", level: int = 6, codec: str = "auto",
) -> int:
    """Write a .tdcc file; returns bytes written (the measurable payload)."""
    data = color_to_bytes(planes, meta, q_scale, retain_k, transform,
                          level=level, codec=codec)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_color(path: str) -> tuple:
    """Read a .tdcc file -> ({plane: f32 coeffs}, meta)."""
    with open(path, "rb") as f:
        return bytes_to_color(f.read())
