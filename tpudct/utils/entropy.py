"""JPEG-grade Huffman entropy stage for coefficient maps (.tdc codec 2).

Native path: csrc/entropy.c (optimal canonical Huffman + per-block
zig-zag (run,size) coding, the ITU-T T.81 §F / §K.2 scheme libjpeg runs
under -optimize), loaded through the same shared library as the JPEG
codec.  Encoding requires the native library; decoding falls back to a
pure-Python bit reader so .tdc files written with this codec stay
readable on toolchain-less hosts (slow, but correct — asserted equal to
the native decoder in tests).

The reference has no entropy stage at all (its storage model is a
libjpeg re-encode of the RECONSTRUCTION, utils.cu:98-147; the actual
compressed payload never leaves device memory — SURVEY.md §5).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_ZZ = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)


def _lib() -> Optional[ctypes.CDLL]:
    from tpudct.utils.imageio import _load_entropy

    lib = _load_entropy()
    if lib is None or not hasattr(lib, "tpudct_huff_encode"):
        return None
    if not getattr(lib, "_tpudct_huff_configured", False):
        lib.tpudct_huff_encode.restype = ctypes.c_long
        lib.tpudct_huff_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long,
        ]
        lib.tpudct_huff_decode.restype = ctypes.c_int
        lib.tpudct_huff_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        if hasattr(lib, "tpudct_rans_encode"):
            lib.tpudct_rans_encode.restype = ctypes.c_long
            lib.tpudct_rans_encode.argtypes = [
                *lib.tpudct_huff_encode.argtypes,
                ctypes.c_int,  # force_bands
                ctypes.c_int,  # interleave (0/1 serial, 4 = v4 opt-in)
            ]
            lib.tpudct_rans_decode.restype = ctypes.c_int
            lib.tpudct_rans_decode.argtypes = lib.tpudct_huff_decode.argtypes
        lib._tpudct_huff_configured = True
    return lib


def native_entropy_available() -> bool:
    return _lib() is not None


def huff_encode(coeffs: np.ndarray) -> bytes:
    """(H, W) int16 coefficient map -> Huffman stream.  Native-only."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native entropy codec unavailable (csrc not built)")
    c = np.ascontiguousarray(coeffs, np.int16)
    h, w = c.shape
    if h % 8 or w % 8:
        raise ValueError(f"coefficient map {h}x{w} is not block-aligned")
    # worst case approaches 4 bytes/coeff (~26 bits/AC symbol, 33-bit DC
    # path) — do not shrink this below 4 or valid encodes start failing
    cap = int(c.size * 4 + 4096)
    out = np.empty(cap, np.uint8)
    n = lib.tpudct_huff_encode(
        c.ctypes.data, h, w, out.ctypes.data, cap
    )
    if n < 0:
        raise ValueError("huffman encode failed")
    return out[:n].tobytes()


def huff_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """Huffman stream -> (H, W) int16 coefficient map.

    Uses the native decoder when available, else the Python fallback."""
    lib = _lib()
    if lib is not None:
        buf = np.frombuffer(data, np.uint8)
        out = np.empty((h, w), np.int16)
        rc = lib.tpudct_huff_decode(
            buf.ctypes.data, len(data), h, w, out.ctypes.data
        )
        if rc != 0:
            raise ValueError(f"corrupt huffman coefficient stream ({rc})")
        return out
    return _py_decode(data, h, w)


# ---- pure-Python fallback decoder -------------------------------------------


class _Reader:
    def __init__(self, data: bytes, nbits: int):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))[:nbits]
        self.pos = 0

    def bit(self) -> int:
        if self.pos >= len(self.bits):
            raise ValueError("corrupt huffman coefficient stream (EOF)")
        b = int(self.bits[self.pos])
        self.pos += 1
        return b

    def take(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


class _Table:
    def __init__(self, bits, huffval):
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        self.huffval = huffval
        code = k = 0
        for i in range(1, 17):
            self.valptr[i] = k
            self.mincode[i] = code
            code += bits[i]
            k += bits[i]
            if code > (1 << i):
                # per-length counts overflow the canonical code space —
                # same rejection as the native dec_lut (a corrupt table
                # would otherwise index huffval out of range in sym())
                raise ValueError(
                    "corrupt huffman coefficient stream (table)"
                )
            self.maxcode[i] = code - 1 if bits[i] else -1
            code <<= 1

    def sym(self, r: _Reader) -> int:
        code = r.bit()
        i = 1
        while self.maxcode[i] < 0 or code > self.maxcode[i]:
            i += 1
            if i > 16:
                raise ValueError("corrupt huffman coefficient stream (code)")
            code = (code << 1) | r.bit()
        idx = self.valptr[i] + code - self.mincode[i]
        if idx >= len(self.huffval):
            raise ValueError("corrupt huffman coefficient stream (code)")
        return self.huffval[idx]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _py_decode(data: bytes, h: int, w: int) -> np.ndarray:
    if h % 8 or w % 8:
        raise ValueError(f"coefficient map {h}x{w} is not block-aligned")
    if len(data) < 17 or data[0] != 1:
        raise ValueError("corrupt huffman coefficient stream (header)")
    dbits = [0] + list(data[1:17])
    ndc = sum(dbits)
    if ndc > 256:  # parity with the C decoder's -4 (ndc > NSYM)
        raise ValueError("corrupt huffman coefficient stream (DC table)")
    dval = list(data[17 : 17 + ndc])
    abits = [0] + list(data[17 + ndc : 33 + ndc])
    nac = sum(abits)
    if nac > 256:
        raise ValueError("corrupt huffman coefficient stream (AC table)")
    aval = list(data[33 + ndc : 33 + ndc + nac])
    off = 33 + ndc + nac
    if len(data) < off + 4:
        raise ValueError("corrupt huffman coefficient stream (length)")
    nbits = int.from_bytes(data[off : off + 4], "little")
    if (len(data) - off - 4) * 8 < nbits:
        # parity with the C decoder's upfront -4 length check: the u32
        # field must not claim more bits than the payload holds
        raise ValueError("corrupt huffman coefficient stream (length)")
    r = _Reader(data[off + 4 :], nbits)
    dct, act = _Table(dbits, dval), _Table(abits, aval)
    out = np.zeros((h, w), np.int16)
    prev = 0
    for by in range(h // 8):
        for bx in range(w // 8):
            s = dct.sym(r)
            if s > 17:  # DC size bound (int16 deltas); parity with the C -5
                raise ValueError("corrupt huffman coefficient stream (DC)")
            prev += _extend(r.take(s), s) if s else 0
            # int16 wraparound parity with the C decoder on adversarial
            # streams whose DC deltas accumulate out of range (numpy would
            # raise OverflowError on a plain assignment instead).
            out[by * 8, bx * 8] = ((prev + 32768) & 0xFFFF) - 32768
            k = 1
            while k < 64:
                sym = act.sym(r)
                if sym == 0x00:
                    break
                if sym == 0xF0:
                    k += 16
                    continue
                k += sym >> 4
                size = sym & 15
                if k > 63:
                    raise ValueError("corrupt huffman coefficient stream (run)")
                zz = _ZZ[k]
                out[by * 8 + (zz >> 3), bx * 8 + (zz & 7)] = _extend(
                    r.take(size), size
                )
                k += 1
    return out


# ---- rANS stage (.tdc codec 3) ----------------------------------------------
#
# Same T.81 symbolization, entropy-coded with a static byte-wise rANS
# (Duda 2013) instead of prefix codes, with positional contexts: one
# frequency table for DC sizes plus per-zig-zag-band AC tables — three
# bands in stream v2 (k in [1,5] / [6,20] / [21,63]), six in stream v3
# (k in [1,2] / [3,5] / [6,10] / [11,20] / [21,35] / [36,63]; measured
# -1.5% to -3.5% over v2 net of table overhead).  Sub-bit symbol costs +
# positional modeling measure 4-9% smaller than the optimal-Huffman
# stage on real coefficient maps (a size ratio, host-side).  The
# encoder is version-ADAPTIVE: it costs both layouts from one histogram
# pass (Shannon bits + table bytes) and emits the smaller — tiny maps
# keep v2, where the three extra tables outweigh the model gain; both
# decoders accept v2 and v3.  Streams split the
# block rows into up to 16 bands that encode/decode on one pthread each
# (tables stay global; DC prediction and rANS state reset per band, so
# bands are fully independent).  The default band count is capped by the
# online CPU count — this CI host exposes ONE core, where 16 forced bands
# measured -17% decode (table-locality overhead) and 1-16 bands are
# otherwise within noise; the parallel win is architectural headroom for
# multi-core serving hosts, not a number measurable here.  Encoding is
# native-only (like Huffman); decoding falls back to pure Python
# (sequential bands).

_RANS_BITS = 12
_RANS_M = 1 << _RANS_BITS
_RANS_L = 1 << 23


def rans_available() -> bool:
    lib = _lib()
    return lib is not None and hasattr(lib, "tpudct_rans_encode")


def rans_encode(coeffs: np.ndarray, bands: int = 0, interleave: int = 0) -> bytes:
    """(H, W) int16 coefficient map -> rANS stream.  Native-only.

    bands: 0 (default) = size-based band count (~1 pthread band per
    4 Mpixel, up to 16); 1..16 = explicit count (tests / tuning).
    interleave: 0/1 (default) = single-state v2/v3 stream; 4 = the 4-way
    interleaved v4 stream — an OPT-IN, not the default, because on a
    1-core host the interleaved decoder measured 0.72-0.89x the serial
    one (the decode loop is throughput-bound, not state-chain-bound).
    Sizes differ by only the flags byte + three extra seeds per band;
    every decoder (both C workers and the Python fallback) reads both."""
    lib = _lib()
    if lib is None or not hasattr(lib, "tpudct_rans_encode"):
        raise RuntimeError("native entropy codec unavailable (csrc not built)")
    c = np.ascontiguousarray(coeffs, np.int16)
    h, w = c.shape
    if h % 8 or w % 8:
        raise ValueError(f"coefficient map {h}x{w} is not block-aligned")
    if not 0 <= bands <= 16:
        raise ValueError(f"bands must be in 0..16, got {bands}")
    if interleave not in (0, 1, 4):
        raise ValueError(f"interleave must be 0, 1 or 4, got {interleave}")
    cap = int(c.size * 4 + 65536)
    out = np.empty(cap, np.uint8)
    n = lib.tpudct_rans_encode(
        c.ctypes.data, h, w, out.ctypes.data, cap, bands, interleave
    )
    if n < 0:
        raise ValueError("rans encode failed")
    return out[:n].tobytes()


def rans_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """rANS stream -> (H, W) int16 coefficient map.

    Native decoder when available, else the pure-Python fallback."""
    lib = _lib()
    if lib is not None and hasattr(lib, "tpudct_rans_decode"):
        buf = np.frombuffer(data, np.uint8)
        out = np.empty((h, w), np.int16)
        rc = lib.tpudct_rans_decode(
            buf.ctypes.data, len(data), h, w, out.ctypes.data
        )
        if rc != 0:
            raise ValueError(f"corrupt rans coefficient stream ({rc})")
        return out
    return _py_rans_decode(data, h, w)


def _rans_ctx_of(table: int, k: int, version: int = 2) -> int:
    if table == 0:
        return 0
    if version == 2:
        if k <= 5:
            return 1
        if k <= 20:
            return 2
        return 3
    if k <= 2:
        return 1
    if k <= 5:
        return 2
    if k <= 10:
        return 3
    if k <= 20:
        return 4
    if k <= 35:
        return 5
    return 6


class _RansTable:
    def __init__(self, entries):
        # entries: list of (symbol, freq); freqs sum to _RANS_M when present
        self.empty = not entries
        self.freq = np.zeros(256, np.uint32)
        self.start = np.zeros(256, np.uint32)
        self.slot = np.zeros(_RANS_M, np.uint8)
        pos = 0
        for s, f in entries:
            if f == 0 or self.freq[s]:
                raise ValueError("corrupt rans coefficient stream (table)")
            self.freq[s] = f
            self.start[s] = pos
            if pos + f > _RANS_M:
                raise ValueError("corrupt rans coefficient stream (table)")
            self.slot[pos : pos + f] = s
            pos += f
        if entries and pos != _RANS_M:
            raise ValueError("corrupt rans coefficient stream (table)")


class _RansState:
    """Single- or N-way-interleaved rANS reader over one shared byte
    stream (n > 1 = the v4 layout: symbol i rides state i mod n)."""

    def __init__(self, stream: bytes, nstates: int = 1):
        if len(stream) < 4 * nstates:
            raise ValueError("corrupt rans coefficient stream (state)")
        self.b = stream
        self.states = [
            int.from_bytes(stream[4 * j : 4 * j + 4], "big")
            for j in range(nstates)
        ]
        self.pos = 4 * nstates
        self.i = 0
        self.n = nstates

    def next(self, t: _RansTable) -> int:
        if t.empty:
            raise ValueError("corrupt rans coefficient stream (ctx)")
        j = self.i % self.n
        self.i += 1
        state = self.states[j]
        slot = state & (_RANS_M - 1)
        s = int(t.slot[slot])
        state = int(t.freq[s]) * (state >> _RANS_BITS) + slot - int(t.start[s])
        while state < _RANS_L:
            if self.pos >= len(self.b):
                raise ValueError("corrupt rans coefficient stream (EOF)")
            state = (state << 8) | self.b[self.pos]
            self.pos += 1
        self.states[j] = state
        return s


def _py_rans_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """Pure-Python decoder for the v2/v3 multi-band streams
    (csrc/entropy.c layout comment); bands decode sequentially here —
    band parallelism is the native decoder's job."""
    if h % 8 or w % 8:
        raise ValueError(f"coefficient map {h}x{w} is not block-aligned")
    if len(data) < 6 or data[0] not in (2, 3, 4):
        raise ValueError("corrupt rans coefficient stream (header)")
    version = data[0]
    nstates = 1
    if version == 4:  # interleaved layout; context choice in the flags byte
        if len(data) < 7:
            raise ValueError("corrupt rans coefficient stream (header)")
        nstates = data[1] & 0x0F
        if nstates != 4:
            raise ValueError("corrupt rans coefficient stream (states)")
        ctxv = 3 if data[1] & 0x10 else 2
        data = data[1:]  # the v2/v3 field layout follows the flags byte
    else:
        ctxv = version
    nctx = 4 if ctxv == 2 else 7
    nbands = data[1]
    rpb = int.from_bytes(data[2:6], "little")
    if not (1 <= nbands <= 16) or rpb % 8 or rpb < 8:
        raise ValueError("corrupt rans coefficient stream (bands)")
    if nbands > 1 and rpb * (nbands - 1) >= h:
        raise ValueError("corrupt rans coefficient stream (bands)")
    if nbands == 1 and rpb > h:  # exact parity with the native -3 check
        raise ValueError("corrupt rans coefficient stream (bands)")
    pos = 6
    tabs = []
    for _ in range(nctx):
        if pos + 2 > len(data):
            raise ValueError("corrupt rans coefficient stream (header)")
        ne = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        if ne > 256 or pos + 3 * ne > len(data):
            raise ValueError("corrupt rans coefficient stream (header)")
        entries = []
        for _i in range(ne):
            entries.append(
                (data[pos], int.from_bytes(data[pos + 1 : pos + 3], "little"))
            )
            pos += 3
        tabs.append(_RansTable(entries))
    if pos + 8 * nbands > len(data):
        raise ValueError("corrupt rans coefficient stream (length)")
    lens = []
    for _ in range(nbands):
        rans_n = int.from_bytes(data[pos : pos + 4], "little")
        nbits = int.from_bytes(data[pos + 4 : pos + 8], "little")
        pos += 8
        if rans_n < 4 * nstates:
            raise ValueError("corrupt rans coefficient stream (length)")
        lens.append((rans_n, nbits))
    out = np.zeros((h, w), np.int16)
    off = pos
    for bi in range(nbands):
        rans_n, nbits = lens[bi]
        xb = (nbits + 7) // 8
        if off + rans_n + xb > len(data):
            raise ValueError("corrupt rans coefficient stream (length)")
        st = _RansState(data[off : off + rans_n], nstates)
        r = _Reader(data[off + rans_n : off + rans_n + xb], nbits)
        off += rans_n + xb
        row0 = rpb * bi
        rows = h - row0 if bi == nbands - 1 else rpb
        prev = 0  # DC prediction resets per band (band independence)
        for by in range(row0 // 8, (row0 + rows) // 8):
            for bx in range(w // 8):
                s = st.next(tabs[0])
                if s > 17:
                    raise ValueError("corrupt rans coefficient stream (DC)")
                prev += _extend(r.take(s), s) if s else 0
                out[by * 8, bx * 8] = ((prev + 32768) & 0xFFFF) - 32768
                k = 1
                while k < 64:
                    sym = st.next(tabs[_rans_ctx_of(1, k, ctxv)])
                    if sym == 0x00:
                        break
                    if sym == 0xF0:
                        k += 16
                        continue
                    size = sym & 15
                    if not size:
                        raise ValueError("corrupt rans coefficient stream (size)")
                    k += sym >> 4
                    if k > 63:
                        raise ValueError("corrupt rans coefficient stream (run)")
                    zz = _ZZ[k]
                    out[by * 8 + (zz >> 3), bx * 8 + (zz & 7)] = _extend(
                        r.take(size), size
                    )
                    k += 1
    return out
