"""JPEG I/O (grayscale + interleaved RGB).

Primary path: the native C codec (csrc/jpeg_codec.c, libjpeg via ctypes) —
the framework's equivalent of the reference's host utils
(load_jpeg_as_matrix utils.cu:38-95, save_grayscale_jpeg utils.cu:98-147).
The shared libraries are built on demand with the system compiler: the JPEG
codec (needs libjpeg) and, separately, the entropy coders (csrc/entropy.c,
no libjpeg), so a host without libjpeg headers still gets the native
entropy stages.  Fallback: PIL, so the framework degrades gracefully where
no C toolchain exists.
"""

from __future__ import annotations

import ctypes
import io
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_CSRC = pathlib.Path(__file__).resolve().parent.parent.parent / "csrc"
_LIB_PATH = _CSRC / "libdctjpeg.so"
_ENTROPY_LIB_PATH = _CSRC / "libdctentropy.so"
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_elib: Optional[ctypes.CDLL] = None
_elib_tried = False
_lib_lock = threading.Lock()


def _build_native(force: bool = False, target: pathlib.Path = _LIB_PATH) -> bool:
    """Build (or freshen) one shared library.  `make` owns the staleness
    check — a fresh .so makes this a no-op, an edited source rebuilds (the
    .so files are build artifacts, not tracked in git)."""
    if not (_CSRC / "Makefile").exists():
        return target.exists()
    try:
        cmd = ["make", "-C", str(_CSRC), target.name] + (["-B"] if force else [])
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        pass  # no toolchain / no libjpeg: fall through to any existing .so
    return target.exists()


def _load_entropy() -> Optional[ctypes.CDLL]:
    """The native entropy coders (csrc/entropy.c), or None."""
    global _elib, _elib_tried
    with _lib_lock:
        if not _elib_tried:
            _elib_tried = True
            if _build_native(target=_ENTROPY_LIB_PATH):
                try:
                    _elib = ctypes.CDLL(str(_ENTROPY_LIB_PATH))
                except OSError:
                    _elib = None
        return _elib


#: Must match csrc/jpeg_codec.c tpudct_abi_version() — bump BOTH when any
#: exported C signature changes; the loader rebuilds on mismatch.
_ABI_VERSION = 5


def _abi_ok(lib) -> bool:
    if not hasattr(lib, "tpudct_abi_version"):
        return False
    lib.tpudct_abi_version.restype = ctypes.c_int
    return int(lib.tpudct_abi_version()) == _ABI_VERSION


def _load_native() -> Optional[ctypes.CDLL]:
    # Coders call the loaders from thread pools: without the lock, threads
    # arriving while the first one builds a library saw "no library" and
    # silently chose another stage.
    with _lib_lock:
        return _load_native_locked()


def _load_native_locked() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("TPUDCT_NO_NATIVE_JPEG"):
        return None
    if not _build_native():
        return None
    try:
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            # e.g. a binary built against a different libjpeg soname:
            # force one rebuild from source before giving up.
            if not _build_native(force=True):
                return None
            lib = ctypes.CDLL(str(_LIB_PATH))
        if not _abi_ok(lib):
            # Stale prebuilt library from older sources (missing or
            # mismatched ABI version): rebuild once.
            subprocess.run(
                ["make", "-C", str(_CSRC), "-B", _LIB_PATH.name],
                check=True, capture_output=True, timeout=120,
            )
            # dlopen caches by path/inode while the first handle is alive
            # (cc -o rewrites in place), so load the rebuilt file through a
            # unique temp copy to guarantee a fresh mapping.
            import shutil
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".so", delete=False) as tmp:
                shutil.copy2(_LIB_PATH, tmp.name)
            try:
                lib = ctypes.CDLL(tmp.name)
            finally:
                # The mapping survives the unlink on Linux; don't leak /tmp copies.
                os.unlink(tmp.name)
            if not _abi_ok(lib):
                return None
    except (OSError, subprocess.SubprocessError):
        return None
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lib.tpudct_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(u8p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tpudct_jpeg_decode.restype = ctypes.c_int
    lib.tpudct_jpeg_encode.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int
    ]
    lib.tpudct_jpeg_encode.restype = ctypes.c_int
    lib.tpudct_jpeg_encode_ch.argtypes = [
        ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.tpudct_jpeg_encode_ch.restype = ctypes.c_int
    lib.tpudct_jpeg_encode_mem.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_ulong),
    ]
    lib.tpudct_jpeg_encode_mem.restype = ctypes.c_int
    lib.tpudct_free.argtypes = [u8p]
    lib.tpudct_free.restype = None
    lib.tpudct_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.tpudct_jpeg_decode_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_backend_available() -> bool:
    return _load_native() is not None


def load_jpeg(path: str, force_gray: bool = True) -> np.ndarray:
    """Decode a JPEG to a (H, W) uint8 array (grayscale).

    Unlike the reference loader — which returns native channels and whose
    drivers then treat RGB data as single-channel (utils.cu:70-72 with
    main_cublass.cu:50-57) — RGB inputs are converted to luminance
    in-codec.
    """
    lib = _load_native()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_ubyte)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        ch = ctypes.c_int()
        rc = lib.tpudct_jpeg_decode(
            str(path).encode(), ctypes.byref(out), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(ch), 1 if force_gray else 0,
        )
        if rc != 0:
            raise IOError(f"native JPEG decode failed (rc={rc}) for {path}")
        try:
            n = h.value * w.value * ch.value
            arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
        finally:
            lib.tpudct_free(out)
        if ch.value == 1:
            return arr.reshape(h.value, w.value)
        return arr.reshape(h.value, w.value, ch.value)
    from PIL import Image

    img = Image.open(path)
    if force_gray:
        img = img.convert("L")
    return np.asarray(img)


def load_jpeg_batch(
    paths, n_threads: int = 0, force_gray: bool = True, errors: str = "raise"
) -> list:
    """Decode many JPEGs in parallel via the C pthread pool.

    The data-loader path: device time is ~0.1 ms/image, so host decode
    dominates bulk encoding — the native pool decodes with true parallelism
    (one libjpeg context per thread, no GIL).  Returns a list of (H, W)
    uint8 arrays in input order.  n_threads=0 = one per CPU (capped at 16).
    errors="raise" (default) raises on the first failed file;
    errors="none" returns None at failed positions — the bulk-encoder mode,
    where one corrupt file must not abort a million-image job.  Falls back
    to sequential load_jpeg when the native codec is unavailable.
    """
    if errors not in ("raise", "none"):
        raise ValueError(f"errors must be 'raise' or 'none', got {errors!r}")
    paths = [str(p) for p in paths]
    lib = _load_native()
    if lib is None or not paths:
        out = []
        for p_ in paths:
            try:
                out.append(load_jpeg(p_, force_gray))
            except Exception:
                if errors == "raise":
                    raise
                out.append(None)
        return out
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 4, 16)

    n = len(paths)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (u8p * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    chs = (ctypes.c_int * n)()
    rcs = (ctypes.c_int * n)()
    lib.tpudct_jpeg_decode_batch(
        names, n, n_threads, outs, ws, hs, chs, rcs, 1 if force_gray else 0
    )
    images = [None] * n
    err = None
    try:
        for i in range(n):
            if rcs[i] != 0:
                err = err or IOError(
                    f"native JPEG decode failed (rc={rcs[i]}) for {paths[i]}"
                )
                continue
            cnt = hs[i] * ws[i] * chs[i]
            arr = np.ctypeslib.as_array(outs[i], shape=(cnt,)).copy()
            shape = (hs[i], ws[i]) if chs[i] == 1 else (hs[i], ws[i], chs[i])
            images[i] = arr.reshape(shape)
    finally:
        for i in range(n):
            if outs[i]:
                lib.tpudct_free(outs[i])
    if err is not None and errors == "raise":
        raise err
    return images


def save_jpeg(path: str, image: np.ndarray, quality: int = 100) -> None:
    """Encode a (H, W) grayscale or (H, W, 3) RGB uint8 array to a JPEG file.

    quality=100 matches the reference drivers' output setting
    (main_cublass.cu:152).  The RGB form serves the color extension — the
    reference has no color output path at all (utils.cu:70-72 forces
    grayscale at load).
    """
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        ch = 1
    elif image.ndim == 3 and image.shape[2] == 3:
        ch = 3
    else:
        raise ValueError(f"expected (H, W) grayscale or (H, W, 3) RGB, got {image.shape}")
    lib = _load_native()
    if lib is not None:
        h, w = image.shape[:2]
        rc = lib.tpudct_jpeg_encode_ch(
            str(path).encode(),
            image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h, ch,
            quality,
        )
        if rc != 0:
            raise IOError(f"native JPEG encode failed (rc={rc}) for {path}")
        return
    from PIL import Image

    Image.fromarray(image, mode="L" if ch == 1 else "RGB").save(
        path, format="JPEG", quality=quality
    )


def encode_jpeg_bytes(image: np.ndarray, quality: int = 100) -> bytes:
    """Encode to an in-memory JPEG (for compressed-size measurement).

    Accepts (H, W) grayscale or (H, W, 3) interleaved RGB — the RGB form
    rides libjpeg's standard color path (YCbCr + 4:2:0 by default), the
    anchor the color BD-rate comparison measures against (round 5)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        ch = 1
    elif image.ndim == 3 and image.shape[2] == 3:
        ch = 3
    else:
        raise ValueError(
            f"expected (H, W) grayscale or (H, W, 3) RGB, got {image.shape}"
        )
    lib = _load_native()
    if lib is not None:
        h, w = image.shape[:2]
        out = ctypes.POINTER(ctypes.c_ubyte)()
        size = ctypes.c_ulong()
        rc = lib.tpudct_jpeg_encode_mem(
            image.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h, ch,
            quality, ctypes.byref(out), ctypes.byref(size),
        )
        if rc != 0:
            raise IOError(f"native in-memory JPEG encode failed (rc={rc})")
        try:
            return bytes(np.ctypeslib.as_array(out, shape=(size.value,)))
        finally:
            lib.tpudct_free(out)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image, mode="L" if ch == 1 else "RGB").save(
        buf, format="JPEG", quality=quality
    )
    return buf.getvalue()


# ---- extension-dispatched I/O ----------------------------------------------

JPEG_EXTS = frozenset({".jpg", ".jpeg", ".jpe", ".jfif"})
# .npy: raw uint8 raster as a NumPy array file — lossless, memmap-friendly
# (the streamed CLI decode open_memmap's it so beyond-RAM rasters write to
# disk band by band without ever residing in host memory, VERDICT r4 #2)
LOSSLESS_EXTS = frozenset({".png", ".bmp", ".tif", ".tiff", ".npy"})
SUPPORTED_EXTS = JPEG_EXTS | LOSSLESS_EXTS
_JPEG_EXTS = JPEG_EXTS  # backward-compat alias


def load_image(path: str, force_gray: bool = True) -> np.ndarray:
    """Load any common image format: JPEGs ride the native libjpeg path
    (`load_jpeg`), everything else (.png, .bmp, .tiff, ...) decodes via PIL;
    .npy rasters memory-map read-only (mmap_mode="r", so a
    larger-than-RAM raster written by the streamed decode loads lazily).

    Beyond-parity: the reference reads JPEG only (utils.cu:38-95).  Note
    the PIL branch's gray conversion uses the same BT.601 weights as
    `load_jpeg`'s in-codec path but a different rounding rule (PIL
    truncates where libjpeg rounds), so identical pixel content stored as
    PNG vs JPEG can convert with ±1 per-pixel differences."""
    ext = pathlib.Path(path).suffix.lower()
    if ext in JPEG_EXTS:
        return load_jpeg(path, force_gray=force_gray)
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r")
        if force_gray and arr.ndim == 3:
            # BT.601 with libjpeg-style rounding, matching load_jpeg —
            # converted in ROW BANDS so a larger-than-RAM raster written
            # by the streamed decoders never materializes f64 temporaries
            # whole (review finding: the one-shot astype defeated the
            # memmap's beyond-RAM purpose)
            out = np.empty(arr.shape[:2], np.uint8)
            # ~64 MB of f64 temporaries per band: 3 channels x 8 bytes
            step = max(1, (64 << 20) // max(1, arr.shape[1] * 24))
            for r0 in range(0, arr.shape[0], step):
                a = arr[r0 : r0 + step].astype(np.float64)
                out[r0 : r0 + step] = np.clip(np.floor(
                    0.299 * a[..., 0] + 0.587 * a[..., 1]
                    + 0.114 * a[..., 2] + 0.5
                ), 0, 255).astype(np.uint8)
            return out
        return arr
    from PIL import Image

    img = Image.open(path)
    if force_gray:
        img = img.convert("L")
    elif img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    return np.asarray(img)


def probe_image_size(path: str):
    """(height, width) from the file header only — no pixel decode.

    Used by the bulk commands to bound per-wave host residency before
    loading anything.  Returns None when the header can't be read (the
    caller treats the file as size-unknown; the actual load surfaces the
    error with the per-file recovery contract)."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            w, h = img.size
        return h, w
    except (OSError, ValueError):
        return None


def save_image(path: str, image: np.ndarray, quality: int = 100) -> None:
    """Save dispatched on extension: .jpg/.jpeg goes through `save_jpeg`
    (native libjpeg, `quality` honored — the reference's output path);
    the LOSSLESS_EXTS formats (.png/.bmp/.tiff) save losslessly via PIL,
    so `decode out.png` yields the EXACT reconstruction with no second
    JPEG generation loss (JPEG quality-100 is near-lossless, not
    lossless).  Other extensions are refused rather than silently routed
    through a lossy PIL default (e.g. .webp saves quality-80)."""
    ext = pathlib.Path(path).suffix.lower()
    if ext in JPEG_EXTS:
        return save_jpeg(path, image, quality=quality)
    if ext == ".npy":
        # raw raster container (lossless; the streamed decoders write it
        # incrementally via open_memmap — this whole-array path is for the
        # in-memory decodes' parity with them)
        return np.save(path, np.ascontiguousarray(image, dtype=np.uint8))
    if ext not in LOSSLESS_EXTS:
        # extensionless paths are refused too — silently writing a LOSSY
        # jpeg to a bare name would contradict the policy above
        raise ValueError(
            f"unsupported output extension {ext!r}: use one of "
            f"{sorted(JPEG_EXTS)} (lossy, quality honored) or "
            f"{sorted(LOSSLESS_EXTS)} (lossless)"
        )
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        mode = "L"
    elif image.ndim == 3 and image.shape[2] == 3:
        mode = "RGB"
    else:
        raise ValueError(
            f"expected (H, W) grayscale or (H, W, 3) RGB, got {image.shape}"
        )
    from PIL import Image

    Image.fromarray(image, mode=mode).save(path)
