"""Transform and quantization constants.

The reference hardcodes two 8x8 float arrays in every translation unit
(T: /root/reference/main.cu:135-143, Q: /root/reference/main.cu:122-130;
duplicated in all 9 TUs).  Here there is exactly one copy of each, plus a
first-principles derivation of T used by the test-suite to prove the
literals are the Haweel et al. (2016) signed/sparse orthogonal DCT
approximation (reference README.md:9,22).

T factors as ``T = D @ Ts`` where ``Ts`` is an integer matrix with entries
in {0, +-1, +-2} (the multiplierless add/shift core) and ``D`` is the
diagonal of reciprocal row norms.  The `fast` pipeline exploits this
factorization to run the core contraction in int8 on the MXU.
"""

from __future__ import annotations

import numpy as np

BLOCK_SIZE = 8

# Signed integer core of the Haweel approximate DCT.  Row r of the reference
# T matrix (main.cu:135-143) equals HAWEEL_TS[r] / ||HAWEEL_TS[r]||_2.
HAWEEL_TS = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 0, 0, 0, 0, -1, -1],
        [2, 1, -1, -2, -2, -1, 1, 2],
        [0, 0, -1, 0, 0, 1, 0, 0],
        [1, -1, -1, 1, 1, -1, -1, 1],
        [1, -1, 0, 0, 0, 0, 1, -1],
        [1, -2, 2, -1, -1, 2, -2, 1],
        [0, 0, 0, -1, 1, 0, 0, 0],
    ],
    dtype=np.int8,
)

# The float literals exactly as hardcoded in the reference (main.cu:135-143,
# main_newAppr.cu:73-81, ...).  These are the canonical runtime values so the
# new framework is bit-compatible with the reference's arithmetic inputs.
T = np.array(
    [
        [0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339, 0.35355339],
        [0.5, 0.5, 0.0, 0.0, 0.0, 0.0, -0.5, -0.5],
        [0.4472136, 0.2236068, -0.2236068, -0.4472136, -0.4472136, -0.2236068, 0.2236068, 0.4472136],
        [0.0, 0.0, -0.70710678, 0.0, 0.0, 0.70710678, 0.0, 0.0],
        [0.35355339, -0.35355339, -0.35355339, 0.35355339, 0.35355339, -0.35355339, -0.35355339, 0.35355339],
        [0.5, -0.5, 0.0, 0.0, 0.0, 0.0, 0.5, -0.5],
        [0.2236068, -0.4472136, 0.4472136, -0.2236068, -0.2236068, 0.4472136, -0.4472136, 0.2236068],
        [0.0, 0.0, 0.0, -0.70710678, 0.70710678, 0.0, 0.0, 0.0],
    ],
    dtype=np.float32,
)

# Standard JPEG luminance quantization table (main.cu:122-130).
Q = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)

QC = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)
"""Standard JPEG chrominance quantization table (ITU-T T.81 Table K.2).

The reference is grayscale-only (utils.cu:70-72 forces luminance) and
carries only the luminance table; the color extension quantizes Cb/Cr
blocks against this table, exactly as baseline JPEG does."""

Q_TABLES = {"luma": Q, "chroma": QC}


def get_q_table(name: str) -> np.ndarray:
    try:
        return Q_TABLES[name]
    except KeyError:
        raise KeyError(
            f"unknown quantization table {name!r}; available: {sorted(Q_TABLES)}"
        ) from None


def register_q_table(table, name: str | None = None) -> str:
    """Register a custom 8x8 quantization table; returns its name.

    The reference hardcodes one table in 9 TUs (main.cu:122-133); here any
    JPEG-style table (mozjpeg tuned tables, camera tables, ...) threads
    through every pipeline — including the fused int8 Pallas kernels, whose
    u8-path eligibility (`hp_pallas.supports_u8`) recomputes the int8
    coefficient bound from the actual table and falls back to f32 when it
    doesn't fit.

    Without an explicit `name`, a content-derived name "q:xxxxxx" (24-bit
    blake2s of the f32 values) is used: deterministic across processes —
    what the .tdc container stores (utils/serialize.py embeds the values
    for non-builtin names).  Re-registering the same values is a no-op;
    registering DIFFERENT values under an existing name raises, which keeps
    the name-keyed kernel-constant lru caches sound.
    """
    import hashlib

    # np.array forces a COPY (ascontiguousarray would alias a contiguous f32
    # input, letting later caller-side mutation desynchronize the registry
    # from the content-derived name and the name-keyed kernel-const caches);
    # write-protect so in-place mutation of the registered table raises.
    t = np.array(table, dtype=np.float32)
    t.setflags(write=False)
    if t.shape != (BLOCK_SIZE, BLOCK_SIZE):
        raise ValueError(f"q_table must be 8x8, got shape {t.shape}")
    if not np.isfinite(t).all() or (t <= 0).any():
        raise ValueError("q_table entries must be finite and > 0")
    if name is None:
        name = "q:" + hashlib.blake2s(t.tobytes(), digest_size=3).hexdigest()
    if not name or len(name.encode("ascii", "replace")) > 8:
        raise ValueError(f"q_table name {name!r} must be 1-8 ASCII bytes")
    existing = Q_TABLES.get(name)
    if existing is not None:
        if not np.array_equal(existing, t):
            raise ValueError(
                f"q_table {name!r} is already registered with different values"
            )
        return name
    Q_TABLES[name] = t
    return name


LEVEL_SHIFT = 128.0  # sub_matrix_scalar / add_matrix_scalar operand (utils_kernels.cu:8-31)


def haweel_row_norms() -> np.ndarray:
    """Euclidean norms of the integer-core rows: (2*sqrt2, 2, sqrt20, sqrt2, ...)."""
    return np.sqrt((HAWEEL_TS.astype(np.float64) ** 2).sum(axis=1))


def haweel_integer_core() -> np.ndarray:
    """The {0,+-1,+-2} integer matrix Ts with T = diag(1/row_norms) @ Ts."""
    return HAWEEL_TS.copy()


def derive_T(dtype=np.float32) -> np.ndarray:
    """Derive T from first principles (Haweel construction): row-normalized Ts.

    The test-suite asserts ``derive_T() ~= T`` so the hardcoded literals are
    provably the Haweel matrix and not arbitrary constants.
    """
    ts = HAWEEL_TS.astype(np.float64)
    return (ts / haweel_row_norms()[:, None]).astype(dtype)


def block_diag_Ts(num_blocks: int, ts: np.ndarray | None = None) -> np.ndarray:
    """Block-diagonal expansion of an int8 integer core (default: Haweel Ts).
    One builder for the hp Pallas kernels, the fast pipeline's MXU einsum,
    and benchmarks."""
    ts = HAWEEL_TS if ts is None else ts
    n = BLOCK_SIZE * num_blocks
    out = np.zeros((n, n), np.int8)
    for b in range(num_blocks):
        s = b * BLOCK_SIZE
        out[s : s + BLOCK_SIZE, s : s + BLOCK_SIZE] = ts
    return out


def block_diag_T(num_blocks: int, transpose: bool = False, dtype=np.float32, t: np.ndarray | None = None) -> np.ndarray:
    """Block-diagonal expansion of T: the analog of `upgrade_T_matrix`
    (utils_kernels.cu:60-69), sized for tiles rather than whole images.

    With ``num_blocks = 16`` this yields the 128x128 matrix ``BDT`` such that
    for a (128, 128) image tile X holding a 16x16 grid of 8x8 blocks,
    ``BDT @ X @ BDT.T`` applies ``T @ Xb @ T.T`` to every block — two
    matmuls for 256 DCT blocks.
    """
    t = T if t is None else t
    t = t.T if transpose else t
    n = BLOCK_SIZE * num_blocks
    out = np.zeros((n, n), dtype=dtype)
    for b in range(num_blocks):
        s = b * BLOCK_SIZE
        out[s : s + BLOCK_SIZE, s : s + BLOCK_SIZE] = t
    return out


def tiled_Q(rows: int, cols: int, scale: float = 1.0, dtype=np.float32) -> np.ndarray:
    """Q broadcast over an (rows, cols) tile, matching the per-block-position
    indexing ``B[threadIdx.y*8 + threadIdx.x]`` in divide_matrices
    (utils_kernels.cu:34-44)."""
    assert rows % BLOCK_SIZE == 0 and cols % BLOCK_SIZE == 0
    return np.tile(Q * np.float32(scale), (rows // BLOCK_SIZE, cols // BLOCK_SIZE)).astype(dtype)


# ---------------------------------------------------------------------------
# Transform registry (beyond-parity: the reference supports only the Haweel
# matrix; the framework is transform-pluggable)
# ---------------------------------------------------------------------------

import dataclasses
from typing import Optional


def _exact_dct8(dtype=np.float64) -> np.ndarray:
    """The exact 8-point DCT-II matrix (orthonormal)."""
    k = np.arange(8)[:, None].astype(np.float64)
    n = np.arange(8)[None, :].astype(np.float64)
    c = np.cos((2 * n + 1) * k * np.pi / 16.0)
    c *= np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    return c.astype(dtype)


def _rdct_core() -> np.ndarray:
    """round(2 * DCT8): a {0, +-1} integer core with exactly orthogonal rows.

    This IS the Cintra-Bayer (2011) DCT approximation (PAPERS.md:
    "A DCT Approximation for Image Compression", arXiv 1402.6034), whose
    transform is defined as exactly this element-wise rounding of the
    scaled DCT matrix (22 additions, 0 multiplies in its butterfly
    factorization); the registry exposes the alias name "cb2011" for it.
    Derived, not hardcoded — the registry test asserts the orthogonality
    that makes T = diag(1/row_norms) @ Ts an exact-inverse transform,
    same structure as the Haweel factorization."""
    ts = np.round(2.0 * _exact_dct8()).astype(np.int8)
    g = ts.astype(np.int64) @ ts.astype(np.int64).T
    assert (g == np.diag(np.diag(g))).all(), "rdct rows must be orthogonal"
    return ts


def _wht_core() -> np.ndarray:
    """Sequency-ordered 8x8 Walsh-Hadamard: a {+-1} integer core with
    exactly orthogonal rows (H @ H.T = 8I by construction — Kronecker
    H2^(x3), rows sorted by sign-change count so low indices are low
    "frequency" and the zonal retention / zig-zag semantics carry over).
    Fully multiplierless; beyond the reference's single hardcoded
    transform.  Derived, not hardcoded."""
    h = np.array([[1]], np.int64)
    for _ in range(3):
        h = np.block([[h, h], [h, -h]])
    sequency = (np.diff(h, axis=1) != 0).sum(axis=1)
    ts = h[np.argsort(sequency, kind="stable")].astype(np.int8)
    g = ts.astype(np.int64) @ ts.astype(np.int64).T
    assert (g == 8 * np.eye(8, dtype=np.int64)).all()
    return ts


def _bas_core() -> np.ndarray:
    """Sparse sign transform in the Bouguezel-Ahmad-Swamy low-complexity
    style (the BAS series of {0,+-1/2,+-1}-entry DCT approximations):
    every row is a sparsification of the corresponding rdct/CB-2011 row —
    entries zeroed, none flipped — chosen so the rows stay EXACTLY
    orthogonal (Ts @ Ts.T = diag(8,4,4,2,8,4,4,2), asserted below).
    36 nonzeros vs rdct's 48 makes it the cheapest DCT-shaped core in
    the registry (28 adds dense, fewer factorized), trading ~0.05 dB on
    the photo image (a rate-distortion figure, host-side).  Like
    every registry entry, diag(d) @ Ts is an exact-inverse transform."""
    ts = np.array([
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 0, 0, 0, 0, -1, -1],
        [1, 0, 0, -1, -1, 0, 0, 1],
        [0, 0, -1, 0, 0, 1, 0, 0],
        [1, -1, -1, 1, 1, -1, -1, 1],
        [1, -1, 0, 0, 0, 0, 1, -1],
        [0, -1, 1, 0, 0, 1, -1, 0],
        [0, 0, 0, -1, 1, 0, 0, 0],
    ], np.int8)
    g = ts.astype(np.int64) @ ts.astype(np.int64).T
    assert (g == np.diag([8, 4, 4, 2, 8, 4, 4, 2])).all()
    return ts


@dataclasses.dataclass(frozen=True)
class Transform:
    """One 8x8 blockwise transform: orthogonal T (f32), optional integer
    core Ts with T = diag(d) @ Ts (enables the int8 MXU paths and the
    bf16-exact butterfly decode), and d = reciprocal row norms."""

    name: str
    t: np.ndarray
    ts: Optional[np.ndarray]  # int8 {small ints} or None (no integer core)
    d: Optional[np.ndarray]  # 1/row_norms, None iff ts is None

    @property
    def has_integer_core(self) -> bool:
        return self.ts is not None


def _norm_t(ts: np.ndarray) -> tuple:
    norms = np.sqrt((ts.astype(np.float64) ** 2).sum(axis=1))
    d = (1.0 / norms).astype(np.float32)
    t = (ts.astype(np.float64) / norms[:, None]).astype(np.float32)
    return t, d


def _build_transforms() -> dict:
    # build each core ONCE: the Transform's .ts must be the same array its
    # .t/.d were derived from (and the orthogonality asserts in _norm_t
    # should not run twice per core at import)
    rd_ts, wh_ts, ba_ts = _rdct_core(), _wht_core(), _bas_core()
    rd_t, rd_d = _norm_t(rd_ts)
    wh_t, wh_d = _norm_t(wh_ts)
    ba_t, ba_d = _norm_t(ba_ts)
    return {
        # Reference parity: the exact float literals from main.cu:135-143.
        "haweel": Transform(
            "haweel", T, HAWEEL_TS, (1.0 / haweel_row_norms()).astype(np.float32)
        ),
        # Derived rounded-DCT approximation ({0,+-1} core, 0 multiplies);
        # identical to the published Cintra-Bayer 2011 transform (see
        # _rdct_core), hence the "cb2011" alias below.
        "rdct": Transform("rdct", rd_t, rd_ts, rd_d),
        # Sequency-ordered Walsh-Hadamard ({+-1} core, 0 multiplies).
        "wht": Transform("wht", wh_t, wh_ts, wh_d),
        # Sparsified-rdct sign transform: the cheapest core (see _bas_core).
        "bas": Transform("bas", ba_t, ba_ts, ba_d),
        # Exact DCT-II: the quality ceiling; no integer core (irrational
        # entries), so it runs on the f32 MXU paths only.
        "dct": Transform("dct", _exact_dct8(np.float32), None, None),
    }


TRANSFORMS = _build_transforms()

# Alternate names accepted by get_transform (and recorded as-is in .tdc
# headers, which store whatever string the config carried — both resolve
# to the same Transform object, so decode is unaffected).  cb2011: the
# Cintra-Bayer 2011 transform is definitionally round(2*DCT8) == rdct.
TRANSFORM_ALIASES = {"cb2011": "rdct"}


def get_transform(name: str) -> Transform:
    try:
        return TRANSFORMS[TRANSFORM_ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(
            f"unknown transform {name!r}; available: {sorted(TRANSFORMS)}"
            f" (aliases: {TRANSFORM_ALIASES})"
        ) from None
