#!/usr/bin/env python
"""Headline benchmark of the codec on the accelerator.

Prints ONE JSON line:
  {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <speedup>}

Metric (BASELINE.json): full 8192x8192 DCT+quant+IDCT codec pass per chip,
flagship (hp) pipeline.  Baseline: the reference HpApprDCT on a Tesla T4
times the DCT phase at 14.70 ms at 8192^2 (README.md:55) and the IDCT phase
the same, so the comparable full-pass baseline is 29.4 ms.  vs_baseline is
the speedup factor (baseline_ms / our_ms; >1 means faster than reference).

Timing protocol: chained on-device iterations, slope between two chain
lengths (tpudct/utils/timing.py) — this removes host/dispatch overhead,
making it a device-time measurement like the reference's cudaEvent
protocol (main_newAppr.cu:266-287).
"""

import json
import sys


def correctness_gate(p, cfg, size: int = 512, force_f32: bool = False) -> dict:
    """On-chip correctness gate, run BEFORE any timing: one 512^2 image
    through the COMPILED (non-interpret) kernels on the real backend,
    asserted against the float64 golden model.

    This is the automated version of the reference's manual stage-corner
    eyeball (main_cublass.cu:121-128): a wrong-but-fast compiled kernel
    must fail the benchmark loudly, never get timed.  Tolerances are the
    documented equivalence class (tests/test_pipelines.py): coefficients
    match the golden except exact .5-quantizer ties (+-1 on <=0.5% of
    entries); reconstruction differs only where a tie flipped (bounded by
    ~Q/2 through one block's inverse).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tests.golden import golden_roundtrip
    from tpudct.benchmark import synthetic_image
    from tpudct.kernels import hp_pallas

    def _check(cond, msg):
        # explicit raise, not `assert`: the gate must survive python -O
        if not cond:
            raise AssertionError(msg)

    img = synthetic_image(size)
    gc, gr = golden_roundtrip(img)
    u8_path = (
        not force_f32
        and hasattr(p, "encode_u8")
        and hp_pallas.supports_u8(
            size, size, cfg.q_scale, cfg.transform, cfg.q_table
        )
    )
    if u8_path:
        xu8 = jnp.asarray(img.astype("uint8"))
        c, r = p.roundtrip_u8(xu8, cfg)
        # The standalone split-path kernels (CLI encode/decode, streaming,
        # serving, color) must agree with the fused roundtrip bit-for-bit —
        # covers compiled-kernel drift in hp_encode_u8/hp_decode_u8 too.
        c_split = p.encode_u8(xu8, cfg)
        r_split = p.decode_u8(c_split, cfg)
        _check(
            (np.asarray(c_split) == np.asarray(c)).all(),
            "standalone encode_u8 disagrees with the fused roundtrip",
        )
        _check(
            (np.asarray(r_split) == np.asarray(r)).all(),
            "standalone decode_u8 disagrees with the fused roundtrip",
        )
    else:
        c, r = p.roundtrip(jnp.asarray(img), cfg)
    c = np.asarray(c).astype(np.float64)
    r = np.asarray(r)
    cdiff = np.abs(c - gc)
    ties = int((cdiff > 0).sum())
    _check(
        cdiff.max() <= 1.0,
        f"coefficient error {cdiff.max()} exceeds the +-1 tie class",
    )
    _check(
        ties <= max(4, int(c.size * 0.005)),
        f"{ties} coefficient mismatches (> 0.5% of {c.size}): not ties",
    )
    rdiff = np.abs(r.astype(np.int64) - gr.astype(np.int64))
    _check(r.dtype == np.uint8, f"reconstruction dtype {r.dtype}")
    # Per-block tie-flip bound: a flipped coefficient (u,v) moves any pixel
    # of its block by at most max|T_u| * max|T_l| * Q[u,v] <= 0.5 * Q[u,v];
    # multiple ties in one block stack additively, truncation adds 1.
    from tpudct.constants import get_q_table

    q8 = get_q_table(cfg.q_table) * cfg.q_scale
    nb = size // 8
    cd_blocks = cdiff.reshape(nb, 8, nb, 8)
    bound = 0.5 * np.einsum("aibj,ij->ab", cd_blocks, q8) + 1.0
    rd_blocks = rdiff.reshape(nb, 8, nb, 8).max(axis=(1, 3))
    worst = (rd_blocks - bound).max()
    _check(
        worst <= 0,
        f"reconstruction error exceeds the per-block tie-flip bound by {worst}",
    )
    mse = float(((r.astype(np.float64) - img) ** 2).mean())
    gmse = float(((gr.astype(np.float64) - img) ** 2).mean())
    _check(
        abs(mse - gmse) <= 0.02 * gmse + 1e-9,
        f"MSE {mse} vs golden {gmse}: quality drifted >2%",
    )
    return {
        "gate": "pass", "size": size, "path": "u8" if u8_path else "f32",
        "coeff_ties": ties, "recon_max_diff": int(rdiff.max()),
        "mse": mse, "golden_mse": gmse,
    }


def family_gates(p, cfg) -> list:
    """One tiny on-backend correctness case per shipped kernel family
    (VERDICT r2 #4): color 4:2:0 u8, the f32 kernels, fractional-scale
    decode, and JPEG coefficient import.  Complements `correctness_gate`
    (which covers the headline u8 gray family): a wrong-but-fast compiled
    kernel in ANY family must fail the bench loudly, never get timed.

    Shapes are tiny and geometry comes from the cfg defaults, so this
    costs a handful of small compiles (cached across runs).  This is the
    automated sweep of what the reference eyeballs every run
    (main_cublass.cu:63-167) — but across every family that ships.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpudct.benchmark import synthetic_image

    def _check(cond, msg):
        if not cond:
            raise AssertionError(msg)

    reports = []

    # --- color 4:2:0 u8: compiled kernels vs interpret-mode reference ----
    from tpudct.models.color import roundtrip_color_u8

    if not hasattr(p, "roundtrip_u8"):
        reports.append({"gate": "skip", "family": "color420_u8",
                        "reason": f"pipeline {p.name!r} has no u8 kernels"})
        g = None
    else:
        g = synthetic_image(256)
    if g is not None:
        rgb = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1).astype(np.uint8)
        icfg = dataclasses.replace(cfg, interpret=True)
        pl_c, _meta, rec_c = roundtrip_color_u8(p, jnp.asarray(rgb), cfg)
        pl_i, _m2, rec_i = roundtrip_color_u8(p, jnp.asarray(rgb), icfg)
        for k in ("y", "cb", "cr"):
            d = np.abs(np.asarray(pl_c[k], np.int32) - np.asarray(pl_i[k], np.int32))
            _check(
                d.max() <= 1 and (d > 0).mean() <= 0.005,
                f"color420_u8 plane {k}: compiled vs interpret differ beyond "
                f"the tie class (max {d.max()}, frac {(d > 0).mean():.4f})",
            )
        rec_c, rec_i = np.asarray(rec_c), np.asarray(rec_i)
        m_c = float(((rec_c.astype(np.float64) - rgb) ** 2).mean())
        m_i = float(((rec_i.astype(np.float64) - rgb) ** 2).mean())
        _check(
            abs(m_c - m_i) <= 0.02 * m_i + 1e-9,
            f"color420_u8 recon MSE drifted: compiled {m_c} vs interpret {m_i}",
        )
        _check(
            np.abs(rec_c.astype(np.int32) - rec_i.astype(np.int32)).mean() <= 0.5,
            "color420_u8 recon: compiled vs interpret mean diff > 0.5",
        )
        reports.append({"gate": "pass", "family": "color420_u8", "mse": m_c})

    # --- f32 kernel family: golden-checked roundtrip at 256^2 ------------
    rep = correctness_gate(p, cfg, size=256, force_f32=True)
    reports.append({**rep, "family": "f32"})

    # --- fractional-scale decode: exact box average of the full decode ---
    from tpudct.ops.scaled import box_pool_u8, scaled_decode

    img = synthetic_image(256).astype(np.float32)
    c = p.dct(jnp.asarray(img), cfg)
    full = np.asarray(p.idct(c, cfg), np.float64)
    s = np.asarray(scaled_decode(c, cfg, 2), np.float64)
    box = full.reshape(128, 2, 128, 2).mean(axis=(1, 3))
    derr = np.abs(s - box).max()
    _check(derr <= 1e-2, f"scaled 1/2 decode deviates from box average by {derr}")
    rep = {"gate": "pass", "family": "scaled", "max_dev": float(derr)}
    if hasattr(p, "decode_u8"):
        # the CLI fast path: fused u8 decode + integer box pool must equal
        # its contract (pool of the clamped/truncated decode) bit-exactly
        from tpudct.ops.scaled import scaled_decode_u8

        c8 = p.encode_u8(jnp.asarray(img.astype("uint8")), cfg)
        fast = np.asarray(scaled_decode_u8(p, c8, cfg, 2))
        ref = np.asarray(box_pool_u8(p.decode_u8(c8, cfg), 2))
        _check(
            (fast == ref).all(),
            "fast scaled decode diverged from pool(decode_u8) contract",
        )
        rep["fast_path"] = "pass"
    reports.append(rep)

    # --- streamed banded codec (gray + color): vs the in-memory path -----
    # One tiny streamed encode -> decode roundtrip per family, asserted
    # BYTE-identical to the in-memory banded writer and BIT-identical to
    # the in-memory decode (VERDICT r4 #5: the streamed band-slicing/
    # padding composition was the one compiled-kernel surface the bench
    # didn't gate).
    from tpudct.utils import serialize, streaming

    if hasattr(p, "encode_u8"):
        from tpudct.models.dispatch import decode_gray_auto, encode_gray_auto

        gimg = synthetic_image(128).astype(np.uint8)[:96]  # 96x128, 3 bands
        sdata, _ = streaming.encode_gray_streamed_bytes(
            p, gimg, cfg, band_rows=32
        )
        c_ref, (gh, gw) = encode_gray_auto(p, gimg, cfg)
        mdata = serialize.coefficients_to_bytes(
            np.asarray(c_ref), cfg.q_scale, cfg.retain_k, orig_shape=(gh, gw),
            transform=cfg.transform, q_table=cfg.q_table, codec="banded:3",
        )
        _check(sdata == mdata,
               "streamed gray encode bytes differ from the in-memory "
               "banded writer")
        rec_s = streaming.decode_gray_streamed(p, sdata, band_rows=32)
        rec_m = np.asarray(decode_gray_auto(p, c_ref, cfg, (gh, gw)))
        _check((rec_s == rec_m).all(),
               "streamed gray decode differs from the in-memory decode")
        reports.append({"gate": "pass", "family": "streamed_gray",
                        "bytes": len(sdata)})

        from tpudct.models.color import decode_color_auto, encode_color_u8

        crgb = np.stack(
            [gimg[:64], np.roll(gimg[:64], 3, 0), np.roll(gimg[:64], 5, 1)],
            -1,
        )  # 64x128 RGB -> pads to 64x256 kernel grid internally
        csdata, _ = streaming.encode_color_streamed_bytes(
            p, crgb, cfg, band_rows=64
        )
        pl_ref, meta_ref = encode_color_u8(p, jnp.asarray(crgb), cfg)
        pl_np = {k: np.asarray(v) for k, v in pl_ref.items()}
        cmdata = serialize.color_to_bytes(
            pl_np, meta_ref, cfg.q_scale, cfg.retain_k, cfg.transform,
            codec="banded:1",
        )
        _check(csdata == cmdata,
               "streamed color encode bytes differ from the in-memory "
               "banded writer")
        crec_s = streaming.decode_color_streamed(p, csdata, band_rows=64)
        crec_m = np.asarray(decode_color_auto(p, pl_ref, meta_ref, cfg))
        _check((crec_s == crec_m).all(),
               "streamed color decode differs from the in-memory decode")
        reports.append({"gate": "pass", "family": "streamed_color",
                        "bytes": len(csdata)})
    else:
        reports.append({"gate": "skip", "family": "streamed",
                        "reason": f"pipeline {p.name!r} has no u8 kernels"})

    # --- JPEG coefficient import -> decode vs libjpeg's own pixels -------
    from tpudct.utils import imageio, jpegcoef

    if jpegcoef.coef_io_available():
        import os
        import tempfile

        from tpudct.config import CodecConfig
        from tpudct.models.dispatch import decode_gray_auto
        from tpudct.utils import serialize

        fd, jpath = tempfile.mkstemp(suffix=".jpg")
        os.close(fd)
        try:
            imageio.save_jpeg(jpath, synthetic_image(64).astype(np.uint8), quality=90)
            data = jpegcoef.import_jpeg(jpath, codec="raw")
            coeffs, q_scale, _k, (h, w), transform, q_table = (
                serialize.bytes_to_coefficients(
                    data, with_orig_shape=True, with_transform=True,
                    with_q_table=True,
                )
            )
            dcfg = CodecConfig(q_scale=q_scale, transform=transform, q_table=q_table)
            dec = decode_gray_auto(p, coeffs, dcfg, (h, w))
            ref = imageio.load_image(jpath)
            jerr = np.abs(dec.astype(np.int32) - ref.astype(np.int32)).max()
            _check(
                jerr <= 1.0,
                f"jpg-import decode deviates from libjpeg pixels by {jerr}",
            )
            reports.append({"gate": "pass", "family": "jpg_import",
                            "max_dev": int(jerr)})
        finally:
            os.remove(jpath)
    else:
        reports.append({"gate": "skip", "family": "jpg_import",
                        "reason": "native library unavailable"})
    return reports


def main() -> int:
    size = 8192
    baseline_pair_ms = 2 * 14.70  # T4 HpApprDCT DCT + IDCT phases, README.md:55

    from tpudct import compile_cache

    compile_cache.configure()

    import jax.numpy as jnp

    from tpudct.benchmark import synthetic_image
    from tpudct.config import CodecConfig
    from tpudct.models import get_pipeline
    from tpudct.utils.timing import device_time_ms

    # Default config = the "butterfly" exact decode tier (see
    # tpudct/kernels/hp_pallas.py).
    cfg = CodecConfig()
    p = get_pipeline("hp")

    # Correctness first: never time garbage.  Exits nonzero on a wrong
    # compiled kernel; the gate reports go to stderr so stdout stays the
    # contract's single JSON line.  The family sweep (color/f32/scaled/
    # jpg-import) can be skipped with TPUDCT_GATE=basic for quick manual
    # runs; the driver always gets the full sweep.
    import os

    try:
        gate = correctness_gate(p, cfg)
        fams = (
            [] if os.environ.get("TPUDCT_GATE") == "basic"
            else family_gates(p, cfg)
        )
    # a gate's setup (jpg write, kernel dispatch, backend init) can raise
    # ValueError/OSError/RuntimeError — the contract is STILL one JSON line
    # on stdout and a nonzero exit, never a traceback
    except (AssertionError, ValueError, OSError, RuntimeError) as e:
        print(json.dumps({"error": f"correctness gate failed: {e}"}))
        return 1
    print(json.dumps(gate), file=sys.stderr)
    for rep in fams:
        print(json.dumps(rep), file=sys.stderr)

    img = synthetic_image(size)

    # Headline: the fully fused u8-native codec pass (uint8 image in HBM ->
    # int8 coefficients + uint8 reconstruction in HBM, one kernel).  Falls
    # back to the f32 separate-phase pair where the u8 path is unsupported.
    from tpudct.kernels import hp_pallas

    if hp_pallas.supports_u8(
        size, size, cfg.q_scale, cfg.transform, cfg.q_table
    ):
        xu8 = jnp.asarray(img.astype("uint8"))
        pair_ms = device_time_ms(
            lambda v: p.roundtrip_u8(v, cfg)[1], xu8, reps=5
        )
    else:
        x = jnp.asarray(img)
        pair_ms = device_time_ms(
            lambda v: p.idct(p.dct(v, cfg), cfg), x, reps=5
        )

    print(
        json.dumps(
            {
                "metric": f"{size}x{size} DCT+quant+IDCT ms/image per chip",
                "value": round(pair_ms, 4),
                "unit": "ms",
                "vs_baseline": round(baseline_pair_ms / pair_ms, 2) if pair_ms > 0 else None,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
