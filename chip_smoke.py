#!/usr/bin/env python
"""Smoke test of the codec on one NVIDIA GPU: the quickest proof that the
system still starts on the card and gives the right answers there.

    python chip_smoke.py           # one card: device, kernels, CLI main path
    python chip_smoke.py --tiles   # one card: the kernel tile sweep only
    python chip_smoke.py --four    # four cards: the band-sharded paths only

Phases (one process — JAX reserves most of the card's memory):

* device: fails unless JAX's first device is a GPU; prints the card, its
  power limit, the JAX version and which host entropy coder is built;
* kernels: every kernel of the main path, compiled for the card, at
  8192x8192 and 4000x3000 (and the color stages at 3840x2160), checked
  against the float64 golden model (tests/golden.py) and against the plain
  XLA versions; times each beside its plain XLA version and beside a plain
  XLA copy that moves the roundtrip's bytes;
* main path: the CLI in-process (``tpudct.cli.main``) encodes seeded .npy
  images to .tdc/.tdcc and decodes them back, full size and scaled, and
  the results are held to the golden model.  Each command runs twice, and
  the seconds JAX spent tracing, lowering and compiling are counted apart.

Times are information labelled with the card, not claims.  Host: the
median over rounds of the mean of back-to-back calls ending in
block_until_ready, kernel and plain XLA alternated (k, x, x, k).  Device:
the busy time of the GPU's rows in a jax.profiler trace, per call.  Any
failed check exits nonzero; the last stdout line is the JSON result only
on success.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
GRAY_SHAPES = ((8192, 8192), (3000, 4000))
COLOR_SHAPE = (2160, 3840)
FOUR_SHAPE = (16384, 8192)
TIE_FRAC = 5e-3  # coefficient ties vs f64: +-1 on at most 0.5% of entries
INV_TOL = 1e-3  # inverse transform before truncation vs f64, gray levels
MSE_TOL = 0.02  # relative MSE drift vs the f64 codec (bench.py's gate)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def timed(fn, *args, reps: int = 20):
    """(first call incl. compile s, mean steady call s) of fn(*args)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps


def host_ms(fn, *args, rounds: int = 9, calls: int = 50) -> float:
    """Median over rounds of the mean of `calls` back-to-back calls, ms."""
    import statistics

    import jax

    jax.block_until_ready(fn(*args))
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        means.append((time.perf_counter() - t0) / calls * 1e3)
    return statistics.median(means)


def device_ms(fn, *args, calls: int = 20):
    """(device ms per call, most frequent device event names) from a
    jax.profiler trace of `calls` calls: the union of the busy intervals
    on the trace's GPU rows, so nested or duplicated rows count once.
    (None, []) when the trace holds no GPU row."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d, create_perfetto_trace=True):
            for _ in range(calls):
                out = fn(*args)
            jax.block_until_ready(out)
        files = list(pathlib.Path(d).rglob("perfetto_trace.json.gz"))
        if not files:
            return None, []
        with gzip.open(files[0]) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu = {e["pid"] for e in events if e.get("ph") == "M" and e.get("name") == "process_name"
           and "GPU" in str(e.get("args", {}).get("name", ""))}
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("pid") in gpu and e.get("dur"))
    if not spans:
        return None, []
    busy, (a, b) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > b:
            busy, a, b = busy + (b - a), s0, s1
        else:
            b = max(b, s1)
    busy += b - a
    names = collections.Counter(e["name"] for e in events
                                if e.get("ph") == "X" and e.get("pid") in gpu)
    return busy / calls / 1e3, [n for n, _ in names.most_common(3)]


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def time_pair(tag, name, kern, plain, args, card):
    """Kernel beside its plain XLA form: host (k, x, x, k) and device."""
    k1 = host_ms(kern, *args)
    x1 = host_ms(plain, *args)
    x2 = host_ms(plain, *args)
    k2 = host_ms(kern, *args)
    kd, kn = device_ms(kern, *args)
    xd, _ = device_ms(plain, *args)
    log(f"[{tag}] time {name}: kernel host {k1:.4f}/{k2:.4f} ms, device {fmt_ms(kd)} {kn} | "
        f"plain XLA host {x1:.4f}/{x2:.4f} ms, device {fmt_ms(xd)}  [{card}]")


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (its monitoring
    events), so CLI wall times can be split into compile and the rest."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.total += duration


def seeded_image(shape, seed: int):
    """A photo-like u8 image: smooth gradients, edges and sensor noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    base = 128 + 90 * np.sin(6.0 * yy + 4.0 * xx) * np.cos(9.0 * xx)
    base = base + 40 * ((xx * 37).astype(np.int32) % 2)  # vertical edges
    chans = [base] if len(shape) == 2 else [base * (0.6 + 0.2 * k) + 30 * k for k in range(3)]
    out = [np.clip(c + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8) for c in chans]
    return out[0] if len(shape) == 2 else np.stack(out, axis=-1)


def golden_model():
    """The float64 golden model (tests/golden.py)."""
    from tests import golden as g

    return g


_GOLDEN = {}


def golden(img, key):
    """f64 golden coefficients of img and their f64 reconstruction (cached
    by key: the f64 model takes seconds at 8192x8192)."""
    g = golden_model()
    if key not in _GOLDEN:
        c = g.golden_dct(img.astype("float64"))
        _GOLDEN[key] = (c, g.golden_idct(c))
    return _GOLDEN[key]


def check_recon(tag, r, c, gc, gr):
    """The u8 reconstruction vs the f64 codec's, within the per-block
    tie-flip bound: a coefficient that flipped at a .5 tie moves each pixel
    of its block by at most 0.5 * Q[u, v]; truncation adds 1."""
    import numpy as np

    from tpudct.constants import Q

    h, w = r.shape
    gpix = np.clip(np.trunc(gr), 0, 255)
    cd = np.abs(c.astype(np.float64) - gc).reshape(h // 8, 8, w // 8, 8)
    bound = 0.5 * np.einsum("aibj,ij->ab", cd, Q) + 1.0
    rd = np.abs(r.astype(np.float64) - gpix).reshape(h // 8, 8, w // 8, 8).max(axis=(1, 3))
    worst = float((rd - bound).max())
    check(worst <= 0, f"[{tag}] recon exceeds the per-block tie-flip bound by {worst}")
    return float((rd > 0).mean())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def device_phase(card: str):
    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"first JAX device is {dev.platform!r}, not a GPU")
    from tpudct.utils import entropy, imageio

    native = imageio.native_backend_available()
    if not native:
        r = subprocess.run(["make", "-C", str(ROOT / "csrc")], capture_output=True, text=True)
        log("native build:", r.returncode, r.stderr.strip()[-2000:])
    log(f"device: {dev.device_kind} x{len(jax.devices())}  card: {card}  jax {jax.__version__}")
    log(f"native host library: {native}  native entropy coders: {entropy.native_entropy_available()}")
    return dev


def kernel_phase(card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpudct.kernels import hp_pallas as hp
    from tpudct.ops.scaled import box_pool_u8

    for shape in GRAY_SHAPES:
        tag = f"{shape[0]}x{shape[1]}"
        img = seeded_image(shape, seed=7)
        x = jnp.asarray(img)
        compiled = hp.hp_roundtrip_u8.lower(x).compile()
        log(f"[{tag}] hp_roundtrip_u8 memory_analysis: {compiled.memory_analysis()}")
        c, r = hp.hp_roundtrip_u8(x)
        c_np, r_np = np.asarray(c), np.asarray(r)
        gc, gr = golden(img, tag)
        mism = c_np != gc
        check(np.abs(c_np - gc).max() <= 1 and mism.mean() <= TIE_FRAC,
              f"[{tag}] coefficients vs f64: {int(mism.sum())} ties, max {np.abs(c_np - gc).max()}")
        ref = golden_model().golden_idct(c_np)
        rf = np.asarray(hp.hp_idct(c.astype(jnp.float32)))
        inv_err = float(np.abs(rf - ref).max())
        check(inv_err <= INV_TOL, f"[{tag}] inverse error vs f64 {inv_err}")
        blocks_off = check_recon(tag, r_np, c_np, gc, gr)
        ce = hp.hp_encode_u8(x)
        rd = hp.hp_decode_u8(c)
        check(bool((np.asarray(ce) == c_np).all()), f"[{tag}] encode != fused roundtrip")
        check(bool((np.asarray(rd) == r_np).all()), f"[{tag}] decode != fused roundtrip")
        for f in (2, 8):
            fused = np.asarray(hp.hp_scaled_decode_u8(c, f, f, out_u8=True))
            comp = np.asarray(box_pool_u8(rd, f, f)).astype(np.uint8)
            check(bool((fused == comp).all()), f"[{tag}] scaled 1/{f} != pool(decode_u8)")
        cx, rx = hp.roundtrip_u8_xla(x)
        check(bool((np.asarray(cx) == c_np).all()), f"[{tag}] kernel coefficients != plain XLA")
        dx = np.abs(np.asarray(rx).astype(int) - r_np.astype(int))
        check(dx.max() <= 1, f"[{tag}] recon vs plain XLA: max {dx.max()}")
        log(f"[{tag}] checks: ties {mism.mean():.2e} inv_err {inv_err:.2e} "
            f"blocks off f64 {blocks_off:.2e} pixels off plain XLA {(dx > 0).mean():.2e}")
        del cx, rx
        f32_checks(tag, img, c_np, gc)
        # timings: kernel beside the plain XLA form of the same semantics
        pairs = {
            "roundtrip_u8": (hp.hp_roundtrip_u8, hp.roundtrip_u8_xla, (x,)),
            "encode_u8": (hp.hp_encode_u8, hp.encode_u8_xla, (x,)),
            "decode_u8": (hp.hp_decode_u8, hp.decode_u8_xla, (c,)),
            "scaled_decode_1/2": (
                lambda v: hp.hp_scaled_decode_u8(v, 2, 2, out_u8=True),
                jax.jit(lambda v: box_pool_u8(hp.decode_u8_xla(v), 2, 2).astype(jnp.uint8)),
                (c,),
            ),
        }
        for name, (kern, plain, args) in pairs.items():
            time_pair(tag, name, kern, plain, args, card)
        # the traffic floor: a plain XLA pass moving the u8 roundtrip's 3
        # bytes per pixel (1 read, 2 written)
        copy3 = jax.jit(lambda v: (v + 1, (v + 2).astype(jnp.int8)))
        cd, _ = device_ms(copy3, x)
        log(f"[{tag}] time copy floor (1 B in, 2 B out per pixel, plain XLA): "
            f"host {host_ms(copy3, x):.4f} ms, device {fmt_ms(cd)}  [{card}]")
        del c, r, ce, rd

    # the existing plain pipeline (128-wide f32 GEMMs) at the headline size
    from tpudct import CodecConfig, get_pipeline

    p = get_pipeline("batched")
    xf = jnp.asarray(seeded_image(GRAY_SHAPES[0], seed=7), jnp.float32)
    fn = jax.jit(lambda v: p.roundtrip(v, CodecConfig()))
    bd, _ = device_ms(fn, xf, calls=5)
    log(f"[{GRAY_SHAPES[0][0]}x{GRAY_SHAPES[0][1]}] time batched-pipeline roundtrip (f32): "
        f"host {host_ms(fn, xf, rounds=5, calls=5):.4f} ms, device {fmt_ms(bd)}  [{card}]")

    color_phase(card)


def f32_checks(tag, img, c_u8, gc):
    """The float entry points on the card: the integer core on f32 pixels
    (the CLI's path below the u8 gate) is bit-identical to the u8 encode;
    the IEEE f32 core (T itself, HIGHEST) and the 'highest' inverse are
    held to f64 like the butterfly tier, so a TF32 lowering would fail."""
    import jax.numpy as jnp
    import numpy as np

    from tpudct.kernels import hp_pallas as hp

    g = golden_model()
    xf = jnp.asarray(img, jnp.float32)
    ci = np.asarray(hp.hp_dct(xf))
    check(bool((ci == c_u8).all()), f"[{tag}] f32-input integer core != u8 encode")
    cf, rf = hp.hp_roundtrip(xf, int_core=False, decode_precision="highest")
    cf = np.asarray(cf)
    d = np.abs(cf - gc)
    check(d.max() <= 1 and (d > 0).mean() <= TIE_FRAC,
          f"[{tag}] f32 core vs f64: {int((d > 0).sum())} ties, max {d.max()}")
    ref = g.golden_idct(cf)
    err_rt = float(np.abs(np.asarray(rf) - ref).max())
    err_hi = float(np.abs(np.asarray(hp.hp_idct(jnp.asarray(cf), decode_precision="highest")) - ref).max())
    check(max(err_rt, err_hi) <= INV_TOL,
          f"[{tag}] 'highest' inverse vs f64: roundtrip {err_rt}, idct {err_hi}")
    log(f"[{tag}] f32 checks: integer core on f32 == u8 encode; f32 core ties "
        f"{(d > 0).mean():.2e}; 'highest' inverse err {err_rt:.2e} / {err_hi:.2e}")


def tiles_phase(card: str):
    """The kernel tile sweep behind hp_pallas.DEFAULT_TILE: the u8
    roundtrip at 8192x8192 for each (band_rows, tile_cols)."""
    import functools

    import jax.numpy as jnp
    import numpy as np

    from tpudct.kernels import hp_pallas as hp

    x = jnp.asarray(seeded_image(GRAY_SHAPES[0], seed=7))
    want = np.asarray(hp.roundtrip_u8_xla(x)[0])
    # tile_cols above 128 does not fit the roundtrip's operands in shared
    # memory (config.py)
    for tile in ((128, 32), (64, 32), (256, 32), (128, 16), (128, 64), (32, 32),
                 (16, 128), (64, 128)):
        fn = functools.partial(hp.hp_roundtrip_u8, band_rows=tile[0], tile_cols=tile[1])
        t0 = time.perf_counter()
        c = np.asarray(fn(x)[0])
        first = time.perf_counter() - t0
        check(bool((c == want).all()), f"tile {tile}: coefficients != plain XLA")
        dev, _ = device_ms(fn, x)
        log(f"tile {tile}: roundtrip_u8 host {host_ms(fn, x, rounds=5):.4f} ms, "
            f"device {fmt_ms(dev)} (first {first:.2f} s)  [{card}]")


def color_phase(card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpudct.utils import color

    tag = f"{COLOR_SHAPE[0]}x{COLOR_SHAPE[1]}"
    rgb = np.moveaxis(seeded_image((*COLOR_SHAPE, 3), seed=11), -1, 0)
    x = jnp.asarray(rgb)
    y, cb, cr = color.split_u8(x, "420")
    m = color.merge_u8(y, cb, cr, "420")
    ry, rcb, rcr = color.ycbcr_split_420_u8(x)
    rm = color.ycbcr_merge_420_u8(y, cb, cr, *COLOR_SHAPE)
    got = {"y": y, "cb": cb, "cr": cr, "rgb": m}
    want = {"y": ry, "cb": rcb, "cr": rcr, "rgb": rm}
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    if cpu is not None:  # the same XLA graph on the host: the bytes .tdcc pins
        xc = jax.device_put(x, cpu)
        hy, hcb, hcr = color.split_u8(xc, "420")
        hm = color.merge_u8(jax.device_put(y, cpu), jax.device_put(cb, cpu),
                            jax.device_put(cr, cpu), "420")
        for k, v in {"y": hy, "cb": hcb, "cr": hcr, "rgb": hm}.items():
            want[f"{k} (host)"] = v
            got[f"{k} (host)"] = got[k]
    for k in want:
        d = np.abs(np.asarray(got[k]).astype(int) - np.asarray(want[k]).astype(int))
        check(d.max() <= 1 and (d > 0).mean() <= TIE_FRAC,
              f"[{tag}] color {k}: max {d.max()}, frac {(d > 0).mean()}")
    split = lambda v: color.split_u8(v, "420")
    merge = lambda a, b, c: color.merge_u8(a, b, c, "420")
    sd, _ = device_ms(split, x)
    md, _ = device_ms(merge, y, cb, cr)
    log(f"[{tag}] time color split_u8 (XLA): host {host_ms(split, x):.4f} ms, device {fmt_ms(sd)} | "
        f"merge_u8 (XLA): host {host_ms(merge, y, cb, cr):.4f} ms, device {fmt_ms(md)}  [{card}]")


def main_path_phase(card: str, work: pathlib.Path):
    import numpy as np

    from tpudct import cli
    from tpudct.utils import serialize

    clock = CompileClock()

    def run(*argv):
        """Run a CLI command twice; returns the second wall (s) and logs
        both, each split into JAX compile time and the rest."""
        walls = []
        for _ in range(2):
            c0, t0 = clock.total, time.perf_counter()
            rc = cli.main([str(a) for a in argv])
            walls.append((time.perf_counter() - t0, clock.total - c0))
            check(rc == 0, f"tpudct {' '.join(map(str, argv[:1]))} exited {rc}")
        (w1, c1), (w2, c2) = walls
        log(f"  wall {' '.join(map(str, argv[:-2]))}: first {w1:.3f} s (compile {c1:.3f} s), "
            f"second {w2:.3f} s (compile {c2:.3f} s)  [{card}]")
        return w2

    for shape in GRAY_SHAPES:
        tag = f"{shape[0]}x{shape[1]}"
        img = seeded_image(shape, seed=7)
        src, tdc = work / f"gray_{tag}.npy", work / f"gray_{tag}.tdc"
        np.save(src, img)
        te = run("encode", src, tdc)
        info = serialize.inspect_stream(tdc.read_bytes())
        td = run("decode", tdc, work / "dec.npy")
        dec = np.load(work / "dec.npy")
        _, gr = golden(img, tag)
        gpix = np.clip(np.trunc(gr), 0, 255)
        mse = float(((dec.astype(np.float64) - img) ** 2).mean())
        gmse = float(((gpix - img) ** 2).mean())
        check(dec.shape == img.shape, f"[{tag}] decoded shape {dec.shape}")
        check(abs(mse - gmse) <= MSE_TOL * gmse, f"[{tag}] MSE {mse} vs golden {gmse}")
        for m, f in ((4, 2), (1, 8)):
            out = work / f"dec_{m}.npy"
            run("decode", "--scale", f"{m}/8", tdc, out)
            s = np.load(out)
            # bit-identical to pooling the full decode (which is held to f64)
            want = dec.reshape(shape[0] // f, f, shape[1] // f, f).astype(np.int64)
            want = (want.sum(axis=(1, 3)) // (f * f)).astype(np.uint8)
            check(s.shape == want.shape and bool((s == want).all()),
                  f"[{tag}] scale {m}/8 != box pool of the full decode")
        log(f"[{tag}] CLI encode {te:.2f} s, decode {td:.2f} s, entropy {info.get('codec')}, "
            f"{tdc.stat().st_size} bytes, MSE {mse:.4f} (golden {gmse:.4f})  [{card}]")

    # below the u8 gate (q_scale < ~0.77): the f32 path, integer core on
    # f32 pixels, and the float decode
    shape, q = GRAY_SHAPES[1], 0.5
    tag = f"{shape[0]}x{shape[1]} q_scale {q}"
    img = seeded_image(shape, seed=7)
    src, tdc = work / "gray_q.npy", work / "gray_q.tdc"
    np.save(src, img)
    te = run("encode", "--q-scale", q, src, tdc)
    td = run("decode", tdc, work / "dec_q.npy")
    dec = np.load(work / "dec_q.npy")
    gm = golden_model()
    gpix = np.clip(np.trunc(gm.golden_idct(gm.golden_dct(img.astype("float64"), q), q)), 0, 255)
    mse = float(((dec.astype(np.float64) - img) ** 2).mean())
    gmse = float(((gpix - img) ** 2).mean())
    check(abs(mse - gmse) <= MSE_TOL * gmse, f"[{tag}] MSE {mse} vs golden {gmse}")
    log(f"[{tag}] CLI encode {te:.2f} s, decode {td:.2f} s, MSE {mse:.4f} (golden {gmse:.4f})  [{card}]")

    tag = f"{COLOR_SHAPE[0]}x{COLOR_SHAPE[1]}"
    rgb = seeded_image((*COLOR_SHAPE, 3), seed=11)
    src, tdcc = work / "color.npy", work / "color.tdcc"
    np.save(src, rgb)
    te = run("encode", "--color", src, tdcc)
    td = run("decode", tdcc, work / "color_dec.npy")
    dec = np.load(work / "color_dec.npy")
    check(dec.shape == rgb.shape, f"[{tag}] color decoded shape {dec.shape}")
    mse = float(((dec.astype(np.float64) - rgb) ** 2).mean())
    # golden: the codec's own color split, each plane through the f64
    # codec against its table (Q luma, QC chroma), then the codec's merge
    from tpudct.constants import QC
    from tpudct.utils import color

    y, cb, cr = (np.asarray(v) for v in color.split_u8(np.moveaxis(rgb, -1, 0), "420"))
    gm = golden_model()
    g = [gm.golden_roundtrip(y)[1]] + [gm.golden_roundtrip(v, q=QC)[1] for v in (cb, cr)]
    grgb = np.moveaxis(np.asarray(color.merge_u8(*g, "420")), 0, -1)
    gmse = float(((grgb.astype(np.float64) - rgb) ** 2).mean())
    check(abs(mse - gmse) <= MSE_TOL * gmse, f"[{tag}] color MSE {mse} vs golden {gmse}")
    log(f"[{tag}] CLI color encode {te:.2f} s, decode {td:.2f} s, "
        f"{tdcc.stat().st_size} bytes, MSE {mse:.4f} (golden {gmse:.4f})  [{card}]")


def four_phase(card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpudct import CodecConfig, get_pipeline
    from tpudct.parallel import (
        band_mesh, gather, save_sharded, shard_batch, shard_image,
        sharded_codec_step, sharded_serving_step,
    )
    from tpudct.utils import serialize

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, found {len(jax.devices())}")
    mesh = band_mesh(4)
    p, cfg = get_pipeline("hp"), CodecConfig()
    img = seeded_image(FOUR_SHAPE, seed=5)
    xs = shard_image(jnp.asarray(img), mesh)
    devs = {s.device for s in xs.addressable_shards}
    check(len(devs) == 4, f"image shards sit on {len(devs)} devices")
    step = sharded_codec_step(p, cfg, mesh)
    t0 = time.perf_counter()
    (c4, r4), metrics = step(xs)
    jax.block_until_ready((c4, r4))
    first = time.perf_counter() - t0
    check(len({s.device for s in c4.addressable_shards}) == 4, "coefficients not on 4 devices")
    one = jax.devices()[0]
    c1, r1 = p.roundtrip(jax.device_put(jnp.asarray(img), one), cfg)
    check(bool((gather(c4) == np.asarray(c1)).all()), "sharded coefficients != one card")
    check(bool((gather(r4) == np.asarray(r1)).all()), "sharded recon != one card")
    _, st = timed(step, xs, reps=5)
    log(f"[4x {FOUR_SHAPE}] sharded_codec_step: {st * 1e3:.4f} ms (first {first:.2f} s), "
        f"psnr {float(metrics['psnr_db']):.3f} dB  [{card}]")

    batch = np.stack([seeded_image((1024, 1024), seed=s) for s in range(16)])
    bs = shard_batch(jnp.asarray(batch), mesh)
    check(len({s.device for s in bs.addressable_shards}) == 4, "batch not on 4 devices")
    serve = sharded_serving_step(p, cfg, mesh)
    (bc, br), bm = serve(bs)
    tall = jax.device_put(jnp.asarray(batch.reshape(-1, 1024)), one)
    c1b, r1b = p.roundtrip_u8(tall, cfg)
    check(bool((gather(bc).reshape(-1, 1024) == np.asarray(c1b)).all()), "serving coefficients != one card")
    check(bool((gather(br).reshape(-1, 1024) == np.asarray(r1b)).all()), "serving recon != one card")
    _, sv = timed(serve, bs, reps=5)
    log(f"[4x 16x1024x1024] sharded_serving_step: {sv * 1e3:.4f} ms, "
        f"{float(bm['images']):.0f} images  [{card}]")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        path = pathlib.Path(work) / "sharded.tdc"
        save_sharded(str(path), c4, cfg.q_scale, cfg.retain_k, orig_shape=img.shape)
        ref = serialize.coefficients_to_bytes(
            np.asarray(c1), q_scale=cfg.q_scale, retain_k=cfg.retain_k,
            orig_shape=img.shape, codec="banded:4",
        )
        check(path.read_bytes() == ref, "save_sharded bytes != single-host banded:4 encode")
    log("four-card checks passed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run only the four-card phase")
    ap.add_argument("--tiles", action="store_true", help="run only the kernel tile sweep")
    args = ap.parse_args(argv)
    if not (ROOT / "tpudct" / "__init__.py").exists():
        print("chip_smoke: the tpudct package is not next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpudct import compile_cache

    log("compile cache:", compile_cache.configure())
    import jax

    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        print(f"chip_smoke: no JAX device: {e}", file=sys.stderr)
        return 2
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    card = card_line()
    t0 = time.perf_counter()
    try:
        device_phase(card)
        if args.four:
            four_phase(card)
        elif args.tiles:
            tiles_phase(card)
        else:
            kernel_phase(card)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
                main_path_phase(card, pathlib.Path(work))
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t0:.1f} s  [{card}]")
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
