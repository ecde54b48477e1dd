"""Distributed pipeline tests on the forced 8-device CPU mesh.

Runs the same code path as a real pod slice (SURVEY.md §4: "distributed
without a cluster").
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpudct import CodecConfig, get_pipeline
from tpudct.parallel import (
    band_mesh,
    gather,
    shard_image,
    sharded_codec_step,
    sharded_roundtrip,
)
from tpudct.parallel.sharding import gather_recon
from tests.golden import golden_roundtrip


def test_mesh_has_8_devices():
    mesh = band_mesh()
    assert mesh.shape["band"] == 8


@pytest.mark.parametrize("name", ["batched", "fast", "hp"])
def test_sharded_matches_single_chip(name, image256):
    mesh = band_mesh()
    p = get_pipeline(name)
    cfg = CodecConfig()
    xs = shard_image(jnp.asarray(image256), mesh)
    c_sh, r_sh = sharded_roundtrip(p, cfg, mesh)(xs)
    c1, r1 = p.roundtrip(jnp.asarray(image256), cfg)
    # The exact-int-core pipelines (hp, fast) produce bit-identical
    # coefficients at any shape on the CPU mesh (on an accelerator,
    # `fast`'s final f32 scale-multiply can fuse differently under
    # shard_map and tie-flip ~0.01% of entries by +-1 — the same
    # equivalence class as below).  `batched` is the f32-literal path: 32-row
    # bands fall back to the K=8 einsum while the full image takes the
    # K=128 block-diag formulation, so f32 accumulation order differs and
    # exact .5 quantizer ties flip on ~0.03% of coefficients; each flip
    # perturbs all 64 pixels of its block (same equivalence class as
    # tests/test_pipelines.py documents across compute strategies).
    cs, c1n = gather(c_sh), np.asarray(c1)
    assert int((cs != c1n).sum()) <= cs.size * 5e-3
    assert np.abs(cs - c1n).max() <= 1.0
    rs, r1n = gather(r_sh).astype(int), np.asarray(r1).astype(int)
    pix_tol = 5e-2 if name == "batched" else 5e-3
    assert (rs != r1n).mean() <= pix_tol and np.abs(rs - r1n).max() <= 64  # one tie-flip at Q=121 moves a pixel by ~Q/2


def test_sharded_matches_golden(image256):
    mesh = band_mesh()
    xs = shard_image(jnp.asarray(image256), mesh)
    c, r = sharded_roundtrip(get_pipeline("batched"), CodecConfig(), mesh)(xs)
    gc, gr = golden_roundtrip(image256)
    # Same half-boundary tolerance as single-chip golden tests.
    assert int((gather(c) != gc).sum()) <= gc.size * 5e-3
    assert np.abs(gather(r).astype(int) - gr.astype(int)).max() <= 64


def test_codec_step_distributed_metrics(image256):
    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    xs = shard_image(jnp.asarray(image256), mesh)
    (c, r), m = sharded_codec_step(p, cfg, mesh)(xs)
    # psum'd metrics must equal host-side metrics on the gathered arrays.
    rec = gather(r).astype(np.float64)
    mse = ((rec - image256) ** 2).mean()
    peen = 100.0 * ((rec - image256) ** 2).sum() / (image256.astype(np.float64) ** 2).sum()
    assert abs(float(m["mse"]) - mse) / mse < 1e-4
    assert abs(float(m["peen_pct"]) - peen) / peen < 1e-4
    assert 0.0 < float(m["nonzero_frac"]) < 1.0


def test_gather_recon_replicates(image256):
    mesh = band_mesh()
    c, full = gather_recon(get_pipeline("batched"), CodecConfig(), mesh)(
        shard_image(jnp.asarray(image256), mesh)
    )
    assert full.shape == image256.shape
    _, r1 = get_pipeline("batched").roundtrip(jnp.asarray(image256), CodecConfig())
    fn, r1n = np.asarray(full).astype(int), np.asarray(r1).astype(int)
    # batched f32 path: band vs full shapes take different contraction
    # widths (see test_sharded_matches_single_chip) — tie flips spread to
    # whole blocks.
    assert (fn != r1n).mean() <= 5e-2 and np.abs(fn - r1n).max() <= 64


def test_shard_image_validates():
    mesh = band_mesh()
    with pytest.raises(ValueError):
        shard_image(jnp.zeros((40, 64)), mesh)  # 40/8 = 5 rows/band: not 8-multiple


def test_uneven_device_counts(image256):
    for n in [1, 2, 4]:
        mesh = band_mesh(n_devices=n)
        xs = shard_image(jnp.asarray(image256), mesh)
        c, r = sharded_roundtrip(get_pipeline("batched"), CodecConfig(), mesh)(xs)
        assert gather(r).shape == image256.shape


def test_scaling_table_cpu_mesh():
    from tpudct.parallel.scaling import scaling_table

    rows = scaling_table(size=256, pipeline="batched", device_counts=[1, 2, 4], reps=1)
    assert [r["devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["pair_ms"] >= 0.0 and r["efficiency"] > 0.0


def test_grid_mesh_2d(image256):
    """2-D (band, col) mesh: zero halo in both axes, psum over both."""
    from tpudct.parallel import grid_mesh, shard_image_grid, sharded_codec_step_grid

    mesh = grid_mesh()  # 8 devices -> (4, 2) by most-square factorization
    assert mesh.shape["band"] * mesh.shape["col"] == 8
    xs = shard_image_grid(jnp.asarray(image256), mesh)
    p = get_pipeline("hp")
    (c, r), m = sharded_codec_step_grid(p, CodecConfig(), mesh)(xs)
    # hp/fast int-exact forward: grid-sharded coefficients == single-chip.
    c1, r1 = p.roundtrip(jnp.asarray(image256), CodecConfig())
    np.testing.assert_array_equal(gather(c), np.asarray(c1))
    rec = gather(r).astype(np.float64)
    mse = ((rec - image256) ** 2).mean()
    assert abs(float(m["mse"]) - mse) / max(mse, 1e-9) < 1e-4


def test_grid_mesh_validates(image256):
    from tpudct.parallel import grid_mesh, shard_image_grid

    mesh = grid_mesh((2, 4))
    with pytest.raises(ValueError):
        shard_image_grid(jnp.zeros((256, 40)), mesh)  # 40/4=10: not 8-multiple
    with pytest.raises(ValueError):
        grid_mesh((4, 4))  # needs 16 devices on the 8-device mesh


def test_sharded_color_step_matches_single_device():
    """Band-parallel color == single-device color: bands align to even rows
    so 4:2:0 pooling is band-local and blockwise coding identical."""
    import dataclasses

    import jax

    from tpudct.models.color import decode_color, encode_color
    from tpudct.parallel import band_mesh, shard_rgb, sharded_color_step

    mesh = band_mesh()
    n = mesh.shape["band"]
    h, w = 16 * n * 2, 128
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (3, h, w), dtype=np.uint8)

    cfg = CodecConfig(interpret=True)
    p = get_pipeline("hp")
    step = sharded_color_step(p, cfg, mesh)
    rec, metrics = step(shard_rgb(jnp.asarray(rgb), mesh))
    rec = np.asarray(jax.device_get(rec))
    assert rec.shape == (3, h, w) and rec.dtype == np.uint8
    assert float(metrics["mse"]) > 0.0

    # single-device reference: same split/codec/merge math
    from tpudct.utils.color import ycbcr_merge_420_u8, ycbcr_split_420_u8

    y, cb, cr = ycbcr_split_420_u8(jnp.asarray(rgb))
    _c, ry = p.roundtrip(jnp.asarray(y, jnp.float32), cfg)
    ccfg = dataclasses.replace(cfg, q_table="chroma")
    _c2, rc = p.roundtrip(jnp.concatenate([cb, cr], 0).astype(jnp.float32), ccfg)
    ph = cb.shape[0]
    ref = np.asarray(ycbcr_merge_420_u8(ry, rc[:ph], rc[ph:], h, w))
    np.testing.assert_array_equal(rec, ref)

    # metrics agree with a host-side recompute
    mse_host = ((rgb.astype(np.float64) - rec.astype(np.float64)) ** 2).mean()
    assert abs(float(metrics["mse"]) - mse_host) / mse_host < 1e-5


def test_shard_rgb_rejects_misaligned():
    from tpudct.parallel import band_mesh, shard_rgb

    mesh = band_mesh()
    n = mesh.shape["band"]
    with pytest.raises(ValueError):
        shard_rgb(jnp.zeros((3, 8 * n, 128), jnp.uint8), mesh)  # 8-row bands
    with pytest.raises(ValueError):
        shard_rgb(jnp.zeros((3, 16 * n, 120), jnp.uint8), mesh)  # width % 16


def test_sharded_serving_step_matches_single_device():
    """Batch data parallelism: a (B, H, W) u8 batch sharded over the mesh
    must reproduce the single-device u8 roundtrip per image, with psum'd
    batch metrics matching a host recompute."""
    import jax

    from tpudct.parallel import band_mesh, gather, shard_batch, sharded_serving_step

    mesh = band_mesh()
    n = mesh.shape["band"]
    b, s = 2 * n, 128  # s=128 keeps the lane width on the real u8 kernel path
    rng = np.random.default_rng(31)
    batch = rng.integers(0, 256, (b, s, s), dtype=np.uint8)
    cfg = CodecConfig(interpret=True)
    p = get_pipeline("hp")
    (c, r), m = sharded_serving_step(p, cfg, mesh)(shard_batch(jnp.asarray(batch), mesh))
    r = gather(r)
    c = gather(c)
    assert r.shape == (b, s, s) and r.dtype == np.uint8
    assert float(m["images"]) == b
    # device 0 holds batch[0:2] stacked tall — must equal the single-device
    # u8 roundtrip of the same stack (blocks are row-band independent)
    _c1, r1 = p.roundtrip_u8(jnp.asarray(batch[:2].reshape(2 * s, s)), cfg)
    np.testing.assert_array_equal(r[:2].reshape(2 * s, s), np.asarray(r1))
    mse_host = ((batch.astype(np.float64) - r.astype(np.float64)) ** 2).mean()
    assert abs(float(m["mse"]) - mse_host) / max(mse_host, 1e-9) < 1e-5


def test_sharded_color_step_grid_matches_band_mesh():
    """Color over the 2-D (band, col) mesh == the band-mesh result: 16-row
    AND 16-col tile alignment keeps 4:2:0 pooling and chroma blocks
    tile-local in both dimensions."""
    from tpudct.parallel import (
        band_mesh, grid_mesh, shard_rgb, shard_rgb_grid,
        sharded_color_step, sharded_color_step_grid,
    )

    gmesh = grid_mesh()  # 8 devices -> (4, 2)
    nb, nc = gmesh.shape["band"], gmesh.shape["col"]
    # h satisfies BOTH meshes: 16-row bands on the 8-device band mesh and
    # 16-row multiples per grid band.  w keeps every tile's CHROMA width a
    # 128-multiple (w / nc / 2) on both meshes, so all planes ride the same
    # Pallas dispatch path — byte-identity is only guaranteed within one
    # compute strategy (coefficient .5-ties differ across strategies).
    h, w = 16 * 8, 256 * nc
    rng = np.random.default_rng(23)
    rgb = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    cfg = CodecConfig(interpret=True)
    p = get_pipeline("hp")

    rec_g, m_g = sharded_color_step_grid(p, cfg, gmesh)(
        shard_rgb_grid(jnp.asarray(rgb), gmesh)
    )
    rec_b, m_b = sharded_color_step(p, cfg, band_mesh())(
        shard_rgb(jnp.asarray(rgb), band_mesh())
    )
    np.testing.assert_array_equal(gather(rec_g), gather(rec_b))
    np.testing.assert_allclose(float(m_g["mse"]), float(m_b["mse"]), rtol=1e-6)


def test_shard_rgb_grid_rejects_misaligned():
    from tpudct.parallel import grid_mesh, shard_rgb_grid

    mesh = grid_mesh((2, 4))
    with pytest.raises(ValueError):
        # 2 bands of 8 rows: not 16-row multiples
        shard_rgb_grid(jnp.zeros((3, 16, 128), jnp.uint8), mesh)
    with pytest.raises(ValueError):
        # 4 col tiles of 8: not 16-col multiples
        shard_rgb_grid(jnp.zeros((3, 32, 32), jnp.uint8), mesh)


def test_save_sharded_byte_identical_and_bit_exact(tmp_path, image256):
    """Distributed serialization (VERDICT r2 #6): a band-sharded map
    serializes to .tdc without a full gather, byte-identical to the
    single-host banded encode of the gathered map, and decodes
    bit-exactly through the ordinary loader."""
    from tpudct.parallel.sharding import save_sharded
    from tpudct.utils import serialize

    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    xs = shard_image(jnp.asarray(image256), mesh)
    (c_sh, _r), _m = sharded_codec_step(p, cfg, mesh)(xs)
    f = tmp_path / "sharded.tdc"
    n = save_sharded(f, c_sh, cfg.q_scale, cfg.retain_k, orig_shape=(256, 256))
    assert n == f.stat().st_size
    full = gather(c_sh)
    ref = serialize.coefficients_to_bytes(
        full, codec="banded:8", orig_shape=(256, 256)
    )
    assert f.read_bytes() == ref
    back, q_scale, _k, (h, w) = serialize.load_coefficients(
        f, with_orig_shape=True
    )
    assert (h, w) == (256, 256) and q_scale == cfg.q_scale
    np.testing.assert_array_equal(np.asarray(back), np.asarray(full))


def test_save_sharded_inner_codec_and_gap_detection(tmp_path, image256):
    from tpudct.parallel.sharding import save_sharded
    from tpudct.utils import serialize

    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    xs = shard_image(jnp.asarray(image256), mesh)
    (c_sh, _r), _m = sharded_codec_step(p, cfg, mesh)(xs)
    f = tmp_path / "spec.tdc"
    save_sharded(f, c_sh, inner="spectral")
    info = serialize.inspect_stream(f.read_bytes())
    assert info["codec"] == "banded" and info["segments"] == 8
    assert info["segment_codecs"] == ["spectral"] * 8


def test_sharded_scaled_decode_matches_single_chip(image256):
    from tpudct.ops.scaled import scaled_decode
    from tpudct.parallel.sharding import sharded_scaled_decode

    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    c = p.dct(jnp.asarray(image256), cfg)
    cs = shard_image(np.asarray(c), mesh)
    for f in (2, 4):
        s_sh = gather(sharded_scaled_decode(cfg, mesh, f)(cs))
        s1 = np.asarray(scaled_decode(c, cfg, f))
        assert s_sh.shape == (256 // f, 256 // f)
        np.testing.assert_allclose(s_sh, s1, atol=1e-3)


def test_sharded_progressive_decode_matches_single_chip(image256):
    from tpudct.parallel.sharding import sharded_idct
    from tpudct.utils import serialize

    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    c = np.asarray(p.dct(jnp.asarray(image256), cfg))
    blob = serialize.coefficients_to_bytes(c, codec="spectral")
    partial = serialize.partial_coefficients(blob, n_planes=4)["coeffs"]
    r_sh = gather(sharded_idct(p, cfg, mesh)(shard_image(partial, mesh)))
    r1 = np.asarray(p.idct(jnp.asarray(partial), cfg))
    np.testing.assert_allclose(r_sh, r1, atol=1e-2)


def test_save_sharded_refuses_grid_sharding(tmp_path, image256):
    """A (band, col) grid shard is not a full-width row band; encoding its
    first column tile as the band would write a corrupt file — refuse."""
    from tpudct.parallel import grid_mesh, shard_image_grid
    from tpudct.parallel.sharding import save_sharded

    gmesh = grid_mesh()
    xg = shard_image_grid(jnp.asarray(image256), gmesh)
    with pytest.raises(ValueError, match="column-sharded"):
        save_sharded(tmp_path / "g.tdc", xg)


def test_save_color_sharded_byte_identical_and_bit_exact(tmp_path):
    """Distributed .tdcc (VERDICT r3 #6): three band-sharded coefficient
    planes serialize with no gather, byte-identical to the single-host
    banded save_color of the gathered planes, and load_color reads them
    back bit-exactly."""
    from tpudct.parallel.sharding import (
        save_color_sharded, shard_rgb, sharded_color_encode,
    )
    from tpudct.utils import color as _color
    from tpudct.utils import serialize

    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (3, 256, 128), dtype=np.uint8)
    xs = shard_rgb(jnp.asarray(rgb), mesh)
    step, meta_fn = sharded_color_encode(p, cfg, mesh)
    cy, cb, cr = step(xs)
    meta = meta_fn(256, 128)
    planes_sh = {"y": cy, "cb": cb, "cr": cr}
    f = tmp_path / "sharded.tdcc"
    n = save_color_sharded(f, planes_sh, meta, cfg.q_scale, cfg.retain_k)
    assert n == f.stat().st_size

    gathered = {k: gather(v) for k, v in planes_sh.items()}
    ref = serialize.color_to_bytes(
        gathered, meta, cfg.q_scale, cfg.retain_k, cfg.transform,
        codec="banded:8",
    )
    assert f.read_bytes() == ref

    back, bmeta = serialize.load_color(f)
    assert bmeta["orig_shape"] == (256, 128)
    assert bmeta["chroma_shape"] == (128, 64)
    assert bmeta["subsample"] == "420"
    assert bmeta["y_q_table"] == "luma" and bmeta["c_q_table"] == "chroma"
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(
            np.asarray(back[k]), np.asarray(gathered[k])
        )

    # the sharded encode equals the SAME band math applied per band
    # unsharded (bit-exact: shard_map runs exactly this; blocks and 2x2
    # pools are band-local, zero halo).  The whole-image encode differs
    # by the documented .5-tie class instead — its 256-row planes take
    # the lane-width contraction branch the 32-row bands cannot.
    import dataclasses

    lcfg = dataclasses.replace(cfg, q_table="luma")
    ccfg = dataclasses.replace(cfg, q_table="chroma")
    ys, cbs, crs = [], [], []
    for a in range(0, 256, 32):
        y1, cb1, cr1 = _color.ycbcr_split_420_u8(jnp.asarray(rgb[:, a : a + 32]))
        ys.append(np.asarray(p.encode(jnp.asarray(y1, jnp.float32), lcfg)))
        cc1 = np.asarray(p.encode(
            jnp.concatenate([cb1, cr1], axis=0).astype(jnp.float32), ccfg
        ))
        ph = cb1.shape[0]
        cbs.append(cc1[:ph])
        crs.append(cc1[ph:])
    np.testing.assert_array_equal(np.asarray(gathered["y"]), np.vstack(ys))
    np.testing.assert_array_equal(np.asarray(gathered["cb"]), np.vstack(cbs))
    np.testing.assert_array_equal(np.asarray(gathered["cr"]), np.vstack(crs))


def test_save_color_sharded_inner_codec_and_decode(tmp_path):
    """Sharded .tdcc with an explicit inner stage: segments report the
    stage, the full color decode runs from the distributed file."""
    from tpudct.models.color import decode_color
    from tpudct.parallel.sharding import (
        save_color_sharded, shard_rgb, sharded_color_encode,
    )
    from tpudct.utils import serialize

    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    rng = np.random.default_rng(10)
    rgb = rng.integers(0, 256, (3, 128, 128), dtype=np.uint8)
    xs = shard_rgb(jnp.asarray(rgb), mesh)
    step, meta_fn = sharded_color_encode(p, cfg, mesh)
    cy, cb, cr = step(xs)
    f = tmp_path / "spec.tdcc"
    save_color_sharded(
        f, {"y": cy, "cb": cb, "cr": cr}, meta_fn(128, 128), inner="spectral"
    )
    info = serialize.inspect_stream(f.read_bytes())
    assert info["container"] == "tdcc (color)"
    for pl in info["planes"]:
        assert pl["codec"] == "banded"
        assert pl["segment_codecs"] == ["spectral"] * pl["segments"]
    planes, meta = serialize.load_color(f)
    rec = np.asarray(decode_color(p, planes, meta, cfg))
    assert rec.shape == (128, 128, 3) and rec.dtype == np.uint8
