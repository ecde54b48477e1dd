"""Multi-host execution test: 2 real processes x 4 virtual CPU devices.

SURVEY.md §7 M6 demands host-count-agnostic operation; this spawns an
actual 2-process `jax.distributed.initialize` cluster (gloo collectives
over localhost DCN) and drives the branches that are dead code on a
single process:

  * `shard_image` / `shard_rgb` / `shard_batch` / `shard_image_grid`
    non-addressable paths (make_array_from_process_local_data from
    per-process slabs; the grid mesh's band-major device order makes each
    process's slab a contiguous row block)
  * cross-process psum inside `sharded_codec_step[_grid]` /
    `sharded_color_step` / `sharded_serving_step`
  * `gather`'s `process_allgather` path

and asserts the assembled results are IDENTICAL to a single-process run
of the same image — the codec cannot tell how many hosts it runs on.
The reference has no analog (single process, single GPU; SURVEY.md §2
row 20).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent

_WORKER = r"""
import json, sys
import jax

# Must pin CPU before any backend init: two processes grabbing one card
# would fail for want of memory.
jax.config.update("jax_platforms", "cpu")
pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
)
import numpy as np

sys.path.insert(0, sys.argv[5])
from tpudct import CodecConfig, get_pipeline
from tpudct.parallel.mesh import band_mesh, grid_mesh
from tpudct.parallel.sharding import (
    gather, shard_batch, shard_image, shard_image_grid, shard_rgb,
    sharded_codec_step, sharded_codec_step_grid, sharded_color_step,
    sharded_serving_step,
)

assert len(jax.devices()) == 4 * nproc and len(jax.local_devices()) == 4
mesh = band_mesh()
p = get_pipeline("batched")
cfg = CodecConfig()

# ---- grayscale: each process passes only ITS row slab -----------------------
img = np.random.default_rng(42).integers(0, 256, (64, 64)).astype(np.float32)
slab = img[pid * (64 // nproc) : (pid + 1) * (64 // nproc)]
x = shard_image(slab, mesh)
assert not x.is_fully_addressable and x.shape == (64, 64)
(c, r), m = sharded_codec_step(p, cfg, mesh)(x)
rec = gather(r)
coeffs = gather(c)

# ---- color: (3, H, W) planar slabs, 16-row bands for 4:2:0 ------------------
rgb = np.random.default_rng(7).integers(0, 256, (3, 128, 64)).astype(np.uint8)
cslab = rgb[:, pid * (128 // nproc) : (pid + 1) * (128 // nproc)]
xc = shard_rgb(cslab, mesh)
assert not xc.is_fully_addressable and xc.shape == (3, 128, 64)
rgb_rec, mc = sharded_color_step(p, cfg, mesh)(xc)
rgb_full = gather(rgb_rec)

# ---- serving batch: (B, H, W) local slabs, global batch check ---------------
hp = get_pipeline("hp")
icfg = CodecConfig(interpret=True)
batch = np.random.default_rng(9).integers(0, 256, (8, 32, 128), dtype=np.uint8)
bslab = batch[pid * (8 // nproc) : (pid + 1) * (8 // nproc)]
xb = shard_batch(bslab, mesh)
assert not xb.is_fully_addressable and xb.shape == (8, 32, 128)
(bc, br), bm = sharded_serving_step(hp, icfg, mesh)(xb)
b_rec = gather(br)

# ---- 2-D (band, col) grid: contiguous row-slab per process ------------------
gmesh = grid_mesh()  # 8 devices -> (4, 2): procs own contiguous band halves
gimg = np.random.default_rng(11).integers(0, 256, (64, 128)).astype(np.float32)
gslab = gimg[pid * (64 // nproc) : (pid + 1) * (64 // nproc)]
xg = shard_image_grid(gslab, gmesh)
assert not xg.is_fully_addressable and xg.shape == (64, 128)
(gc, gr), gm = sharded_codec_step_grid(p, cfg, gmesh)(xg)
g_rec = gather(gr)

# ---- distributed serialization: sharded .tdc without a full gather ----------
import pathlib
from tpudct.parallel.sharding import save_sharded

spath = pathlib.Path(out).parent / "mh_sharded.tdc"
# collective (two allgathers inside): every process must call it
n_tdc = save_sharded(spath, c, cfg.q_scale, cfg.retain_k, orig_shape=(64, 64))

# ---- distributed color serialization: sharded .tdcc, no gather --------------
from tpudct.parallel.sharding import save_color_sharded, sharded_color_encode

cstep, cmeta_fn = sharded_color_encode(p, cfg, mesh)
ccy, ccb, ccr = cstep(xc)
cpath = pathlib.Path(out).parent / "mh_sharded.tdcc"
n_tdcc = save_color_sharded(
    cpath, {"y": ccy, "cb": ccb, "cr": ccr}, cmeta_fn(128, 64),
    cfg.q_scale, cfg.retain_k,
)

if pid == 0:
    json.dump(
        {
            "mse": float(m["mse"]),
            "tdc_sha": __import__("hashlib").sha256(
                spath.read_bytes()
            ).hexdigest(),
            "tdc_bytes": n_tdc,
            "tdcc_sha": __import__("hashlib").sha256(
                cpath.read_bytes()
            ).hexdigest(),
            "tdcc_bytes": n_tdcc,
            "rec_sha": __import__("hashlib").sha256(
                np.ascontiguousarray(rec).tobytes()
            ).hexdigest(),
            "coeff_sum": float(np.asarray(coeffs, np.float64).sum()),
            "color_mse": float(mc["mse"]),
            "rgb_sha": __import__("hashlib").sha256(
                np.ascontiguousarray(rgb_full).tobytes()
            ).hexdigest(),
            "batch_sha": __import__("hashlib").sha256(
                np.ascontiguousarray(b_rec).tobytes()
            ).hexdigest(),
            "batch_images": float(bm["images"]),
            "grid_sha": __import__("hashlib").sha256(
                np.ascontiguousarray(g_rec).tobytes()
            ).hexdigest(),
            "grid_mse": float(gm["mse"]),
        },
        open(out, "w"),
    )
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster_matches_single_process(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out = tmp_path / "result.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # A fresh interpreter must not inherit this process's pytest/JAX state.
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port), str(out), str(_REPO)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    logs = []
    for pr in procs:
        stdout, _ = pr.communicate(timeout=300)
        logs.append(stdout)
    assert all(pr.returncode == 0 for pr in procs), "\n".join(logs)
    got = json.loads(out.read_text())

    # Single-process truth on the SAME images (this process: 8-device mesh).
    import hashlib

    import jax.numpy as jnp

    from tpudct import CodecConfig, get_pipeline
    from tpudct.parallel.mesh import band_mesh
    from tpudct.parallel.sharding import (
        gather, shard_image, shard_rgb, sharded_codec_step, sharded_color_step,
    )

    mesh = band_mesh()
    p = get_pipeline("batched")
    cfg = CodecConfig()
    img = np.random.default_rng(42).integers(0, 256, (64, 64)).astype(np.float32)
    (c, r), m = sharded_codec_step(p, cfg, mesh)(shard_image(jnp.asarray(img), mesh))
    assert got["rec_sha"] == hashlib.sha256(
        np.ascontiguousarray(gather(r)).tobytes()
    ).hexdigest()
    assert got["coeff_sum"] == float(np.asarray(gather(c), np.float64).sum())
    np.testing.assert_allclose(got["mse"], float(m["mse"]), rtol=1e-6)

    # Distributed serialization: the 2-process sharded save must be
    # byte-identical to BOTH this single-process sharded save and the
    # plain banded encode of the gathered map, and decode bit-exactly.
    from tpudct.parallel.sharding import save_sharded
    from tpudct.utils import serialize

    f1 = tmp_path / "sp_sharded.tdc"
    n1 = save_sharded(f1, c, cfg.q_scale, cfg.retain_k, orig_shape=(64, 64))
    assert got["tdc_bytes"] == n1
    assert got["tdc_sha"] == hashlib.sha256(f1.read_bytes()).hexdigest()
    ref = serialize.coefficients_to_bytes(
        gather(c), q_scale=cfg.q_scale, retain_k=cfg.retain_k,
        orig_shape=(64, 64), codec="banded:8",
    )
    assert f1.read_bytes() == ref
    back = serialize.load_coefficients(f1)[0]
    np.testing.assert_array_equal(np.asarray(back), np.asarray(gather(c)))

    rgb = np.random.default_rng(7).integers(0, 256, (3, 128, 64)).astype(np.uint8)
    rgb_rec, mc = sharded_color_step(p, cfg, mesh)(shard_rgb(jnp.asarray(rgb), mesh))
    assert got["rgb_sha"] == hashlib.sha256(
        np.ascontiguousarray(gather(rgb_rec)).tobytes()
    ).hexdigest()
    np.testing.assert_allclose(got["color_mse"], float(mc["mse"]), rtol=1e-6)

    # Distributed color serialization: the 2-process sharded .tdcc must be
    # byte-identical to this single-process sharded save AND the banded
    # save_color of the gathered planes, and load bit-exactly.
    from tpudct.parallel.sharding import save_color_sharded, sharded_color_encode

    cstep, cmeta_fn = sharded_color_encode(p, cfg, mesh)
    ccy, ccb, ccr = cstep(shard_rgb(jnp.asarray(rgb), mesh))
    cmeta = cmeta_fn(128, 64)
    f2 = tmp_path / "sp_sharded.tdcc"
    n2 = save_color_sharded(
        f2, {"y": ccy, "cb": ccb, "cr": ccr}, cmeta, cfg.q_scale, cfg.retain_k
    )
    assert got["tdcc_bytes"] == n2
    assert got["tdcc_sha"] == hashlib.sha256(f2.read_bytes()).hexdigest()
    gathered = {"y": gather(ccy), "cb": gather(ccb), "cr": gather(ccr)}
    cref = serialize.color_to_bytes(
        gathered, cmeta, cfg.q_scale, cfg.retain_k, cfg.transform,
        codec="banded:8",
    )
    assert f2.read_bytes() == cref
    back_planes, back_meta = serialize.load_color(f2)
    assert back_meta["orig_shape"] == (128, 64)
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(
            np.asarray(back_planes[k]), np.asarray(gathered[k])
        )

    from tpudct.parallel.mesh import grid_mesh
    from tpudct.parallel.sharding import (
        shard_batch, shard_image_grid, sharded_codec_step_grid,
        sharded_serving_step,
    )

    hp = get_pipeline("hp")
    icfg = CodecConfig(interpret=True)
    batch = np.random.default_rng(9).integers(0, 256, (8, 32, 128), dtype=np.uint8)
    (_bc, br), bm = sharded_serving_step(hp, icfg, mesh)(
        shard_batch(jnp.asarray(batch), mesh)
    )
    assert got["batch_sha"] == hashlib.sha256(
        np.ascontiguousarray(gather(br)).tobytes()
    ).hexdigest()
    assert got["batch_images"] == float(bm["images"]) == 8.0

    gmesh = grid_mesh()
    gimg = np.random.default_rng(11).integers(0, 256, (64, 128)).astype(np.float32)
    (_gc, gr), gm = sharded_codec_step_grid(p, cfg, gmesh)(
        shard_image_grid(jnp.asarray(gimg), gmesh)
    )
    assert got["grid_sha"] == hashlib.sha256(
        np.ascontiguousarray(gather(gr)).tobytes()
    ).hexdigest()
    np.testing.assert_allclose(got["grid_mse"], float(gm["mse"]), rtol=1e-6)
