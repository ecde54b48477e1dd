"""The backend gate, the kernels against their plain-XLA form at masked
widths, container bytes (through the 8x8 padding, and against the earlier
encoder), chip_smoke.py's refusal without a card, and compile-cache
placement."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpudct import CodecConfig, get_pipeline
from tpudct.kernels import hp_pallas, resolve_interpret

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ---- the one backend gate ---------------------------------------------------


@pytest.mark.parametrize("platform, interpret", [("gpu", False), ("cpu", True)])
def test_gate_by_platform(platform, interpret):
    assert resolve_interpret(None, platform) is interpret
    assert resolve_interpret(False, platform) is interpret


def test_gate_never_interprets_on_gpu_unless_forced():
    assert resolve_interpret(None, "gpu") is False
    assert resolve_interpret(True, "gpu") is True  # explicit test override


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_gate_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no kernel route"):
        resolve_interpret(None, platform)


def test_gate_default_platform_here():
    assert resolve_interpret() is (jax.default_backend() == "cpu")


# ---- kernels vs plain XLA at masked, non-power-of-two widths ----------------


@pytest.mark.parametrize("shape", [(24, 40), (40, 264), (136, 72), (8, 1000)])
def test_kernels_match_plain_xla_masked(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    x = jnp.asarray(img)
    c, r = hp_pallas.hp_roundtrip_u8(x, tile_cols=64)
    cx, rx = hp_pallas.roundtrip_u8_xla(x)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(cx))
    d = np.abs(np.asarray(r).astype(int) - np.asarray(rx).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    np.testing.assert_array_equal(np.asarray(hp_pallas.hp_encode_u8(x)), np.asarray(c))
    np.testing.assert_array_equal(np.asarray(hp_pallas.hp_decode_u8(c)), np.asarray(r))


# ---- the 8x8 padding and crop keep .tdc bytes ------------------------------


@pytest.mark.parametrize("shape", [(37, 61), (100, 130), (8, 8)])
def test_padding_keeps_container_bytes(shape):
    """The dispatch now pads only to the 8x8 block grid; the earlier kernel
    grid was (32, 128).  Edge replication makes the extra padding
    invisible inside the 8-aligned crop, so the .tdc bytes are those of an
    encode of the (32, 128)-padded image, cropped."""
    from tpudct.models.dispatch import encode_gray_auto
    from tpudct.ops.padding import padded_shape
    from tpudct.utils import serialize

    img = np.random.default_rng(shape[0]).integers(0, 256, shape).astype(np.uint8)
    c, hw = encode_gray_auto(get_pipeline("hp"), img, CodecConfig())
    h, w = shape
    wide = np.pad(img, ((0, -h % 32), (0, -w % 128)), mode="edge")
    h8, w8 = padded_shape(h, w)
    old = np.asarray(hp_pallas.encode_u8_xla(jnp.asarray(wide)))[:h8, :w8]
    new_bytes = serialize.coefficients_to_bytes(np.asarray(c), orig_shape=hw)
    old_bytes = serialize.coefficients_to_bytes(old, orig_shape=shape)
    assert new_bytes == old_bytes


def _photo(shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 100 * np.sin(yy / 5.0) * np.cos(xx / 7.0)
    if len(shape) == 3:
        base = np.stack([base, 255 - base, base * 0.5 + 40], -1)
    return np.clip(base + rng.normal(0, 20, shape), 0, 255).astype(np.uint8)


# sha256 of `tpudct encode ... --entropy raw` output, written by the
# encoder as it stood before the kernels were rewritten for the GPU (the
# (32, 128)-tiled kernels, run in interpret mode).  Below q_scale ~0.77
# the u8 gate fails, so gray encodes take the f32 path and color encodes
# the float-plane path.
_EARLIER_CLI_BYTES = [
    ("gray", (64, 128), ["--q-scale", "1.0"],
     "f22d941567b3ac4f590b3b6aa1eae8e70a55fb270a992ba66017d3579f4ed814"),
    ("gray", (64, 128), ["--q-scale", "0.5"],
     "1aa34d83dea0241346cdf1af71bcb8a7a48de1f330578b50653ef6b77a829a0e"),
    ("gray", (37, 61), ["--q-scale", "0.5"],
     "ae90117eef01f48c17c291c5a2cca1d9345f5ae6cdde23bfd5ebacf33a949e04"),
    ("gray", (96, 200), ["--q-scale", "0.3"],
     "4f44a8b3cb89401aa0ae3f53a004155574a4a1f3e583ebb699af318188bd1ef2"),
    ("gray", (96, 200), ["--jpeg-quality", "90"],
     "8f843477fc28e390a6accf1c0380fa00df591d880e6949d6459ec75b55a60d3b"),
    ("gray", (40, 72), ["--q-scale", "0.5", "--transform", "rdct"],
     "9209e6919bfd4803f87255e69556643b47d3a41a1fbe282739a4a9a2fc915717"),
    ("gray", (40, 72), ["--q-scale", "0.5", "--q-table-file", "QC"],
     "d285e283607895e76a7ed7fe4f4f6a0d8b6c81b35986db05f4a55ebf6ee909ad"),
    ("color", (64, 128, 3), ["--q-scale", "0.5"],
     "bd060d6e58074174863895c959ee0aaa24ab1c113870f79d34fedcf75bfea440"),
    ("color", (48, 80, 3), ["--q-scale", "0.5", "--chroma", "444"],
     "651814b913f2172c31775131eb9b246a2009cb1717e51b36d2f2ff593db19384"),
    ("color", (48, 80, 3), ["--q-scale", "0.4", "--chroma", "422"],
     "96aa395195663d4378dd52571aad77a697347e4bd26c5677bc2e26f6dd296222"),
]


@pytest.mark.parametrize("case", range(len(_EARLIER_CLI_BYTES)))
def test_cli_container_bytes_match_earlier_encoder(case, tmp_path):
    import hashlib

    from tpudct import cli
    from tpudct.constants import QC

    kind, shape, flags, digest = _EARLIER_CLI_BYTES[case]
    qc = tmp_path / "qc.txt"
    np.savetxt(qc, np.asarray(QC).reshape(8, 8))
    src = tmp_path / "in.npy"
    np.save(src, _photo(shape, case))
    dst = tmp_path / ("out.tdcc" if kind == "color" else "out.tdc")
    flags = [str(qc) if f == "QC" else f for f in flags]
    argv = ["encode", *(["--color"] if kind == "color" else []), *flags,
            "--entropy", "raw", str(src), str(dst)]
    assert cli.main(argv) == 0
    assert hashlib.sha256(dst.read_bytes()).hexdigest() == digest


# The same for library calls with float pixels (truncated by the integer
# core at kernel widths) and unaligned color planes.
_EARLIER_LIB_BYTES = {
    ("gray", (37, 61), 1.0, False):
        "ceca2e151b1e67be94354f3465bdd05744ed2356ce5e6799bdd620bdaa32c5aa",
    ("gray", (37, 61), 0.5, True):
        "783c7b73af27f493d288acedd813db2e7315fcbab799db27193230044e415dff",
    ("gray", (64, 256), 0.5, True):
        "f2b7f490cceb9731777c9abbc00da1325e1254cc51566084174ab6821c72c30e",
    ("gray", (40, 100), 1.0, True):
        "a252649de7d8bce417fd4813646068f3865b81968f9d5923144fc94bab19b799",
    ("color", (50, 70, 3), 0.5, None):
        "cd7e1e1de32477aa5aa4b3c1da2ee9191a842fde79d4c0b4294df632125ab4a0",
    ("color", (64, 256, 3), 0.3, None):
        "e86cbeae324a86fa740ebbbad9eb5ebbb4e315835c29c10dcb7628b8245e0952",
}


def test_library_container_bytes_match_earlier_encoder():
    import hashlib

    from tpudct.models.color import encode_color_auto
    from tpudct.models.dispatch import encode_gray_auto
    from tpudct.utils import serialize

    p = get_pipeline("hp")
    rng = np.random.default_rng(0)
    got = {}
    for kind, shape, q, frac in _EARLIER_LIB_BYTES:
        cfg = CodecConfig(q_scale=q)
        if kind == "gray":
            img = rng.uniform(0, 255, shape).astype(np.float32)
            img = img if frac else np.floor(img)
            c, hw = encode_gray_auto(p, img, cfg)
            b = serialize.coefficients_to_bytes(np.asarray(c), q_scale=q, orig_shape=hw, codec="raw")
        else:
            rgb = rng.integers(0, 256, shape).astype(np.uint8)
            planes, meta = encode_color_auto(p, jnp.asarray(rgb), cfg)
            b = serialize.color_to_bytes(
                {k: np.asarray(v) for k, v in planes.items()}, meta, q, None, "haweel", codec="raw"
            )
        got[(kind, shape, q, frac)] = hashlib.sha256(b).hexdigest()
    assert got == _EARLIER_LIB_BYTES


# ---- chip_smoke.py without a card -----------------------------------------


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# ---- compile-cache placement -----------------------------------------------


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_config):
    from tpudct import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_defaults_into_checkout(monkeypatch, cache_config):
    from tpudct import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


# ---- on the card -----------------------------------------------------------


@pytest.mark.gpu
def test_kernels_compile_and_match_on_card(gpu):
    assert resolve_interpret() is False
    img = np.random.default_rng(3).integers(0, 256, (264, 1000)).astype(np.uint8)
    x = jnp.asarray(img)
    c, r = hp_pallas.hp_roundtrip_u8(x)
    cx, rx = hp_pallas.roundtrip_u8_xla(x)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(cx))
    assert np.abs(np.asarray(r).astype(int) - np.asarray(rx).astype(int)).max() <= 1
    # the f32 entry points: integer core on f32 pixels, IEEE f32 core
    xf = x.astype(jnp.float32)
    np.testing.assert_array_equal(np.asarray(hp_pallas.hp_dct(xf)), np.asarray(c))
    cf, _ = hp_pallas.hp_roundtrip(xf, int_core=False, decode_precision="highest")
    d = np.abs(np.asarray(cf) - np.asarray(c))
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3
