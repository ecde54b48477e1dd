"""Custom quantization tables (beyond-parity: the reference hardcodes one
luminance table in 9 TUs, main.cu:122-133).

Covers: registration semantics (content-derived names, redefinition safety
for the name-keyed kernel-const lru caches), pipeline threading incl. the
u8-eligibility recomputation, and the self-describing .tdc container
(embedded 256-byte f32 table block, re-registered on load)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpudct import CodecConfig, get_pipeline
from tpudct.constants import Q, Q_TABLES, get_q_table, register_q_table
from tpudct.utils import serialize
from tests.golden import golden_roundtrip


# A plausible custom table: flat mid-strength quantizer, coefficients still
# int8-eligible at q_scale=1 for haweel (bound ~97.2*16/Q.min()... checked
# via supports_u8 in the test itself).
FLAT32 = np.full((8, 8), 32.0, np.float32)
# An aggressive low-quantization table that pushes coefficients past int8.
FINE = np.full((8, 8), 2.0, np.float32)


@pytest.fixture
def clean_registry():
    """Snapshot/restore Q_TABLES so registrations don't leak across tests.

    Also clears the name-keyed kernel-constant lru caches: wiping the
    registry bypasses register_q_table's redefinition guard, so a stale
    cache entry under a reused name would silently serve the wrong table."""
    snap = dict(Q_TABLES)
    yield
    Q_TABLES.clear()
    Q_TABLES.update(snap)
    from tpudct.kernels import hp_pallas

    hp_pallas._max_coeff.cache_clear()
    hp_pallas._fwd_consts.cache_clear()
    hp_pallas._inv_consts.cache_clear()


def test_register_validates(clean_registry):
    with pytest.raises(ValueError):
        register_q_table(np.ones((4, 4)))
    with pytest.raises(ValueError):
        register_q_table(np.zeros((8, 8)))  # non-positive
    with pytest.raises(ValueError):
        register_q_table(np.full((8, 8), np.inf))
    with pytest.raises(ValueError):
        register_q_table(FLAT32, name="far-too-long-name")


def test_register_content_names(clean_registry):
    name = register_q_table(FLAT32)
    assert name.startswith("q:") and len(name) == 8
    assert register_q_table(FLAT32) == name  # idempotent
    np.testing.assert_array_equal(get_q_table(name), FLAT32)
    # same name + different values must refuse (lru-cache soundness)
    with pytest.raises(ValueError):
        register_q_table(FINE, name=name)
    # explicit alias works and coexists
    alias = register_q_table(FLAT32, name="mytable")
    assert alias == "mytable"


def test_pipeline_roundtrip_matches_golden(clean_registry, rng):
    name = register_q_table(FLAT32)
    img = rng.integers(0, 256, (64, 128)).astype(np.float32)
    cfg = CodecConfig(q_table=name, interpret=True)
    c, r = get_pipeline("hp").roundtrip(jnp.asarray(img), cfg)
    gc, gr = golden_roundtrip(img, q=FLAT32)
    cdiff = np.abs(np.asarray(c, np.float64) - gc)
    assert cdiff.max() <= 1.0 and (cdiff > 0).mean() <= 0.005  # tie class
    assert np.abs(np.asarray(r).astype(int) - gr.astype(int)).mean() < 2.0


def test_u8_eligibility_recomputed(clean_registry):
    from tpudct.kernels.hp_pallas import supports_u8

    flat = register_q_table(FLAT32)
    fine = register_q_table(FINE)
    assert supports_u8(64, 128, 1.0, "haweel", flat)
    # |c| <= ~97.2 * 16/2 = 778 with the fine table: must NOT take int8
    assert not supports_u8(64, 128, 1.0, "haweel", fine)


def test_container_self_describing(clean_registry, rng):
    name = register_q_table(FLAT32)
    img = rng.integers(0, 256, (64, 128)).astype(np.float32)
    cfg = CodecConfig(q_table=name, interpret=True)
    c, _ = get_pipeline("hp").roundtrip(jnp.asarray(img), cfg)
    data = serialize.coefficients_to_bytes(
        np.asarray(c), q_table=name, orig_shape=(64, 128)
    )
    # builtin-table streams must be byte-identical to the pre-feature format
    base = serialize.coefficients_to_bytes(np.asarray(c), orig_shape=(64, 128))
    assert len(data) == len(base) + 256  # exactly the embedded table block

    # wipe the registration: a fresh process must decode from the stream alone
    del Q_TABLES[name]
    c2, q_scale, _k, oshape, transform, q_table = serialize.bytes_to_coefficients(
        data, with_orig_shape=True, with_transform=True, with_q_table=True
    )
    assert q_table == name  # content-derived name reproduced
    np.testing.assert_array_equal(get_q_table(q_table), FLAT32)
    np.testing.assert_array_equal(c2, np.asarray(c, np.float32))


def test_container_rejects_corrupt_table(clean_registry, rng):
    name = register_q_table(FLAT32)
    c = np.zeros((16, 16), np.float32)
    data = serialize.coefficients_to_bytes(c, q_table=name)
    # zero out the embedded table block (bytes right after the header)
    import struct

    hl = struct.calcsize(serialize._HEADER4)
    bad = data[:hl] + b"\x00" * 256 + data[hl + 256 :]
    del Q_TABLES[name]
    with pytest.raises(ValueError):
        serialize.bytes_to_coefficients(bad)


def test_preview_with_custom_table(clean_registry, rng):
    name = register_q_table(FLAT32)
    img = rng.integers(0, 256, (64, 128)).astype(np.float32)
    cfg = CodecConfig(q_table=name, interpret=True)
    c, _ = get_pipeline("hp").roundtrip(jnp.asarray(img), cfg)
    data = serialize.coefficients_to_bytes(
        np.asarray(c), q_table=name, orig_shape=(64, 128), codec="spectral"
    )
    del Q_TABLES[name]
    thumb = serialize.preview_from_bytes(data)
    means = img.reshape(8, 8, 16, 8).mean(axis=(1, 3))
    assert thumb.shape == (8, 16)
    # DC quantization with Q00=32: block means recovered within Q00/2 + 1
    assert np.abs(thumb.astype(np.float64) - means).max() <= 32 / 2 + 1


def test_cli_q_table_file(clean_registry, tmp_path):
    from tpudct.cli import _register_q_table_file

    p = tmp_path / "qt.txt"
    rows = ["# my table"] + [
        " ".join(str(int(v)) for v in row) for row in np.asarray(FLAT32)
    ]
    p.write_text("\n".join(rows))
    name = _register_q_table_file(str(p))
    np.testing.assert_array_equal(get_q_table(name), FLAT32)
    bad = tmp_path / "short.txt"
    bad.write_text("1 2 3")
    with pytest.raises(SystemExit):
        _register_q_table_file(str(bad))
