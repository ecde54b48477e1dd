"""Mesh construction and multi-host bring-up."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, PartitionSpec

BAND_AXIS = "band"


def distributed_init(coordinator: Optional[str] = None, **kw) -> None:
    """Multi-host bring-up (`jax.distributed.initialize`).

    No-op on a single host (or when already initialized).  After this,
    `band_mesh()` spans every device of every process and the same
    shard_map'd codec runs unchanged — host-count-agnostic by construction.
    """
    try:
        if coordinator is not None:
            jax.distributed.initialize(coordinator_address=coordinator, **kw)
        else:
            jax.distributed.initialize(**kw)
    except RuntimeError as e:
        msg = str(e).lower()
        # jax <=0.4 says "already initialized"; jax 0.9 says
        # "distributed.initialize should only be called once."
        if "already" in msg or "only be called once" in msg:
            return  # double-init: harmless
        if coordinator is not None or kw:
            # The caller explicitly asked for a cluster: a silent fallback
            # to single-host would run N divergent jobs.  Fail fast.
            raise
        # Bare best-effort probe on a single-process environment.
    except ValueError:
        if coordinator is not None or kw:
            raise


def band_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the row-band axis.

    Row-bands are the codec's natural parallel axis (SURVEY.md §5: the
    structural analog of sequence parallelism — zero-halo because 8x8
    blocks are independent).  The only collectives are the reassembly
    gathers and metric reductions.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (BAND_AXIS,), devices=devices)


def band_spec() -> PartitionSpec:
    """Rows sharded over the band axis, columns replicated."""
    return PartitionSpec(BAND_AXIS, None)


COL_AXIS = "col"


def grid_mesh(
    shape: Optional[Sequence[int]] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """2-D (band, col) mesh: rows shard over 'band', columns over 'col'.

    8x8 blocks are independent in BOTH image dimensions, so a 2-D tile grid
    is as zero-halo as row bands.  The cards of one host are joined all to
    all by NVLink, so the mesh shape follows the algorithm alone: a 2-D
    grid keeps each shard closer to square, which suits tall-and-wide
    images whose row count alone does not split evenly.  Default shape:
    the most-square factorization of the device count."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        n = len(devices)
        a = int(n**0.5)
        while n % a:
            a -= 1
        shape = (n // a, a)
    nb, nc = int(shape[0]), int(shape[1])
    if nb * nc > len(devices):
        raise ValueError(f"mesh {nb}x{nc} needs {nb*nc} devices, have {len(devices)}")
    return jax.make_mesh(
        (nb, nc), (BAND_AXIS, COL_AXIS), devices=list(devices)[: nb * nc]
    )


def grid_spec() -> PartitionSpec:
    """Rows over 'band', columns over 'col'."""
    return PartitionSpec(BAND_AXIS, COL_AXIS)
