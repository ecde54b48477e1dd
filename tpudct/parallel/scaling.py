"""Scaling-efficiency measurement across device counts.

The reference has no multi-device story at all (SURVEY.md §2 row 19); the
north-star for this framework is >=90% scaling efficiency across devices
(BASELINE.md).  This module measures it with the same chained-slope
protocol as the single-chip benchmarks, applied to the shard_map'd codec:

  * the image is band-sharded once (no per-iteration H2D);
  * the chained op is the full sharded DCT->IDCT pass — outputs stay
    band-sharded, so NO collective sits on the critical path (the design
    property that makes near-linear scaling possible: blocks are
    independent, reassembly is output-only);
  * efficiency(n) = throughput(n) / (n * throughput(1)).

On the CI CPU mesh the numbers validate the methodology, not the hardware;
on four cards the same call reports the real efficiency.
"""

from __future__ import annotations

from typing import Iterable, Optional

import jax
import jax.numpy as jnp

from tpudct.config import CodecConfig
from tpudct.models import get_pipeline
from tpudct.parallel.mesh import band_mesh, band_spec
from tpudct.parallel.sharding import shard_image
from tpudct.utils.timing import device_time_ms


def _sharded_pair(pipeline, cfg: CodecConfig, mesh):
    """Chainable sharded op: band-local dct -> idct, image in/image out."""

    def band_fn(x):
        return pipeline.idct(pipeline.dct(x, cfg), cfg)

    return jax.shard_map(
        band_fn, mesh=mesh, in_specs=band_spec(), out_specs=band_spec(),
        check_vma=False,
    )


def scaling_table(
    size: int = 2048,
    pipeline: str = "hp",
    device_counts: Optional[Iterable[int]] = None,
    cfg: Optional[CodecConfig] = None,
    reps: int = 3,
    k_pair: Optional[tuple] = None,
) -> list:
    """Throughput + efficiency per device count.  Device counts default to
    powers of two up to the available devices.  Pin `k_pair` (e.g. (8, 72))
    on the card: the adaptive chain-length search costs 5+ compiles
    per count."""
    from tpudct.benchmark import synthetic_image

    cfg = cfg or CodecConfig()
    p = get_pipeline(pipeline)
    total = len(jax.devices())
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= total]
    # ascending: efficiency is defined relative to the SMALLEST count
    device_counts = sorted({int(n) for n in device_counts})

    img = synthetic_image(size)
    rows = []
    base_per_device = None  # throughput per device at the smallest count
    for n in device_counts:
        mesh = band_mesh(n_devices=n)
        xs = shard_image(jnp.asarray(img), mesh)
        op = _sharded_pair(p, cfg, mesh)
        ms = (device_time_ms(op, xs, reps=reps, k_pair=k_pair)
              if k_pair is not None else device_time_ms(op, xs, reps=reps))
        # tiny CI shapes can measure a zero slope; floor to one timer tick
        ms = max(ms, 1e-6)
        mpix = size * size / ms / 1e3
        if base_per_device is None:
            base_per_device = mpix / n
        rows.append(
            {
                "devices": n,
                "pair_ms": ms,
                "mpix_per_s": mpix,
                # efficiency relative to the smallest measured count, not
                # hardcoded to n0 == 1: (mpix/n) / (mpix_0/n_0).
                "efficiency": (mpix / n) / base_per_device,
                "backend": jax.default_backend(),
            }
        )
    return rows
