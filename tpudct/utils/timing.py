"""Device-time measurement.

The reference wraps each transform phase in cudaEvent pairs inside the
wrappers and prints "DCT (w,h): ms" (main_newAppr.cu:266-287,
main_cublass.cu:216-254), averaged over 100 runs (README.md:46).

Here the protocol — immune to async-dispatch pitfalls on any JAX backend
and free of per-dispatch overhead — is *chained on-device iteration*:

  1. jit a fori_loop running K data-dependent iterations of the op;
  2. synchronize by fetching a scalar reduction of the result;
  3. time at two K values and take the slope:  t_op = (t_K2 - t_K1)/(K2 - K1).

The data dependence (output feeds next input) stops XLA from CSE-ing the
iterations; the slope removes dispatch latency, transfer and the reduction.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import jax
import jax.numpy as jnp


def _chain(op: Callable, k: int) -> Callable:
    @jax.jit
    def run(x):
        y = jax.lax.fori_loop(0, k, lambda i, y: op(y), x)
        return jnp.sum(jnp.asarray(y, jnp.float32))

    return run


def _best_wall(f: Callable, x, reps: int) -> float:
    float(f(x))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(f(x))
        best = min(best, time.perf_counter() - t0)
    return best


def device_time_ms(
    op: Callable,
    example,
    k_pair: Sequence[int] | None = None,
    reps: int = 5,
    min_span_s: float = 0.05,
    max_k: int = 8192,
) -> float:
    """Floor-free per-call device time of `op` in milliseconds.

    `op` must map an array to an array of a shape/dtype it can consume again
    (chainable).  For ops that aren't naturally chainable, wrap them, e.g.
    ``lambda x: idct(dct(x))``.

    The chain length adapts until the timed span (t_k2 - t_k1) exceeds
    `min_span_s`, otherwise fast ops at small sizes drown in dispatch jitter
    (a short chain of a 0.07 ms op can report an impossible slope under
    ms-scale jitter).  Pass `k_pair` to pin the
    lengths explicitly (tests do, for speed).
    """
    if k_pair is not None:
        k1, k2 = k_pair
        if k2 <= k1:
            raise ValueError(f"k_pair must be increasing, got {k_pair}")
        t1 = _best_wall(_chain(op, k1), example, reps)
        t2 = _best_wall(_chain(op, k2), example, reps)
        return max((t2 - t1) / (k2 - k1), 0.0) * 1e3

    k1 = 8
    if max_k <= k1:
        raise ValueError(f"max_k must exceed {k1}, got {max_k}")
    t1 = _best_wall(_chain(op, k1), example, reps)
    k2 = 64
    while k2 <= max_k:
        t2 = _best_wall(_chain(op, k2), example, reps)
        if t2 - t1 >= min_span_s or k2 == max_k:
            break
        k2 *= 2
    else:
        k2 = max_k
        t2 = _best_wall(_chain(op, k2), example, reps)
    return max((t2 - t1) / (k2 - k1), 0.0) * 1e3


class PhaseTimer:
    """Structured per-phase timing record (the printf replacement for the
    reference's 'DCT (w,h): ms' lines)."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    def record(self, name: str, ms: float):
        self.phases[name] = ms

    def measure(self, name: str, op: Callable, example, **kw):
        ms = device_time_ms(op, example, **kw)
        self.phases[name] = ms
        return ms

    def report(self) -> dict:
        return dict(self.phases)
