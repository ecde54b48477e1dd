"""Hand-written device kernels (Pallas, Triton route) and the one backend gate.

:func:`resolve_interpret` is the single place that decides how a Pallas
kernel runs: compiled for the card on ``"gpu"``, in the Pallas interpreter
on ``"cpu"`` (tests and CPU rehearsals), and an error anywhere else.
``CodecConfig.interpret`` / ``interpret=True`` is an explicit override for
tests; nothing falls back to the interpreter silently.
"""

import jax


def resolve_interpret(override=None, platform=None) -> bool:
    """True when Pallas kernels must run in interpret mode.

    ``override`` truthy forces interpret mode; otherwise the platform
    (default: ``jax.default_backend()``) decides."""
    if override:
        return True
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"no kernel route for platform {platform!r}: the codec runs compiled "
        "on 'gpu' and interpreted on 'cpu'"
    )


from tpudct.kernels.hp_pallas import (  # noqa: E402 — needs resolve_interpret
    hp_dct,
    hp_idct,
    hp_roundtrip,
    hp_encode_u8,
    hp_decode_u8,
    hp_roundtrip_u8,
    supports,
    supports_u8,
)

__all__ = [
    "resolve_interpret",
    "hp_dct",
    "hp_idct",
    "hp_roundtrip",
    "hp_encode_u8",
    "hp_decode_u8",
    "hp_roundtrip_u8",
    "supports",
    "supports_u8",
]
