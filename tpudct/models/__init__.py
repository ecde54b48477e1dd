"""Pipeline (model) families.

Four compute strategies for the identical codec math, mirroring the
reference's four binaries (makefile:4), each re-designed for JAX:

- ``cublas``   per-block sequential contraction via lax.map — the deliberately
               launch-bound analog of main_cublass.cu's host GEMM loop.
- ``cublas2`` / ``batched``  whole-image batched einsum — the answer to
               main_cublass_2.cu's block-diagonal whole-image GEMM.
- ``fast``     Haweel integer core in int8 with float row-norm scaling —
               the multiplierless spirit of main_fastAppr.cu.
- ``hp``       flagship fused Pallas kernel (level-shift + transform +
               quantize in one register-resident pass) — the analog of
               main_newAppr.cu's fused shared-memory kernel.
"""

from tpudct.models.base import Pipeline, register, get_pipeline, available_pipelines

# Import for registration side effects.
from tpudct.models import cublas_like as _cublas_like  # noqa: F401
from tpudct.models import batched as _batched  # noqa: F401
from tpudct.models import fast_appr as _fast_appr  # noqa: F401
from tpudct.models import hp_appr as _hp_appr  # noqa: F401

__all__ = ["Pipeline", "register", "get_pipeline", "available_pipelines"]
