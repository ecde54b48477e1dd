"""Image <-> 8x8-block layout transforms.

The reference never materializes a block layout — every CUDA kernel indexes
the flat (H, W) image with block arithmetic (e.g. main_newAppr.cu:177-211
maps one 8x8 thread block onto one 8x8 image block).  In XLA the idiomatic
equivalent is a reshape/transpose into a batched (nb, 8, 8) tensor that
feeds batched contractions.
"""

from __future__ import annotations


from tpudct.constants import BLOCK_SIZE


def num_blocks(h: int, w: int, bs: int = BLOCK_SIZE) -> int:
    return (h // bs) * (w // bs)


def blockify(x, bs: int = BLOCK_SIZE):
    """(H, W) -> (H//bs * W//bs, bs, bs), row-major over the block grid.

    Inverse of :func:`deblockify`; the pair is tested to be an exact
    round-trip (the reference's implicit indexing contract,
    main_fastAppr.cu:166-199).
    """
    h, w = x.shape
    return (
        x.reshape(h // bs, bs, w // bs, bs)
        .transpose(0, 2, 1, 3)
        .reshape(num_blocks(h, w, bs), bs, bs)
    )


def deblockify(blocks, h: int, w: int, bs: int = BLOCK_SIZE):
    """(nb, bs, bs) -> (H, W). Exact inverse of :func:`blockify`."""
    return (
        blocks.reshape(h // bs, w // bs, bs, bs)
        .transpose(0, 2, 1, 3)
        .reshape(h, w)
    )


def as_block_grid(x, bs: int = BLOCK_SIZE):
    """(H, W) -> (H//bs, bs, W//bs, bs) view used by einsum pipelines.

    Avoids the transpose in :func:`blockify`: XLA contracts directly over the
    in-block axes, so the whole-image DCT is one batched matmul with no
    data movement — the answer to `upgrade_T_matrix`'s O(N^3) whole-image
    GEMM (main_cublass_2.cu:225-235).
    """
    h, w = x.shape
    if h % bs or w % bs:
        # the central choke point for every einsum pipeline: a clear
        # message instead of an opaque XLA reshape error
        raise ValueError(
            f"image {h}x{w} not divisible into {bs}x{bs} blocks; "
            "pad first (ops.padding.pad_to_blocks)"
        )
    return x.reshape(h // bs, bs, w // bs, bs)


def from_block_grid(g):
    """(H//bs, bs, W//bs, bs) -> (H, W)."""
    nbh, bs, nbw, _ = g.shape
    return g.reshape(nbh * bs, nbw * bs)
