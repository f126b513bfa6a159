"""Output-grid enumeration for block-parallel stages.

Equivalent of the reference's ``Grid.create(dims, computeBlockSize, blockSize)``
(used at SparkAffineFusion.java:456-463, SparkResaveN5.java:192-198): tile an
n-D volume into *compute blocks* that are integer multiples of the *storage
block* size, so that concurrent writers always own disjoint storage chunks —
the reference's central race-freedom invariant (SURVEY.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class GridBlock:
    """One work item of block-grid data parallelism (strategy P1).

    offset/size are in voxels relative to the dataset origin; grid_pos is the
    block position in units of STORAGE blocks (what N5 block writing needs).
    """

    offset: tuple[int, ...]
    size: tuple[int, ...]
    grid_pos: tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.offset)


def create_grid(
    dims: Sequence[int],
    compute_block_size: Sequence[int],
    storage_block_size: Sequence[int] | None = None,
) -> list[GridBlock]:
    """Enumerate compute blocks covering ``dims``.

    ``compute_block_size`` should be an integer multiple of
    ``storage_block_size`` per axis (the reference's ``blockSize * blockScale``);
    edge blocks are clipped to the volume.
    """
    dims = tuple(int(d) for d in dims)
    cbs = tuple(int(b) for b in compute_block_size)
    sbs = tuple(int(b) for b in (storage_block_size or compute_block_size))
    for c, s in zip(cbs, sbs):
        if c % s != 0:
            raise ValueError(
                f"compute block {cbs} must be a multiple of storage block {sbs}"
            )
    ndim = len(dims)
    counts = [(dims[d] + cbs[d] - 1) // cbs[d] for d in range(ndim)]

    blocks: list[GridBlock] = []
    idx = [0] * ndim
    total = 1
    for c in counts:
        total *= c
    for flat in range(total):
        rem = flat
        for d in range(ndim):
            idx[d] = rem % counts[d]
            rem //= counts[d]
        offset = tuple(idx[d] * cbs[d] for d in range(ndim))
        size = tuple(min(cbs[d], dims[d] - offset[d]) for d in range(ndim))
        grid_pos = tuple(offset[d] // sbs[d] for d in range(ndim))
        blocks.append(GridBlock(offset, size, grid_pos))
    return blocks
