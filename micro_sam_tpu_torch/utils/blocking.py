"""Tile/block geometry with halos.

A copy of ``micro_sam_tpu/utils/blocking.py`` (which imports nothing of JAX,
but sits in a package whose ``__init__`` does). A re-implementation of the
blocking semantics the reference gets from ``nifty.tools.blocking`` (used at
micro_sam/util.py:765, inference.py:316 and throughout the tiled code
paths): an n-dimensional ROI is covered by a regular
grid of blocks; each block can be grown by a halo, clipped to the ROI, yielding
the *outer* block (what is read / computed on), the *inner* block (what is
written back) and the *local* inner block (the inner block in the outer block's
coordinate system).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class Block:
    begin: Tuple[int, ...]
    end: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(e - b for b, e in zip(self.begin, self.end))

    @property
    def slicing(self) -> Tuple[slice, ...]:
        return tuple(slice(b, e) for b, e in zip(self.begin, self.end))


@dataclass(frozen=True)
class BlockWithHalo:
    outer_block: Block
    inner_block: Block
    inner_block_local: Block


class Blocking:
    """Regular grid of blocks covering an n-dimensional ROI.

    Args:
        roi_begin: Start of the ROI (inclusive).
        roi_end: End of the ROI (exclusive).
        block_shape: Shape of a single block; border blocks are clipped.
    """

    def __init__(
        self,
        roi_begin: Sequence[int],
        roi_end: Sequence[int],
        block_shape: Sequence[int],
    ):
        self.roi_begin = tuple(int(x) for x in roi_begin)
        self.roi_end = tuple(int(x) for x in roi_end)
        self.block_shape = tuple(int(x) for x in block_shape)
        assert len(self.roi_begin) == len(self.roi_end) == len(self.block_shape)
        if any(e < b for b, e in zip(self.roi_begin, self.roi_end)):
            raise ValueError(f"Invalid ROI: {roi_begin}, {roi_end}")
        if any(bs <= 0 for bs in self.block_shape):
            raise ValueError(f"Invalid block shape: {block_shape}")
        self.blocks_per_axis = tuple(
            max(1, -(-(e - b) // bs))
            for b, e, bs in zip(self.roi_begin, self.roi_end, self.block_shape)
        )
        self.number_of_blocks = 1
        for n in self.blocks_per_axis:
            self.number_of_blocks *= n

    def __len__(self) -> int:
        return self.number_of_blocks

    def block_grid_position(self, block_id: int) -> Tuple[int, ...]:
        if not 0 <= block_id < self.number_of_blocks:
            raise IndexError(block_id)
        pos = []
        for n in reversed(self.blocks_per_axis):
            pos.append(block_id % n)
            block_id //= n
        return tuple(reversed(pos))

    def grid_position_to_id(self, pos: Sequence[int]) -> int:
        block_id = 0
        for p, n in zip(pos, self.blocks_per_axis):
            if not 0 <= p < n:
                raise IndexError(tuple(pos))
            block_id = block_id * n + p
        return block_id

    def get_block(self, block_id: int) -> Block:
        pos = self.block_grid_position(block_id)
        begin = tuple(
            rb + p * bs for rb, p, bs in zip(self.roi_begin, pos, self.block_shape)
        )
        end = tuple(
            min(b + bs, re)
            for b, bs, re in zip(begin, self.block_shape, self.roi_end)
        )
        return Block(begin, end)

    def get_block_with_halo(
        self, block_id: int, halo: Sequence[int]
    ) -> BlockWithHalo:
        inner = self.get_block(block_id)
        halo = tuple(int(h) for h in halo)
        outer_begin = tuple(
            max(b - h, rb) for b, h, rb in zip(inner.begin, halo, self.roi_begin)
        )
        outer_end = tuple(
            min(e + h, re) for e, h, re in zip(inner.end, halo, self.roi_end)
        )
        outer = Block(outer_begin, outer_end)
        local_begin = tuple(ib - ob for ib, ob in zip(inner.begin, outer.begin))
        local_end = tuple(lb + s for lb, s in zip(local_begin, inner.shape))
        return BlockWithHalo(outer, inner, Block(local_begin, local_end))

    def coordinates_to_block_id(self, coords: Sequence[int]) -> int:
        """Return the id of the block whose *inner* region contains ``coords``."""
        pos = []
        for c, rb, re, bs in zip(coords, self.roi_begin, self.roi_end, self.block_shape):
            c = min(max(int(c), rb), re - 1)
            pos.append((c - rb) // bs)
        return self.grid_position_to_id(pos)

    def __iter__(self):
        for block_id in range(self.number_of_blocks):
            yield self.get_block(block_id)

    def blocks_with_halo(self, halo: Sequence[int]):
        for block_id in range(self.number_of_blocks):
            yield self.get_block_with_halo(block_id, halo)


def chunk_grid(shape: Sequence[int], chunks: Sequence[int]):
    """Iterate (chunk_index_tuple, slicing) over a chunk grid."""
    ranges = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*ranges):
        sl = tuple(
            slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape)
        )
        yield idx, sl
