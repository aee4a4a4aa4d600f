"""All-to-all ops: repartition, random_shuffle, sort.

Shuffle is the reference's push-based two-stage design
(data/_internal/push_based_shuffle.py:330,348,363): map tasks split every
input block into R partition-pieces (one per reducer, returned as separate
store objects so each reducer pulls only its piece), reduce tasks concat
their pieces. Sort samples boundaries then range-partitions through the
same two-stage machinery (data/_internal/sort.py).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np

from .. import api
from .block import (
    BlockAccessor, BlockMetadata, DelegatingBlockBuilder, concat_blocks,
)
from .plan import BlockList


@api.remote
def _shuffle_map(block, n_reduce: int, seed: Optional[int], map_idx: int):
    """Split one block into n_reduce pieces, random permutation first."""
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    rng = np.random.default_rng(None if seed is None else seed + map_idx)
    perm = rng.permutation(n)
    bounds = np.linspace(0, n, n_reduce + 1).astype(int)
    pieces = []
    for r in range(n_reduce):
        idx = perm[bounds[r]:bounds[r + 1]]
        pieces.append(_take_rows(block, acc, idx))
    return tuple(pieces) if n_reduce > 1 else pieces[0]


@api.remote
def _partition_map(block, boundaries: List[Any], key: Callable):
    """Range-partition one block by sort key into len(boundaries)+1 pieces."""
    acc = BlockAccessor.for_block(block)
    rows = list(acc.iter_rows())
    keys = [key(r) for r in rows]
    order = np.argsort(np.asarray(keys, dtype=object), kind="stable") \
        if not _is_numeric(keys) else np.argsort(np.asarray(keys))
    sorted_idx = list(order)
    pieces: List[List[Any]] = [[] for _ in range(len(boundaries) + 1)]
    b = 0
    for i in sorted_idx:
        k = keys[i]
        while b < len(boundaries) and k >= boundaries[b]:
            b += 1
        pieces[b].append(rows[i])
    out = [_rows_like(block, acc, p) for p in pieces]
    return tuple(out) if len(out) > 1 else out[0]


@api.remote
def _shuffle_reduce(*pieces):
    block = concat_blocks(list(pieces))
    meta = BlockAccessor.for_block(block).get_metadata()
    return block, meta


@api.remote
def _sort_reduce(key_fn, *pieces):
    rows = []
    for p in pieces:
        rows.extend(BlockAccessor.for_block(p).iter_rows())
    rows.sort(key=key_fn)
    block = _rows_like(pieces[0] if pieces else [], None, rows)
    meta = BlockAccessor.for_block(block).get_metadata()
    return block, meta


def _is_numeric(keys) -> bool:
    return bool(keys) and isinstance(keys[0], (int, float, np.number))


def _take_rows(block, acc: BlockAccessor, idx):
    if isinstance(block, np.ndarray):
        return block[idx]
    if isinstance(block, dict):
        return {k: np.asarray(v)[idx] for k, v in block.items()}
    type_name = type(block).__module__
    if "pandas" in type_name:
        return block.iloc[idx]
    rows = list(acc.iter_rows())
    return [rows[i] for i in idx]


def _rows_like(template, acc, rows: List[Any]):
    """Rebuild a block from python rows, preserving tensor shape when the
    source was columnar."""
    if isinstance(template, np.ndarray) and rows:
        return np.asarray(rows)
    if isinstance(template, dict) and rows and isinstance(rows[0], dict):
        return {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    type_name = type(template).__module__
    if "pandas" in type_name and rows:
        import pandas as pd

        return pd.DataFrame(rows)
    return list(rows)


def random_shuffle_stage(seed: Optional[int], num_blocks: Optional[int]):
    def do(blocks: BlockList) -> BlockList:
        n_in = len(blocks)
        if n_in == 0:
            return blocks
        n_reduce = num_blocks or n_in
        piece_refs: List[List[Any]] = []
        for m, (ref, _meta) in enumerate(blocks):
            out = _shuffle_map.options(num_returns=n_reduce).remote(
                ref, n_reduce, seed, m)
            piece_refs.append(out if isinstance(out, list) else [out])
        result: BlockList = []
        out_refs = []
        for r in range(n_reduce):
            pieces = [piece_refs[m][r] for m in range(n_in)]
            block_ref, meta_ref = _shuffle_reduce.options(
                num_returns=2).remote(*pieces)
            out_refs.append((block_ref, meta_ref))
        for block_ref, meta_ref in out_refs:
            result.append((block_ref, api.get(meta_ref)))
        return result

    return do


def overlapping_blocks(blocks: BlockList, lo: int, hi: int):
    """Select only the input blocks whose rows intersect [lo, hi) and
    rebase the range onto their concatenation — each downstream task
    receives just the blocks it needs, not the whole dataset."""
    sel_rows: List[int] = []
    sel_refs: List[Any] = []
    offset = 0
    start = None
    for ref, m in blocks:
        n = m.num_rows or 0
        blo, bhi = offset, offset + n
        offset = bhi
        if bhi <= lo or blo >= hi or n == 0:
            continue
        if start is None:
            start = blo
        sel_rows.append(n)
        sel_refs.append(ref)
    if start is None:
        return 0, 0, [], []
    return lo - start, hi - start, sel_rows, sel_refs


def repartition_stage(num_blocks: int):
    """Split/merge to exactly num_blocks without a full shuffle (reference
    Dataset.repartition(shuffle=False): splits by target row counts)."""

    def do(blocks: BlockList) -> BlockList:
        if not blocks:
            return blocks
        total = sum(m.num_rows or 0 for _, m in blocks)
        bounds = np.linspace(0, total, num_blocks + 1).astype(int)
        # one task per output block slices its row range from the inputs
        out_refs = []
        for r in range(num_blocks):
            lo, hi, rows, refs = overlapping_blocks(
                blocks, int(bounds[r]), int(bounds[r + 1]))
            block_ref, meta_ref = _slice_range.options(
                num_returns=2).remote(lo, hi, rows, *refs)
            out_refs.append((block_ref, meta_ref))
        return [(b, api.get(m)) for b, m in out_refs]

    return do


@api.remote
def _slice_range(lo: int, hi: int, rows_per_block: List[int], *blocks):
    """Concatenate rows [lo, hi) of the logical dataset."""
    builder = DelegatingBlockBuilder()
    offset = 0
    for nrows, block in zip(rows_per_block, blocks):
        blo, bhi = offset, offset + nrows
        offset = bhi
        if bhi <= lo or blo >= hi:
            continue
        s, e = max(lo - blo, 0), min(hi - blo, nrows)
        builder.add_block(BlockAccessor.for_block(block).slice(s, e))
    block = builder.build()
    meta = BlockAccessor.for_block(block).get_metadata()
    return block, meta


def sort_stage(key: Optional[Callable], descending: bool = False):
    def do(blocks: BlockList) -> BlockList:
        if not blocks:
            return blocks
        key_fn = key if callable(key) else (
            (lambda r, k=key: r[k]) if key is not None else (lambda r: r))
        n_reduce = len(blocks)
        # sample boundaries from each block (sort.py sample_boundaries)
        sample_refs = [_sample_keys.remote(ref, key_fn)
                       for ref, _ in blocks]
        samples = sorted(s for part in api.get(sample_refs) for s in part)
        if samples and n_reduce > 1:
            step = len(samples) / n_reduce
            boundaries = [samples[int(step * i)]
                          for i in range(1, n_reduce)]
        else:
            boundaries = []
        piece_refs = []
        for ref, _meta in blocks:
            out = _partition_map.options(
                num_returns=len(boundaries) + 1).remote(
                ref, boundaries, key_fn)
            piece_refs.append(out if isinstance(out, list) else [out])
        out_refs = []
        for r in range(len(boundaries) + 1):
            pieces = [piece_refs[m][r] for m in range(len(blocks))]
            block_ref, meta_ref = _sort_reduce.options(
                num_returns=2).remote(key_fn, *pieces)
            out_refs.append((block_ref, meta_ref))
        result = [(b, api.get(m)) for b, m in out_refs]
        if descending:
            result = list(reversed(result))
            result = [(_reverse_block.remote(b), m) for b, m in result]
        return result

    return do


@api.remote
def _sample_keys(block, key_fn):
    return BlockAccessor.for_block(block).sample(5, key_fn)


@api.remote
def _reverse_block(block):
    acc = BlockAccessor.for_block(block)
    rows = list(acc.iter_rows())
    return _rows_like(block, acc, list(reversed(rows)))
