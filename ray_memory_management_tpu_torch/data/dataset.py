"""Dataset: lazy, distributed, block-based data transforms.

The reference's ``ray.data.Dataset`` (python/ray/data/dataset.py:124 —
``map:214``, ``map_batches:307``, plus repartition/random_shuffle/sort/
split/zip/groupby/iter_batches/write_*). Same lazy-plan design over the
runtime: blocks are store objects (tensor blocks stay contiguous and
zero-copy host numpy), per-block transforms are tasks (or warm-actor
pools, which may lease the card), and ``iter_batches`` is the per-host
input pipeline that feeds the card — the role Ray Data plays for Ray
Train.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

from .. import api
from .block import (
    BlockAccessor, BlockMetadata, DelegatingBlockBuilder, batch_to_block,
    concat_blocks,
)
from .plan import (
    ActorPoolStrategy, AllToAllStage, BlockList, ExecutionPlan, OneToOneStage,
)
from . import shuffle as _shuffle


class Dataset:
    def __init__(self, plan: ExecutionPlan):
        self._plan = plan

    # ------------------------------------------------------------ transforms
    def map(self, fn: Callable[[Any], Any], *,
            compute: Any = "tasks") -> "Dataset":
        def block_fn(block):
            builder = DelegatingBlockBuilder()
            for row in BlockAccessor.for_block(block).iter_rows():
                builder.add(fn(row))
            return builder.build()

        return self._with_stage(OneToOneStage("map", block_fn, compute))

    def flat_map(self, fn: Callable[[Any], List[Any]], *,
                 compute: Any = "tasks") -> "Dataset":
        def block_fn(block):
            builder = DelegatingBlockBuilder()
            for row in BlockAccessor.for_block(block).iter_rows():
                for out in fn(row):
                    builder.add(out)
            return builder.build()

        return self._with_stage(OneToOneStage("flat_map", block_fn, compute))

    def filter(self, fn: Callable[[Any], bool], *,
               compute: Any = "tasks") -> "Dataset":
        def block_fn(block):
            builder = DelegatingBlockBuilder()
            for row in BlockAccessor.for_block(block).iter_rows():
                if fn(row):
                    builder.add(row)
            return builder.build()

        return self._with_stage(OneToOneStage("filter", block_fn, compute))

    def map_batches(self, fn: Callable[[Any], Any], *,
                    batch_size: Optional[int] = 4096,
                    batch_format: str = "default",
                    compute: Any = "tasks",
                    **fn_kwargs) -> "Dataset":
        """Apply fn to batches (reference dataset.py:307). The hot path for
        preprocessing: with batch_format='numpy' the batch is a
        contiguous ndarray (or dict of them) ready for vectorized ops."""

        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            size = batch_size or max(n, 1)
            builder = DelegatingBlockBuilder()
            for start in range(0, max(n, 1), size):
                if n == 0:
                    break
                end = min(start + size, n)
                piece = acc.slice(start, end)
                batch = BlockAccessor.for_block(piece).to_batch(batch_format)
                out = fn(batch, **fn_kwargs) if fn_kwargs else fn(batch)
                builder.add_block(batch_to_block(out))
            return builder.build()

        return self._with_stage(
            OneToOneStage("map_batches", block_fn, compute))

    def add_column(self, col: str, fn: Callable[[Any], Any]) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            batch = acc.to_batch("pandas")
            batch[col] = fn(batch)
            return batch

        return self._with_stage(OneToOneStage("add_column", block_fn))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda df: df.drop(columns=cols), batch_format="pandas")

    # ------------------------------------------------------------ all-to-all
    def repartition(self, num_blocks: int, *,
                    shuffle: bool = False) -> "Dataset":
        if shuffle:
            return self._with_stage(AllToAllStage(
                "repartition", _shuffle.random_shuffle_stage(
                    None, num_blocks)))
        return self._with_stage(AllToAllStage(
            "repartition", _shuffle.repartition_stage(num_blocks)))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        return self._with_stage(AllToAllStage(
            "random_shuffle", _shuffle.random_shuffle_stage(
                seed, num_blocks)))

    def sort(self, key: Union[str, Callable, None] = None,
             descending: bool = False) -> "Dataset":
        return self._with_stage(AllToAllStage(
            "sort", _shuffle.sort_stage(key, descending)))

    def groupby(self, key: Union[str, Callable]) -> "GroupedData":
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        """Zip blocks row-aligned with another dataset (dataset.py zip)."""
        my_blocks = self._plan.execute()
        other_blocks = other._plan.execute()
        n_rows = sum(m.num_rows or 0 for _, m in my_blocks)
        o_rows = sum(m.num_rows or 0 for _, m in other_blocks)
        if n_rows != o_rows:
            raise ValueError(
                f"zip requires equal row counts: {n_rows} vs {o_rows}")
        # each task receives only the other-side blocks overlapping its
        # row range (offset rebased by overlapping_blocks)
        out_refs = []
        offset = 0
        for ref, meta in my_blocks:
            count = meta.num_rows or 0
            lo, _hi, rows, orefs = _shuffle.overlapping_blocks(
                other_blocks, offset, offset + count)
            block_ref, meta_ref = _zip_slice.options(num_returns=2).remote(
                ref, lo, count, rows, *orefs)
            out_refs.append((block_ref, meta_ref))
            offset += count
        blocks = [(b, api.get(m)) for b, m in out_refs]
        return Dataset(ExecutionPlan(blocks, stats=self._plan.stats))

    def union(self, *others: "Dataset") -> "Dataset":
        blocks = list(self._plan.execute())
        for o in others:
            blocks.extend(o._plan.execute())
        return Dataset(ExecutionPlan(blocks, stats=self._plan.stats))

    # ------------------------------------------------------------ consuming
    def num_blocks(self) -> int:
        return len(self._plan.execute())

    def count(self) -> int:
        return sum(m.num_rows or 0 for _, m in self._plan.execute())

    def size_bytes(self) -> int:
        return sum(m.size_bytes or 0 for _, m in self._plan.execute())

    def schema(self) -> Any:
        blocks = self._plan.execute()
        return blocks[0][1].schema if blocks else None

    def input_files(self) -> List[str]:
        files: List[str] = []
        for _, m in self._plan.execute():
            files.extend(m.input_files)
        return sorted(set(files))

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            # rmtcheck: disable=log-discipline — show() IS console output
            print(row)

    def limit(self, limit: int) -> "Dataset":
        blocks = self._plan.execute()
        kept: BlockList = []
        remaining = limit
        for ref, meta in blocks:
            if remaining <= 0:
                break
            n = meta.num_rows or 0
            if n <= remaining:
                kept.append((ref, meta))
                remaining -= n
            else:
                block_ref, meta_ref = _truncate.options(
                    num_returns=2).remote(ref, remaining)
                kept.append((block_ref, api.get(meta_ref)))
                remaining = 0
        return Dataset(ExecutionPlan(kept, stats=self._plan.stats))

    def iter_rows(self) -> Iterator[Any]:
        for block in self._iter_blocks():
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "default",
                     prefetch_blocks: int = 1,
                     drop_last: bool = False) -> Iterator[Any]:
        """Stream batches; blocks are prefetched with wait() ahead of use
        (the per-host input pipeline; reference dataset.py iter_batches)."""
        carry = None
        for block in self._iter_blocks(prefetch=prefetch_blocks):
            if carry is not None:
                block = concat_blocks([carry, block])
                carry = None
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            if batch_size is None:
                yield acc.to_batch(batch_format)
                continue
            start = 0
            while start + batch_size <= n:
                piece = acc.slice(start, start + batch_size)
                yield BlockAccessor.for_block(piece).to_batch(batch_format)
                start += batch_size
            if start < n:
                carry = acc.slice(start, n)
        if carry is not None and not drop_last:
            yield BlockAccessor.for_block(carry).to_batch(batch_format)

    def _iter_blocks(self, prefetch: int = 1) -> Iterator[Any]:
        """Stream blocks with real read-ahead: a fetch thread resolves the
        next ``prefetch`` blocks (waiting on their producing tasks and
        mapping/deserializing them) while the caller consumes the current
        one — ingest/compute overlap for the step loop."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        blocks = self._plan.execute()
        refs = [ref for ref, _ in blocks]
        if not refs:
            return
        depth = max(1, prefetch)
        ex = ThreadPoolExecutor(1, thread_name_prefix="data-prefetch")
        try:
            futs = deque(ex.submit(api.get, r) for r in refs[:depth])
            next_i = len(futs)
            while futs:
                block = futs.popleft().result()
                if next_i < len(refs):
                    futs.append(ex.submit(api.get, refs[next_i]))
                    next_i += 1
                yield block
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def split(self, n: int, *, equal: bool = False,
              locality_hints=None) -> List["Dataset"]:
        """Split into n datasets by block (reference dataset.py split);
        equal=True rebalances row counts exactly."""
        blocks = self._plan.execute()
        if equal:
            per = self.count() // n
            return self.split_at_indices([per * i for i in range(1, n)])
        out: List[List] = [[] for _ in range(n)]
        for i, bm in enumerate(blocks):
            out[i % n].append(bm)
        return [Dataset(ExecutionPlan(b, stats=self._plan.stats))
                for b in out]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        blocks = self._plan.execute()
        total = sum(m.num_rows or 0 for _, m in blocks)
        prev = 0
        pieces: List[Dataset] = []
        for idx in list(indices) + [total]:
            lo, hi, rows, refs = _shuffle.overlapping_blocks(
                blocks, prev, idx)
            block_ref, meta_ref = _shuffle._slice_range.options(
                num_returns=2).remote(lo, hi, rows, *refs)
            pieces.append(Dataset(ExecutionPlan(
                [(block_ref, api.get(meta_ref))], stats=self._plan.stats)))
            prev = idx
        return pieces

    # ------------------------------------------------------------ aggregates
    def sum(self, on: Optional[str] = None):
        return self._agg(np.sum, on)

    def min(self, on: Optional[str] = None):
        return self._agg(np.min, on)

    def max(self, on: Optional[str] = None):
        return self._agg(np.max, on)

    def mean(self, on: Optional[str] = None):
        total = self._agg(np.sum, on)
        n = self.count()
        return total / n if n else None

    def std(self, on: Optional[str] = None):
        vals = np.asarray(self._column_values(on))
        return float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0

    def _column_values(self, on: Optional[str]):
        vals: List[Any] = []
        for row in self.iter_rows():
            vals.append(row[on] if on is not None else row)
        return vals

    def _agg(self, op, on: Optional[str]):
        refs = [_block_agg.remote(ref, op, on)
                for ref, _ in self._plan.execute()]
        parts = [p for p in api.get(refs) if p is not None]
        if not parts:
            return None
        result = op(np.asarray(parts))
        return result.item() if hasattr(result, "item") else result

    # ------------------------------------------------------------ conversion
    def to_numpy(self, column: Optional[str] = None):
        batches = list(self.iter_batches(batch_size=None,
                                         batch_format="numpy"))
        if not batches:
            return np.array([])
        if isinstance(batches[0], dict):
            merged = {k: np.concatenate([b[k] for b in batches])
                      for k in batches[0]}
            return merged[column] if column else merged
        return np.concatenate(batches)

    def to_pandas(self):
        import pandas as pd

        frames = list(self.iter_batches(batch_size=None,
                                        batch_format="pandas"))
        return pd.concat(frames, ignore_index=True) if frames else \
            pd.DataFrame()

    def to_torch(self, column: Optional[str] = None, *, device=None):
        """Materialize as a torch.Tensor on ``device`` (one copy of the
        contiguous numpy form) — the terminal op that lands the data on
        the card. ``device=None`` is the card: without one it raises;
        pass ``device="cpu"`` for the host."""
        import torch

        from ..utils.device import resolve_device

        device = resolve_device(device)
        arr = self.to_numpy(column)
        if isinstance(arr, dict):
            return {k: torch.as_tensor(v, device=device)
                    for k, v in arr.items()}
        return torch.as_tensor(arr, device=device)

    def materialize(self) -> "Dataset":
        self._plan.execute()
        return self

    fully_executed = materialize

    def window(self, *, blocks_per_window: int = 10):
        from .pipeline import DatasetPipeline

        return DatasetPipeline.from_dataset(
            self, blocks_per_window=blocks_per_window)

    def repeat(self, times: Optional[int] = None):
        """Repeat the dataset ``times`` epochs; no argument = infinite
        (reference dataset.py repeat semantics)."""
        from .pipeline import DatasetPipeline

        return DatasetPipeline.from_dataset(
            self, blocks_per_window=max(1, self.num_blocks()),
            repeat=-1 if times is None else times)

    # --------------------------------------------------------------- writes
    def write_csv(self, path: str) -> List[str]:
        return self._write(path, "csv")

    def write_json(self, path: str) -> List[str]:
        return self._write(path, "json")

    def write_parquet(self, path: str) -> List[str]:
        return self._write(path, "parquet")

    def _write(self, path: str, fmt: str) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)
        blocks = self._plan.execute()
        refs = [_write_block.remote(ref, path, fmt, i)
                for i, (ref, _) in enumerate(blocks)]
        return api.get(refs)

    # ---------------------------------------------------------------- misc
    def stats(self) -> str:
        return self._plan.stats.summary()

    def _with_stage(self, stage) -> "Dataset":
        return Dataset(self._plan.with_stage(stage))

    def __repr__(self):
        if self._plan.has_lazy_stages():
            return "Dataset(lazy)"
        blocks = self._plan.execute()
        return (f"Dataset(num_blocks={len(blocks)}, "
                f"num_rows={self.count()}, schema={self.schema()})")


class GroupedData:
    """Sort/hash-free hash aggregation (reference data/grouped_dataset.py):
    map tasks partial-aggregate per block by key; the driver merges."""

    def __init__(self, ds: Dataset, key: Union[str, Callable]):
        self._ds = ds
        self._key = key

    def _key_fn(self) -> Callable:
        key = self._key
        return key if callable(key) else (lambda r: r[key])

    def count(self) -> Dict[Any, int]:
        return self._aggregate(lambda rows: len(rows))

    def sum(self, on: Optional[str] = None) -> Dict[Any, Any]:
        return self._aggregate(
            lambda rows: np.sum(_vals(rows, on)).item())

    def min(self, on: Optional[str] = None) -> Dict[Any, Any]:
        return self._aggregate(
            lambda rows: np.min(_vals(rows, on)).item())

    def max(self, on: Optional[str] = None) -> Dict[Any, Any]:
        return self._aggregate(
            lambda rows: np.max(_vals(rows, on)).item())

    def mean(self, on: Optional[str] = None) -> Dict[Any, Any]:
        sums = self._aggregate(
            lambda rows: np.sum(_vals(rows, on)).item())
        counts = self.count()
        return {k: sums[k] / counts[k] for k in sums}

    def map_groups(self, fn: Callable[[List[Any]], Any]) -> Dataset:
        groups = self._collect_groups()
        rows = [fn(v) for v in groups.values()]
        from .read_api import from_items

        return from_items(rows, parallelism=max(1, min(8, len(rows))))

    def _collect_groups(self) -> Dict[Any, List[Any]]:
        key_fn = self._key_fn()
        refs = [_group_block.remote(ref, key_fn)
                for ref, _ in self._ds._plan.execute()]
        merged: Dict[Any, List[Any]] = {}
        for part in api.get(refs):
            for k, rows in part.items():
                merged.setdefault(k, []).extend(rows)
        return merged

    def _aggregate(self, agg: Callable[[List[Any]], Any]) -> Dict[Any, Any]:
        return {k: agg(v) for k, v in sorted(
            self._collect_groups().items(), key=lambda kv: repr(kv[0]))}


def _vals(rows: List[Any], on: Optional[str]):
    return np.asarray([r[on] if on is not None else r for r in rows])


@api.remote
def _group_block(block, key_fn):
    groups: Dict[Any, List[Any]] = {}
    for row in BlockAccessor.for_block(block).iter_rows():
        groups.setdefault(key_fn(row), []).append(row)
    return groups


@api.remote
def _block_agg(block, op, on: Optional[str]):
    acc = BlockAccessor.for_block(block)
    if acc.num_rows() == 0:
        return None
    if on is not None:
        vals = np.asarray([r[on] for r in acc.iter_rows()])
    elif isinstance(block, np.ndarray):
        vals = block
    else:
        vals = np.asarray(list(acc.iter_rows()))
    return op(vals).item()


@api.remote
def _truncate(block, n: int):
    acc = BlockAccessor.for_block(block)
    piece = acc.slice(0, n)
    return piece, BlockAccessor.for_block(piece).get_metadata()


@api.remote
def _zip_slice(my_block, offset: int, count: int,
               other_rows: List[int], *other_blocks):
    """Pair rows [offset, offset+count) of the other dataset with
    my_block's rows."""
    from .shuffle import _rows_like

    other_sel: List[Any] = []
    pos = 0
    for nrows, blk in zip(other_rows, other_blocks):
        lo, hi = pos, pos + nrows
        pos = hi
        if hi <= offset or lo >= offset + count:
            continue
        s = max(offset - lo, 0)
        e = min(offset + count - lo, nrows)
        other_sel.extend(
            BlockAccessor.for_block(
                BlockAccessor.for_block(blk).slice(s, e)).iter_rows())
    rows = []
    for mine, theirs in zip(
            BlockAccessor.for_block(my_block).iter_rows(), other_sel):
        if isinstance(mine, dict) and isinstance(theirs, dict):
            merged = dict(mine)
            for k, v in theirs.items():
                merged[k if k not in merged else f"{k}_1"] = v
            rows.append(merged)
        else:
            rows.append((mine, theirs))
    block = rows
    return block, BlockAccessor.for_block(block).get_metadata()


@api.remote
def _write_block(block, path: str, fmt: str, index: int) -> str:
    import os

    acc = BlockAccessor.for_block(block)
    fname = os.path.join(path, f"part-{index:05d}.{fmt}")
    if fmt == "csv":
        acc.to_pandas().to_csv(fname, index=False)
    elif fmt == "json":
        acc.to_pandas().to_json(fname, orient="records", lines=True)
    elif fmt == "parquet":
        acc.to_pandas().to_parquet(fname, index=False)
    else:
        raise ValueError(fmt)
    return fname
