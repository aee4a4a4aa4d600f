"""Dataset creation: ranges, items, arrays, files.

The reference's read API (python/ray/data/read_api.py — range, from_items,
from_numpy/pandas/arrow, read_csv/json/parquet/text/binary_files via
datasources, data/datasource/). File reads are one task per file; ranges
and items are partitioned driver-side into ``parallelism`` blocks.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, List, Optional

import numpy as np

from .. import api
from .block import BlockAccessor
from .dataset import Dataset
from .plan import BlockList, ExecutionPlan


_py_range = range  # the builtin, shadowed by the public range() below


def _make_dataset(blocks: BlockList) -> Dataset:
    return Dataset(ExecutionPlan(blocks))


def _put_block(block) -> tuple:
    meta = BlockAccessor.for_block(block).get_metadata()
    return api.put(block), meta


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    """Integers [0, n) as simple rows (reference read_api.range)."""
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1).astype(int)
    blocks = [_put_block(list(_py_range(int(lo), int(hi))))
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    return _make_dataset(blocks)


def range_tensor(n: int, *, shape=(1,), parallelism: int = 8) -> Dataset:
    """ndarray blocks of shape [rows, *shape] (read_api.range_tensor) —
    rows are tensors, stored contiguously."""
    parallelism = max(1, min(parallelism, n or 1))
    bounds = np.linspace(0, n, parallelism + 1).astype(int)
    blocks = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        base = np.arange(int(lo), int(hi), dtype=np.int64)
        arr = np.broadcast_to(
            base.reshape((-1,) + (1,) * len(shape)),
            (len(base),) + tuple(shape)).copy()
        blocks.append(_put_block(arr))
    return _make_dataset(blocks)


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    parallelism = max(1, min(parallelism, len(items) or 1))
    bounds = np.linspace(0, len(items), parallelism + 1).astype(int)
    blocks = [_put_block(list(items[int(lo):int(hi)]))
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    return _make_dataset(blocks)


def from_numpy(arrays) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return _make_dataset([_put_block(np.asarray(a)) for a in arrays])


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return _make_dataset([_put_block(df) for df in dfs])


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return _make_dataset([_put_block(t) for t in tables])


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise ValueError(f"no input files found for {paths}")
    return out


def _read_files(paths, reader_fn) -> Dataset:
    files = _expand_paths(paths)
    out_refs = [_read_file_task.options(num_returns=2).remote(f, reader_fn)
                for f in files]
    blocks = [(b, api.get(m)) for b, m in out_refs]
    return _make_dataset(blocks)


@api.remote
def _read_file_task(path: str, reader_fn):
    block = reader_fn(path)
    meta = BlockAccessor.for_block(block).get_metadata(input_files=[path])
    return block, meta


def read_csv(paths, **kwargs) -> Dataset:
    def reader(path):
        import pandas as pd

        return pd.read_csv(path, **kwargs)

    return _read_files(paths, reader)


def read_json(paths, *, lines: bool = True, **kwargs) -> Dataset:
    def reader(path):
        import pandas as pd

        return pd.read_json(path, lines=lines, **kwargs)

    return _read_files(paths, reader)


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    def reader(path):
        import pyarrow.parquet as pq

        return pq.read_table(path, columns=columns)

    return _read_files(paths, reader)


def read_text(paths, *, encoding: str = "utf-8") -> Dataset:
    def reader(path):
        with open(path, encoding=encoding) as f:
            return [line.rstrip("\n") for line in f]

    return _read_files(paths, reader)


def read_binary_files(paths) -> Dataset:
    def reader(path):
        with open(path, "rb") as f:
            return [f.read()]

    return _read_files(paths, reader)


def read_numpy(paths) -> Dataset:
    def reader(path):
        return np.load(path)

    return _read_files(paths, reader)
