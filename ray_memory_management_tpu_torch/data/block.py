"""Block model: the unit of distributed data.

The reference's Dataset is a list of object-store blocks with driver-side
metadata (python/ray/data/block.py — Block, BlockMetadata, BlockAccessor;
blocks are arrow/pandas/simple-list). Here a block is one of five shapes,
chosen to keep tensors contiguous end-to-end (zero-copy through the shm
store onto the card, no row-wise boxing):

  - list            — "simple" rows (any Python objects)
  - np.ndarray      — a tensor batch; row i is ``arr[i]``
  - dict[str, np.ndarray] — columnar tensor batch; row i is ``{k: v[i]}``
  - pandas.DataFrame
  - pyarrow.Table

``BlockAccessor.for_block`` dispatches on the runtime type, mirroring the
reference's accessor pattern (data/block.py BlockAccessor.for_block).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def _pandas():
    import pandas as pd

    return pd


def _arrow():
    import pyarrow as pa

    return pa


@dataclass
class BlockMetadata:
    """Driver-side per-block stats (reference data/block.py BlockMetadata)."""

    num_rows: Optional[int]
    size_bytes: Optional[int]
    schema: Any = None
    input_files: List[str] = field(default_factory=list)
    exec_stats: Optional[dict] = None


class BlockAccessor:
    def __init__(self, block: Any):
        self._block = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        if isinstance(block, list):
            return SimpleBlockAccessor(block)
        if isinstance(block, np.ndarray):
            return NumpyBlockAccessor(block)
        if isinstance(block, dict):
            return NumpyDictBlockAccessor(block)
        type_name = type(block).__module__ + "." + type(block).__name__
        if "pandas" in type_name:
            return PandasBlockAccessor(block)
        if "pyarrow" in type_name:
            return ArrowBlockAccessor(block)
        raise TypeError(f"unsupported block type: {type(block)}")

    # interface ---------------------------------------------------------
    def num_rows(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def iter_rows(self) -> Iterator[Any]:
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Any:
        raise NotImplementedError

    def schema(self) -> Any:
        raise NotImplementedError

    def to_batch(self, batch_format: str) -> Any:
        """Convert to the user-facing batch format: 'default'/'native' (the
        block itself), 'numpy' (ndarray or dict of ndarrays), 'pandas'."""
        if batch_format in ("default", "native"):
            return self._block
        if batch_format == "numpy":
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self.to_arrow()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def to_numpy(self):
        raise NotImplementedError

    def to_pandas(self):
        raise NotImplementedError

    def to_arrow(self):
        raise NotImplementedError

    def get_metadata(self, input_files: Optional[List[str]] = None,
                     exec_stats: Optional[dict] = None) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=input_files or [],
            exec_stats=exec_stats,
        )

    def sample(self, n: int, key=None) -> List[Any]:
        rows = list(self.iter_rows())
        if not rows:
            return []
        idx = np.random.default_rng(len(rows)).integers(
            0, len(rows), size=min(n, len(rows)))
        picked = [rows[i] for i in idx]
        if key is not None:
            picked = [key(r) for r in picked]
        return picked


class SimpleBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        import sys

        return sum(sys.getsizeof(r) for r in self._block[:100]) * max(
            1, len(self._block) // max(1, min(100, len(self._block))))

    def iter_rows(self):
        return iter(self._block)

    def slice(self, start, end):
        return self._block[start:end]

    def schema(self):
        return type(self._block[0]).__name__ if self._block else None

    def to_numpy(self):
        first = self._block[0] if self._block else None
        if isinstance(first, dict):
            keys = first.keys()
            return {k: np.asarray([r[k] for r in self._block]) for k in keys}
        return np.asarray(self._block)

    def to_pandas(self):
        pd = _pandas()
        first = self._block[0] if self._block else None
        if isinstance(first, dict):
            return pd.DataFrame(self._block)
        return pd.DataFrame({"value": self._block})

    def to_arrow(self):
        pa = _arrow()
        first = self._block[0] if self._block else None
        if isinstance(first, dict):
            return pa.Table.from_pylist(self._block)
        return pa.table({"value": self._block})


class NumpyBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        return int(self._block.nbytes)

    def iter_rows(self):
        return iter(self._block)

    def slice(self, start, end):
        return self._block[start:end]

    def schema(self):
        return f"ndarray{list(self._block.shape[1:])}:{self._block.dtype}"

    def to_numpy(self):
        return self._block

    def to_pandas(self):
        pd = _pandas()
        if self._block.ndim == 1:
            return pd.DataFrame({"value": self._block})
        return pd.DataFrame({"value": list(self._block)})

    def to_arrow(self):
        pa = _arrow()
        return pa.table({"value": self._block.tolist()})


class NumpyDictBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        if not self._block:
            return 0
        return len(next(iter(self._block.values())))

    def size_bytes(self) -> int:
        return int(sum(np.asarray(v).nbytes for v in self._block.values()))

    def iter_rows(self):
        n = self.num_rows()
        for i in range(n):
            yield {k: v[i] for k, v in self._block.items()}

    def slice(self, start, end):
        return {k: v[start:end] for k, v in self._block.items()}

    def schema(self):
        return {k: str(np.asarray(v).dtype) for k, v in self._block.items()}

    def to_numpy(self):
        return self._block

    def to_pandas(self):
        pd = _pandas()
        return pd.DataFrame({
            k: (v if np.asarray(v).ndim == 1 else list(v))
            for k, v in self._block.items()
        })

    def to_arrow(self):
        pa = _arrow()
        return pa.Table.from_pydict(
            {k: np.asarray(v).tolist() for k, v in self._block.items()})


class PandasBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        return int(self._block.memory_usage(deep=True).sum())

    def iter_rows(self):
        for _, row in self._block.iterrows():
            yield row.to_dict()

    def slice(self, start, end):
        return self._block.iloc[start:end]

    def schema(self):
        return {c: str(t) for c, t in self._block.dtypes.items()}

    def to_numpy(self):
        return {c: self._block[c].to_numpy() for c in self._block.columns}

    def to_pandas(self):
        return self._block

    def to_arrow(self):
        pa = _arrow()
        return pa.Table.from_pandas(self._block, preserve_index=False)


class ArrowBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return self._block.num_rows

    def size_bytes(self) -> int:
        return int(self._block.nbytes)

    def iter_rows(self):
        for row in self._block.to_pylist():
            yield row

    def slice(self, start, end):
        return self._block.slice(start, end - start)

    def schema(self):
        return self._block.schema

    def to_numpy(self):
        return {name: col.to_numpy(zero_copy_only=False)
                for name, col in zip(self._block.column_names,
                                     self._block.columns)}

    def to_pandas(self):
        return self._block.to_pandas()

    def to_arrow(self):
        return self._block


def batch_to_block(batch: Any) -> Any:
    """Normalize a user-returned batch into a block (reference
    data/_internal/output_buffer / batch conversions)."""
    if isinstance(batch, (list, np.ndarray)):
        return batch
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    return batch  # pandas / arrow pass through


def concat_blocks(blocks: List[Any]) -> Any:
    blocks = [b for b in blocks if BlockAccessor.for_block(b).num_rows() > 0]
    if not blocks:
        return []
    first = blocks[0]
    if len(blocks) == 1:
        return first
    if isinstance(first, list):
        out: List[Any] = []
        for b in blocks:
            out.extend(b)
        return out
    if isinstance(first, np.ndarray):
        return np.concatenate(blocks, axis=0)
    if isinstance(first, dict):
        keys = first.keys()
        return {k: np.concatenate([np.asarray(b[k]) for b in blocks], axis=0)
                for k in keys}
    type_name = type(first).__module__
    if "pandas" in type_name:
        pd = _pandas()
        return pd.concat(blocks, ignore_index=True)
    if "pyarrow" in type_name:
        pa = _arrow()
        return pa.concat_tables(blocks)
    raise TypeError(f"cannot concat block type {type(first)}")


class DelegatingBlockBuilder:
    """Accumulate rows/blocks and emit one block of the right shape
    (reference data/_internal/delegating_block_builder.py)."""

    def __init__(self):
        self._rows: List[Any] = []
        self._blocks: List[Any] = []

    def add(self, row: Any) -> None:
        self._rows.append(row)

    def add_block(self, block: Any) -> None:
        if self._rows:
            self._blocks.append(self._rows)
            self._rows = []
        self._blocks.append(block)

    def num_rows(self) -> int:
        n = len(self._rows)
        for b in self._blocks:
            n += BlockAccessor.for_block(b).num_rows()
        return n

    def build(self) -> Any:
        blocks = list(self._blocks)
        if self._rows:
            blocks.append(list(self._rows))
        if not blocks:
            return []
        return concat_blocks(blocks)
