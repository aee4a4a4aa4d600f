"""DatasetPipeline: windowed streaming execution.

The reference's pipelining layer (python/ray/data/dataset_pipeline.py +
_internal/pipeline_executor.py): a dataset is split into windows of
blocks; per-window transforms execute while earlier windows are being
consumed, overlapping ingest with compute — the input-pipeline shape that
keeps a GPU step loop fed.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, List, Optional

from .dataset import Dataset
from .plan import ExecutionPlan


class DatasetPipeline:
    def __init__(self, windows_fn: Callable[[], Iterator[Dataset]],
                 length: Optional[int] = None):
        self._windows_fn = windows_fn
        self._length = length
        self._consumed = False

    @staticmethod
    def from_dataset(ds: Dataset, *, blocks_per_window: int = 10,
                     repeat: Optional[int] = None) -> "DatasetPipeline":
        blocks = ds._plan.execute()
        windows: List[Dataset] = []
        for i in range(0, len(blocks), blocks_per_window):
            windows.append(Dataset(ExecutionPlan(
                blocks[i:i + blocks_per_window], stats=ds._plan.stats)))

        if repeat is None:
            def gen():
                return iter(windows)

            return DatasetPipeline(gen, length=len(windows))

        def gen_repeat():
            if repeat <= 0:  # infinite
                return (w for w in itertools.cycle(windows))
            return (w for _ in range(repeat) for w in windows)

        return DatasetPipeline(
            gen_repeat,
            length=None if repeat <= 0 else len(windows) * repeat)

    # per-window transforms: lazily applied as windows stream through
    def map(self, fn, **kwargs) -> "DatasetPipeline":
        return self._transform(lambda ds: ds.map(fn, **kwargs))

    def map_batches(self, fn, **kwargs) -> "DatasetPipeline":
        return self._transform(lambda ds: ds.map_batches(fn, **kwargs))

    def filter(self, fn, **kwargs) -> "DatasetPipeline":
        return self._transform(lambda ds: ds.filter(fn, **kwargs))

    def flat_map(self, fn, **kwargs) -> "DatasetPipeline":
        return self._transform(lambda ds: ds.flat_map(fn, **kwargs))

    def random_shuffle_each_window(self, *, seed=None) -> "DatasetPipeline":
        return self._transform(lambda ds: ds.random_shuffle(seed=seed))

    def repartition_each_window(self, n: int) -> "DatasetPipeline":
        return self._transform(lambda ds: ds.repartition(n))

    def _transform(self, f: Callable[[Dataset], Dataset]) -> "DatasetPipeline":
        prev = self._windows_fn

        def gen():
            return (f(w) for w in prev())

        return DatasetPipeline(gen, length=self._length)

    # consumption
    def iter_datasets(self) -> Iterator[Dataset]:
        self._mark_consumed()
        return iter(self._windows_fn())

    def iter_rows(self) -> Iterator[Any]:
        for ds in self.iter_datasets():
            yield from ds.iter_rows()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        for ds in self.iter_datasets():
            yield from ds.iter_batches(**kwargs)

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def count(self) -> int:
        return sum(ds.count() for ds in self.iter_datasets())

    def split(self, n: int) -> List["DatasetPipeline"]:
        """Split each window across n consumers (used per-host)."""
        base = self._windows_fn

        def make(idx: int) -> "DatasetPipeline":
            def gen():
                return (w.split(n)[idx] for w in base())

            return DatasetPipeline(gen, length=self._length)

        return [make(i) for i in range(n)]

    def num_windows(self) -> Optional[int]:
        return self._length

    def _mark_consumed(self) -> None:
        self._consumed = True
