"""Data library tests (reference python/ray/data/tests coverage shape:
test_dataset.py basics, block formats, shuffle/sort, splits, pipeline).

The PyTorch port's copy of ``tests/test_data.py``: the same cases run
against ``ray_memory_management_tpu_torch``, with its own fixture (the
shared conftest starts the JAX package's runtime). ``test_to_jax``
becomes ``test_to_torch`` (``Dataset.to_torch(device="cpu")``)."""

import os

import numpy as np
import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import data as rd
from ray_memory_management_tpu_torch.data import ActorPoolStrategy
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def rmt_start_regular():
    """One runtime for the module's cases (each case's own init and
    shutdown cost about 2 s here, twenty times its body)."""
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


class TestCreation:
    def test_range(self, rmt_start_regular):
        ds = rd.range(100, parallelism=4)
        assert ds.count() == 100
        assert ds.num_blocks() == 4
        assert ds.take(5) == [0, 1, 2, 3, 4]

    def test_range_tensor(self, rmt_start_regular):
        ds = rd.range_tensor(16, shape=(2, 2), parallelism=2)
        assert ds.count() == 16
        row = ds.take(1)[0]
        assert row.shape == (2, 2)
        assert (row == 0).all()

    def test_from_items(self, rmt_start_regular):
        ds = rd.from_items([{"a": i, "b": -i} for i in range(10)],
                           parallelism=3)
        assert ds.count() == 10
        assert ds.take(2) == [{"a": 0, "b": 0}, {"a": 1, "b": -1}]

    def test_from_numpy(self, rmt_start_regular):
        arr = np.arange(24, dtype=np.float32).reshape(8, 3)
        ds = rd.from_numpy(arr)
        out = ds.to_numpy()
        np.testing.assert_array_equal(out, arr)

    def test_from_pandas(self, rmt_start_regular):
        import pandas as pd

        df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
        ds = rd.from_pandas(df)
        assert ds.count() == 3
        assert ds.take(1) == [{"x": 1, "y": "a"}]


class TestTransforms:
    def test_map(self, rmt_start_regular):
        ds = rd.range(10, parallelism=2).map(lambda x: x * 2)
        assert ds.take_all() == [x * 2 for x in range(10)]

    def test_filter_flat_map_fuse(self, rmt_start_regular):
        ds = (rd.range(10, parallelism=2)
              .filter(lambda x: x % 2 == 0)
              .flat_map(lambda x: [x, x]))
        assert ds.take_all() == [0, 0, 2, 2, 4, 4, 6, 6, 8, 8]
        # fused one-to-one stages execute as a single pass
        assert any("+" in name for name, _, _ in ds._plan.stats.stages)

    def test_map_batches_numpy(self, rmt_start_regular):
        ds = rd.range_tensor(8, shape=(3,), parallelism=2)
        out = ds.map_batches(lambda b: b + 1.0, batch_format="numpy")
        first = out.take(1)[0]
        assert (first == 1.0).all()

    def test_map_batches_pandas(self, rmt_start_regular):
        ds = rd.from_items([{"v": i} for i in range(8)], parallelism=2)

        def add_col(df):
            df["w"] = df["v"] * 10
            return df

        out = ds.map_batches(add_col, batch_format="pandas")
        assert out.take(1) == [{"v": 0, "w": 0}]

    def test_map_batches_actor_compute(self, rmt_start_regular):
        ds = rd.range(12, parallelism=3).map_batches(
            lambda b: [v + 100 for v in b],
            compute=ActorPoolStrategy(size=2))
        assert sorted(ds.take_all()) == [v + 100 for v in range(12)]

    def test_add_drop_columns(self, rmt_start_regular):
        ds = rd.from_items([{"a": i} for i in range(4)])
        ds2 = ds.add_column("b", lambda df: df["a"] * 2)
        assert ds2.take(1) == [{"a": 0, "b": 0}]
        ds3 = ds2.drop_columns(["a"])
        assert ds3.take(1) == [{"b": 0}]


class TestAllToAll:
    def test_repartition(self, rmt_start_regular):
        ds = rd.range(20, parallelism=2).repartition(5)
        assert ds.num_blocks() == 5
        assert ds.count() == 20
        assert ds.take_all() == list(range(20))

    def test_random_shuffle(self, rmt_start_regular):
        ds = rd.range(50, parallelism=4).random_shuffle(seed=7)
        rows = ds.take_all()
        assert sorted(rows) == list(range(50))
        assert rows != list(range(50))

    def test_shuffle_deterministic_seed(self, rmt_start_regular):
        a = rd.range(30, parallelism=3).random_shuffle(seed=5).take_all()
        b = rd.range(30, parallelism=3).random_shuffle(seed=5).take_all()
        assert a == b

    def test_sort_simple(self, rmt_start_regular):
        ds = rd.range(40, parallelism=4).random_shuffle(seed=1).sort()
        assert ds.take_all() == list(range(40))

    def test_sort_key_descending(self, rmt_start_regular):
        ds = rd.from_items(
            [{"k": i % 5, "v": i} for i in range(20)], parallelism=2)
        rows = ds.sort(key="k").take_all()
        assert [r["k"] for r in rows] == sorted(i % 5 for i in range(20))
        rows_d = ds.sort(key="k", descending=True).take_all()
        assert [r["k"] for r in rows_d] == sorted(
            (i % 5 for i in range(20)), reverse=True)

    def test_groupby(self, rmt_start_regular):
        ds = rd.from_items(
            [{"k": i % 3, "v": i} for i in range(12)], parallelism=3)
        g = ds.groupby("k")
        assert g.count() == {0: 4, 1: 4, 2: 4}
        assert g.sum("v") == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10,
                              2: 2 + 5 + 8 + 11}
        assert g.mean("v")[0] == (0 + 3 + 6 + 9) / 4

    def test_zip(self, rmt_start_regular):
        a = rd.range(8, parallelism=2)
        b = rd.range(8, parallelism=2).map(lambda x: x * 10)
        rows = a.zip(b).take_all()
        assert rows == [(i, i * 10) for i in range(8)]

    def test_union(self, rmt_start_regular):
        a = rd.range(5, parallelism=1)
        b = rd.range(5, parallelism=1).map(lambda x: x + 5)
        assert a.union(b).take_all() == list(range(10))


class TestConsume:
    def test_iter_batches(self, rmt_start_regular):
        ds = rd.range(10, parallelism=3)
        batches = list(ds.iter_batches(batch_size=4, batch_format="numpy"))
        assert [len(b) for b in batches] == [4, 4, 2]
        np.testing.assert_array_equal(
            np.concatenate(batches), np.arange(10))

    def test_iter_batches_drop_last(self, rmt_start_regular):
        ds = rd.range(10, parallelism=2)
        batches = list(ds.iter_batches(batch_size=4, drop_last=True,
                                       batch_format="numpy"))
        assert [len(b) for b in batches] == [4, 4]

    def test_split(self, rmt_start_regular):
        ds = rd.range(12, parallelism=4)
        parts = ds.split(2)
        assert sum(p.count() for p in parts) == 12

    def test_split_equal(self, rmt_start_regular):
        ds = rd.range(10, parallelism=3)
        parts = ds.split(2, equal=True)
        assert [p.count() for p in parts] == [5, 5]
        assert sorted(parts[0].take_all() + parts[1].take_all()) == \
            list(range(10))

    def test_limit_take(self, rmt_start_regular):
        ds = rd.range(100, parallelism=4).limit(7)
        assert ds.count() == 7
        assert ds.take_all() == list(range(7))

    def test_aggregates(self, rmt_start_regular):
        ds = rd.range(10, parallelism=3)
        assert ds.sum() == 45
        assert ds.min() == 0
        assert ds.max() == 9
        assert ds.mean() == 4.5
        ds2 = rd.from_items([{"v": i} for i in range(5)])
        assert ds2.sum("v") == 10

    def test_to_torch(self, rmt_start_regular):
        import torch

        ds = rd.range_tensor(8, shape=(2,), parallelism=2)
        arr = ds.to_torch(device="cpu")
        assert isinstance(arr, torch.Tensor)
        assert arr.shape == (8, 2)

    def test_schema_repr(self, rmt_start_regular):
        ds = rd.range_tensor(4, shape=(2,), parallelism=1)
        assert "int64" in ds.schema()
        assert "num_rows=4" in repr(ds.materialize())


class TestIO:
    def test_csv_roundtrip(self, rmt_start_regular, tmp_path):
        ds = rd.from_items([{"a": i, "b": i * 2} for i in range(10)],
                           parallelism=2)
        out = str(tmp_path / "csvs")
        files = ds.write_csv(out)
        assert len(files) == 2
        back = rd.read_csv(out)
        assert back.count() == 10
        assert sorted(r["a"] for r in back.take_all()) == list(range(10))
        assert back.input_files()

    def test_json_roundtrip(self, rmt_start_regular, tmp_path):
        ds = rd.from_items([{"x": i} for i in range(6)], parallelism=2)
        out = str(tmp_path / "jsons")
        ds.write_json(out)
        back = rd.read_json(out)
        assert sorted(r["x"] for r in back.take_all()) == list(range(6))

    def test_parquet_roundtrip(self, rmt_start_regular, tmp_path):
        ds = rd.from_items([{"x": i, "y": float(i)} for i in range(8)],
                           parallelism=2)
        out = str(tmp_path / "pq")
        ds.write_parquet(out)
        back = rd.read_parquet(out)
        assert back.count() == 8
        assert back.sum("x") == sum(range(8))

    def test_read_text(self, rmt_start_regular, tmp_path):
        p = tmp_path / "t.txt"
        p.write_text("alpha\nbeta\ngamma\n")
        ds = rd.read_text(str(p))
        assert ds.take_all() == ["alpha", "beta", "gamma"]

    def test_read_binary(self, rmt_start_regular, tmp_path):
        p = tmp_path / "b.bin"
        p.write_bytes(b"\x00\x01\x02")
        ds = rd.read_binary_files(str(p))
        assert ds.take_all() == [b"\x00\x01\x02"]


class TestPipeline:
    def test_window_iter(self, rmt_start_regular):
        pipe = rd.range(20, parallelism=4).window(blocks_per_window=2)
        assert pipe.num_windows() == 2
        assert pipe.count() == 20

    def test_pipeline_transforms(self, rmt_start_regular):
        pipe = (rd.range(12, parallelism=4)
                .window(blocks_per_window=2)
                .map(lambda x: x + 1))
        assert sorted(pipe.take(12)) == list(range(1, 13))

    def test_repeat(self, rmt_start_regular):
        pipe = rd.range(4, parallelism=2).repeat(3)
        rows = list(pipe.iter_rows())
        assert len(rows) == 12

    def test_pipeline_split(self, rmt_start_regular):
        pipe = rd.range(8, parallelism=4).window(blocks_per_window=4)
        shards = pipe.split(2)
        counts = [sum(1 for _ in s.iter_rows()) for s in shards]
        assert sum(counts) == 8

    def test_pipeline_batches(self, rmt_start_regular):
        pipe = rd.range(16, parallelism=4).window(blocks_per_window=2)
        batches = list(pipe.iter_batches(batch_size=4, batch_format="numpy"))
        assert sum(len(b) for b in batches) == 16
