"""The port's measurement harnesses emit every field the bench contract
names: copies of ``tests/test_bench_format.py``'s
``*_reports_required_fields`` cases for the transfer, compression,
locality, tracing, logging and profile suites, run against
``ray_memory_management_tpu_torch.utils`` at the same mini sizes and with
the same assertions. The ``REQUIRED_*_FIELDS`` lists are read from the
root ``bench.py``, loaded as the reference test loads it (the port's
package never reads it). The codecs offered are whatever the host has:
nothing here assumes ``lz4``.
"""

import importlib.util
import os

import pytest

from _port_fixtures import one_intra_op_thread  # noqa: F401

_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench.py")


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("rmt_bench", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_transfer_microbench_reports_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.transfer_bench import (
        run_transfer_microbench,
    )

    out = run_transfer_microbench(small_pulls=25, payload_mb=16, n_dests=2)
    missing = [k for k in bench.REQUIRED_TRANSFER_FIELDS if k not in out]
    assert not missing, missing
    assert out["stripe_requests"] >= 1
    assert 0.0 <= out["pool_hit_rate"] <= 1.0
    # the distribution-tree egress property, in bytes: naive serves every
    # copy off one node; the chain caps any single node at ~one copy
    assert out["naive_source_bytes"] == 2 * out["chain_max_source_bytes"]


def test_compression_bench_reports_required_fields(bench):
    from ray_memory_management_tpu_torch.core import codec
    from ray_memory_management_tpu_torch.utils.transfer_bench import (
        run_compression_bench,
    )

    out = run_compression_bench(payload_mb=8, n_dests=2, trials=1,
                                overhead_trials=1)
    missing = [k for k in bench.REQUIRED_COMPRESSION_FIELDS
               if k not in out]
    assert not missing, missing
    assert set(out["codecs_offered"]) <= set(codec.available_codecs())
    for name in out["corpora"]:
        assert out["corpus_effective_gbps"][name] > 0, name
        assert out["corpus_raw_gbps"][name] > 0, name
        assert out["corpus_uncompressed_gbps"][name] > 0, name
        assert out["corpus_ratio"][name] >= 1.0, name
    # the sparse gradient corpus must actually compress on the wire
    assert out["corpus_ratio"]["sparse-grad"] > 2.0
    assert out["corpus_codec"]["random"] is None  # probe skipped it
    assert out["broadcast_effective_gbps"] > 0
    # per-precision accuracy: f32 bit-exact, sub-f32 within envelope
    assert out["allreduce_err"]["f32"] == 0.0
    assert 0 < out["allreduce_err"]["bf16"] <= 2.0 ** -7
    assert 0 < out["allreduce_err"]["int8"] <= 1.5 / 127.0
    assert out["allreduce_wire_factor"]["bf16"] == pytest.approx(2.0)
    assert out["allreduce_wire_factor"]["int8"] > 3.0


def test_locality_suite_reports_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.locality_bench import (
        run_locality_suite,
    )

    out = run_locality_suite(n_nodes=2, n_tasks=4, arg_mb=4, trials=1)
    missing = [k for k in bench.REQUIRED_LOCALITY_FIELDS if k not in out]
    assert not missing, missing
    assert out["locality_on_tasks_per_s"] > 0
    assert out["locality_off_tasks_per_s"] > 0
    assert out["locality_bytes_avoided_mb"] > 0
    # the prestage proof: a forced non-holder placement pulled its arg
    # while the task rode the dispatch queue
    assert out["prefetch_completed"] >= 1
    assert out["prefetch_overlap_ms"] > 0


@pytest.mark.parametrize("suite", ["tracing", "logging", "profile"])
def test_overhead_suite_reports_required_fields(bench, suite):
    """The three on/off overhead suites (the reference's tracing, logging
    and profile cases, one case each)."""
    from importlib import import_module

    mod = import_module(
        f"ray_memory_management_tpu_torch.utils.{suite}_bench")
    out = getattr(mod, f"run_{suite}_suite")(n_tasks=16, trials=1)
    required = getattr(bench, f"REQUIRED_{suite.upper()}_FIELDS")
    missing = [k for k in required if k not in out]
    assert not missing, missing
    assert out[f"{suite}_on_tasks_per_s"] > 0
    assert out[f"{suite}_off_tasks_per_s"] > 0
