"""The port's harnesses over the device tier, health, Train, the job
plane and the serve, scale and pod curves: copies of
``tests/test_bench_format.py``'s health, elastic and device
``*_reports_required_fields`` cases at the same mini sizes and with the
same assertions (the device suite on CPU tensors, ``device="cpu"``), one
case for ``run_job_plane_suite(mini=True)``, and the reference's three
``slow`` curve cases with the same mark (on the card, ``chip_smoke.py``
runs them). The ``REQUIRED_*_FIELDS`` lists come from the root
``bench.py``, loaded as the reference test loads it.
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


def test_health_suite_reports_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.health_bench import (
        run_health_suite,
    )

    out = run_health_suite(n_tasks=16, trials=1, sim_nodes=16, n_rules=3)
    missing = [k for k in bench.REQUIRED_HEALTH_FIELDS if k not in out]
    assert not missing, missing
    assert out["health_on_tasks_per_s"] > 0
    assert out["health_off_tasks_per_s"] > 0
    assert out["rule_eval_ms"] >= 0
    assert out["store_points"] > 0  # the rings actually filled


def test_elastic_suite_reports_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.train_elastic_bench import (
        run_elastic_suite,
    )

    out = run_elastic_suite(n_steps=6, checkpoint_every=2, payload_kb=8,
                            save_trials=3)
    missing = [k for k in bench.REQUIRED_ELASTIC_FIELDS if k not in out]
    assert not missing, missing
    assert out["steps_per_s_ckpt_off"] > 0
    assert out["steps_per_s_ckpt_sync"] > 0
    assert out["steps_per_s_ckpt_async"] > 0
    assert out["blocking_ms_sync"] > 0
    # the acceptance property: async blocks the step for a small
    # fraction of the sync write
    assert out["async_blocking_vs_sync_pct"] < 50


def test_device_suite_reports_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.device_bench import (
        run_device_suite,
    )

    out = run_device_suite(payload_mb=4, trials=1, sweep_mb=(1,),
                           device="cpu")
    missing = [k for k in bench.REQUIRED_DEVICE_FIELDS if k not in out]
    assert not missing, missing
    assert out["zero_copy_gbps"] > 0
    assert out["shm_roundtrip_gbps"] > 0
    # the zero-copy proof: the read skipped serialization outright
    assert out["bytes_avoided_mb"] > 0
    assert out["demotion_evictions"] >= 1
    assert out["eviction_sweep"] and out["eviction_sweep"][0]["evictions"] > 0
    # ici_move, one device: the zero-length transfer, counted once a trial
    assert out["ici_transfers"] == 1


def test_job_plane_suite_reports_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.job_plane_bench import (
        run_job_plane_suite,
    )

    out = run_job_plane_suite(mini=True)
    missing = [k for k in bench.REQUIRED_JOB_FIELDS if k not in out]
    assert not missing, missing
    assert out["single_job_tasks_per_s"] > 0
    assert out["multi_job_tasks_per_s"] > 0
    assert out["churn_jobs"] > 0 and out["churn_kills"] > 0
    assert out["sweep_leaked_rows"] == 0
    assert out["churn_leaked_rows"] == 0
    assert out["churn_leaked_device_bytes"] == 0


@pytest.mark.slow
def test_scale_curve_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.scale_bench import (
        run_scale_curve,
    )

    out = run_scale_curve(node_counts=(1, 2), per_node_cpus=1,
                          n_tasks=100, n_actors=2, trials=1)
    missing = [k for k in bench.REQUIRED_SCALE_CURVE_FIELDS
               if k not in out]
    assert not missing, missing
    assert out["nodes"] == [1, 2]
    assert set(out["many_tasks_per_s"]) == {"1", "2"}
    assert all(v > 0 for v in out["many_tasks_per_s"].values())
    assert all(v > 0 for v in out["many_actors_per_s"].values())
    # only 1 and 4-node points define the 1->4 factor; a 2-point run
    # leaves it None rather than inventing a ratio
    assert out["tasks_scaling_1_to_4"] is None
    row = out["stats"]["many_tasks_per_s"]["1"]
    assert {"median", "min", "max", "trials"} <= set(row)


@pytest.mark.slow
def test_pod_curve_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.pod_bench import run_pod_curve

    out = run_pod_curve(node_counts=(2, 4), tasks_per_point=80,
                        rows_target=3000, hot_max_rows=512,
                        rows_per_agent_chunk=250)
    missing = [k for k in bench.REQUIRED_POD_FIELDS if k not in out]
    assert not missing, missing
    assert out["nodes"] == [2, 4]
    assert set(out["tasks_per_s"]) == {"2", "4"}
    assert all(v > 0 for v in out["tasks_per_s"].values())
    assert all(v > 0 for v in out["dir_p99_us"].values())
    assert all(v > 0 for v in out["head_rss_mb"].values())
    rows = out["rows"]
    assert rows["total"] >= rows["target"] == 3000
    assert rows["cold"] > 0  # the hot cap engaged during the flood
    assert rows["rss_mb_at_rows"] > 0


@pytest.mark.slow
def test_serve_suite_required_fields(bench):
    from ray_memory_management_tpu_torch.utils.serve_bench import (
        run_serve_suite,
    )

    out = run_serve_suite(mini=True, device="cpu")
    missing = [k for k in bench.REQUIRED_SERVE_FIELDS if k not in out]
    assert not missing, missing
    assert out["paged_slots"] > out["slab_slots"]
    assert out["paged_slots_ratio"] >= 1.5
    assert out["continuous_tokens_per_s"] > 0
    assert out["cold_start_shipped_s"] > 0
    assert out["n_requests"] > 0
