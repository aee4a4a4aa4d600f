"""Workflow against the JAX package, and the port's rules for tensors and
the card.

- A two-step workflow (a step over a seeded numpy array, then a step
  that reduces its result) runs on each package's runtime in turn: the
  same output and status; its second step fails once, the workflow is
  FAILED, and ``rerun`` takes the first step's result from storage (it
  ran once) and gives the same output in both.
- The port's storage keeps a step's tensors bit-equal (fp32 and bf16,
  which numpy cannot hold), on their device; a CUDA tensor loaded where
  there is no card raises instead of landing on the CPU.
- A ``step(num_gpus=1)`` whose lease names a GPU with no card behind it
  fails the workflow: ``run`` raises and ``get_status`` is FAILED.
"""

import functools
import importlib

import numpy as np
import pytest
from _port_fixtures import one_intra_op_thread  # noqa: F401

PACKAGES = {"jax": "ray_memory_management_tpu",
            "torch": "ray_memory_management_tpu_torch"}


@functools.lru_cache(maxsize=None)
def _program(kind: str, base: str) -> dict:
    rmt = importlib.import_module(PACKAGES[kind])
    workflow = importlib.import_module(PACKAGES[kind] + ".workflow")
    values = np.random.default_rng(4).standard_normal((16, 8))
    marker = f"{base}/{kind}.failed_once"
    ran = f"{base}/{kind}.ran"

    @workflow.step
    def column_means(x, ran_log):
        with open(ran_log, "a") as f:
            f.write("1")
        return x.mean(axis=0)

    @workflow.step
    def scaled_norm(m, marker_path):
        import os

        if marker_path and not os.path.exists(marker_path):
            open(marker_path, "w").close()
            raise RuntimeError("injected failure")
        return float(np.sqrt((m ** 2).sum()) * 3.0)

    old = workflow.get_storage()
    workflow.set_storage(f"{base}/{kind}")
    rmt.init(num_cpus=2)
    try:
        out = {"value": workflow.run(scaled_norm.step(
            column_means.step(values, ran), ""), workflow_id="two")}
        out["status"] = workflow.get_status("two")
        dag = scaled_norm.options(max_retries=0).step(
            column_means.step(values, ran), marker)
        with pytest.raises(Exception, match="injected failure"):
            workflow.run(dag, workflow_id="resumed")
        out["failed_status"] = workflow.get_status("resumed")
        out["resumed"] = workflow.rerun(dag, workflow_id="resumed")
        out["resumed_status"] = workflow.get_status("resumed")
        with open(ran) as f:
            out["first_step_runs"] = len(f.read())
        return out
    finally:
        rmt.shutdown()
        workflow.set_storage(old)


def test_two_step_workflow_matches_jax(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("wf"))
    want, got = _program("jax", base), _program("torch", base)
    assert got == want
    assert got["status"] == got["resumed_status"] == "SUCCESS"
    assert got["failed_status"] == "FAILED"
    assert got["resumed"] == got["value"]
    # one run per workflow: the rerun loaded the first step from storage
    assert got["first_step_runs"] == 2


def test_storage_keeps_tensors_bit_equal(tmp_path):
    import torch

    from ray_memory_management_tpu_torch.workflow.storage import (
        WorkflowStorage,
    )

    gen = torch.Generator().manual_seed(0)
    result = {"f32": torch.randn(5, 7, generator=gen),
              "bf16": torch.randn(33, generator=gen).to(torch.bfloat16),
              "meta": [1, "x"]}
    store = WorkflowStorage("t", base=str(tmp_path))
    store.save_step_result("s", result)
    back = store.load_step_result("s")
    for k in ("f32", "bf16"):
        assert back[k].dtype == result[k].dtype
        assert back[k].device.type == "cpu"
        assert torch.equal(back[k].view(torch.int16 if k == "bf16"
                                        else torch.int32),
                           result[k].view(torch.int16 if k == "bf16"
                                          else torch.int32))
    assert back["meta"] == [1, "x"]


def test_a_stored_cuda_tensor_never_lands_on_the_cpu(monkeypatch):
    """A step result holding a CUDA tensor, loaded in a process without a
    card (this one), raises: it does not come back on the CPU unseen."""
    import torch

    from ray_memory_management_tpu_torch.workflow import storage

    assert not torch.cuda.is_available()
    host = np.arange(6, dtype=np.float32)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with pytest.raises(RuntimeError, match="without a card"):
        storage._load_tensor(host, "float32", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RuntimeError, match="without a card"):
        storage._load_tensor(host, "float32", "cuda")
    t = storage._load_tensor(host, "float32", "cpu")
    assert t.device.type == "cpu" and t.tolist() == host.tolist()


@pytest.fixture
def rmt_named_gpus(monkeypatch, tmp_path):
    """A node whose CUDA_VISIBLE_DEVICES names card "5": one GPU counted,
    no card behind it; workflow storage under ``tmp_path``."""
    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import workflow

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5")
    old = workflow.get_storage()
    workflow.set_storage(str(tmp_path / "wf"))
    rt = rmt.init(num_cpus=2)
    yield rt
    rmt.shutdown()
    workflow.set_storage(old)


def test_gpu_step_without_a_card_fails_the_workflow(rmt_named_gpus,
                                                    tmp_path):
    import torch

    from ray_memory_management_tpu_torch import workflow
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    q = torch.ones(1, 4, 8)
    step = workflow.step(num_gpus=1, max_retries=0)(runtime_smoke.attend_step)
    with pytest.raises(Exception, match="card is not visible"):
        workflow.run(step.step(q, q, q, str(tmp_path / "log")),
                     workflow_id="gpu")
    assert workflow.get_status("gpu") == workflow.FAILED
    assert not (tmp_path / "log").exists()
