"""Train library tests: the minimum end-to-end slice — trainer →
placement group → worker actors → collective DP → session reports →
checkpoints → resume → elastic restart.

The PyTorch port's copy of ``tests/test_train.py``: ``TorchTrainer``
where the original has ``JaxTrainer``, tensors (saved with
``torch.save``) where it has jax arrays (saved with orbax), the port's
GPT and ``torch.optim.Adam`` in the model loop. The two
``test_xla_*`` cases run the port's ``dist`` world (``"xla"`` is its
alias) over gloo: two worker processes form one process group, and the
data-parallel gradient over a DeviceMesh equals the full-batch value.
(The originals fail in the reference run; these must pass.) The chip
partitioning cases partition device NAMES (ROADMAP C).
"""

import os

import numpy as np
import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.train import (
    Checkpoint,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
)
from _port_fixtures import one_intra_op_thread  # noqa: F401


_shared = []  # the runtime of the cases that take rmt_start_regular


@pytest.fixture
def rmt_start_regular():
    """One runtime for every case of this module that takes this fixture
    (the conftest's fixture starts one per case): made at the first such
    case and kept for the next; ``_own_runtime`` shuts it down before a
    case that starts its own, and ``_end_shared`` at the module's end."""
    from ray_memory_management_tpu_torch import _worker_context

    if not _shared or _worker_context.get_runtime() is not _shared[0]:
        rmt.shutdown()
        _shared[:] = [rmt.init(num_cpus=4)]
    return _shared[0]


@pytest.fixture(autouse=True)
def _own_runtime(request):
    if _shared and "rmt_start_regular" not in request.fixturenames:
        rmt.shutdown()
        _shared.clear()


@pytest.fixture(autouse=True, scope="module")
def _end_shared():
    yield
    rmt.shutdown()
    _shared.clear()


# ------------------------------------------------------------- checkpoint
def test_checkpoint_dict_bytes_roundtrip(tmp_path):
    ck = Checkpoint.from_dict({"a": 1, "arr": torch.arange(5)})
    d = Checkpoint.from_bytes(ck.to_bytes()).to_dict()
    assert d["a"] == 1 and torch.equal(d["arr"], torch.arange(5))


def test_checkpoint_directory_roundtrip(tmp_path):
    ck = Checkpoint.from_dict({"a": [1, 2]})
    path = ck.to_directory(str(tmp_path / "c1"))
    d = Checkpoint.from_directory(path).to_dict()
    assert d["a"] == [1, 2]


def test_checkpoint_pytree_orbax_roundtrip(tmp_path):
    """The tensor tree is saved with torch.save (the original's orbax)."""
    tree = {"w": torch.ones((4, 4)), "b": torch.zeros(4)}
    ck = Checkpoint.from_pytree(tree, extra={"step": 3})
    path = ck.to_directory(str(tmp_path / "c2"))
    restored = Checkpoint.from_directory(path)
    out = restored.get_pytree()
    assert torch.equal(out["w"], torch.ones((4, 4)))
    assert restored.to_dict()["step"] == 3


# ----------------------------------------------------------------- trainer
def _simple_loop(config):
    from ray_memory_management_tpu_torch.train import Checkpoint, session

    rank = session.get_world_rank()
    start = 0
    ck = session.get_checkpoint()
    if ck is not None:
        start = ck.to_dict()["step"] + 1
    for step in range(start, config["steps"]):
        session.report(
            {"step": step, "rank": rank},
            checkpoint=Checkpoint.from_dict({"step": step})
            if rank == 0 else None,
        )


def test_fit_two_workers(rmt_start_regular, tmp_path):
    trainer = TorchTrainer(
        _simple_loop, train_loop_config={"steps": 4},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="t1", storage_path=str(tmp_path)),
    )
    res = trainer.fit()
    assert res.error is None
    assert res.metrics["step"] == 3
    assert [m["step"] for m in res.metrics_history] == [0, 1, 2, 3]
    assert res.checkpoint.to_dict()["step"] == 3
    assert os.path.isdir(os.path.join(str(tmp_path), "t1"))


def test_fit_resume(rmt_start_regular, tmp_path):
    t1 = TorchTrainer(
        _simple_loop, train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="r1", storage_path=str(tmp_path)),
    )
    r1 = t1.fit()
    t2 = TorchTrainer(
        _simple_loop, train_loop_config={"steps": 6},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="r2", storage_path=str(tmp_path)),
        resume_from_checkpoint=r1.checkpoint,
    )
    r2 = t2.fit()
    assert [m["step"] for m in r2.metrics_history] == [3, 4, 5]


def _collective_dp_loop(config):
    """Real distributed data-parallel: per-rank gradients allreduced through
    the worker group's collective."""
    import torch

    from ray_memory_management_tpu_torch import collective as col
    from ray_memory_management_tpu_torch.train import session

    rank = session.get_world_rank()
    world = session.get_world_size()
    group = session.get_collective_group_name()
    w = torch.zeros(2)
    for step in range(config["steps"]):
        grad = torch.full((2,), float(rank + 1))
        g = col.allreduce(grad, group_name=group) / world
        w = w - 0.1 * g
        session.report({"step": step, "w0": float(w[0])})


def test_fit_with_collective_allreduce(rmt_start_regular, tmp_path):
    trainer = TorchTrainer(
        _collective_dp_loop, train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="dp", storage_path=str(tmp_path)),
    )
    res = trainer.fit()
    assert res.error is None
    # mean grad = (1+2)/2 = 1.5 -> after 3 steps w0 = -0.45
    assert abs(res.metrics["w0"] + 0.45) < 1e-5


def _failing_loop(config):
    import os

    from ray_memory_management_tpu_torch.train import Checkpoint, session

    marker = config["marker"]
    start = 0
    ck = session.get_checkpoint()
    if ck is not None:
        start = ck.to_dict()["step"] + 1
    for step in range(start, config["steps"]):
        if step == 2 and not os.path.exists(marker):
            open(marker, "w").write("crashed")
            os._exit(1)  # hard worker death mid-training
        session.report(
            {"step": step},
            checkpoint=Checkpoint.from_dict({"step": step})
            if session.get_world_rank() == 0 else None,
        )


def test_elastic_restart_from_checkpoint(rmt_start_regular, tmp_path):
    marker = str(tmp_path / "crashed_once")
    trainer = TorchTrainer(
        _failing_loop,
        train_loop_config={"steps": 5, "marker": marker},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            name="ft", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    res = trainer.fit()
    assert res.error is None
    steps = [m["step"] for m in res.metrics_history]
    # crashed at step 2 (after reporting 0,1), restarted from ckpt step 1
    assert steps == [0, 1, 2, 3, 4]
    assert os.path.exists(marker)


def test_model_training_through_trainer(rmt_start_regular, tmp_path):
    """The flagship slice: TransformerLM trained through the Trainer."""

    def lm_loop(config):
        import torch

        from ray_memory_management_tpu_torch.models import gpt
        from ray_memory_management_tpu_torch.train import (
            Checkpoint, session,
        )

        cfg = gpt.PRESETS["test"]
        gen = torch.Generator().manual_seed(0)
        params = gpt.init_params(cfg, gen, "cpu")
        leaves = list(gpt.param_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=1e-3)
        toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1)}

        for i in range(config["steps"]):
            opt.zero_grad()
            loss = gpt.loss_fn(params, batch, cfg)
            loss.backward()
            opt.step()
            session.report({"step": i, "loss": float(loss)})
        session.report({"final": True},
                       checkpoint=Checkpoint.from_pytree(params))

    trainer = TorchTrainer(
        lm_loop, train_loop_config={"steps": 3},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="lm", storage_path=str(tmp_path)),
    )
    res = trainer.fit()
    assert res.error is None
    losses = [m["loss"] for m in res.metrics_history if "loss" in m]
    assert losses[-1] < losses[0]
    assert res.checkpoint.get_pytree() is not None


def _global_mesh_loop():
    """One data point per rank: x_r = r + 1, sharded over a dp mesh of the
    dist world; the gradient of mean((w x - 1)^2) at w = 2, replicated."""
    import os

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_memory_management_tpu_torch.parallel import make_mesh
    from ray_memory_management_tpu_torch.train import session

    n = dist.get_world_size()
    rank = dist.get_rank()
    mesh = make_mesh({"dp": n}, device_type="cpu")
    x = DTensor.from_local(torch.tensor([rank + 1.0]), mesh, [Shard(0)])
    w = DTensor.from_local(torch.tensor(2.0), mesh, [Replicate()])
    w.requires_grad_(True)
    loss = ((w * x - 1.0) ** 2).mean()
    loss.backward()
    session.report({"grad": float(w.grad.full_tensor()), "n": n,
                    "processes": n, "backend": dist.get_backend(),
                    "node": os.environ.get("RMT_NODE_ID", "")})


def _expected_grad(n):
    full_x = np.arange(1, n + 1, dtype=np.float32)
    return float(np.mean(2.0 * (2.0 * full_x - 1.0) * full_x))


def test_xla_cross_worker_global_mesh(rmt_start_regular, tmp_path):
    """Two worker PROCESSES form one dist world (the "xla" alias); the
    gradient over a DeviceMesh spanning both matches the single-process
    full-batch gradient (the _setup_torch_process_group analog,
    train/torch/config.py:54)."""
    trainer = TorchTrainer(
        _global_mesh_loop,
        scaling_config=ScalingConfig(num_workers=2,
                                     collective_backend="xla"),
        run_config=RunConfig(storage_path=str(tmp_path)),
    )
    res = trainer.fit()
    assert res.error is None, res.error
    reports = [m for m in res.metrics_history if "grad" in m]
    assert reports, "no gradient reported"
    rep = reports[-1]
    assert rep["processes"] == 2  # a real multi-process world formed
    assert rep["backend"] == "gloo"  # CPU workers: no GPU lease
    np.testing.assert_allclose(rep["grad"], _expected_grad(rep["n"]),
                               rtol=1e-5)


def test_chip_partitioning_unit():
    """dist-mode workers sharing a node must receive DISJOINT slices of
    its device names covering the node."""
    from ray_memory_management_tpu_torch.train.backend_executor import (
        TrainingFailedError, partition_chips_for_host,
    )

    names = [str(i) for i in range(8)]
    assert partition_chips_for_host(names[:4], 2) == ["0,1", "2,3"]
    assert partition_chips_for_host(names, 4) == ["0,1", "2,3", "4,5",
                                                  "6,7"]
    assert partition_chips_for_host(names[:4], 1) == ["0,1,2,3"]
    slices = partition_chips_for_host(names, 2)
    seen = [c for s in slices for c in s.split(",")]
    assert len(seen) == len(set(seen)) == 8  # disjoint and covering
    with pytest.raises(TrainingFailedError):
        partition_chips_for_host(names[:2], 3)


def test_chip_env_applied_before_jax_init(monkeypatch):
    """The visible cards are set before CUDA initializes (the original's
    jax-backend check), and a worker whose CUDA is live refuses."""
    from ray_memory_management_tpu_torch.train.backend_executor import (
        _TrainWorkerImpl,
    )

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    w = _TrainWorkerImpl(0, 2, "g")
    assert w._rmt_set_visible_chips("2,3")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,3"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already initialized"):
        w._rmt_set_visible_chips("4")
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,3"


def test_xla_world_across_two_agent_nodes(tmp_path):
    """The dist world runs with its two worker processes on two AGENT
    nodes (separate OS processes joined over TCP), not bare local actors
    — the gradient must still match the full-batch value."""
    rt = rmt.init(num_cpus=0)  # head schedules nothing: workers go to agents
    try:
        node_a = rt.add_remote_node_process(num_cpus=2)
        node_b = rt.add_remote_node_process(num_cpus=2)
        trainer = TorchTrainer(
            _global_mesh_loop,
            scaling_config=ScalingConfig(
                num_workers=2, collective_backend="xla",
                placement_strategy="STRICT_SPREAD"),
            run_config=RunConfig(storage_path=str(tmp_path)),
        )
        res = trainer.fit()
        assert res.error is None, res.error
        reports = [m for m in res.metrics_history if "grad" in m]
        assert reports
        rep = reports[-1]
        assert rep["processes"] == 2
        # the two ranks really ran on the two agent NODES
        nodes = {m["node"] for m in reports if "node" in m}
        assert nodes <= {node_a.hex(), node_b.hex()}
        np.testing.assert_allclose(rep["grad"], _expected_grad(rep["n"]),
                                   rtol=1e-5)
    finally:
        rmt.shutdown()
