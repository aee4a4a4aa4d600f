"""Elastic, preemption-tolerant training: atomic async sharded
checkpointing, manifest-CRC fallback, cloud-uri transport, durable run
state (resume_from="auto"), elastic restarts with per-rank loader state.

The PyTorch port's copy of ``tests/test_train_elastic.py``, all 17 of
its cases: ``TorchTrainer`` where the original has ``JaxTrainer``, the
tensor tree saved with ``torch.save`` where it is saved with orbax. The
two chaos soaks are marked slow, as in the original.
"""

import json
import os
import time

import pytest

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core.external_storage import (
    InMemoryStorage,
    register_storage_scheme,
)
from ray_memory_management_tpu_torch.train import (
    AsyncCheckpointManager,
    Checkpoint,
    ElasticConfig,
    FailureConfig,
    CheckpointConfig,
    TorchTrainer,
    RunConfig,
    ScalingConfig,
    verify_checkpoint_dir,
)
from ray_memory_management_tpu_torch.analysis import lockwatch
from ray_memory_management_tpu_torch.utils import faults
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()


def _metric_total(accessor_name: str, **tag_filter) -> float:
    from ray_memory_management_tpu_torch.core import metrics_defs as mdefs

    m = getattr(mdefs, accessor_name)()
    total = 0.0
    for tags, v in m.series().items():
        if all((k, str(val)) in tags for k, val in tag_filter.items()):
            total += v
    return total


# ------------------------------------------------------ atomic directory save
def test_to_directory_writes_manifest_and_verifies(tmp_path):
    p = str(tmp_path / "ck")
    Checkpoint.from_dict({"step": 7}).to_directory(p)
    assert os.path.exists(os.path.join(p, "MANIFEST.json"))
    ok, why = verify_checkpoint_dir(p)
    assert ok, why
    # flip one payload byte: verification must fail
    with open(os.path.join(p, "checkpoint.pkl"), "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    ok, why = verify_checkpoint_dir(p)
    assert not ok and "mismatch" in why


def test_to_directory_is_atomic_on_crash(tmp_path, monkeypatch):
    """A crash mid-save must leave the PREVIOUS directory intact and
    loadable — never a half-written one (satellite 1)."""
    p = str(tmp_path / "ck")
    Checkpoint.from_dict({"step": 1}).to_directory(p)

    boom = RuntimeError("disk died mid-save")

    def exploding_materialize(self, path):
        # half-written payload, then the crash
        with open(os.path.join(path, "checkpoint.pkl"), "wb") as f:
            f.write(b"partial")
        raise boom

    monkeypatch.setattr(Checkpoint, "_materialize", exploding_materialize)
    with pytest.raises(RuntimeError):
        Checkpoint.from_dict({"step": 2}).to_directory(p)
    monkeypatch.undo()
    # old contents survived, still verified, no tmp orphans under tmp_path
    ok, why = verify_checkpoint_dir(p)
    assert ok, why
    assert Checkpoint.from_directory(p).to_dict()["step"] == 1
    leftovers = [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    assert not leftovers, leftovers


def test_orbax_overwrite_is_non_destructive(tmp_path):
    """Overwriting a pytree checkpoint directory must never rmtree the
    old pytree/ before the new save succeeds (satellite 1, orbax half)."""
    import numpy as np

    p = str(tmp_path / "ck")
    Checkpoint.from_pytree({"w": np.zeros(4)}, extra={"step": 1}
                           ).to_directory(p)
    Checkpoint.from_pytree({"w": np.ones(4)}, extra={"step": 2}
                           ).to_directory(p)
    out = Checkpoint.from_directory(p).to_dict()
    assert out["step"] == 2
    assert np.allclose(out["__rmt_pytree__"]["w"], np.ones(4))
    ok, why = verify_checkpoint_dir(p)
    assert ok, why


# ------------------------------------------------------------- uri transport
def test_checkpoint_uri_roundtrip_through_storage_registry(tmp_path):
    """s3://gs://-style schemes route through the external-storage blob
    surface (satellite 2) — proven with the in-memory cloud double."""
    register_storage_scheme("mem", InMemoryStorage)
    ck = Checkpoint.from_dict({"step": 11, "data": list(range(8))})
    uri = "mem://bucket/runs/ck1"
    assert ck.to_uri(uri) == uri
    back = Checkpoint.from_uri(uri)
    assert back.to_dict()["step"] == 11
    # unknown schemes still fail loudly
    with pytest.raises(ValueError):
        ck.to_uri("ftp://nope/ck")
    with pytest.raises((ValueError, FileNotFoundError)):
        Checkpoint.from_uri("mem://bucket/runs/absent")


def test_file_uri_roundtrip(tmp_path):
    uri = f"file://{tmp_path}/ck2"
    Checkpoint.from_dict({"step": 5}).to_uri(uri)
    assert Checkpoint.from_uri(uri).to_dict()["step"] == 5


# ----------------------------------------------------- AsyncCheckpointManager
def _blob(step, **extra):
    return Checkpoint.from_dict({"step": step, **extra}).to_bytes()


def test_manager_retention_gc(tmp_path):
    m = AsyncCheckpointManager(str(tmp_path / "run"), retain_k=2,
                               mode="sync")
    for s in range(5):
        m.save({0: _blob(s)}, step=s)
    dirs = sorted(n for n in os.listdir(tmp_path / "run"))
    assert dirs == ["checkpoint_000003", "checkpoint_000004"], dirs
    rec = m.latest()
    assert rec["step"] == 4


def test_manager_crc_mismatch_falls_back_to_previous(tmp_path):
    m = AsyncCheckpointManager(str(tmp_path / "run"), retain_k=3,
                               mode="sync")
    for s in range(3):
        m.save({0: _blob(s), 1: b"rank1-" + bytes([s])}, step=s)
    newest = os.path.join(tmp_path / "run", "checkpoint_000002",
                          "checkpoint.pkl")
    with open(newest, "r+b") as f:
        f.write(b"\x00\x00")
    rec = m.latest()
    assert rec["step"] == 1  # fell back past the corrupt newest
    assert rec["rank_states"] == {1: b"rank1-\x01"}
    assert _metric_total("train_checkpoint_restores", source="fallback") >= 1


def test_manager_async_drains_in_background(tmp_path):
    m = AsyncCheckpointManager(str(tmp_path / "run"), retain_k=4,
                               mode="async")
    blocking = m.save({0: _blob(0)}, step=0)
    assert m.drain(20)
    assert m.latest()["step"] == 0
    assert m.last_error is None
    assert blocking < 5.0  # snapshotting, not the durable write
    m.close()


def test_manager_mirrors_to_storage_uri_and_gcs_old_mirrors(tmp_path):
    register_storage_scheme("mem", InMemoryStorage)
    store = InMemoryStorage("mem://ckbkt")
    durable = []
    m = AsyncCheckpointManager(
        str(tmp_path / "run"), retain_k=1, mode="sync",
        storage_uri="mem://ckbkt/runA", on_durable=durable.append)
    m.save({0: _blob(0)}, step=0)
    m.save({0: _blob(1)}, step=1)
    # retention pruned checkpoint_000000 locally AND in the mirror
    urls = store.list_blobs("mem://ckbkt/runA")
    assert urls and all("checkpoint_000001" in u for u in urls)
    assert durable[-1]["uri"] == "mem://ckbkt/runA/checkpoint_000001"
    # the mirrored checkpoint loads through from_uri
    assert Checkpoint.from_uri(durable[-1]["uri"]).to_dict()["step"] == 1


def test_checkpoint_fault_sites(tmp_path):
    """The chaos plane strikes the checkpoint path like transfer/spill
    (satellite 3): save errors are contained + counted, injected
    corruption is caught by restore-time CRC and falls back."""
    try:
        faults.configure("checkpoint.save:error:max=1", seed=7)
        m = AsyncCheckpointManager(str(tmp_path / "run"), retain_k=4,
                                   mode="sync")
        m.save({0: _blob(0)}, step=0)  # injected failure, contained
        assert isinstance(m.last_error, faults.FaultInjected)
        assert m.latest() is None
        assert _metric_total("faults_injected", site="checkpoint.save") >= 1
        assert _metric_total("train_checkpoint_saves", result="error") >= 1
        m.save({0: _blob(1)}, step=1)  # budget exhausted: this one lands
        assert m.latest()["step"] == 1

        # corrupt-on-save: manifest CRC catches it at restore time
        faults.configure("checkpoint.save:corrupt:max=1", seed=7)
        m.save({0: _blob(2)}, step=2)
        rec = m.latest()
        assert rec["step"] == 1  # corrupted newest skipped
        # restore-side injection: newest dir unreadable -> fallback
        faults.configure("checkpoint.restore:error:max=1", seed=7)
        m.save({0: _blob(3)}, step=3)
        rec = m.latest()
        assert rec["step"] == 1  # step-3 dir hit the injected read error
    finally:
        faults.reset()


# -------------------------------------------------- durable run state / auto
def _ckpt_loop(config):
    from ray_memory_management_tpu_torch.train import Checkpoint, session

    rank = session.get_world_rank()
    ck = session.get_checkpoint()
    start = ck.to_dict()["step"] + 1 if ck else 0
    for step in range(start, config["steps"]):
        session.report(
            {"step": step},
            checkpoint=Checkpoint.from_dict(
                {"step": step} if rank == 0
                else {"step": step, "rank": rank}),
        )


def test_resume_from_auto_across_head_restart(tmp_path):
    """resume_from="auto" continues an interrupted run across
    rmt.shutdown()/re-init on the same gcs_storage_path: run state (run
    name, checkpoint, step, world) is in the durable kv."""
    db = str(tmp_path / "gcs.db")
    store = str(tmp_path / "runs")

    rmt.init(num_cpus=4, _config=Config(gcs_storage_path=db))
    try:
        r1 = TorchTrainer(
            _ckpt_loop, train_loop_config={"steps": 3},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="autorun", storage_path=store,
                                 checkpoint_config=CheckpointConfig(
                                     mode="sync")),
        ).fit()
        assert r1.error is None
        rt = rmt.init(ignore_reinit_error=True)
        raw = rt.gcs.kv_get("train/run/autorun")
        meta = json.loads(raw)
        assert meta["step"] == 2 and meta["world_size"] == 1
        assert meta["path"] and os.path.isdir(meta["path"])
    finally:
        rmt.shutdown()

    # head restart on the same durable tables
    rmt.init(num_cpus=4, _config=Config(gcs_storage_path=db))
    try:
        r2 = TorchTrainer(
            _ckpt_loop, train_loop_config={"steps": 6},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="autorun", storage_path=store,
                                 checkpoint_config=CheckpointConfig(
                                     mode="sync")),
            resume_from="auto",
        ).fit()
        assert r2.error is None
        assert [m["step"] for m in r2.metrics_history] == [3, 4, 5]
    finally:
        rmt.shutdown()


def test_resume_from_auto_fresh_run_starts_at_zero(rmt_start_regular,
                                                   tmp_path):
    res = TorchTrainer(
        _ckpt_loop, train_loop_config={"steps": 2},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="fresh", storage_path=str(tmp_path)),
        resume_from="auto",
    ).fit()
    assert res.error is None
    assert [m["step"] for m in res.metrics_history] == [0, 1]


# --------------------------------------------------------- elastic machinery
def test_placeable_world_size(rmt_start_regular):
    from ray_memory_management_tpu_torch.train import placeable_world_size

    rt = rmt_start_regular
    assert placeable_world_size({"CPU": 1}, 16, runtime=rt) == 4
    assert placeable_world_size({"CPU": 1}, 2, runtime=rt) == 2
    rt.add_node({"num_cpus": 2})
    assert placeable_world_size({"CPU": 1}, 16, runtime=rt) == 6
    assert placeable_world_size({"CPU": 64}, 16, runtime=rt) == 0


def test_request_resources_feeds_autoscaler_demand(rmt_start_regular):
    from ray_memory_management_tpu_torch.autoscaler import (
        StandardAutoscaler, VirtualNodeProvider, request_resources,
    )

    rt = rmt_start_regular
    provider = VirtualNodeProvider(rt)
    sc = StandardAutoscaler(provider, node_config={"num_cpus": 4},
                            min_workers=0, max_workers=2,
                            idle_timeout_s=3600, runtime=rt)
    try:
        assert sc.pending_demand() == 0
        request_resources([{"CPU": 4}] * 3)  # head holds 4 -> 2 unmet
        assert sc.pending_demand() == 2
        sc.update()
        assert len(provider.non_terminated_nodes()) == 1
        sc.update()
        assert len(provider.non_terminated_nodes()) == 2  # capped at max
        assert sc.pending_demand() == 0  # totals now hold all 3 bundles
    finally:
        request_resources([])


def _stateful_loop(config):
    """Every rank reports a checkpoint shard; after the injected crash,
    nonzero ranks must see their own shard again via get_rank_state().
    Steps are paced (like a real training step) so the driver drains the
    report stream before the crash — reports still queued in a worker
    when it dies are gone with the process, by design."""
    import os
    import time as _t

    from ray_memory_management_tpu_torch.train import Checkpoint, session

    rank = session.get_world_rank()
    ck = session.get_checkpoint()
    rs = session.get_rank_state()
    start = ck.to_dict()["step"] + 1 if ck else 0
    if os.path.exists(config["marker"]) and rank != 0:
        # this is the post-crash incarnation: loader state restored
        assert rs is not None and rs["rank"] == rank, rs
        assert rs["step"] >= 0
    for step in range(start, config["steps"]):
        _t.sleep(0.1)
        if (step == config["crash_step"] and rank == 0
                and not os.path.exists(config["marker"])):
            open(config["marker"], "w").close()
            os._exit(1)
        session.report(
            {"step": step},
            checkpoint=Checkpoint.from_dict(
                {"step": step} if rank == 0
                else {"step": step, "rank": rank}),
        )


def test_restart_restores_per_rank_loader_state(rmt_start_regular,
                                                tmp_path):
    steps = 8
    res = TorchTrainer(
        _stateful_loop,
        train_loop_config={"steps": steps, "crash_step": 4,
                           "marker": str(tmp_path / "crashed")},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name="rs", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1),
            checkpoint_config=CheckpointConfig(mode="sync"),
        ),
    ).fit()
    assert res.error is None, res.error
    got = [m["step"] for m in res.metrics_history]
    assert max(got) == steps - 1
    assert set(got) == set(range(steps))
    assert os.path.exists(tmp_path / "crashed")


# ----------------------------------------------------------------- chaos soak
def _soak_loop(config):
    import time as _t

    from ray_memory_management_tpu_torch.train import Checkpoint, session

    rank = session.get_world_rank()
    ck = session.get_checkpoint()
    start = ck.to_dict()["step"] + 1 if ck else 0
    for step in range(start, config["steps"]):
        _t.sleep(config["step_s"])
        session.report(
            {"step": step, "world": session.get_world_size()},
            checkpoint=Checkpoint.from_dict(
                {"step": step} if rank == 0
                else {"step": step, "rank": rank}),
        )


def _run_soak(tmp_path, kill_mode, stall_s=1.0):
    """2-worker elastic run over two 1-CPU agent nodes; the NodeKiller
    strikes one mid-run and an autoscaler Monitor replaces the dead
    node. Returns (result, killer, resize deltas, steps)."""
    import threading

    from ray_memory_management_tpu_torch.autoscaler import (
        Monitor, ProcessNodeProvider, StandardAutoscaler,
    )
    from ray_memory_management_tpu_torch.utils.chaos import NodeKiller

    steps, step_s = 24, 0.25
    rt = rmt.init(num_cpus=0)  # head schedules nothing
    provider = ProcessNodeProvider(rt)
    provider.create_node({"num_cpus": 1})
    provider.create_node({"num_cpus": 1})
    sc = StandardAutoscaler(provider, node_config={"num_cpus": 1},
                            min_workers=2, max_workers=3,
                            idle_timeout_s=3600, runtime=rt)
    monitor = Monitor(sc, update_interval_s=1.0)
    down0 = _metric_total("train_elastic_resizes", direction="down")
    up0 = _metric_total("train_elastic_resizes", direction="up")
    stop_arm = threading.Event()

    def _arm_monitor_after_dip():
        # hold the replacement back until the trainer has re-sharded
        # DOWN to the surviving capacity (a fresh node can register in
        # <100ms here, which no real cloud provider does) — then let the
        # autoscaler replace the node so the run grows back
        deadline = time.monotonic() + 60
        while (time.monotonic() < deadline and not stop_arm.is_set()
               and _metric_total("train_elastic_resizes",
                                 direction="down") <= down0):
            time.sleep(0.2)
        monitor.start()

    if kill_mode == "sigkill":
        threading.Thread(target=_arm_monitor_after_dip,
                         daemon=True).start()
    try:
        trainer = TorchTrainer(
            _soak_loop,
            train_loop_config={"steps": steps, "step_s": step_s},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(
                name=f"soak_{kill_mode}", storage_path=str(tmp_path),
                checkpoint_config=CheckpointConfig(mode="async",
                                                   num_to_keep=3),
            ),
            elastic_config=ElasticConfig(
                min_workers=1, max_workers=2, settle_s=0.75,
                resize_check_interval_s=1.0),
        )
        with NodeKiller(rt, interval_s=2.5, max_kills=1,
                        kill_mode=kill_mode, stall_s=stall_s) as killer:
            res = trainer.fit()
        down1 = _metric_total("train_elastic_resizes", direction="down")
        up1 = _metric_total("train_elastic_resizes", direction="up")
        return res, killer, (down1 - down0, up1 - up0), steps
    finally:
        stop_arm.set()
        monitor.stop()
        rmt.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_soak_train_survives_node_kill(tmp_path):
    """The tentpole acceptance: SIGKILL a training-worker's node agent
    mid-fit(). The run must complete, lose at most one checkpoint
    interval of progress (visible as re-executed steps), and the elastic
    world size must dip below 2 and recover. Runs under the lock-order
    detector: the node loss + re-shard + grow-back path must produce
    zero lock-order-inversion cycles."""
    with lockwatch.watching() as lw:
        res, killer, (downs, ups), steps = _run_soak(tmp_path, "sigkill")
        rep = lw.report()
    assert rep["acquisitions"] > 0, "lock detector saw no runtime locks"
    assert rep["cycles"] == [], rep["cycles"]
    assert killer.kills, "chaos harness never fired"
    assert res.error is None, res.error
    got = [m["step"] for m in res.metrics_history]
    # complete: every step ran at least once, run reached the end
    assert set(got) == set(range(steps))
    # <= one checkpoint interval lost per rebuild: checkpoints land every
    # step, so re-executed work is bounded by the interval plus the async
    # drain lag, for each of the (failure, grow-back) rebuilds
    assert len(got) <= steps + 8, got
    # the elastic world dipped (rebuild below 2 workers) and recovered
    assert downs >= 1, "group never re-sharded below full size"
    assert ups >= 1, "group never grew back after replacement"
    worlds = [m["world"] for m in res.metrics_history if "world" in m]
    assert 1 in worlds and worlds[-1] == 2, worlds


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_soak_train_short_stall_is_gray_failure(tmp_path):
    """SIGSTOP an agent briefly (below the death deadline): the classic
    gray failure must cost ZERO progress — no restart, no resize, every
    step reported exactly once. Runs under the lock-order detector:
    the stall/heartbeat-suspect path must stay inversion-free."""
    with lockwatch.watching() as lw:
        res, killer, (downs, ups), steps = _run_soak(tmp_path, "stall",
                                                     stall_s=1.0)
        rep = lw.report()
    assert rep["acquisitions"] > 0, "lock detector saw no runtime locks"
    assert rep["cycles"] == [], rep["cycles"]
    assert killer.stalls, "chaos harness never fired"
    assert res.error is None, res.error
    got = [m["step"] for m in res.metrics_history]
    assert got == list(range(steps)), got
    assert downs == 0 and ups == 0
