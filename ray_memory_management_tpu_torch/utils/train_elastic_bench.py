"""Elastic-training bench: what preemption tolerance costs per step.

Three numbers matter:

- steps/s with checkpointing off / sync / async — the end-to-end drag of
  durability on a small real run (TorchTrainer + worker actors, not a
  mock);
- the STEP-BLOCKING slice of one save, sync vs async — async must block
  the step for < 10% of the sync-save baseline (the durable write drains
  on the background thread while steps keep running);
- recovery_s — wall-clock added to a run by one injected worker kill
  mid-fit (elastic restart from the latest durable checkpoint).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict

ELASTIC_DEFAULTS = dict(n_steps=24, checkpoint_every=4, payload_kb=64,
                        save_trials=10)


def _make_loop():
    """Train loop factory. Reports every step; attaches a checkpoint
    every ``checkpoint_every`` steps when checkpointing is on. With
    ``cfg["crash_step"]`` >= 0, rank 0 hard-exits ONCE at that step (a
    marker file dedups the crash across restarts) — the injected
    preemption. The checkpoint carries its payload as a uint8 tensor,
    saved as a ``torch.save`` tree."""

    def loop(cfg):
        import os

        import torch

        from ray_memory_management_tpu_torch.train import session
        from ray_memory_management_tpu_torch.train.checkpoint import Checkpoint

        ck = session.get_checkpoint()
        start = (ck.to_dict()["step"] + 1) if ck else 0
        payload = torch.full((cfg["payload_bytes"],), 0xab,
                             dtype=torch.uint8)
        every = cfg["checkpoint_every"]
        for step in range(start, cfg["n_steps"]):
            if (step == cfg["crash_step"]
                    and session.get_world_rank() == 0
                    and not os.path.exists(cfg["marker"])):
                open(cfg["marker"], "w").close()
                os._exit(1)
            if every and step % every == every - 1:
                session.report(
                    {"step": step},
                    checkpoint=Checkpoint.from_pytree(
                        {"payload": payload}, extra={"step": step}))
            else:
                session.report({"step": step})

    return loop


def _fit_once(tmp: str, name: str, mode: str, n_steps: int,
              checkpoint_every: int, payload_bytes: int,
              crash_step: int = -1) -> float:
    """One TorchTrainer.fit() run; returns wall seconds."""
    from ..train import (CheckpointConfig, ElasticConfig, RunConfig,
                         ScalingConfig, TorchTrainer)

    cfg = {
        "n_steps": n_steps,
        "checkpoint_every": checkpoint_every if mode != "off" else 0,
        "payload_bytes": payload_bytes,
        "crash_step": crash_step,
        "marker": os.path.join(tmp, f"{name}.crashed"),
    }
    trainer = TorchTrainer(
        _make_loop(),
        train_loop_config=cfg,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(
            name=name, storage_path=tmp,
            checkpoint_config=CheckpointConfig(
                mode=mode if mode != "off" else "async", num_to_keep=2),
        ),
        elastic_config=ElasticConfig(min_workers=1, max_workers=2,
                                     settle_s=2.0),
    )
    t0 = time.perf_counter()
    res = trainer.fit()
    dt = time.perf_counter() - t0
    if res.error is not None:
        raise RuntimeError(f"bench fit {name!r} failed: {res.error!r}")
    return dt


def _blocking_ms(mode: str, payload_bytes: int, trials: int) -> float:
    """Mean step-blocking milliseconds of one manager.save() — the slice
    the training loop actually waits on. One untimed save goes first: in
    async mode it starts the writer thread, a once-a-run cost that a
    loaded host can stretch past a whole sync write."""
    import torch

    from ..train.checkpoint import AsyncCheckpointManager, Checkpoint

    run_dir = tempfile.mkdtemp(prefix=f"rmt_ckpt_bench_{mode}_")
    mgr = AsyncCheckpointManager(run_dir, retain_k=2, mode=mode)
    blob = Checkpoint.from_pytree(
        {"payload": torch.full((payload_bytes,), 0xcd, dtype=torch.uint8)},
        extra={"step": 0}).to_bytes()
    try:
        mgr.save({0: blob, 1: blob}, step=0)
        total = 0.0
        for step in range(1, trials + 1):
            total += mgr.save({0: blob, 1: blob}, step=step)
        mgr.close()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return total / trials * 1000.0


def run_elastic_suite(n_steps: int = 24, checkpoint_every: int = 4,
                      payload_kb: int = 64,
                      save_trials: int = 10) -> Dict:
    from .. import api as rmt

    payload_bytes = payload_kb * 1024

    # step-blocking slice: no cluster needed, measured first for a clean
    # machine (the acceptance ratio: async < 10% of sync)
    blocking_sync = _blocking_ms("sync", payload_bytes, save_trials)
    blocking_async = _blocking_ms("async", payload_bytes, save_trials)

    tmp = tempfile.mkdtemp(prefix="rmt_elastic_bench_")
    rmt.init(num_cpus=8)
    try:
        times = {}
        for mode in ("off", "sync", "async"):
            times[mode] = _fit_once(tmp, f"bench_{mode}", mode, n_steps,
                                    checkpoint_every, payload_bytes)
        # one injected rank-0 kill mid-run: recovery cost is the extra
        # wall-clock over the same run without the kill
        crashed = _fit_once(tmp, "bench_kill", "async", n_steps,
                            checkpoint_every, payload_bytes,
                            crash_step=n_steps // 2)
        recovery_s = max(0.0, crashed - times["async"])
    finally:
        rmt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)

    return {
        "n_steps": n_steps,
        "checkpoint_every": checkpoint_every,
        "payload_kb": payload_kb,
        "steps_per_s_ckpt_off": round(n_steps / times["off"], 2),
        "steps_per_s_ckpt_sync": round(n_steps / times["sync"], 2),
        "steps_per_s_ckpt_async": round(n_steps / times["async"], 2),
        "blocking_ms_sync": round(blocking_sync, 3),
        "blocking_ms_async": round(blocking_async, 3),
        # the acceptance number: async step-blocking cost as % of sync
        "async_blocking_vs_sync_pct": round(
            blocking_async / blocking_sync * 100.0, 2)
            if blocking_sync > 0 else 0.0,
        "recovery_s": round(recovery_s, 2),
    }
