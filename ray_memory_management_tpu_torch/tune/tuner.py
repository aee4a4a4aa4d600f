"""Tuner + TrialRunner: the experiment event loop.

Mirrors the reference's tune execution layer — `Tuner.fit`
(tune/tuner.py:32,212) → `tune.run` (tune/tune.py:129) → `TrialRunner.step`
(tune/execution/trial_runner.py:236,864) with trials placed as actors by
`RayTrialExecutor` (tune/execution/ray_trial_executor.py). Each trial is one
actor implementing the Trainable step/save/restore contract; the runner polls
outstanding ``train()`` calls with ``wait``, feeds results to the scheduler,
and applies CONTINUE/STOP plus PBT exploit requests.

GPU note: ``resources_per_trial={"GPU": n}`` leases each trial actor n
cards (its ``CUDA_VISIBLE_DEVICES`` set before the trainable runs); the
scheduler's resource accounting keeps concurrent trials on distinct cards.
A trial that runs a ``TorchTrainer`` asks for CPU only: the trainer's
workers lease their own cards.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from .. import api
from ..exceptions import RmtError
from .schedulers import CONTINUE, STOP, FIFOScheduler, TrialScheduler
from .search import BasicVariantGenerator, Searcher
from .trainable import RESULT_DONE, Trainable, wrap_function

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Searcher] = None
    seed: Optional[int] = None
    max_iterations: Optional[int] = None


@dataclasses.dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    checkpoint_blob: Optional[bytes] = None
    error: Optional[str] = None
    # the trial's end state: TERMINATED, or ERROR with ``error`` set
    status: str = TERMINATED

    @property
    def metrics_dataframe(self):
        return self.metrics_history


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self._results = results
        self.metric = metric
        self.mode = mode

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self.metric
        mode = mode or self.mode
        scored = [r for r in self._results
                  if r.error is None and metric in r.metrics]
        if not scored:
            raise RmtError("no successful trial reported "
                           f"metric {metric!r}")
        key = (lambda r: r.metrics[metric])
        return (min if mode == "min" else max)(scored, key=key)

    def get_dataframe(self) -> List[Dict[str, Any]]:
        return [dict(r.metrics, trial_id=r.trial_id) for r in self._results]


class _TrialActorImpl:
    """Generic trial actor hosting one Trainable instance. ``kind`` is
    "class" (blob is a Trainable subclass) or "fn" (blob is a plain function
    wrapped into a FunctionTrainable here, so only the user fn crosses the
    wire)."""

    def __init__(self, kind: str, blob: bytes, config: dict,
                 trial_info: dict):
        import cloudpickle

        obj = cloudpickle.loads(blob)
        cls = obj if kind == "class" else wrap_function(obj)
        self.trainable: Trainable = cls(config, trial_info)

    def train(self) -> dict:
        return self.trainable.train()

    def save(self) -> bytes:
        return self.trainable.save()

    def restore(self, blob: bytes) -> bool:
        self.trainable.restore(blob)
        return True

    def reset(self, config: dict) -> bool:
        return self.trainable.reset(config)

    def stop(self) -> bool:
        self.trainable.stop()
        return True


class Trial:
    def __init__(self, config: Dict[str, Any], trial_num: int,
                 experiment: str):
        self.id = f"{experiment}_{trial_num:05d}_{uuid.uuid4().hex[:6]}"
        self.config = config
        self.status = PENDING
        self.actor = None
        self.pending_ref = None
        self.last_result: Dict[str, Any] = {}
        self.history: List[Dict[str, Any]] = []
        self.checkpoint_blob: Optional[bytes] = None
        self.error: Optional[str] = None
        # queued exploit: (donor checkpoint blob, new config) applied
        # between train() rounds
        self.exploit: Optional[Tuple[str, Dict[str, Any]]] = None


class TrialRunner:
    def __init__(self, trainable: Tuple[str, Any],
                 trials: List[Trial], tune_config: TuneConfig,
                 resources_per_trial: Dict[str, float],
                 syncer=None):
        from .. import serialization as ser

        self.kind, payload = trainable
        self.blob = ser.dumps_function(payload)
        self.trials = trials
        self.cfg = tune_config
        self.resources = resources_per_trial
        self.syncer = syncer  # tune/syncer.py analog: cloud checkpoints
        self.scheduler = tune_config.scheduler or FIFOScheduler(
            tune_config.metric, tune_config.mode)
        cluster_cpus = int(api.cluster_resources().get("CPU", 1))
        per_trial_cpus = max(1, int(resources_per_trial.get("CPU", 1)))
        self.max_concurrent = tune_config.max_concurrent_trials or max(
            1, cluster_cpus // per_trial_cpus)
        self._exploits: List[Tuple[Trial, str, Dict[str, Any]]] = []

    # -- scheduler callback ---------------------------------------------------
    def request_exploit(self, trial: Trial, donor_trial_id: str,
                        new_config: Dict[str, Any]) -> None:
        self._exploits.append((trial, donor_trial_id, new_config))

    # -- lifecycle ------------------------------------------------------------
    def _start_trial(self, trial: Trial) -> None:
        cls = api.remote(_TrialActorImpl)
        trial.actor = cls.options(
            num_cpus=self.resources.get("CPU", 1),
            num_gpus=self.resources.get("GPU", 0),
        ).remote(self.kind, self.blob, trial.config,
                 {"id": trial.id, "name": trial.id})
        trial.status = RUNNING
        trial.pending_ref = trial.actor.train.remote()

    def _stop_trial(self, trial: Trial, status: str,
                    error: Optional[str] = None) -> None:
        trial.status = status
        trial.error = error
        if trial.actor is not None:
            try:
                if status == TERMINATED:
                    trial.checkpoint_blob = api.get(
                        trial.actor.save.remote(), timeout=60)
                    api.get(trial.actor.stop.remote(), timeout=60)
            except Exception:
                pass
            try:
                api.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        if self.syncer is not None and trial.checkpoint_blob:
            # durability, not correctness: a failed upload must not fail
            # the trial — but it must be LOUD (the experiment thinks its
            # checkpoints survive the head's disk)
            try:
                self.syncer.upload(
                    trial.id, trial.checkpoint_blob,
                    iteration=trial.last_result.get("training_iteration"))
            except Exception as e:  # noqa: BLE001
                from ..utils import events

                events.emit(
                    "TUNE_SYNC_FAILED",
                    f"checkpoint upload for trial {trial.id} failed: "
                    f"{e!r}", severity=events.WARNING, source="tune")
        trial.pending_ref = None
        self.scheduler.on_trial_complete(self, trial, trial.last_result)
        if self.cfg.search_alg is not None:
            self.cfg.search_alg.on_trial_complete(
                trial.id, trial.last_result, error=status == ERROR)

    def _apply_exploits(self) -> None:
        by_id = {t.id: t for t in self.trials}
        while self._exploits:
            trial, donor_id, new_config = self._exploits.pop()
            donor = by_id.get(donor_id)
            if donor is None or trial.actor is None:
                continue
            blob = None
            if donor.actor is not None:
                try:
                    blob = api.get(donor.actor.save.remote(), timeout=120)
                except Exception:
                    pass
            if blob is None:
                # donor already terminated — exploit its final checkpoint
                blob = donor.checkpoint_blob
            if blob is None:
                continue
            trial.exploit = None
            try:
                # hot path: in-place reset if the trainable supports it,
                # else replace the actor (pbt.py restarts the same way)
                ok = api.get(trial.actor.reset.remote(new_config),
                             timeout=120)
                if not ok:
                    api.kill(trial.actor)
                    cls = api.remote(_TrialActorImpl)
                    trial.actor = cls.options(
                        num_cpus=self.resources.get("CPU", 1),
                        num_gpus=self.resources.get("GPU", 0),
                    ).remote(self.kind, self.blob, new_config,
                             {"id": trial.id, "name": trial.id})
                api.get(trial.actor.restore.remote(blob), timeout=120)
                trial.config = new_config
                trial.pending_ref = trial.actor.train.remote()
            except Exception as e:
                self._stop_trial(trial, ERROR, f"exploit failed: {e}")

    # -- main loop ------------------------------------------------------------
    def run(self) -> None:
        pending = [t for t in self.trials]
        while True:
            running = [t for t in self.trials if t.status == RUNNING]
            while pending and len(running) < self.max_concurrent:
                trial = pending.pop(0)
                try:
                    self._start_trial(trial)
                    running.append(trial)
                except Exception as e:
                    trial.status = ERROR
                    trial.error = str(e)
            if not running and not pending:
                break
            ref_to_trial = {t.pending_ref: t for t in running
                            if t.pending_ref is not None}
            if not ref_to_trial:
                time.sleep(0.05)
                continue
            # block until at least one result, then sweep up everything
            # that is already done so concurrent trials advance in lockstep
            # (the reference processes one event per step() but its executor
            # keeps per-trial futures running; here fairness needs the sweep)
            refs = list(ref_to_trial.keys())
            ready, _ = api.wait(refs, num_returns=1, timeout=1.0)
            if ready:
                ready, _ = api.wait(refs, num_returns=len(refs), timeout=0)
            for ref in ready:
                trial = ref_to_trial[ref]
                try:
                    result = api.get(ref)
                except Exception as e:
                    self._stop_trial(trial, ERROR, str(e))
                    continue
                # a bare done-sentinel (function trainable exhausted) carries
                # no user metrics — don't let it clobber the last real result
                sentinel = result.get(RESULT_DONE, False) and not (
                    set(result) - {RESULT_DONE, "training_iteration",
                                   "time_total_s", "trial_id"})
                if not sentinel:
                    trial.last_result = result
                    trial.history.append(result)
                    if self.cfg.search_alg is not None:
                        self.cfg.search_alg.on_trial_result(trial.id, result)
                done = result.get(RESULT_DONE, False)
                max_it = self.cfg.max_iterations
                if max_it is not None and \
                        result.get("training_iteration", 0) >= max_it:
                    done = True
                decision = self.scheduler.on_trial_result(
                    self, trial, result)
                if done or decision == STOP:
                    self._stop_trial(trial, TERMINATED)
                else:
                    trial.pending_ref = trial.actor.train.remote()
            self._apply_exploits()


class Tuner:
    """tune/tuner.py:32 analog.

    ``trainable`` may be a Trainable subclass, a plain function
    ``fn(config)`` using train.session.report, or a trainer object with
    ``.fit()`` (TorchTrainer — mirroring how the reference runs trainers under
    Tune, base_trainer.py:354).
    """

    def __init__(self, trainable, *, param_space: Optional[dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 name: Optional[str] = None,
                 upload_dir: Optional[str] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.cfg = tune_config or TuneConfig()
        self.resources = resources_per_trial or {"CPU": 1}
        self.name = name or f"tune_{int(time.time())}"
        # cloud checkpoint sync (tune/syncer.py's upload_dir): every
        # completed trial's checkpoint blob uploads through the external-
        # storage registry (s3:// gs:// file:// or a registered scheme)
        self.syncer = None
        if upload_dir:
            from .syncer import Syncer

            self.syncer = Syncer(upload_dir, self.name)

    def _trainable_payload(self) -> Tuple[str, Any]:
        t = self.trainable
        if isinstance(t, type) and issubclass(t, Trainable):
            return ("class", t)
        if callable(t) and not hasattr(t, "fit"):
            return ("fn", t)
        if hasattr(t, "fit"):
            trainer = t

            def run_trainer(config):
                from ..train import session

                merged = dict(trainer.config or {})
                merged.update(config)
                trainer.config = merged
                result = trainer.fit()
                if result.error is not None:
                    raise result.error
                session.report(result.metrics or {"_fit": "ok"})

            return ("fn", run_trainer)
        raise TypeError(f"unsupported trainable: {t!r}")

    def _generate_trials(self) -> List[Trial]:
        configs = BasicVariantGenerator(
            self.param_space, self.cfg.num_samples,
            seed=self.cfg.seed).variants()
        return [Trial(c, i, self.name) for i, c in enumerate(configs)]

    def _fit_with_searcher(self) -> List[Trial]:
        """Model-based search needs results fed back between suggestions
        (the suggest/on_trial_complete loop, tune/search/searcher.py):
        trials run in waves of ``max_concurrent_trials`` (default 1 wave
        of everything for a stateless searcher would starve the model, so
        the default wave is 1), with every completion reported to the
        searcher before the next wave is suggested."""
        import dataclasses

        alg = self.cfg.search_alg
        # wave size trades model freshness for throughput: 1 gives the
        # searcher feedback after every trial, large waves parallelize.
        # Default 4 keeps feedback-free searchers from running strictly
        # serially while a model-based searcher still observes often.
        wave = self.cfg.max_concurrent_trials or 4
        # the runner must NOT also report to the searcher (it would use
        # its own trial ids, double-counting every completion); this loop
        # is the single feedback path, keyed by the suggest() ids
        runner_cfg = dataclasses.replace(self.cfg, search_alg=None)
        payload = self._trainable_payload()  # pickle the trainable once
        trials: List[Trial] = []
        i = 0
        while i < self.cfg.num_samples:
            batch = []
            for j in range(min(wave, self.cfg.num_samples - i)):
                cfg = alg.suggest(f"t{i + j}")
                if cfg is None:
                    break  # searcher exhausted
                batch.append(Trial(cfg, i + j, self.name))
            if not batch:
                break
            runner = TrialRunner(payload, batch, runner_cfg,
                                 self.resources, syncer=self.syncer)
            runner.run()
            for j, t in enumerate(batch):
                alg.on_trial_complete(f"t{i + j}", t.last_result,
                                      error=t.error is not None)
            trials.extend(batch)
            i += len(batch)
        return trials

    def fit(self) -> ResultGrid:
        if self.cfg.search_alg is not None:
            trials = self._fit_with_searcher()
        else:
            trials = self._generate_trials()
            runner = TrialRunner(self._trainable_payload(), trials,
                                 self.cfg, self.resources,
                                 syncer=self.syncer)
            runner.run()
        results = [
            TrialResult(
                trial_id=t.id, config=t.config, metrics=t.last_result,
                metrics_history=t.history, checkpoint_blob=t.checkpoint_blob,
                error=t.error, status=t.status,
            )
            for t in trials
        ]
        return ResultGrid(results, self.cfg.metric, self.cfg.mode)
