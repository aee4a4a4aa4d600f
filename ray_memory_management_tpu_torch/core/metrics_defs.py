"""Canonical core-runtime instrument set (the reference's
src/ray/stats/metric_defs.cc analog).

Every metric the runtime emits is declared here once — name, type, help
text, tag keys, bucket boundaries — and call sites fetch instruments via
the accessor functions. Accessors re-register on demand so the set
survives ``metrics.clear_registry()`` in tests: construction either
registers a fresh instrument or aliases the storage of an
already-registered one (utils/metrics.py _adopt_prior).

Naming follows the Prometheus conventions the reference exporter uses:
``rmt_`` prefix, ``_total`` suffix on counters, base units in names
(seconds / bytes).
"""

from __future__ import annotations

from typing import Dict

from ..utils.metrics import Counter, Gauge, Histogram, Metric

# latency buckets: 500us .. 60s, roughly log-spaced — covers scheduler
# hops (sub-ms) through long collective/transfer ops
LATENCY_BOUNDARIES = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                      0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0]
# size buckets: 1KiB .. 4GiB
BYTES_BOUNDARIES = [float(1 << s) for s in (10, 14, 17, 20, 23, 26, 29, 32)]

# name -> (cls, kwargs); pure data so tests can assert the full set
DEFS: Dict[str, tuple] = {
    # task lifecycle (task_events analog)
    "rmt_tasks_submitted_total": (Counter, dict(
        description="Tasks submitted to the runtime (incl. actor tasks).")),
    "rmt_tasks_finished_total": (Counter, dict(
        description="Tasks that reached FINISHED.")),
    "rmt_tasks_failed_total": (Counter, dict(
        description="Tasks that reached FAILED (after retries).")),
    "rmt_tasks_retried_total": (Counter, dict(
        description="Task retry attempts (app error or worker death).")),
    "rmt_task_stage_seconds": (Histogram, dict(
        description="Per-task time spent in each lifecycle stage.",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("stage",))),
    # scheduler
    "rmt_scheduler_placements_total": (Counter, dict(
        description="Successful pick_node placements.")),
    "rmt_scheduler_queue_depth": (Gauge, dict(
        description="Dispatch-queue depth (queued + inflight) per node.",
        tag_keys=("node_id",))),
    "rmt_scheduler_pending_args": (Gauge, dict(
        description="Tasks waiting on argument dependencies.")),
    "rmt_scheduler_locality_hits_total": (Counter, dict(
        description="Placements (with locality scoring engaged) that "
                    "landed on a node already holding >= locality_min_"
                    "bytes of the task's argument bytes.")),
    "rmt_scheduler_locality_misses_total": (Counter, dict(
        description="Placements where some node held >= locality_min_"
                    "bytes of the task's args but placement landed "
                    "elsewhere (hard affinity, saturation spillback, or "
                    "the weighted score preferring an idle node).")),
    "rmt_scheduler_locality_bytes_avoided_total": (Counter, dict(
        description="Argument bytes already resident on the chosen node "
                    "at placement time — bytes the data plane never has "
                    "to move because the scheduler went to the data.")),
    "rmt_prefetch_started_total": (Counter, dict(
        description="Argument prestage pulls launched for tasks placed "
                    "on a non-holder (transfer overlaps dispatch-queue "
                    "wait instead of serializing before execution).")),
    "rmt_prefetch_completed_total": (Counter, dict(
        description="Argument prestage pulls that landed (task's args "
                    "were store-resident before a worker asked).")),
    "rmt_sched_local_placed_total": (Counter, dict(
        description="Leaf tasks placed through the agent-local lease "
                    "fast path (bulk-granted credits; no cluster-"
                    "scheduler pass, no per-task head routing).")),
    "rmt_sched_local_spillback_total": (Counter, dict(
        description="Leaf tasks spilled back to the head router: no "
                    "node had lease credits, or a saturated/dead agent "
                    "returned the lease (the two-level raylet spillback "
                    "hop, raylet_client.h:398).")),
    # object / device stores
    "rmt_object_store_bytes": (Gauge, dict(
        description="Shared-memory object store bytes in use per node.",
        tag_keys=("node_id",))),
    "rmt_device_store_bytes": (Gauge, dict(
        description="Accelerator-resident object bytes (device store).")),
    "rmt_device_objects_pinned": (Gauge, dict(
        description="Objects currently resident in a process's device "
                    "tier, per process (node_id, pid).",
        tag_keys=("node_id", "pid"))),
    "rmt_device_bytes_pinned": (Gauge, dict(
        description="Bytes currently resident in a process's device "
                    "tier, per process (node_id, pid).",
        tag_keys=("node_id", "pid"))),
    "rmt_device_evictions_total": (Counter, dict(
        description="Device objects demoted out of the HBM tier under "
                    "capacity pressure, by destination tier (shm = the "
                    "host store's create/seal path; the spill plane "
                    "takes over below it).",
        tag_keys=("to_tier",))),
    "rmt_device_zero_copy_hits_total": (Counter, dict(
        description="Device-object reads served zero-copy from the "
                    "live pinned torch.Tensor (no serialization, no host "
                    "copy).")),
    "rmt_device_ici_transfers_total": (Counter, dict(
        description="Device objects moved device-to-device over the "
                    "jitted same-mesh transfer path instead of the "
                    "host wire.")),
    "rmt_objects_spilled_total": (Counter, dict(
        description="Objects spilled to external storage.")),
    "rmt_objects_spilled_bytes_total": (Counter, dict(
        description="Bytes spilled to external storage.")),
    "rmt_objects_restored_total": (Counter, dict(
        description="Objects restored from external storage.")),
    "rmt_objects_restored_bytes_total": (Counter, dict(
        description="Bytes restored from external storage.")),
    # transfer plane
    "rmt_transfer_bytes": (Histogram, dict(
        description="Object payload size per transfer.",
        boundaries=BYTES_BOUNDARIES, tag_keys=("direction",))),
    "rmt_transfer_latency_seconds": (Histogram, dict(
        description="Wall time per object transfer.",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("direction",))),
    "rmt_transfer_stripe_requests_total": (Counter, dict(
        description="Range (partial-object) requests served — each stripe "
                    "of a striped pull is one.")),
    "rmt_transfer_striped_fetches_total": (Counter, dict(
        description="Pulls that used the striped multi-connection path.")),
    "rmt_transfer_pool_hits_total": (Counter, dict(
        description="Transfer connections reused from the pool "
                    "(handshake amortized).")),
    "rmt_transfer_pool_misses_total": (Counter, dict(
        description="Transfer connections freshly dialed (pool empty "
                    "for the peer, or pooling disabled).")),
    "rmt_transfer_broadcast_waits_total": (Counter, dict(
        description="Multi-destination pulls that waited at the broadcast "
                    "gate for an earlier copy to land (then pulled from a "
                    "new holder instead of the original source).")),
    # fault plane / recovery (the robustness PR's instrument set: every
    # injected fault, retry, failover and degradation is countable, so a
    # recovery regression shows in /metrics, not just tail latency)
    "rmt_faults_injected_total": (Counter, dict(
        description="Faults injected by the deterministic fault plane "
                    "(utils/faults.py), by site and mode.",
        tag_keys=("site", "mode"))),
    "rmt_retry_attempts_total": (Counter, dict(
        description="Retries taken under the unified RetryPolicy, by "
                    "plane (transfer, transfer.dial, push, spill, ...).",
        tag_keys=("plane",))),
    "rmt_retry_exhausted_total": (Counter, dict(
        description="RetryPolicy budgets spent without success, by plane.",
        tag_keys=("plane",))),
    "rmt_transfer_failovers_total": (Counter, dict(
        description="Mid-pull holder failovers: stripe ranges re-pulled "
                    "from an alternate holder after the original stalled "
                    "or died (no lineage re-execution).")),
    "rmt_transfer_checksum_mismatch_total": (Counter, dict(
        description="Payload CRC32 mismatches detected at a "
                    "materialization boundary (stripe completion, "
                    "restore) — treated as object loss, never returned.")),
    "rmt_transfer_auth_failures_total": (Counter, dict(
        description="Transfer dials refused at the authentication "
                    "handshake (non-retryable, distinct from peer death).")),
    # compressed movement plane (wire codecs + quantized collectives):
    # bytes_out/bytes_in is the achieved ratio per codec; the seconds
    # histogram splits encode vs decode so a slow decompressor shows up
    # on the right side of the wire.
    "rmt_transfer_compress_bytes_in_total": (Counter, dict(
        description="Logical (uncompressed) bytes entering a wire codec "
                    "on encode, by codec.",
        tag_keys=("codec",))),
    "rmt_transfer_compress_bytes_out_total": (Counter, dict(
        description="Compressed bytes leaving a wire codec for the wire "
                    "on encode, by codec (out/in = achieved ratio).",
        tag_keys=("codec",))),
    "rmt_transfer_compress_seconds": (Histogram, dict(
        description="Wire-codec CPU time per chunk, by codec and op "
                    "(encode|decode).",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("codec", "op"))),
    "rmt_transfer_compress_skipped_total": (Counter, dict(
        description="Payloads that bypassed wire compression, by reason "
                    "(below_threshold, incompressible probe verdict, "
                    "no_codec negotiated).",
        tag_keys=("reason",))),
    "rmt_collective_quantized_ops_total": (Counter, dict(
        description="Collective ops that quantized shards below f32 "
                    "before the wire (dequantize+accumulate stays f32), "
                    "by op and precision.",
        tag_keys=("op", "precision"))),
    "rmt_spill_errors_total": (Counter, dict(
        description="Spill-storage IO errors (before retry), by op.",
        tag_keys=("op",))),
    "rmt_spill_degraded_total": (Counter, dict(
        description="Times the store entered spill-degraded mode "
                    "(persistent storage failure; objects stay in memory "
                    "under backpressure until a probe succeeds).")),
    "rmt_stale_creates_aborted_total": (Counter, dict(
        description="Unsealed creates swept and aborted after exceeding "
                    "unsealed_create_deadline_s (leaked by a dead "
                    "fetcher).")),
    "rmt_object_directory_prunes_total": (Counter, dict(
        description="Stale GCS object-directory locations pruned after a "
                    "holder reported the object missing.")),
    # pod-scale control plane (hot/cold directory + delta heartbeats):
    # the memory bound and the O(changes) ingress claim are measurable,
    # not just asserted by the pod bench
    "rmt_gcs_directory_hot_rows": (Gauge, dict(
        description="RAM-resident GCS object-directory rows across "
                    "shards (bounded by gcs_directory_hot_max_rows).")),
    "rmt_gcs_directory_cold_rows": (Gauge, dict(
        description="Directory rows spilled to the gcs_storage blob "
                    "surface; only their per-oid index entry stays in "
                    "head RAM.")),
    "rmt_gcs_directory_faults_total": (Counter, dict(
        description="Cold directory batches faulted back into the hot "
                    "tables on a locate/mutation of a spilled row.")),
    "rmt_gcs_directory_spills_total": (Counter, dict(
        description="Directory LRU-tail batches spilled to the "
                    "gcs_storage blob surface by the hot-row cap.")),
    "rmt_heartbeat_resyncs_total": (Counter, dict(
        description="Full-state heartbeat resyncs requested after a "
                    "delta-pong sequence gap or reconnect.")),
    "rmt_leaf_lease_batches_total": (Counter, dict(
        description="lease_batch frames flushed (leaf grants coalesced "
                    "per node per scheduling pass instead of one frame "
                    "per task).")),
    # elastic train plane (checkpoint/restore/resize — the preemption-
    # tolerance instrument set: a training run's durability overhead and
    # recovery behavior are countable, not just visible in wall-clock)
    "rmt_train_checkpoint_saves_total": (Counter, dict(
        description="Durable training checkpoints written (atomic "
                    "tmp+rename with CRC32 manifest), by result.",
        tag_keys=("result",))),
    "rmt_train_checkpoint_restores_total": (Counter, dict(
        description="Training checkpoints loaded for resume, by source "
                    "(latest, fallback after a corrupt/partial newest, "
                    "uri).",
        tag_keys=("source",))),
    "rmt_train_checkpoint_save_seconds": (Histogram, dict(
        description="Training checkpoint save time split by phase: "
                    "'blocking' is the step-blocking slice the trainer "
                    "waits on (enqueue/snapshot), 'drain' is the "
                    "background writer's full durable-write time.",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("phase",))),
    "rmt_train_elastic_resizes_total": (Counter, dict(
        description="Elastic worker-group resizes (rebuild at a new "
                    "world size), by direction (down after node loss, "
                    "up when capacity returned).",
        tag_keys=("direction",))),
    # collectives
    "rmt_collective_latency_seconds": (Histogram, dict(
        description="Wall time per collective op.",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("op",))),
    # liveness
    "rmt_worker_heartbeat_age_seconds": (Gauge, dict(
        description="Seconds since each node's last heartbeat.",
        tag_keys=("node_id",))),
    # worker-process-side (merged into the head registry via the
    # done-reply/flush piggyback channel)
    "rmt_worker_tasks_executed_total": (Counter, dict(
        description="Tasks executed, counted worker-side.")),
    # observability plane itself
    "rmt_timeline_events_dropped_total": (Counter, dict(
        description="Timeline spans evicted from the bounded event ring "
                    "(oldest-first) before they could be dumped; counted "
                    "in whichever process dropped them and merged into "
                    "the head registry via the flush channel.")),
    # log plane (utils/structlog.py)
    "rmt_logs_records_total": (Counter, dict(
        description="Structured log records captured, by source stream "
                    "(logging bridge vs the stdout/stderr tee); counted "
                    "at emit time in whichever process captured them.",
        tag_keys=("stream",))),
    "rmt_logs_bytes_total": (Counter, dict(
        description="Structured log message bytes captured (payload "
                    "text only, excluding the record envelope).")),
    "rmt_logs_dropped_total": (Counter, dict(
        description="Log records dropped oldest-first: buffer_full is "
                    "the worker-side bounded queue overflowing under "
                    "backpressure, retention is head-side LogStore ring "
                    "eviction.",
        tag_keys=("reason",))),
    "rmt_logs_flush_seconds": (Histogram, dict(
        description="Worker-side log batch drain time per flush frame "
                    "(done reply, ticker, or exit flush).",
        boundaries=LATENCY_BOUNDARIES)),
    # serve data plane (serve/: router, replica, proxy, paged KV engine)
    "rmt_serve_requests_total": (Counter, dict(
        description="Requests executed by serve replicas, by deployment "
                    "and result (ok | error).",
        tag_keys=("deployment", "result"))),
    "rmt_serve_request_seconds": (Histogram, dict(
        description="Replica-side service time per request (queue wait "
                    "inside the replica included, routing excluded).",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("deployment",))),
    "rmt_serve_shed_total": (Counter, dict(
        description="Requests shed instead of queued, by reason: "
                    "backpressure_timeout (router deadline expired), "
                    "no_replicas (routing table stayed empty), "
                    "queue_full (proxy 429 on queue depth past "
                    "serve_shed_queue_factor x capacity).",
        tag_keys=("reason",))),
    "rmt_serve_queue_depth": (Gauge, dict(
        description="Cluster-wide ongoing-request depth per deployment, "
                    "from the replica queue-depth snapshots piggybacked "
                    "on the controller's routing table.",
        tag_keys=("deployment",))),
    "rmt_serve_autoscale_errors_total": (Counter, dict(
        description="Replica metrics fetches that failed during an "
                    "autoscale pass (previously swallowed silently).")),
    "rmt_serve_autoscale_decisions_total": (Counter, dict(
        description="Autoscaling decisions that changed a deployment's "
                    "target replica count, by direction (up | down).",
        tag_keys=("direction",))),
    "rmt_serve_kv_pages_in_use": (Gauge, dict(
        description="KV-cache pages currently allocated from the serve "
                    "engine's device page pool (live-token footprint in "
                    "kv_page_tokens units).")),
    "rmt_serve_kv_backpressure_total": (Counter, dict(
        description="Admissions deferred because the KV page pool was "
                    "exhausted (the request stays queued and admits "
                    "when a retiring slot frees pages — backpressure, "
                    "never an allocation failure).")),
    "rmt_serve_cold_start_seconds": (Histogram, dict(
        description="Replica model cold-start time, by weight source "
                    "(init = fresh parameter init, shipped = quantized "
                    "weights from the movement plane).",
        boundaries=LATENCY_BOUNDARIES, tag_keys=("source",))),
    "rmt_serve_replica_placements_total": (Counter, dict(
        description="Replica actor placements, by mode (tier_affine = "
                    "soft node affinity toward a holder of the "
                    "deployment's weights object from the tier-tagged "
                    "locality directory, default = no hint).",
        tag_keys=("mode",))),
    # multi-tenant job plane (core/job_plane.py: quotas, sweeps,
    # preemption — the tenancy instrument set: a leaked job shows up as
    # a non-zero post-sweep gauge, not just missing HBM bytes)
    "rmt_jobs_active": (Gauge, dict(
        description="Jobs with a live ledger (driver + connected "
                    "clients + job_submission drivers).")),
    "rmt_job_sweeps_total": (Counter, dict(
        description="Job-death sweeps completed, by trigger "
                    "(disconnect = client conn closed, watchdog = "
                    "dropped-detach recovery, stop = explicit job stop, "
                    "retry = re-run after an injected sweep error).",
        tag_keys=("trigger",))),
    "rmt_job_preemptions_total": (Counter, dict(
        description="Leaf-lease preemptions: a higher-priority job "
                    "evicted a lower-priority job's leaf task (the "
                    "victim re-queues on a free retry).")),
    "rmt_job_quota_rejections_total": (Counter, dict(
        description="Admissions rejected by a job quota, by resource "
                    "(object_bytes | device_bytes).",
        tag_keys=("resource",))),
    "rmt_job_sweep_seconds": (Histogram, dict(
        description="Wall time per job-death sweep (walk the job's "
                    "directory/refcount rows, free objects, kill "
                    "actors, cancel leases).",
        boundaries=LATENCY_BOUNDARIES)),
    # profiling plane (utils/profiler.py)
    "rmt_proc_cpu_seconds_total": (Counter, dict(
        description="Process CPU seconds (user+system) accumulated, by "
                    "process role; fed by the continuous sampler's "
                    "per-tick delta and by per-task rusage attribution.",
        tag_keys=("role",))),
    "rmt_proc_rss_bytes": (Gauge, dict(
        description="Process resident set size in bytes, sampled by the "
                    "profiling plane (/proc/self/statm; getrusage peak "
                    "where /proc is absent).")),
    "rmt_profile_samples_total": (Counter, dict(
        description="Stack samples captured (one per thread per sampler "
                    "tick or burst tick), counted in whichever process "
                    "captured them.")),
    "rmt_profile_bytes_total": (Counter, dict(
        description="Folded-stack payload bytes drained onto flush "
                    "frames / pongs (the profiling plane's wire cost).")),
    "rmt_profile_dropped_total": (Counter, dict(
        description="Stack samples dropped: agg_full is the bounded "
                    "per-process aggregation map refusing a new distinct "
                    "stack, retention is head-side ProfileStore ring "
                    "eviction.",
        tag_keys=("reason",))),
    # health plane (utils/tsdb.py + core/health.py)
    "rmt_metrics_series_overflow_total": (Counter, dict(
        description="Metric writes folded into the all-__other__ "
                    "overflow series by the registry cardinality guard "
                    "(a NEW distinct tag combo past metrics_max_series_"
                    "per_name), by metric name.",
        tag_keys=("metric",))),
    "rmt_tsdb_dropped_total": (Counter, dict(
        description="Time-series samples the head tsdb refused into a "
                    "dedicated ring: cardinality is a tag combo past "
                    "tsdb_max_series_per_name (the sample folds into "
                    "the per-name __other__ bucket instead).",
        tag_keys=("reason",))),
    "rmt_workers_exited_total": (Counter, dict(
        description="Worker processes that exited (clean or crashed) "
                    "and were reaped by the head's death path; the "
                    "health plane's worker-churn rate signal.")),
    "rmt_health_alerts_total": (Counter, dict(
        description="Health-rule alert transitions (firing + resolved), "
                    "by rule and severity.",
        tag_keys=("rule", "severity"))),
}


def get(name: str) -> Metric:
    """Fetch (constructing if needed) a canonical instrument by name.

    Construction is idempotent: utils.metrics aliases storage when the
    name is already registered, so this is cheap enough for emit sites to
    call per event — but hot paths should still hoist the result."""
    cls, kw = DEFS[name]
    return cls(name, **kw)


def tasks_submitted() -> Counter:
    return get("rmt_tasks_submitted_total")


def tasks_finished() -> Counter:
    return get("rmt_tasks_finished_total")


def tasks_failed() -> Counter:
    return get("rmt_tasks_failed_total")


def tasks_retried() -> Counter:
    return get("rmt_tasks_retried_total")


def task_stage_seconds() -> Histogram:
    return get("rmt_task_stage_seconds")


def scheduler_placements() -> Counter:
    return get("rmt_scheduler_placements_total")


def scheduler_queue_depth() -> Gauge:
    return get("rmt_scheduler_queue_depth")


def scheduler_pending_args() -> Gauge:
    return get("rmt_scheduler_pending_args")


def scheduler_locality_hits() -> Counter:
    return get("rmt_scheduler_locality_hits_total")


def scheduler_locality_misses() -> Counter:
    return get("rmt_scheduler_locality_misses_total")


def scheduler_locality_bytes_avoided() -> Counter:
    return get("rmt_scheduler_locality_bytes_avoided_total")


def prefetch_started() -> Counter:
    return get("rmt_prefetch_started_total")


def prefetch_completed() -> Counter:
    return get("rmt_prefetch_completed_total")


def object_store_bytes() -> Gauge:
    return get("rmt_object_store_bytes")


def device_store_bytes() -> Gauge:
    return get("rmt_device_store_bytes")


def device_objects_pinned() -> Gauge:
    return get("rmt_device_objects_pinned")


def device_bytes_pinned() -> Gauge:
    return get("rmt_device_bytes_pinned")


def device_evictions() -> Counter:
    return get("rmt_device_evictions_total")


def device_zero_copy_hits() -> Counter:
    return get("rmt_device_zero_copy_hits_total")


def device_ici_transfers() -> Counter:
    return get("rmt_device_ici_transfers_total")


def objects_spilled() -> Counter:
    return get("rmt_objects_spilled_total")


def objects_spilled_bytes() -> Counter:
    return get("rmt_objects_spilled_bytes_total")


def objects_restored() -> Counter:
    return get("rmt_objects_restored_total")


def objects_restored_bytes() -> Counter:
    return get("rmt_objects_restored_bytes_total")


def transfer_bytes() -> Histogram:
    return get("rmt_transfer_bytes")


def transfer_latency_seconds() -> Histogram:
    return get("rmt_transfer_latency_seconds")


def transfer_stripe_requests() -> Counter:
    return get("rmt_transfer_stripe_requests_total")


def transfer_striped_fetches() -> Counter:
    return get("rmt_transfer_striped_fetches_total")


def transfer_pool_hits() -> Counter:
    return get("rmt_transfer_pool_hits_total")


def transfer_pool_misses() -> Counter:
    return get("rmt_transfer_pool_misses_total")


def transfer_broadcast_waits() -> Counter:
    return get("rmt_transfer_broadcast_waits_total")


def faults_injected() -> Counter:
    return get("rmt_faults_injected_total")


def retry_attempts() -> Counter:
    return get("rmt_retry_attempts_total")


def retry_exhausted() -> Counter:
    return get("rmt_retry_exhausted_total")


def transfer_failovers() -> Counter:
    return get("rmt_transfer_failovers_total")


def transfer_checksum_mismatch() -> Counter:
    return get("rmt_transfer_checksum_mismatch_total")


def transfer_auth_failures() -> Counter:
    return get("rmt_transfer_auth_failures_total")


def transfer_compress_bytes_in() -> Counter:
    return get("rmt_transfer_compress_bytes_in_total")


def transfer_compress_bytes_out() -> Counter:
    return get("rmt_transfer_compress_bytes_out_total")


def transfer_compress_seconds() -> Histogram:
    return get("rmt_transfer_compress_seconds")


def transfer_compress_skipped() -> Counter:
    return get("rmt_transfer_compress_skipped_total")


def collective_quantized_ops() -> Counter:
    return get("rmt_collective_quantized_ops_total")


def spill_errors() -> Counter:
    return get("rmt_spill_errors_total")


def spill_degraded() -> Counter:
    return get("rmt_spill_degraded_total")


def stale_creates_aborted() -> Counter:
    return get("rmt_stale_creates_aborted_total")


def object_directory_prunes() -> Counter:
    return get("rmt_object_directory_prunes_total")


def gcs_directory_hot_rows() -> Gauge:
    return get("rmt_gcs_directory_hot_rows")


def gcs_directory_cold_rows() -> Gauge:
    return get("rmt_gcs_directory_cold_rows")


def gcs_directory_faults() -> Counter:
    return get("rmt_gcs_directory_faults_total")


def gcs_directory_spills() -> Counter:
    return get("rmt_gcs_directory_spills_total")


def heartbeat_resyncs() -> Counter:
    return get("rmt_heartbeat_resyncs_total")


def leaf_lease_batches() -> Counter:
    return get("rmt_leaf_lease_batches_total")


def sched_local_placed() -> Counter:
    return get("rmt_sched_local_placed_total")


def sched_local_spillback() -> Counter:
    return get("rmt_sched_local_spillback_total")


def train_checkpoint_saves() -> Counter:
    return get("rmt_train_checkpoint_saves_total")


def train_checkpoint_restores() -> Counter:
    return get("rmt_train_checkpoint_restores_total")


def train_checkpoint_save_seconds() -> Histogram:
    return get("rmt_train_checkpoint_save_seconds")


def train_elastic_resizes() -> Counter:
    return get("rmt_train_elastic_resizes_total")


def collective_latency_seconds() -> Histogram:
    return get("rmt_collective_latency_seconds")


def worker_heartbeat_age_seconds() -> Gauge:
    return get("rmt_worker_heartbeat_age_seconds")


def worker_tasks_executed() -> Counter:
    return get("rmt_worker_tasks_executed_total")


def timeline_events_dropped() -> Counter:
    return get("rmt_timeline_events_dropped_total")


def logs_records() -> Counter:
    return get("rmt_logs_records_total")


def logs_bytes() -> Counter:
    return get("rmt_logs_bytes_total")


def logs_dropped() -> Counter:
    return get("rmt_logs_dropped_total")


def logs_flush_seconds() -> Histogram:
    return get("rmt_logs_flush_seconds")


def proc_cpu_seconds() -> Counter:
    return get("rmt_proc_cpu_seconds_total")


def proc_rss_bytes() -> Gauge:
    return get("rmt_proc_rss_bytes")


def serve_requests() -> Counter:
    return get("rmt_serve_requests_total")


def serve_request_seconds() -> Histogram:
    return get("rmt_serve_request_seconds")


def serve_shed() -> Counter:
    return get("rmt_serve_shed_total")


def serve_queue_depth() -> Gauge:
    return get("rmt_serve_queue_depth")


def serve_autoscale_errors() -> Counter:
    return get("rmt_serve_autoscale_errors_total")


def serve_autoscale_decisions() -> Counter:
    return get("rmt_serve_autoscale_decisions_total")


def serve_kv_pages_in_use() -> Gauge:
    return get("rmt_serve_kv_pages_in_use")


def serve_kv_backpressure() -> Counter:
    return get("rmt_serve_kv_backpressure_total")


def serve_cold_start_seconds() -> Histogram:
    return get("rmt_serve_cold_start_seconds")


def serve_replica_placements() -> Counter:
    return get("rmt_serve_replica_placements_total")


def jobs_active() -> Gauge:
    return get("rmt_jobs_active")


def job_sweeps() -> Counter:
    return get("rmt_job_sweeps_total")


def job_preemptions() -> Counter:
    return get("rmt_job_preemptions_total")


def job_quota_rejections() -> Counter:
    return get("rmt_job_quota_rejections_total")


def job_sweep_seconds() -> Histogram:
    return get("rmt_job_sweep_seconds")


def profile_samples() -> Counter:
    return get("rmt_profile_samples_total")


def profile_bytes() -> Counter:
    return get("rmt_profile_bytes_total")


def profile_dropped() -> Counter:
    return get("rmt_profile_dropped_total")


def metrics_series_overflow() -> Counter:
    return get("rmt_metrics_series_overflow_total")


def tsdb_dropped() -> Counter:
    return get("rmt_tsdb_dropped_total")


def workers_exited() -> Counter:
    return get("rmt_workers_exited_total")


def health_alerts() -> Counter:
    return get("rmt_health_alerts_total")
