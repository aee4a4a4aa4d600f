"""Multi-tenant job plane (core/job_plane.py + runtime sweeps).

Quota admission edges (exactly-met, typed rejection, cpu-slot
backpressure, device-quota vs demotion interplay), stride fair shares,
leaf-lease priority preemption (queued and running victims, including a
victim holding an unsealed create), job-death sweeps idempotent under
injected job.sweep errors, watchdog recovery of a dropped job.detach
notification, JobSubmissionClient stale-state repair after SIGKILL,
per-job observability views, and the driver-churn chaos soak.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch import api as _api
from ray_memory_management_tpu_torch import state
from ray_memory_management_tpu_torch.config import Config
from ray_memory_management_tpu_torch.core.object_ref import ObjectRef
from ray_memory_management_tpu_torch.exceptions import QuotaExceededError, RmtError
from ray_memory_management_tpu_torch.utils import faults
from _port_fixtures import one_intra_op_thread  # noqa: F401


@pytest.fixture
def rmt_start_regular():
    rt = rmt.init(num_cpus=4, ignore_reinit_error=True)
    yield rt
    rmt.shutdown()



def _submit_as(rt, fn, job, *args):
    """Submit one task attributed to ``job`` the way the cluster server
    stamps thin-client payloads (job_id set server-side on the payload);
    returns the single return-object id."""
    payload = dict(fn._template())
    enc_args, enc_kwargs = _api._encode_call(args, {})
    payload["args"] = enc_args
    payload["kwargs"] = enc_kwargs
    if job is not None:
        payload["job_id"] = job
    return rt.submit_task(payload)[0]


@pytest.fixture
def clean_faults():
    yield
    faults.reset()


# --------------------------------------------------------------- quota edges
def test_quota_exactly_met_then_typed_rejection(rmt_start_regular):
    """A put landing exactly ON the byte quota admits; the next one gets
    a typed QuotaExceededError naming job/resource/limit/usage, counted
    on the ledger, with the rest of the cluster untouched."""
    rt = rmt_start_regular
    job = os.urandom(16)
    rt.register_client_job(job, {"type": "client"})
    rt.put_object(b"a" * 1000, job_id=job)
    used = rt.job_usage()[job.hex()]["object_bytes"]
    rt.set_job_quota(job, {"object_bytes": 2 * used})

    rt.put_object(b"a" * 1000, job_id=job)  # exactly met: admitted
    assert rt.job_usage()[job.hex()]["object_bytes"] == 2 * used

    with pytest.raises(QuotaExceededError) as ei:
        rt.put_object(b"a" * 1000, job_id=job)
    err = ei.value
    assert err.resource == "object_bytes"
    assert err.job_id_hex == job.hex()
    assert err.limit == 2 * used and err.used == 2 * used
    assert rt.job_usage()[job.hex()]["rejections"] == 1
    # rejection is strictly local to the offending job: the (unlimited)
    # root driver still puts freely
    assert rmt.get(rmt.put(b"root-unaffected")) == b"root-unaffected"

    assert rt.sweep_job(job, trigger="disconnect")
    assert rt.gcs.count_job_rows(job) == 0
    assert job.hex() not in rt.job_usage()


def test_cpu_slots_backpressure_not_rejection(rmt_start_regular):
    """cpu_slots throttles by PARKING, never by erroring: 6 submits
    against a 2-slot quota all complete, with at most 2 ever in flight
    and the parked queue observably draining."""
    rt = rmt_start_regular

    @rmt.remote
    def slow(i):
        import time as _t

        _t.sleep(0.15)
        return i * 7

    job = os.urandom(16)
    rt.register_client_job(job, quota={"cpu_slots": 2})
    rids = [_submit_as(rt, slow, job, i) for i in range(6)]

    peak, saw_parked = 0, False
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        u = rt.job_usage().get(job.hex())
        assert u is not None
        peak = max(peak, u["tasks_inflight"])
        saw_parked = saw_parked or u["tasks_parked"] > 0
        if u["tasks_finished"] >= 6:
            break
        time.sleep(0.01)

    assert rt.get_objects(rids, timeout=60) == [i * 7 for i in range(6)]
    u = rt.job_usage()[job.hex()]
    assert peak <= 2, f"cpu_slots=2 but saw {peak} in flight"
    assert saw_parked, "6 submits over 2 slots never queued"
    assert u["tasks_parked"] == 0 and u["tasks_finished"] == 6
    assert rt.sweep_job(job)


def test_device_quota_vs_demotion_interplay():
    """Device-tier demotion moves a pin's bytes from device_bytes to
    object_bytes accounting — demoted bytes stop counting against the
    device quota — and the job-aware victim rank demotes the client
    job's cold pins before the driver's, even older ones."""
    one = 4096 * 4  # float32[4096] = 16384 bytes
    cfg = Config(device_store_capacity_bytes=40_000)
    rt = rmt.init(num_cpus=2, _config=cfg)
    try:
        driver_oid = rt.put_device_object(
            torch.zeros(4096, dtype=torch.float32))  # untagged: rank last
        job = os.urandom(16)
        rt.register_client_job(job, quota={"device_bytes": 3 * one})
        o1 = rt.put_device_object(
            torch.zeros(4096, dtype=torch.float32), job_id=job)
        # third pin crosses the 40KB tier budget: the store demotes the
        # JOB's LRU pin (o1) to host shm — not the colder driver pin
        o2 = rt.put_device_object(
            torch.ones(4096, dtype=torch.float32), job_id=job)
        u = rt.job_usage()[job.hex()]
        assert u["device_bytes"] == one, u
        assert u["object_bytes"] == one  # demoted o1 migrated tiers
        assert rt.device_store.contains(driver_oid)
        assert not rt.device_store.contains(o1)
        # the demoted copy is still readable through the host tier
        assert (rt.get_objects([o1], timeout=30)[0] == 0).all()
        # a third pin would be over the 48KB device quota WITHOUT the
        # demotion credit (3*16384 charged); with it, only o2 counts
        o3 = rt.put_device_object(
            torch.full((4096,), 2.0, dtype=torch.float32), job_id=job)
        u = rt.job_usage()[job.hex()]
        assert u["device_bytes"] == one  # o3 resident, o2 now demoted
        assert u["object_bytes"] == 2 * one

        # hard rejection is typed and NEVER sweeps another job's state
        pauper = os.urandom(16)
        rt.register_client_job(pauper, quota={"device_bytes": one})
        rt.put_device_object(torch.zeros(4096, dtype=torch.float32),
                             job_id=pauper)  # exactly met
        with pytest.raises(QuotaExceededError) as ei:
            rt.put_device_object(torch.zeros(4096, dtype=torch.float32),
                                 job_id=pauper)
        assert ei.value.resource == "device_bytes"
        assert rt.device_store.contains(driver_oid)
        assert (rt.get_objects([o1, o3], timeout=30)[0] == 0).all()

        assert rt.sweep_job(pauper)
        assert rt.sweep_job(job)
        assert rt.gcs.count_job_rows(job) == 0
        # every job pin left the device tier; the driver's survives
        assert rt.device_store.contains(driver_oid)
        assert rt.device_store.total_bytes() == one
    finally:
        rmt.shutdown()


# --------------------------------------------------------------- fair shares
def test_fair_order_same_priority_within_10pct():
    """Stride interleave: two equal-priority jobs split every prefix of
    one drained batch 50/50 (±10%), whatever the arrival order; 3:1
    priorities get 3:1 shares."""
    from ray_memory_management_tpu_torch.core.job_plane import (
        JobLedger, JobQuota, fair_order)

    class S:
        def __init__(self, led):
            self.led = led

    a, b = JobLedger(b"A" * 16), JobLedger(b"B" * 16)
    batch = [S(a) for _ in range(100)] + [S(b) for _ in range(100)]
    out = fair_order(batch, lambda s: s.led)
    for n in (20, 50, 100, 200):
        got_a = sum(1 for s in out[:n] if s.led is a)
        assert abs(got_a - n / 2) <= max(1, 0.1 * (n / 2)), (n, got_a)

    hi = JobLedger(b"H" * 16, JobQuota(priority=3))
    lo = JobLedger(b"L" * 16, JobQuota(priority=1))
    out = fair_order([S(hi) for _ in range(90)]
                     + [S(lo) for _ in range(90)], lambda s: s.led)
    got_hi = sum(1 for s in out[:80] if s.led is hi)
    assert abs(got_hi - 60) <= 6, got_hi  # 3:1 weighted share, ±10%


# ---------------------------------------------------------------- preemption
def test_priority_preemption_of_queued_leaf_lease(tmp_path):
    """A priority-2 job preempts a priority-1 job's QUEUED leaf lease
    when every credit is taken; the victim re-queues through the normal
    scheduler and still completes (acceptance criterion)."""
    cfg = Config(leaf_lease_slots=3)
    rt = rmt.init(num_cpus=1, _config=cfg)
    try:
        ready = str(tmp_path / "ready")
        release = str(tmp_path / "go")

        @rmt.remote
        def blocker(ready_p, release_p):
            import os as _o
            import time as _t

            open(ready_p, "a").close()
            while not _o.path.exists(release_p):
                _t.sleep(0.01)
            return "blocked-done"

        # half-CPU so the victims CANNOT pipeline onto the blocker's
        # held 1-CPU lease — they stay in the node queue as preemptable
        # QUEUED leaf work (still leaf-eligible: <= 1 CPU)
        @rmt.remote(num_cpus=0.5)
        def quick(i):
            return i * 3

        lo, hi = os.urandom(16), os.urandom(16)
        rt.register_client_job(lo, quota={"priority": 1})
        rt.register_client_job(hi, quota={"priority": 2})

        b = _submit_as(rt, blocker, lo, ready, release)
        deadline = time.monotonic() + 60
        while not os.path.exists(ready):
            assert time.monotonic() < deadline, "blocker never started"
            time.sleep(0.01)
        q1 = _submit_as(rt, quick, lo, 1)
        q2 = _submit_as(rt, quick, lo, 2)
        nm = rt.head_node()
        while True:  # all 3 lease credits taken: the pool is dry
            with nm._lock:
                if nm.leaf_credits == 0:
                    break
            assert time.monotonic() < deadline, "leaf pool never drained"
            time.sleep(0.01)

        h = _submit_as(rt, quick, hi, 100)
        while rt.job_usage()[lo.hex()]["preempted"] < 1:
            assert time.monotonic() < deadline, "no preemption happened"
            time.sleep(0.01)

        open(release, "a").close()
        assert rt.get_objects([h], timeout=60)[0] == 300
        # the preempted task completed after its re-queue
        assert rt.get_objects([b, q1, q2], timeout=60) == \
            ["blocked-done", 3, 6]
        from ray_memory_management_tpu_torch.core import metrics_defs as mdefs

        assert mdefs.job_preemptions().get() >= 1
    finally:
        rmt.shutdown()


def test_preempting_running_victim_aborts_unsealed_create(tmp_path):
    """Preempting a RUNNING victim kills its worker mid-task; the
    head-store staging create the victim's work held open (the mid-pull
    analog — worker-side creates seal synchronously, head-side staging
    is the leak candidate) is ABORTED by the unsealed-create GC, not
    leaked, and the victim re-queues and completes."""
    cfg = Config(leaf_lease_slots=1)
    rt = rmt.init(num_cpus=1, _config=cfg)
    try:
        ready = str(tmp_path / "ready")
        release = str(tmp_path / "go")

        @rmt.remote
        def blocker(ready_p, release_p):
            import os as _o
            import time as _t

            open(ready_p, "a").close()
            while not _o.path.exists(release_p):
                _t.sleep(0.01)
            return "survived"

        @rmt.remote
        def quick(i):
            return i * 3

        lo, hi = os.urandom(16), os.urandom(16)
        rt.register_client_job(lo, quota={"priority": 1})
        rt.register_client_job(hi, quota={"priority": 2})

        b = _submit_as(rt, blocker, lo, ready, release)
        deadline = time.monotonic() + 60
        while not os.path.exists(ready):
            assert time.monotonic() < deadline, "blocker never started"
            time.sleep(0.01)

        # the victim's in-flight staging: an unsealed head-store create
        nm = rt.head_node()
        stage = os.urandom(16)
        buf = nm.store.create(stage, 8192)
        del buf

        h = _submit_as(rt, quick, hi, 5)  # no queued victim: kills worker
        while rt.job_usage()[lo.hex()]["preempted"] < 1:
            assert time.monotonic() < deadline, "no preemption happened"
            time.sleep(0.01)

        open(release, "a").close()
        assert rt.get_objects([h], timeout=60)[0] == 15
        # preemption refunded the retry: the killed victim re-ran
        assert rt.get_objects([b], timeout=60)[0] == "survived"
        # the orphaned create is aborted, not leaked
        assert nm.store.sweep_unsealed(deadline_s=0.0) == 1
        assert stage not in nm.store._unsealed
    finally:
        rmt.shutdown()


# -------------------------------------------------------------- sweep chaos
def test_sweep_idempotent_under_injected_job_sweep_errors(clean_faults):
    """The job.sweep fault site: the first sweep attempt loses two steps
    to injected errors, reports incomplete, and the heartbeat retry
    re-runs it to zero rows — preserving the original trigger, with
    admission closed the whole time."""
    cfg = Config(job_sweep_retry_s=0.1)
    rt = rmt.init(num_cpus=2, _config=cfg)
    try:
        faults.configure("job.sweep:error:p=1.0:max=2")
        job = os.urandom(16)
        rt.register_client_job(job)
        for _ in range(3):
            rt.put_object(b"z" * 200_000, job_id=job)  # directory rows
        assert rt.gcs.count_job_rows(job) > 0

        assert not rt.sweep_job(job, trigger="stop")
        with rt._lock:
            assert job in rt._sweep_retry
        # admission closed even while the sweep is mid-retry
        with pytest.raises(RmtError):
            rt.put_object(b"x", job_id=job)

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if rt.gcs.count_job_rows(job) == 0 \
                    and job.hex() not in rt.job_usage():
                break
            time.sleep(0.05)
        assert rt.gcs.count_job_rows(job) == 0
        assert job.hex() not in rt.job_usage()
        row = [r for r in rt.gcs.list_jobs()
               if r.get("job_id") == job.hex()]
        assert row and row[0]["state"] == "STOPPED"  # trigger preserved
        assert faults.plane().counters()["job.sweep:error"] == 2
    finally:
        rmt.shutdown()


def test_dropped_detach_notice_recovered_by_watchdog(rmt_start_regular,
                                                     clean_faults):
    """The job.detach fault site: the client's disconnect notification
    is dropped, so the connection thread never reclaims — the watchdog
    finds the orphan and sweeps it with the watchdog trigger (job row
    FAILED), leaking nothing."""
    from ray_memory_management_tpu_torch.client import ClusterServer

    rt = rmt_start_regular
    faults.configure("job.detach:drop:max=1")
    server = ClusterServer(port=0)
    try:
        script = f"""
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.client import connect
connect("127.0.0.1:{server.port}")
r = rmt.put(b"orphan" * 1000)
assert rmt.get(r) == b"orphan" * 1000
print("CLIENT OK", flush=True)
import os
os._exit(0)
"""
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=240)
        assert "CLIENT OK" in out.stdout, out.stderr
        deadline = time.monotonic() + 30
        jobs = []
        while time.monotonic() < deadline:
            jobs = state.list_jobs(filters=[("type", "=", "client")])
            if jobs and jobs[0]["state"] == "FAILED":
                break
            time.sleep(0.1)
        assert jobs and jobs[0]["state"] == "FAILED", jobs
        dead = bytes.fromhex(jobs[0]["job_id"])
        assert rt.gcs.count_job_rows(dead) == 0
        assert dead.hex() not in rt.job_usage()
        assert faults.plane().counters()["job.detach:drop"] == 1
    finally:
        server.close()


# ------------------------------------------------------- job_submission fix
def test_job_submission_sigkilled_driver_fails_and_reaps(tmp_path):
    """A SIGKILLed driver must not report RUNNING forever: the owning
    client fails it via poll() and reaps the Popen handle; a foreign
    client (no handle) fails it via the pid check, guarded against pid
    reuse by the /proc birth-time comparison."""
    from ray_memory_management_tpu_torch.job_submission import (
        FAILED, RUNNING, JobSubmissionClient)

    sleeper = f"{sys.executable} -c 'import time; time.sleep(600)'"
    c1 = JobSubmissionClient(job_dir=str(tmp_path))
    jid = c1.submit_job(entrypoint=sleeper)
    assert c1.get_job_status(jid) == RUNNING
    os.kill(c1.get_job_info(jid)["pid"], signal.SIGKILL)
    deadline = time.monotonic() + 10
    while c1.get_job_status(jid) == RUNNING:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    info = c1.get_job_info(jid)
    assert info["status"] == FAILED
    assert info["returncode"] == -signal.SIGKILL
    assert info["end_time"] is not None
    assert jid not in c1._procs  # orphaned subprocess handle reaped

    # foreign-client path: rewrite the meta back to RUNNING (the owning
    # client died before recording anything) — a fresh client must spot
    # the dead pid on get_status/list_jobs and fail the job
    meta = dict(info)
    meta["status"] = RUNNING
    meta["end_time"] = None
    c1._write_meta(jid, meta)
    c2 = JobSubmissionClient(job_dir=str(tmp_path))
    assert c2.get_job_status(jid) == FAILED
    assert all(r["status"] == FAILED for r in c2.list_jobs())

    # pid-reuse guard: a LIVE process born long after the job's submit
    # time is a recycled pid, not the driver
    probe = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        assert not c2._pid_is_this_job(
            {"pid": probe.pid, "start_time": time.time() - 3600})
        assert c2._pid_is_this_job(
            {"pid": probe.pid, "start_time": time.time()})
    finally:
        probe.kill()
        probe.wait()


# ------------------------------------------------------------ per-job views
def test_per_job_state_views_and_cli(rmt_start_regular, capsys):
    rt = rmt_start_regular

    @rmt.remote
    def tag(i):
        return i + 1

    job = os.urandom(16)
    rt.register_client_job(job, {"type": "client"},
                           quota={"priority": 2, "cpu_slots": 8})
    rids = [_submit_as(rt, tag, job, i) for i in range(4)]
    big = rt.put_object(b"q" * 200_000, job_id=job)
    assert rt.get_objects(rids, timeout=60) == [1, 2, 3, 4]

    mine = state.list_tasks(job_id=job.hex())
    assert len(mine) == 4
    # task ids carry the job's 4-byte prefix (attribution by eye)
    assert all(r["task_id"].startswith(job.hex()[:8]) for r in mine)
    # an unfiltered listing sees the same rows tagged with the job
    tagged = [r for r in state.list_tasks()
              if r.get("job_id") == job.hex()
              or r["task_id"].startswith(job.hex()[:8])]
    assert len(tagged) >= 4

    objs = state.list_objects(job_id=job.hex())
    assert any(r["object_id"] == big.hex() for r in objs)
    assert all(r.get("job_id") in (job.hex(), None) for r in objs)
    # log/profile planes accept the filter (rows, possibly empty)
    assert isinstance(state.get_logs(job_id=job.hex()), list)
    assert isinstance(state.get_profile(job_id=job.hex(), fold=False),
                      list)

    from ray_memory_management_tpu_torch.scripts import cli as rmt_cli

    assert rmt_cli.cmd_jobs(argparse.Namespace(json=True)) == 0
    rows = json.loads(capsys.readouterr().out)
    me = [r for r in rows if r.get("job_id") == job.hex()]
    assert me and me[0]["usage"]["priority"] == 2
    assert me[0]["usage"]["quota"]["cpu_slots"] == 8

    assert rmt_cli.cmd_jobs(argparse.Namespace(json=False)) == 0
    table = capsys.readouterr().out
    assert job.hex()[:8] in table and "prio" in table

    assert rt.sweep_job(job)
    # the swept job's rows vanish from the filtered views
    assert state.list_objects(job_id=job.hex()) == []


# ------------------------------------------------------------- churn soak
def test_driver_churn_soak(clean_faults):
    """Acceptance: 4 concurrent drivers churning register -> submit
    (chained DAGs + puts + device pins) -> clean disconnect or abrupt
    watchdog sweep (the SIGKILL analog), under bounded transfer /
    control.dispatch fault injection. Afterwards: zero directory rows
    for any dead job, device bytes back to baseline, every leaf lease
    returned, and every surviving round's results bit-exact."""
    rt = rmt.init(num_cpus=4)
    try:
        # two injected dispatch errors (absorbed by the 3-attempt
        # dispatch retry — no task can lose all its attempts) plus two
        # transfer faults, deterministic under the plane seed
        faults.configure(
            "control.dispatch:error:max=2;transfer.send:error:max=2",
            seed=11)

        @rmt.remote
        def stage1(i):
            return i * 3

        @rmt.remote
        def stage2(x):
            return x + 1

        @rmt.remote(num_cpus=2)
        def wide(i):  # not leaf-eligible: rides the control.dispatch site
            return i - 1

        credits0 = {}
        for nm in rt.nodes.values():
            with nm._lock:
                credits0[nm.node_id] = nm.leaf_credits
        dev_baseline = rt.device_store.total_bytes()

        dead, dead_lock = [], threading.Lock()
        errors = []

        def driver(ix):
            try:
                for rnd in range(3):
                    job = os.urandom(16)
                    rt.register_client_job(
                        job, {"type": "churn"},
                        quota={"priority": 1 + ix % 2})
                    mids = [_submit_as(rt, stage1, job, i)
                            for i in range(6)]
                    outs = [_submit_as(rt, stage2, job, ObjectRef(m))
                            for m in mids]
                    outs.append(_submit_as(rt, wide, job, 10 * ix))
                    put_id = rt.put_object(bytes([ix]) * 2048, job_id=job)
                    rt.put_device_object(
                        torch.full((256,), float(ix), dtype=torch.float32),
                        job_id=job)
                    if (ix + rnd) % 3 == 2:
                        # SIGKILL analog: tasks still in flight, no
                        # goodbye — the sweep cancels and reclaims all
                        rt.sweep_job(job, trigger="watchdog")
                    else:
                        vals = rt.get_objects(outs, timeout=120)
                        assert vals == [i * 3 + 1 for i in range(6)] \
                            + [10 * ix - 1], vals  # bit-exact survivors
                        assert rt.get_objects([put_id])[0] == \
                            bytes([ix]) * 2048
                        rt.sweep_job(job, trigger="disconnect")
                    with dead_lock:
                        dead.append(job)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=driver, args=(i,),
                                    name=f"churn-driver-{i}")
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(dead) == 12

        # leak probes: directory/refcount rows, ledgers, HBM, leases
        for job in dead:
            assert rt.gcs.count_job_rows(job) == 0, job.hex()
        live = rt.job_usage()
        assert not any(j.hex() in live for j in dead)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            dev_ok = rt.device_store.total_bytes() == dev_baseline
            lease_ok = True
            for nm in rt.nodes.values():
                with nm._lock:
                    lease_ok &= nm.leaf_credits == credits0[nm.node_id]
            if dev_ok and lease_ok:
                break
            time.sleep(0.1)
        assert rt.device_store.total_bytes() == dev_baseline
        for nm in rt.nodes.values():
            with nm._lock:
                assert nm.leaf_credits == credits0[nm.node_id]
        # the chaos was real: both injected dispatch faults fired
        assert faults.plane().counters()["control.dispatch:error"] == 2
    finally:
        rmt.shutdown()
