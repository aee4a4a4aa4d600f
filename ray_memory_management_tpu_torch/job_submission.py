"""Job submission: run driver scripts as managed subprocesses.

The reference's job manager + SDK (dashboard/modules/job/job_manager.py,
python/ray/job_submission/): submit an entrypoint command, track status,
stream logs, stop. No REST head here — the client manages jobs directly,
with state durable in a filesystem job dir so a second client (or CLI)
can list/inspect the same jobs.

Given a cluster's client port (``address``, or ``RMT_CLIENT_ADDRESS``),
each entrypoint runs with ``RMT_CLIENT_ADDRESS`` and ``RMT_SUBMISSION_ID``
set: its driver joins that head with ``init(address="auto")``, and the
head's job row (``state.list_jobs()``) carries the ``submission_id``,
so the job plane charges, lists and sweeps the driver's tasks and
objects under that job (``state.list_tasks(job_id=...)``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"

_DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "rmt_jobs")


class JobSubmissionClient:
    def __init__(self, job_dir: Optional[str] = None,
                 address: Optional[str] = None):
        self.job_dir = job_dir or os.environ.get(
            "RMT_JOB_DIR", _DEFAULT_DIR)
        self.address = address or os.environ.get("RMT_CLIENT_ADDRESS")
        os.makedirs(self.job_dir, exist_ok=True)
        self._procs: Dict[str, subprocess.Popen] = {}

    # -- paths ----------------------------------------------------------------
    def _meta_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir, job_id, "meta.json")

    def _log_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir, job_id, "driver.log")

    def _write_meta(self, job_id: str, meta: Dict[str, Any]) -> None:
        path = self._meta_path(job_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    def _read_meta(self, job_id: str) -> Dict[str, Any]:
        with open(self._meta_path(job_id)) as f:
            return json.load(f)

    # -- API ------------------------------------------------------------------
    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        """Launch the entrypoint as a detached subprocess; returns the
        job id (JobSubmissionClient.submit_job in the reference)."""
        if not entrypoint or not entrypoint.strip():
            raise ValueError("entrypoint must be a non-empty command")
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        job_root = os.path.join(self.job_dir, job_id)
        if os.path.exists(job_root):
            raise ValueError(f"job {job_id!r} already exists")
        os.makedirs(job_root)
        env = dict(os.environ)
        env["RMT_SUBMISSION_ID"] = job_id
        if self.address:
            env["RMT_CLIENT_ADDRESS"] = self.address
        renv = runtime_env or {}
        env.update({str(k): str(v)
                    for k, v in (renv.get("env_vars") or {}).items()})
        cwd = renv.get("working_dir") or os.getcwd()
        log = open(self._log_path(job_id), "wb")
        proc = subprocess.Popen(
            entrypoint, shell=True, cwd=cwd, env=env,
            stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True,  # survives this client; killable by pgid
        )
        log.close()
        self._procs[job_id] = proc
        self._write_meta(job_id, {
            "job_id": job_id,
            "entrypoint": entrypoint,
            "status": RUNNING,
            "pid": proc.pid,
            "start_time": time.time(),
            "end_time": None,
            "metadata": metadata or {},
            "address": self.address,
        })
        return job_id

    @staticmethod
    def _proc_start_time(pid: int) -> Optional[float]:
        """The epoch start time of ``pid`` from /proc (Linux), None when
        unreadable. Field 22 of /proc/<pid>/stat is jiffies-since-boot;
        boot time comes from /proc/stat btime."""
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                stat = f.read().decode("ascii", "replace")
            # the comm field may contain spaces/parens: split after the
            # LAST ')' so field indexing is immune to process names
            fields = stat[stat.rfind(")") + 2:].split()
            start_jiffies = int(fields[19])  # field 22 overall
            with open("/proc/stat", "rb") as f:
                for line in f:
                    if line.startswith(b"btime "):
                        btime = int(line.split()[1])
                        break
                else:
                    return None
            hz = os.sysconf("SC_CLK_TCK")
            return btime + start_jiffies / float(hz)
        except Exception:  # noqa: BLE001 — non-Linux / races
            return None

    def _pid_is_this_job(self, meta: Dict[str, Any]) -> bool:
        """Is the recorded pid still THIS job's driver? A SIGKILLed
        driver frees its pid, and the kernel may hand it to an unrelated
        process — kill(pid, 0) alone would then report the dead job
        RUNNING forever. Compare the live process's start time against
        the job's: a process born after the job was submitted is a pid
        reuse, not the driver."""
        pid = meta["pid"]
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            pass  # someone holds the pid; fall through to the birth check
        started = self._proc_start_time(pid)
        if started is None:
            return True  # can't verify: keep the conservative answer
        # 2s slack: btime/jiffies rounding vs time.time() at submit
        return started <= meta["start_time"] + 2.0

    def _refresh(self, job_id: str) -> Dict[str, Any]:
        meta = self._read_meta(job_id)
        if meta["status"] != RUNNING:
            # reap a terminal job's subprocess handle: without this the
            # Popen (and its zombie, if unwaited) lives for the client's
            # lifetime, and a recycled pid could alias a foreign process
            proc = self._procs.pop(job_id, None)
            if proc is not None:
                try:
                    proc.wait(timeout=0)
                except Exception:  # noqa: BLE001
                    pass
            return meta
        proc = self._procs.get(job_id)
        if proc is not None:
            code = proc.poll()
            if code is None:
                return meta
            meta["status"] = SUCCEEDED if code == 0 else FAILED
            meta["returncode"] = code
            self._procs.pop(job_id, None)  # reaped by poll()
        else:
            # job started by another client (or a restarted one): no
            # Popen handle, so liveness comes from the pid — guarded
            # against pid reuse by the birth-time check
            if self._pid_is_this_job(meta):
                return meta
            # SIGKILLed / crashed without a clean exit path: the meta
            # said RUNNING but nothing backs it — fail the job
            meta["status"] = FAILED
            meta.setdefault("returncode", None)
        meta["end_time"] = time.time()
        self._write_meta(job_id, meta)
        return meta

    def get_job_status(self, job_id: str) -> str:
        return self._refresh(job_id)["status"]

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        return self._refresh(job_id)

    def get_job_logs(self, job_id: str) -> str:
        try:
            with open(self._log_path(job_id), "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def list_jobs(self) -> List[Dict[str, Any]]:
        jobs = []
        for job_id in sorted(os.listdir(self.job_dir)):
            if os.path.exists(self._meta_path(job_id)):
                jobs.append(self._refresh(job_id))
        return jobs

    def stop_job(self, job_id: str) -> bool:
        meta = self._refresh(job_id)
        if meta["status"] != RUNNING:
            return False
        try:
            os.killpg(os.getpgid(meta["pid"]), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
        deadline = time.time() + 5
        while time.time() < deadline:
            if self._refresh(job_id)["status"] != RUNNING:
                break
            time.sleep(0.1)
        meta = self._refresh(job_id)
        if meta["status"] == RUNNING:
            try:
                os.killpg(os.getpgid(meta["pid"]), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            meta["status"] = STOPPED
            meta["end_time"] = time.time()
            self._write_meta(job_id, meta)
        elif meta["status"] in (FAILED, SUCCEEDED):
            # terminated by our signal: record the stop intent
            meta["status"] = STOPPED
            self._write_meta(job_id, meta)
        return True

    def delete_job(self, job_id: str) -> None:
        import shutil

        if self.get_job_status(job_id) == RUNNING:
            raise ValueError("stop the job before deleting it")
        shutil.rmtree(os.path.join(self.job_dir, job_id),
                      ignore_errors=True)

    def tail_job_logs(self, job_id: str, timeout_s: float = 30.0):
        """Generator yielding log chunks until the job finishes."""
        path = self._log_path(job_id)
        pos = 0
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            status = self.get_job_status(job_id)
            try:
                with open(path, "r", errors="replace") as f:
                    f.seek(pos)
                    chunk = f.read()
                    pos = f.tell()
            except FileNotFoundError:
                chunk = ""
            if chunk:
                yield chunk
            if status != RUNNING:
                return
            time.sleep(0.2)
