"""Checkpoint sync to cloud storage — the reference's ``tune/syncer.py``.

The reference syncs each trial's checkpoint directory to a cloud
``upload_dir`` (``Syncer``/``SyncConfig``, tune/syncer.py:99) so an
experiment survives the loss of the head node's disk. Here trial
checkpoints are opaque blobs (the Trainable save() contract), so the
syncer is blob-level: every checkpoint uploads through the same
URI-scheme registry the spill tier uses (core/external_storage.py —
s3:// and gs:// built in, ``register_storage_scheme`` for anything
else), under a deterministic key layout:

    <upload_dir>/<hex(experiment/trial/checkpoint)>    (checkpoint blob)
    <upload_dir>/<hex(experiment/trial/.meta)>         (latest-pointer)

The latest-pointer makes recovery independent of local state: a fresh
process (or another host) constructs ``Syncer(upload_dir)`` and calls
``download(trial_id)`` with no manifest on disk. Both built-in storage
backends return URLs of the form ``<base>/<hex(object_id)>``, which is
what makes the deterministic layout possible; a custom scheme's storage
just has to keep ``spill(oid, ...)`` / ``restore(oid, url)``
deterministic in ``oid`` the same way.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..core.external_storage import ExternalStorage, storage_for_uri


class Syncer:
    """Blob-level checkpoint sync for one experiment."""

    def __init__(self, upload_dir: str, experiment: str):
        self.upload_dir = upload_dir.rstrip("/")
        self.experiment = experiment
        self.storage: ExternalStorage = storage_for_uri(upload_dir)

    # -- key layout -----------------------------------------------------------
    def _oid(self, trial_id: str, what: str) -> bytes:
        return f"{self.experiment}/{trial_id}/{what}".encode()

    def _url_for(self, oid: bytes) -> str:
        return f"{self.upload_dir}/{oid.hex()}"

    # -- upload ---------------------------------------------------------------
    def upload(self, trial_id: str, blob: bytes,
               iteration: Optional[int] = None) -> str:
        """Upload one checkpoint blob and advance the trial's
        latest-pointer; returns the checkpoint URL."""
        oid = self._oid(trial_id, "checkpoint")
        url = self.storage.spill(oid, memoryview(blob))
        meta = {"url": url, "iteration": iteration,
                "size": len(blob)}
        self.storage.spill(self._oid(trial_id, ".meta"),
                           memoryview(json.dumps(meta).encode()))
        return url

    # -- download -------------------------------------------------------------
    def meta(self, trial_id: str) -> Optional[Dict]:
        oid = self._oid(trial_id, ".meta")
        try:
            raw = self.storage.restore(oid, self._url_for(oid))
        except Exception:  # noqa: BLE001 — nothing uploaded yet
            return None
        return json.loads(bytes(raw))

    def download(self, trial_id: str) -> Optional[bytes]:
        """The trial's latest checkpoint blob, or None if never synced.
        Needs no local state — a fresh process recovers from the
        deterministic key layout alone."""
        m = self.meta(trial_id)
        if m is None:
            return None
        oid = self._oid(trial_id, "checkpoint")
        try:
            return bytes(self.storage.restore(oid, m["url"]))
        except Exception:  # noqa: BLE001
            return None

    def delete(self, trial_id: str) -> None:
        for what in ("checkpoint", ".meta"):
            oid = self._oid(trial_id, what)
            try:
                self.storage.delete(self._url_for(oid))
            except Exception:  # noqa: BLE001
                pass

    def trials_synced(self, trial_ids: List[str]) -> List[str]:
        return [t for t in trial_ids if self.meta(t) is not None]
