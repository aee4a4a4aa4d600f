"""Checkpoint: a value-semantic handle convertible between dict / directory /
bytes / URI forms, plus the driver-side AsyncCheckpointManager.

Mirrors the reference's AIR Checkpoint (python/ray/air/checkpoint.py:42 —
from_dict:215/to_dict:239, from_directory:327/to_directory:432,
from_bytes:536/to_bytes:551, from_uri/to_uri). Counterpart of
``train/checkpoint.py`` in the JAX package: where it stores jax pytrees
with orbax, the port stores a tree of tensors with ``torch.save`` (CPU
tensors; DTensors are gathered with ``full_tensor()`` when the
checkpoint is made), inside the same atomic directory with the same CRC
manifest; plain picklable state rides cloudpickle.

Durability model (the preemption-tolerance contract):

- ``to_directory`` is ATOMIC: payload lands in a ``.tmp-*`` sibling, a
  MANIFEST.json with per-file CRC32s is written last, and the sibling is
  renamed into place. A crash mid-save leaves either the previous valid
  directory or a ``.tmp-*`` orphan — never a half-written directory that
  ``from_directory`` would happily load.
- ``to_uri``/``from_uri`` route every non-``file://`` scheme through the
  ``core.external_storage`` registry (CloudStorage for s3://gs://), so
  object-store IO code lives in exactly one place.
- :class:`AsyncCheckpointManager` drains durable writes on a background
  thread (training steps keep running), retains the last K checkpoints,
  verifies manifests on restore (falling back to the previous checkpoint
  on CRC mismatch), and mirrors to a cloud tier when configured.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import shutil
import tempfile
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

_PYTREE_KEY = "__rmt_pytree__"
_PICKLE_FILE = "checkpoint.pkl"
_TREE_DIR = "pytree"
_TREE_FILE = "tree.pt"
_MANIFEST = "MANIFEST.json"
_RANK_STATES_FILE = "rank_states.pkl"
_MANIFEST_FORMAT = 1


# -- manifest / atomicity helpers ---------------------------------------------
def _iter_files(root: str):
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            yield os.path.relpath(full, root), full


def write_manifest(path: str, **meta: Any) -> None:
    """Write MANIFEST.json over every file currently in ``path`` (CRC32 +
    size per file). Written LAST during a save: its presence certifies the
    payload, its checksums catch torn/corrupted files on restore."""
    files: Dict[str, Dict[str, int]] = {}
    for rel, full in _iter_files(path):
        if rel == _MANIFEST:
            continue
        crc = 0
        size = 0
        with open(full, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                size += len(chunk)
        files[rel] = {"crc32": crc & 0xFFFFFFFF, "size": size}
    doc = {"format": _MANIFEST_FORMAT, "files": files}
    doc.update(meta)
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, os.path.join(path, _MANIFEST))


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_checkpoint_dir(path: str) -> Tuple[bool, str]:
    """(ok, reason): the directory has a manifest and every listed file is
    present with a matching CRC32. A directory that fails is treated as
    LOSS — the caller falls back to an older checkpoint, never loads
    corrupt state."""
    doc = read_manifest(path)
    if doc is None:
        return False, "missing or unreadable MANIFEST.json"
    for rel, want in doc.get("files", {}).items():
        full = os.path.join(path, rel)
        try:
            crc = 0
            size = 0
            with open(full, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
                    size += len(chunk)
        except OSError:
            return False, f"missing file {rel}"
        if size != want.get("size") or (crc & 0xFFFFFFFF) != want.get("crc32"):
            return False, f"checksum mismatch on {rel}"
    return True, "ok"


def _replace_dir(tmp: str, final: str) -> None:
    """Swap a fully-written ``tmp`` directory into ``final``. When final
    does not exist this is one atomic rename; when it does, the old tree
    is moved aside first and removed only after the new one is in place —
    the old checkpoint is never destroyed before the new one is durable."""
    if not os.path.isdir(final):
        try:
            os.rename(tmp, final)
            return
        except OSError:
            pass  # lost a creation race; fall through to the swap path
    old = f"{final}.old-{uuid.uuid4().hex[:8]}"
    os.rename(final, old)
    try:
        os.rename(tmp, final)
    except OSError:
        os.rename(old, final)  # restore the previous valid directory
        raise
    shutil.rmtree(old, ignore_errors=True)


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None):
        self._data = data
        self._directory = directory

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=os.path.abspath(path))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        return cls(data=pickle.loads(blob))

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        """Load from file://, a bare path, or any scheme registered with
        ``core.external_storage`` (s3://, gs://, ...). Cloud checkpoints
        download into a temp directory and verify their manifest."""
        if uri.startswith("file://"):
            return cls.from_directory(uri[len("file://"):])
        if "://" not in uri:
            return cls.from_directory(uri)
        local = download_checkpoint_uri(uri)
        ok, why = verify_checkpoint_dir(local)
        if not ok:
            raise ValueError(f"checkpoint at {uri!r} failed verification: "
                             f"{why}")
        return cls.from_directory(local)

    # -- conversions ----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        assert self._directory is not None
        out: Dict[str, Any] = {}
        pkl = os.path.join(self._directory, _PICKLE_FILE)
        if os.path.exists(pkl):
            with open(pkl, "rb") as f:
                out.update(pickle.load(f))
        tree_path = os.path.join(self._directory, _TREE_DIR, _TREE_FILE)
        if os.path.exists(tree_path):
            import torch

            # restore as CPU tensors; consumers re-shard with parallel.
            # shard_pytree for their own mesh
            out[_PYTREE_KEY] = torch.load(tree_path, map_location="cpu",
                                          weights_only=True)
        return out

    def _materialize(self, path: str) -> None:
        """Write this checkpoint's payload into ``path`` (an existing
        private directory) — no manifest, no swap; the atomic wrapper is
        :meth:`to_directory`. The tensor tree's subdirectory is itself
        written to a ``.tmp`` sibling and swapped so even a payload-level
        overwrite never destroys an old tree before the new save
        succeeds."""
        if self._directory is not None:
            if os.path.abspath(path) != self._directory:
                shutil.copytree(self._directory, path, dirs_exist_ok=True)
            return
        data = dict(self._data or {})
        pytree = data.pop(_PYTREE_KEY, None)
        with open(os.path.join(path, _PICKLE_FILE), "wb") as f:
            import cloudpickle

            cloudpickle.dump(data, f)
        if pytree is not None:
            import torch

            target = os.path.join(path, _TREE_DIR)
            tmp = f"{target}.tmp-{uuid.uuid4().hex[:8]}"
            os.makedirs(tmp)
            try:
                torch.save(pytree, os.path.join(tmp, _TREE_FILE))
                _replace_dir(tmp, target)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize to a directory ATOMICALLY: payload + MANIFEST.json
        land in a ``.tmp-*`` sibling which is renamed into place, so a
        crash mid-save can never leave a half-written directory at
        ``path`` (the previous contents, if any, survive)."""
        if path is None:
            path = tempfile.mkdtemp(prefix="rmt_ckpt_")
            self._materialize(path)
            write_manifest(path)
            return path
        final = os.path.abspath(path)
        if self._directory is not None and final == self._directory:
            return final
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp)
        try:
            self._materialize(tmp)
            write_manifest(tmp)
            _replace_dir(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final

    def to_bytes(self) -> bytes:
        import cloudpickle

        return cloudpickle.dumps(self.to_dict())

    def to_uri(self, uri: str) -> str:
        """Persist to file://, a bare path, or any scheme registered with
        ``core.external_storage`` (s3://, gs://, ...) — cloud schemes ride
        the CloudStorage blob surface, one key per checkpoint file."""
        if uri.startswith("file://"):
            self.to_directory(uri[len("file://"):])
            return uri
        if "://" not in uri:
            self.to_directory(uri)
            return f"file://{uri}"
        local = self._directory
        if local is None or not os.path.exists(
                os.path.join(local, _MANIFEST)):
            local = self.to_directory()
        upload_checkpoint_dir(local, uri)
        return uri

    # -- pytree sugar ---------------------------------------------------------
    @classmethod
    def from_pytree(cls, pytree, extra: Optional[Dict[str, Any]] = None
                    ) -> "Checkpoint":
        """Checkpoint carrying a tree (nested dicts, lists, tuples) of
        tensors (params/opt state), saved with ``torch.save`` on
        to_directory(). Leaves are taken as CPU tensors: a DTensor is
        gathered with ``full_tensor()``, and a local ep or pp shard that
        ``parallel.shard_pytree`` cut (or the optimizer state that trains
        it) with ``parallel.sharding.gather_local_shard`` — collectives,
        so every rank of the mesh makes the checkpoint, and rank 0
        reports it — and numpy arrays become tensors."""
        data = dict(extra or {})
        data[_PYTREE_KEY] = _host_tree(pytree)
        return cls(data=data)

    def get_pytree(self):
        """The tree of :meth:`from_pytree`, as CPU tensors."""
        return self.to_dict().get(_PYTREE_KEY)

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._directory}"
        return f"Checkpoint({kind})"


def _host_tree(node):
    """``node`` with every tensor leaf a CPU tensor (DTensors and local
    shards gathered, numpy arrays converted); other leaves as they
    are."""
    import numpy as np
    import torch

    from ..parallel.sharding import gather_local_shard

    if isinstance(node, dict):
        return {k: _host_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_host_tree(v) for v in node)
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node))
    if isinstance(node, torch.Tensor):
        full = getattr(node, "full_tensor", None)  # a DTensor
        t = full() if full is not None else gather_local_shard(node)
        return t.detach().cpu().clone()
    return node


# -- uri transport (CloudStorage-backed) --------------------------------------
def _storage_for(uri: str):
    from ..core.external_storage import storage_for_uri

    return storage_for_uri(uri)


def upload_checkpoint_dir(local: str, uri: str) -> None:
    """Mirror a checkpoint directory to ``uri`` through the external-
    storage registry. The manifest uploads LAST — a reader that sees it
    can trust every other key is already there."""
    storage = _storage_for(uri)
    base = uri.rstrip("/")
    manifest_rel = None
    for rel, full in _iter_files(local):
        if rel == _MANIFEST:
            manifest_rel = (rel, full)
            continue
        with open(full, "rb") as f:
            storage.put_blob(f"{base}/{rel}", f.read())
    if manifest_rel is not None:
        rel, full = manifest_rel
        with open(full, "rb") as f:
            storage.put_blob(f"{base}/{rel}", f.read())


def download_checkpoint_uri(uri: str, dest: Optional[str] = None) -> str:
    """Fetch every blob under ``uri`` into a local directory."""
    storage = _storage_for(uri)
    base = uri.rstrip("/")
    urls = storage.list_blobs(base)
    if not urls:
        raise FileNotFoundError(f"no checkpoint found at {uri!r}")
    dest = dest or tempfile.mkdtemp(prefix="rmt_ckpt_dl_")
    for url in urls:
        rel = url[len(base):].lstrip("/")
        full = os.path.join(dest, rel)
        os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
        with open(full, "wb") as f:
            f.write(storage.get_blob(url))
    return dest


def delete_checkpoint_uri(uri: str) -> None:
    storage = _storage_for(uri)
    storage.delete_prefix(uri.rstrip("/"))


# -- the async checkpoint manager ---------------------------------------------
class AsyncCheckpointManager:
    """Driver-side durable checkpoint writer for a training run.

    ``save()`` is the step-blocking slice: it snapshots the (already
    host-resident) per-rank shard bytes and enqueues them; a background
    writer thread does the durable work — atomic directory write with
    CRC32 manifest, optional mirror to a CloudStorage uri, retention GC,
    and the ``on_durable`` callback (the trainer records run state in the
    GCS kv there). Training steps keep running while the save drains.

    ``mode``:
      - "async": background writer (default);
      - "sync":  ``save()`` blocks until the checkpoint is durable — the
        baseline the bench compares against.

    Restore (:meth:`latest`) verifies manifests newest-first and falls
    back to the previous checkpoint on mismatch: a torn or corrupted
    newest checkpoint costs one extra interval of progress, never a
    poisoned resume.
    """

    def __init__(self, run_dir: str, *, retain_k: int = 3,
                 mode: str = "async", storage_uri: Optional[str] = None,
                 on_durable: Optional[Callable[[Dict[str, Any]], None]]
                 = None):
        if mode not in ("async", "sync"):
            raise ValueError(f"unknown checkpoint mode {mode!r}")
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.retain_k = max(1, int(retain_k))
        self.mode = mode
        self.storage_uri = storage_uri.rstrip("/") if storage_uri else None
        self.on_durable = on_durable
        self.last_error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._index = self._next_index()

    # -- directory scan -------------------------------------------------------
    def _dirs(self) -> List[str]:
        """checkpoint_* directories, oldest first."""
        try:
            names = sorted(
                n for n in os.listdir(self.run_dir)
                if n.startswith("checkpoint_") and ".tmp" not in n
                and ".old" not in n
                and os.path.isdir(os.path.join(self.run_dir, n)))
        except OSError:
            return []
        return [os.path.join(self.run_dir, n) for n in names]

    def _next_index(self) -> int:
        idx = 0
        for d in self._dirs():
            try:
                idx = max(idx, int(os.path.basename(d).split("_")[1]) + 1)
            except (IndexError, ValueError):
                continue
        return idx

    # -- save path ------------------------------------------------------------
    def save(self, shards: Dict[int, bytes], step: int) -> float:
        """Submit one checkpoint (per-rank shard bytes, rank 0 = model
        state) for durable write; returns the step-blocking seconds."""
        from ..core import metrics_defs as mdefs

        t0 = time.perf_counter()
        item = (dict(shards), int(step))
        if self.mode == "sync":
            try:
                self._write(*item)
            except BaseException as e:  # noqa: BLE001 - surfaced via state
                self._record_failure(e)
        else:
            self._ensure_thread()
            self._q.put(item)
        dt = time.perf_counter() - t0
        try:
            mdefs.train_checkpoint_save_seconds().observe(
                dt, tags={"phase": "blocking"})
        except Exception:  # noqa: BLE001
            pass
        return dt

    def _ensure_thread(self) -> None:
        with self._mu:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="rmt-ckpt-writer")
                self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                # coalesce: if the trainer outran the writer, only the
                # NEWEST pending checkpoint matters (latest-wins); older
                # pending saves would be GC'd by retention immediately
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._q.put(None)
                        break
                    self._q.task_done()
                    item = nxt
                try:
                    self._write(*item)
                except BaseException as e:  # noqa: BLE001
                    self._record_failure(e)
            finally:
                self._q.task_done()

    def drain(self, timeout_s: float = 120.0) -> bool:
        """Block until every enqueued save is durable (or timeout)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.unfinished_tasks == 0:  # noqa: SLF001 - stdlib attr
                return True
            time.sleep(0.02)
        return False

    def close(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self.drain()
            self._q.put(None)
            self._thread.join(timeout=10.0)

    def _record_failure(self, e: BaseException) -> None:
        from ..core import metrics_defs as mdefs

        self.last_error = e
        try:
            mdefs.train_checkpoint_saves().inc(tags={"result": "error"})
        except Exception:  # noqa: BLE001
            pass
        try:
            from ..utils import events

            events.emit("CHECKPOINT_SAVE_FAILED",
                        f"checkpoint save failed: {e!r}",
                        severity=events.ERROR, source="train")
        except Exception:  # noqa: BLE001
            pass

    def _write(self, shards: Dict[int, bytes], step: int) -> None:
        from ..core import metrics_defs as mdefs
        from ..utils import faults

        t0 = time.perf_counter()
        act = faults.fire("checkpoint.save")
        if act is not None:
            if act.mode == "stall":
                act.sleep()
            elif act.mode in ("error", "drop"):
                act.raise_()
        with self._mu:
            idx = self._index
            self._index += 1
        name = f"checkpoint_{idx:06d}"
        final = os.path.join(self.run_dir, name)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp)
        try:
            rank0 = shards.get(0)
            if rank0 is not None:
                Checkpoint.from_bytes(rank0)._materialize(tmp)
            others = {r: b for r, b in shards.items() if r != 0}
            if others:
                with open(os.path.join(tmp, _RANK_STATES_FILE), "wb") as f:
                    pickle.dump(others, f)
            write_manifest(tmp, step=step, world_size=len(shards))
            if act is not None and act.mode == "corrupt":
                # flip one byte in the payload AFTER the manifest was
                # computed — only restore-time CRC verification can catch
                # this (the disk-corruption physics of spill.write)
                self._corrupt_one_file(tmp)
            _replace_dir(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        uri = None
        if self.storage_uri is not None:
            uri = f"{self.storage_uri}/{name}"
            upload_checkpoint_dir(final, uri)
        self._gc()
        dt = time.perf_counter() - t0
        try:
            mdefs.train_checkpoint_saves().inc(tags={"result": "ok"})
            mdefs.train_checkpoint_save_seconds().observe(
                dt, tags={"phase": "drain"})
        except Exception:  # noqa: BLE001
            pass
        if self.on_durable is not None:
            try:
                self.on_durable({"step": step, "index": idx,
                                 "path": final, "uri": uri,
                                 "world_size": len(shards)})
            except Exception:  # noqa: BLE001 - bookkeeping never fails a save
                pass

    @staticmethod
    def _corrupt_one_file(path: str) -> None:
        for rel, full in sorted(_iter_files(path)):
            if rel == _MANIFEST:
                continue
            with open(full, "r+b") as f:
                b = f.read(1)
                if not b:
                    continue
                f.seek(0)
                f.write(bytes([b[0] ^ 0xFF]))
            return

    def _gc(self) -> None:
        """Retain the newest ``retain_k`` checkpoints; older ones (and
        their cloud mirrors) are removed."""
        dirs = self._dirs()
        for d in dirs[:-self.retain_k]:
            shutil.rmtree(d, ignore_errors=True)
            if self.storage_uri is not None:
                try:
                    delete_checkpoint_uri(
                        f"{self.storage_uri}/{os.path.basename(d)}")
                except Exception:  # noqa: BLE001 - best-effort GC
                    pass

    # -- restore path ---------------------------------------------------------
    def latest(self) -> Optional[Dict[str, Any]]:
        """Newest VERIFIED checkpoint as ``{step, checkpoint, rank_states,
        path}`` — scans newest-first and falls back past any directory
        whose manifest is missing or whose CRCs mismatch."""
        from ..core import metrics_defs as mdefs
        from ..utils import faults

        dirs = self._dirs()
        fell_back = False
        for d in reversed(dirs):
            act = faults.fire("checkpoint.restore")
            corrupted_by_fault = False
            if act is not None:
                if act.mode == "stall":
                    act.sleep()
                elif act.mode in ("error", "drop"):
                    fell_back = True
                    continue  # injected read failure: this dir unusable
                elif act.mode == "corrupt":
                    corrupted_by_fault = True
            ok, why = verify_checkpoint_dir(d)
            if corrupted_by_fault:
                ok, why = False, "injected corruption"
            if not ok:
                fell_back = True
                try:
                    from ..utils import events

                    events.emit(
                        "CHECKPOINT_CORRUPT",
                        f"checkpoint {os.path.basename(d)} failed "
                        f"verification ({why}); falling back",
                        severity=events.WARNING, source="train")
                except Exception:  # noqa: BLE001
                    pass
                continue
            doc = read_manifest(d) or {}
            rank_states: Dict[int, bytes] = {}
            rs_path = os.path.join(d, _RANK_STATES_FILE)
            if os.path.exists(rs_path):
                with open(rs_path, "rb") as f:
                    rank_states = pickle.load(f)
            try:
                mdefs.train_checkpoint_restores().inc(
                    tags={"source": "fallback" if fell_back else "latest"})
            except Exception:  # noqa: BLE001
                pass
            return {"step": doc.get("step"),
                    "checkpoint": Checkpoint.from_directory(d),
                    "rank_states": rank_states, "path": d}
        return None
