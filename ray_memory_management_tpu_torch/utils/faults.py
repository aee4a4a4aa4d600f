"""Deterministic fault-injection plane: seeded, config-gated, replayable.

``utils/chaos.py`` kills whole nodes — the crash-failure story. But at
TPU-pod scale the faults that dominate operation are PARTIAL: a transfer
stream that stalls, a connection that dies mid-stripe, a flaky spill
volume, bit corruption on the wire ("Exploring the limits of Concurrency
in ML Training on Google TPUs", arxiv 2011.03641). This module gives the
runtime a registry of named injection points wired through the data and
control planes::

    transfer.send      TransferServer request serving (drop/stall/error/corrupt/
                       corrupt-compressed: flip a byte INSIDE a compressed
                       frame after its CRC is stamped — proves the
                       frame checksum catches wire bit flips before the
                       decoder runs; a no-op on uncompressed replies)
    transfer.recv      client-side payload receive   (stall/error/corrupt/drop)
    transfer.dial      connect + handshake           (error/stall/drop)
    spill.write        external-storage spill        (error/stall/corrupt/drop)
    spill.read         external-storage restore      (error/stall/corrupt/drop)
    control.dispatch   head -> node task dispatch    (error/stall/drop)
    worker.exec        worker-side task execution    (error/stall/drop)
    checkpoint.save    train checkpoint durable write (error/stall/corrupt/drop)
    checkpoint.restore train checkpoint load/verify   (error/stall/corrupt/drop)
    device.materialize device<->host object movement  (error/stall/drop):
                       on-demand device→host materialization for remote
                       readers and host→device re-promotion on a device
                       read of a demoted object
    device.evict       capacity-driven HBM→host demotion (error/stall/drop):
                       an injected error defers the eviction — the object
                       stays device-resident and readable (pressure causes
                       slowness, never loss)
    serve.admit        serve-engine slot admission     (error/stall/drop):
                       an injected error fails ONLY the request being
                       admitted (the engine keeps serving); stall delays
                       the admission, exercising queue backpressure
    replica.exec       serve replica request execution (error/stall/drop):
                       error/drop raise out of handle_request (the
                       caller's ref resolves to the failure); stall
                       inflates service time, exercising shed paths
    job.detach         client-disconnect notification  (error/stall/drop):
                       drop/error loses the disconnect notice at the
                       cluster server — the job's reclaim never runs on
                       the connection path and the ORPHANED job must be
                       found and swept by the job watchdog instead
    job.sweep          job-death sweep step            (error/stall/drop):
                       an injected error aborts one sweep step (mark /
                       cancel-tasks / kill-actors / free-objects); the
                       sweep reschedules itself via the heartbeat loop —
                       sweeps are idempotent, so the retry releases
                       whatever the failed attempt left behind
    directory.spill    cold directory-batch write      (error/stall/drop):
                       a failed spill degrades to RAM-resident — the
                       batch's rows stay hot (counted, backed off) and
                       are NEVER lost; stall delays the write under the
                       shard lock, exercising hot-path latency
    directory.fault    cold directory-batch read       (error/stall/drop):
                       a failed fault-in is a MISS, not a loss — the
                       blob and the cold index stay intact, the locate
                       simply omits the row until a retry succeeds

Each site × mode carries a probability, an optional activation offset
(``after``: skip the first N hits) and budget (``max``: stop after N
injections), drawn from a per-site RNG derived from ONE plane seed — the
k-th decision at a site is a pure function of (seed, site, k), so a
chaos run is replayable bit-for-bit from its seed regardless of thread
interleavings elsewhere. (This copy, in the PyTorch port, leaves out the
metrics and cluster-event hooks the JAX package fires on each injection:
the port has no metrics or event plane yet. :meth:`FaultPlane.counters`
still reports every injection.)

Spec grammar (config flag ``fault_injection_spec`` / env
``RMT_fault_injection_spec``; ``;``-separated sites)::

    site:mode[:p=P][:after=N][:max=N][:stall=S]

    "transfer.recv:corrupt:p=0.5;spill.write:error:max=2"
    "worker.exec:error:p=1.0:max=2"        # first two executions fail
    "transfer.send:stall:stall=5:after=1"  # serve #2+ stalls 5s

Call sites use :func:`fire`: it returns ``None`` (the overwhelmingly
common case — one module-global check when the plane is off) or a
:class:`FaultAction` whose ``mode`` the site maps to its own physics
(drop the connection, sleep, raise, flip a byte via
:func:`corrupt_bytes`).
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional

MODES = ("drop", "stall", "error", "corrupt", "corrupt-compressed")

SITES = (
    "transfer.send", "transfer.recv", "transfer.dial",
    "spill.write", "spill.read", "control.dispatch", "worker.exec",
    "checkpoint.save", "checkpoint.restore",
    "device.materialize", "device.evict",
    "serve.admit", "replica.exec",
    "job.detach", "job.sweep",
    "directory.spill", "directory.fault",
)


class FaultInjected(Exception):
    """The error raised by sites whose 'error'/'drop' physics is an
    exception. The message always contains the site so logs and events
    attribute the failure to the injector, not the component."""


class FaultAction:
    """One injection decision handed back to a call site."""

    __slots__ = ("site", "mode", "stall_s", "seq")

    def __init__(self, site: str, mode: str, stall_s: float, seq: int):
        self.site = site
        self.mode = mode
        self.stall_s = stall_s
        self.seq = seq  # per-site injection ordinal (replay debugging)

    def sleep(self) -> None:
        """The stall physics shared by most sites."""
        time.sleep(self.stall_s)

    def raise_(self) -> None:
        raise FaultInjected(
            f"injected {self.mode} at {self.site} (#{self.seq})")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"FaultAction({self.site}:{self.mode} #{self.seq})"


class FaultSite:
    """One (site, mode) injection rule with its own deterministic RNG."""

    def __init__(self, site: str, mode: str, p: float = 1.0,
                 after: int = 0, max_injections: Optional[int] = None,
                 stall_s: float = 2.0, seed: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (want {MODES})")
        self.site = site
        self.mode = mode
        self.p = float(p)
        self.after = int(after)
        self.max_injections = max_injections
        self.stall_s = float(stall_s)
        # per-site stream derived from the ONE plane seed: decision k at
        # this site is a pure function of (seed, site, mode, k) — thread
        # interleavings across sites cannot perturb the schedule
        self._rng = random.Random(
            zlib.crc32(f"{seed}:{site}:{mode}".encode()))
        self.hits = 0       # times the site was reached
        self.injected = 0   # times a fault actually fired

    def decide(self) -> Optional[FaultAction]:
        k = self.hits
        self.hits += 1
        draw = self._rng.random()  # always consume: hit k -> draw k
        if k < self.after:
            return None
        if self.max_injections is not None and \
                self.injected >= self.max_injections:
            return None
        if draw >= self.p:
            return None
        self.injected += 1
        return FaultAction(self.site, self.mode, self.stall_s,
                           self.injected)


class FaultPlane:
    """The per-process registry of active injection rules."""

    def __init__(self, seed: int = 0, spec: str = ""):
        self.seed = int(seed)
        self._mu = threading.Lock()
        self._sites: Dict[str, List[FaultSite]] = {}
        if spec:
            for rule in parse_spec(spec, seed=self.seed):
                self.add(rule)

    def add(self, rule: FaultSite) -> "FaultPlane":
        with self._mu:
            self._sites.setdefault(rule.site, []).append(rule)
        return self

    def fire(self, site: str) -> Optional[FaultAction]:
        rules = self._sites.get(site)
        if not rules:
            return None
        with self._mu:
            act = None
            for rule in rules:
                act = rule.decide()
                if act is not None:
                    break
        return act

    def counters(self) -> Dict[str, int]:
        """{f"{site}:{mode}": injected} — the replay fingerprint."""
        with self._mu:
            return {f"{r.site}:{r.mode}": r.injected
                    for rules in self._sites.values() for r in rules}

    def schedule(self, site: str, mode: str, n: int,
                 p: float = 0.5) -> List[bool]:
        """The would-be decisions for the first ``n`` hits of a FRESH
        (site, mode) rule with probability ``p`` under this plane's seed
        — the replayability probe used by tests; does not consume the
        live rules' state."""
        probe = FaultSite(site, mode, p=p, seed=self.seed)
        return [probe.decide() is not None for _ in range(n)]


def parse_spec(spec: str, seed: int = 0) -> List[FaultSite]:
    """Parse the ``site:mode[:k=v]...`` grammar; raises ValueError on a
    malformed rule (a chaos config typo must fail loudly at configure
    time, not silently inject nothing)."""
    rules: List[FaultSite] = []
    for part in spec.replace(",", ";").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"fault rule {part!r}: want site:mode[...]")
        site, mode = fields[0].strip(), fields[1].strip()
        kwargs: Dict[str, float] = {}
        for kv in fields[2:]:
            if "=" not in kv:
                raise ValueError(
                    f"fault rule {part!r}: parameter {kv!r} is not k=v")
            k, v = kv.split("=", 1)
            k = k.strip()
            if k == "p":
                kwargs["p"] = float(v)
            elif k == "after":
                kwargs["after"] = int(v)
            elif k == "max":
                kwargs["max_injections"] = int(v)
            elif k == "stall":
                kwargs["stall_s"] = float(v)
            else:
                raise ValueError(f"fault rule {part!r}: unknown key {k!r}")
        rules.append(FaultSite(site, mode, seed=seed, **kwargs))
    return rules


def corrupt_bytes(data, offset: int = 0) -> bytes:
    """A copy of ``data`` with one bit-flipped byte — the minimal wire/
    disk corruption a checksum must catch. Never mutates the input (the
    input is usually a view of the REAL object)."""
    b = bytearray(data)
    if b:
        i = offset % len(b)
        b[i] ^= 0xFF
    return bytes(b)


# ---------------------------------------------------------------- process API
_mu = threading.Lock()
_plane: Optional[FaultPlane] = None
_env_checked = False
_from_config = False  # plane installed by configure_from (vs configure())
_exported = False     # configure_from wrote the RMT_ env vars


def configure(spec: str = "", seed: int = 0) -> FaultPlane:
    """Install the process fault plane programmatically (tests / the
    runtime's configure_from). An empty spec installs an empty plane —
    still addressable via ``plane().add(...)``."""
    global _plane, _env_checked
    with _mu:
        _plane = FaultPlane(seed=seed, spec=spec)
        _env_checked = True
        return _plane


def configure_from(config) -> Optional[FaultPlane]:
    """Pick the plane up from a Config (head init, agent hello): a no-op
    when the config carries no spec AND nothing was configured yet, so a
    programmatically-installed plane survives a later runtime init.
    Exports the spec/seed to this process's environment so every child
    it spawns (agents, the worker zygote, workers) runs the SAME
    schedule — replayable chaos across the whole process tree."""
    global _from_config, _exported
    spec = getattr(config, "fault_injection_spec", "") or ""
    if not spec:
        return _plane
    seed = getattr(config, "fault_injection_seed", 0)
    os.environ["RMT_fault_injection_spec"] = spec
    os.environ["RMT_fault_injection_seed"] = str(seed)
    _exported = True
    p = configure(spec, seed=seed)
    _from_config = True
    return p


def deconfigure() -> None:
    """Tear down a config-installed plane at cluster shutdown: pop the
    env exports so a LATER cluster in this process (or any child it
    spawns) doesn't silently inherit the previous cluster's chaos. A
    plane installed programmatically via :func:`configure` is left in
    place — its owner tears it down with :func:`reset`."""
    global _plane, _env_checked, _from_config, _exported
    with _mu:
        if _exported:
            os.environ.pop("RMT_fault_injection_spec", None)
            os.environ.pop("RMT_fault_injection_seed", None)
            _exported = False
        if _from_config:
            _plane = None
            _from_config = False
        _env_checked = False


def reset() -> None:
    """Drop the plane (and the env memo) — test teardown."""
    global _plane, _env_checked, _from_config, _exported
    with _mu:
        _plane = None
        _env_checked = False
        _from_config = False
        _exported = False


def plane() -> Optional[FaultPlane]:
    return _plane


def is_active() -> bool:
    return _plane is not None and bool(_plane._sites)


def fire(site: str) -> Optional[FaultAction]:
    """The one call every instrumented site makes. Near-zero cost while
    the plane is off: one global read + one bool check (the env spec is
    consulted once per process, then memoized)."""
    global _plane, _env_checked
    p = _plane
    if p is None:
        if _env_checked:
            return None
        with _mu:
            if not _env_checked:
                _env_checked = True
                spec = os.environ.get("RMT_fault_injection_spec", "")
                if spec:
                    seed = int(
                        os.environ.get("RMT_fault_injection_seed", "0")
                        or 0)
                    _plane = FaultPlane(seed=seed, spec=spec)
            p = _plane
        if p is None:
            return None
    return p.fire(site)

