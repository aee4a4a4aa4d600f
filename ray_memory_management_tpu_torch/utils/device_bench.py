"""Device-tier bench: zero-copy handoff, demotion, and ICI-vs-host.

Measures what the device object tier (CUDA memory) is for — the
serialization that never happens. Four stanzas:

  - zero-copy handoff: ``put(tensor, device=True)`` + ``get`` round trip
    of one payload vs the same payload through the shm store (serialize
    + shm write + read + deserialize). The acceptance bar is >=10x at
    64 MB, and the store's ``bytes_avoided`` counter must move — the
    proof the read skipped the copy rather than hiding it.
  - demotion: a put past the tier budget forces the LRU resident down
    to shm; the measured put time IS the demotion cost (serialize +
    host-store write), reported as GB/s of demoted payload.
  - ICI vs host path: moving a device tensor to a device of the same
    process (``transfer.ici_move`` — a device-to-device copy, a no-op
    when src == dst, as it is with one card) vs the host wire path
    (serialize + deserialize), the route ``_device_route`` falls back to
    when the devices are not the process's own. The keys keep the
    reference's ``ici_`` names.
  - eviction-pressure sweep: fixed budget, rising payload sizes; shows
    eviction count and aggregate put throughput as pressure grows.

Runs on the card unless the caller passes ``device="cpu"`` (CPU tensors
in CI — the tier logic is identical; the card only changes the
constants). Without a card and without ``device="cpu"`` it raises.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

MB = 1 << 20

DEVICE_DEFAULTS = dict(payload_mb=64, trials=3, sweep_mb=(4, 8, 16))


def _counter(acc: str) -> float:
    from ..core import metrics_defs as mdefs

    return sum(getattr(mdefs, acc)().series().values())


def run_device_suite(payload_mb: int = 64, trials: int = 3,
                     sweep_mb=(4, 8, 16), device=None) -> Dict:
    import numpy as np
    import torch

    from .. import api as rmt
    from .. import serialization as ser
    from ..api import _backend
    from ..config import Config
    from ..core import transfer as xfer
    from .device import resolve_device

    dev = resolve_device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    def on_device(a):
        t = torch.from_numpy(a).to(dev)
        sync()
        return t

    nbytes = payload_mb * MB
    np_payload = np.random.rand(nbytes // 4).astype(np.float32)

    # ---- zero-copy handoff vs shm round trip -----------------------------
    rmt.init(num_cpus=2)
    try:
        rt = _backend()
        arr = on_device(np_payload)
        avoided0 = rt.device_store.bytes_avoided()
        dt_zero = float("inf")
        dt_shm = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            ref = rmt.put(arr, device=True)
            got = rmt.get(ref)
            dt_zero = min(dt_zero, time.perf_counter() - t0)
            assert got is arr  # the whole point
            del ref, got
            gc.collect()

            t0 = time.perf_counter()
            ref = rmt.put(np_payload)
            got = rmt.get(ref)
            dt_shm = min(dt_shm, time.perf_counter() - t0)
            del ref, got
            gc.collect()
        bytes_avoided = rt.device_store.bytes_avoided() - avoided0

        # ---- ICI move vs host wire path ----------------------------------
        ici0 = _counter("device_ici_transfers")
        dst = dev
        dt_ici = float("inf")
        dt_host = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            xfer.ici_move(arr, dst)
            sync()
            dt_ici = min(dt_ici, time.perf_counter() - t0)

            t0 = time.perf_counter()
            data = ser.serialize(np_payload)
            ser.loads(data.to_bytes())
            dt_host = min(dt_host, time.perf_counter() - t0)
        ici_transfers = _counter("device_ici_transfers") - ici0
    finally:
        rmt.shutdown()

    # ---- demotion throughput ---------------------------------------------
    # budget fits ONE payload: the second put demotes the first; that
    # put's wall time is the demotion cost (serialize + host-store write)
    evict0 = _counter("device_evictions")
    rmt.init(num_cpus=2, _config=Config(
        device_store_capacity_bytes=nbytes + MB))
    try:
        a = on_device(np_payload)
        b = a + 1.0
        sync()
        # refs stay live: a dropped ref frees the object (router nudge)
        # and releases the very pressure being measured
        ra = rmt.put(a, device=True)
        t0 = time.perf_counter()
        rb = rmt.put(b, device=True)
        dt_demote = time.perf_counter() - t0
        del ra, rb
    finally:
        rmt.shutdown()
    demote_evictions = _counter("device_evictions") - evict0

    # ---- eviction-pressure sweep ------------------------------------------
    sweep = []
    for m in sweep_mb:
        cap = 2 * m * MB
        e0 = _counter("device_evictions")
        rmt.init(num_cpus=2, _config=Config(device_store_capacity_bytes=cap))
        try:
            rt = _backend()
            n_puts = 6
            refs = []  # held: dropped refs free and cancel the pressure
            t0 = time.perf_counter()
            for i in range(n_puts):
                refs.append(rmt.put(on_device(
                    np.full((m * MB) // 4, i, dtype=np.float32)),
                    device=True))
            dt = time.perf_counter() - t0
            resident = rt.device_store.count()
            del refs
        finally:
            rmt.shutdown()
        sweep.append({
            "payload_mb": m,
            "capacity_mb": cap // MB,
            "puts": n_puts,
            "evictions": round(_counter("device_evictions") - e0),
            "resident_at_end": resident,
            "put_gbps": round(n_puts * m * MB / max(dt, 1e-9) / 1e9, 2),
        })

    return {
        "payload_mb": payload_mb,
        "trials": trials,
        "zero_copy_gbps": round(nbytes / max(dt_zero, 1e-9) / 1e9, 2),
        "shm_roundtrip_gbps": round(nbytes / max(dt_shm, 1e-9) / 1e9, 2),
        "zero_copy_speedup": round(dt_shm / max(dt_zero, 1e-9), 1),
        "bytes_avoided_mb": round(bytes_avoided / MB, 1),
        "demotion_gbps": round(nbytes / max(dt_demote, 1e-9) / 1e9, 2),
        "demotion_evictions": round(demote_evictions),
        "ici_gbps": round(nbytes / max(dt_ici, 1e-9) / 1e9, 2),
        "host_path_gbps": round(nbytes / max(dt_host, 1e-9) / 1e9, 2),
        "ici_vs_host_speedup": round(dt_host / max(dt_ici, 1e-9), 1),
        "ici_transfers": round(ici_transfers),
        "eviction_sweep": sweep,
    }
