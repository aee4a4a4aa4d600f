"""Transfer-plane microbenchmarks: the three v2 wire-protocol wins.

Runs at the transfer layer itself — local NodeObjectStores wired through
real TransferServers over loopback TCP — so the numbers isolate the p2p
plane (handshake, striping, request loop) from scheduler/worker noise:

  * **small pulls**: p50 latency of a 1 KiB pull with a warm connection
    pool (handshake amortized) vs a fresh dial + HMAC challenge per pull
    — the v1 economics, where the handshake dominated metadata-sized
    payloads.
  * **striped vs single-stream**: one large object pulled as parallel
    range requests vs one connection.
  * **multi-destination chain vs naive**: n destinations pulling the same
    object off one source (naive: source serves every copy, O(n·size)
    egress) vs a chain where each destination serves the next (per-source
    egress stays O(size) regardless of n — the distribution-tree shape
    runtime.py's broadcast gate produces).

:func:`run_compression_bench` adds the compressed-movement-plane curve:
ratio / raw / effective GB/s per corpus (zeros, tiled text, sparse
gradient pages, random bytes), the compressed broadcast chain, the
incompressible-payload overhead vs the raw path, and the quantized
allreduce accuracy-vs-wire-bytes table per precision.

The output keys are those the JAX package's ``bench.py`` names in its
``REQUIRED_TRANSFER_FIELDS`` and ``REQUIRED_COMPRESSION_FIELDS``; the
codecs offered are whatever ``core.codec.available_codecs()`` finds (zlib
always, lz4 only where it is installed).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict


def run_transfer_microbench(small_pulls: int = 1000,
                            payload_mb: int = 256,
                            n_dests: int = 4) -> Dict[str, object]:
    import os

    from ..config import Config
    from ..core.object_store import NodeObjectStore
    from ..core.transfer import (
        ConnectionPool, TransferServer, fetch_object,
    )

    capacity = max(64 << 20, (payload_mb << 20) * 2)
    cfg = Config(object_store_memory=capacity)
    chunk = cfg.object_manager_chunk_size
    key = os.urandom(16)
    tag = os.urandom(3).hex()
    out: Dict[str, object] = {
        "small_pulls": small_pulls,
        "payload_mb": payload_mb,
        "n_dests": n_dests,
    }

    src = NodeObjectStore(f"/rmtb_src_{tag}", cfg)
    dst = NodeObjectStore(f"/rmtb_dst_{tag}", cfg)
    srv = TransferServer(src, key, chunk,
                         max_conns=cfg.transfer_max_conns,
                         idle_timeout=cfg.transfer_idle_timeout_s)
    pool = ConnectionPool(max_idle_per_peer=cfg.transfer_pool_size)
    try:
        # -- small-object pull latency: warm pool vs per-pull handshake ------
        oid = b"s" * 32
        src.put_bytes(oid, os.urandom(1024))

        def timed_pulls(n: int, p) -> list:
            lat = []
            for _ in range(n):
                t0 = time.perf_counter()
                err = fetch_object("127.0.0.1", srv.port, key, oid, dst,
                                   chunk, pool=p)
                lat.append((time.perf_counter() - t0) * 1e6)
                assert err is None, err
                dst.delete(oid)
            return lat

        timed_pulls(5, pool)  # warm the pool + fault both stores' pages
        pooled = timed_pulls(small_pulls, pool)
        fresh = timed_pulls(small_pulls, None)
        out["small_pull_p50_us_pooled"] = round(statistics.median(pooled), 1)
        out["small_pull_p50_us_fresh"] = round(statistics.median(fresh), 1)
        out["pool_speedup"] = round(
            out["small_pull_p50_us_fresh"]
            / max(out["small_pull_p50_us_pooled"], 1e-9), 2)
        out["pool_hit_rate"] = round(
            pool.hits / max(pool.hits + pool.misses, 1), 4)
        src.delete(oid)

        # -- striped vs single-stream large pull ------------------------------
        big = b"b" * 32
        src.put_bytes(big, os.urandom(payload_mb << 20))
        gb = payload_mb / 1024
        stripes0 = srv.requests_served

        def one_pull(threshold: int) -> float:
            t0 = time.perf_counter()
            err = fetch_object("127.0.0.1", srv.port, key, big, dst, chunk,
                               pool=pool, stripe_threshold=threshold,
                               stripe_count=cfg.transfer_stripe_count)
            dt = time.perf_counter() - t0
            assert err is None, err
            dst.delete(big)
            return gb / dt

        one_pull(1 << 40)  # warmup: fault dst pages once, untimed
        out["single_stream_gbps"] = round(one_pull(1 << 40), 3)
        out["striped_gbps"] = round(one_pull(cfg.transfer_stripe_threshold),
                                    3)
        # stripe requests counted server-side (includes the deferred
        # size-only request): > stripe_count proves the parallel path ran
        out["stripe_requests"] = srv.requests_served - stripes0
        src.delete(big)
    finally:
        pool.close()
        srv.close()
        dst.close(unlink=True)

    # -- multi-destination distribution: chain vs naive -----------------------
    payload = os.urandom(min(payload_mb, 64) << 20)
    oid = b"m" * 32
    src.put_bytes(oid, payload)
    stores = [src]
    servers = [TransferServer(src, key, chunk)]
    pools = []
    try:
        for i in range(n_dests):
            st = NodeObjectStore(f"/rmtb_d{i}_{tag}", cfg)
            stores.append(st)
            servers.append(TransferServer(st, key, chunk))

        def distribute(chained: bool) -> float:
            p = ConnectionPool(max_idle_per_peer=cfg.transfer_pool_size)
            pools.append(p)
            t0 = time.perf_counter()
            for i in range(1, n_dests + 1):
                # chain: pull from the PREVIOUS holder; naive: always src
                source = servers[i - 1] if chained else servers[0]
                err = fetch_object("127.0.0.1", source.port, key, oid,
                                   stores[i], chunk, pool=p)
                assert err is None, err
            dt = time.perf_counter() - t0
            for i in range(1, n_dests + 1):
                stores[i].delete(oid)
            return (len(payload) / (1 << 30)) * n_dests / dt

        naive0 = servers[0].bytes_served
        out["naive_gbps"] = round(distribute(chained=False), 3)
        out["naive_source_bytes"] = servers[0].bytes_served - naive0
        marks = [s.bytes_served for s in servers]
        out["broadcast_chain_gbps"] = round(distribute(chained=True), 3)
        out["chain_max_source_bytes"] = max(
            s.bytes_served - m for s, m in zip(servers, marks))
    finally:
        for p in pools:
            p.close()
        for s in servers:
            s.close()
        for st in stores:
            st.close(unlink=True)
    return out


def _settle_served(read_fn, want: int, deadline_s: float = 10.0) -> None:
    """Serving-side byte counters are written on the SERVER thread after
    the last chunk goes out; the client's fetch returns the instant that
    chunk lands, so on a single-core host a counter read right after the
    pull can run first. Wait until ``read_fn()`` accounts ``want`` bytes
    (wire counters are written before logical ones per request, so a
    settled logical delta implies the wire delta is complete too)."""
    deadline = time.perf_counter() + deadline_s
    while read_fn() < want and time.perf_counter() < deadline:
        time.sleep(0.002)


def _sig(x: float, digits: int = 3) -> float:
    """Round to significant digits: raw (wire) GB/s on a highly
    compressible corpus can be ~1e-6, which fixed 3-decimal rounding
    would misreport as 0.0."""
    return float(f"{x:.{digits}g}")


def _build_corpora(nbytes: int) -> Dict[str, bytes]:
    """The ratio-vs-corpus curve's x axis: all-zero pages (fresh arenas,
    zero-init checkpoint buffers), tiled ASCII (logs, JSON metadata),
    sparse float32 gradient pages (7/8 of 4 KiB pages zero — the MoE /
    padded-shard shape zrle exists for), and urandom (ciphertext /
    already-compressed media — the incompressible worst case the probe
    must catch)."""
    import numpy as np

    rng = np.random.default_rng(0)
    para = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. " * 64)
    grad = rng.standard_normal(nbytes // 4).astype(np.float32)
    pages = grad.view(np.uint8).reshape(-1, 4096).copy()
    pages[rng.random(len(pages)) < 0.875] = 0
    return {
        "zeros": bytes(nbytes),
        "text": (para * (nbytes // len(para) + 1))[:nbytes],
        "sparse-grad": pages.tobytes(),
        "random": rng.bytes(nbytes),
    }


def run_compression_bench(payload_mb: int = 64, n_dests: int = 4,
                          trials: int = 3,
                          overhead_trials: int = 5) -> Dict[str, object]:
    """The compressed movement plane's accuracy-vs-speed report.

    Every GB/s figure comes in two flavors: raw =
    wire bytes / wall clock (what the NIC carried), effective = logical
    bytes / wall clock (what the application received). Compression wins
    when effective beats the uncompressed baseline while raw collapses.
    """
    import os

    import numpy as np

    from ..config import Config
    from ..core import codec
    from ..core.object_store import NodeObjectStore
    from ..core.transfer import (
        ConnectionPool, TransferServer, fetch_object,
    )

    nbytes = payload_mb << 20
    capacity = max(64 << 20, nbytes * 3)
    cfg = Config(object_store_memory=capacity, transfer_compression="auto")
    chunk = cfg.object_manager_chunk_size
    key = os.urandom(16)
    tag = os.urandom(3).hex()
    offered = codec.client_codecs(cfg) or ()
    corpora = _build_corpora(nbytes)
    gb = payload_mb / 1024
    out: Dict[str, object] = {
        "payload_mb": payload_mb,
        "n_dests": n_dests,
        "codecs_offered": list(offered),
        "corpora": list(corpora),
    }

    src = NodeObjectStore(f"/rmtc_src_{tag}", cfg)
    dst = NodeObjectStore(f"/rmtc_dst_{tag}", cfg)
    srv = TransferServer(src, key, chunk,
                         max_conns=cfg.transfer_max_conns,
                         idle_timeout=cfg.transfer_idle_timeout_s,
                         compress_min_bytes=cfg.transfer_compress_min_bytes)
    pool = ConnectionPool(max_idle_per_peer=cfg.transfer_pool_size)

    def timed_pull(oid, codecs) -> float:
        t0 = time.perf_counter()
        err = fetch_object("127.0.0.1", srv.port, key, oid, dst, chunk,
                           pool=pool,
                           stripe_threshold=cfg.transfer_stripe_threshold,
                           stripe_count=cfg.transfer_stripe_count,
                           codecs=codecs)
        dt = time.perf_counter() - t0
        assert err is None, err
        dst.delete(oid)
        return dt

    try:
        # -- ratio / raw / effective per corpus ------------------------------
        ratios: Dict[str, float] = {}
        eff: Dict[str, float] = {}
        raw: Dict[str, float] = {}
        base: Dict[str, float] = {}
        chosen: Dict[str, object] = {}
        for name, data in corpora.items():
            oid = name.encode().ljust(32, b"_")
            src.put_bytes(oid, data)
            # the same probe the server runs, reported client-side so the
            # curve names which codec each corpus landed on
            chosen[name], _skip = codec.choose_codec(
                offered, codec.available_codecs(), data)
            timed_pull(oid, offered)  # warmup: pages + pooled conns
            b0, w0 = srv.bytes_served, srv.bytes_served_wire
            dt = timed_pull(oid, offered)
            _settle_served(lambda: srv.bytes_served - b0, len(data))
            logical = srv.bytes_served - b0
            wire = srv.bytes_served_wire - w0
            if wire == 0:  # served raw (probe skipped): wire == logical
                wire = logical
            dt = statistics.median(
                [dt] + [timed_pull(oid, offered)
                        for _ in range(trials - 1)])
            ratios[name] = round(logical / max(wire, 1), 1)
            eff[name] = round(gb / dt, 3)
            raw[name] = _sig((wire / (1 << 30)) / dt)
            # same-run uncompressed control: the honest baseline is THIS
            # host THIS run, not a number recorded on different iron
            base[name] = round(gb / statistics.median(
                timed_pull(oid, None) for _ in range(trials)), 3)
            src.delete(oid)
        out["corpus_codec"] = chosen
        out["corpus_ratio"] = ratios
        out["corpus_effective_gbps"] = eff
        out["corpus_raw_gbps"] = raw
        out["corpus_uncompressed_gbps"] = base

        # -- incompressible overhead: probe-skip path vs codecs-off ----------
        oid = b"r" * 32
        src.put_bytes(oid, corpora["random"])
        timed_pull(oid, offered)
        timed_pull(oid, None)
        # interleaved min-of-N: on a shared host the minimum is the least
        # interference-polluted estimate of each arm's true cost
        t_on = min(timed_pull(oid, offered)
                   for _ in range(overhead_trials))
        t_off = min(timed_pull(oid, None)
                    for _ in range(overhead_trials))
        out["incompressible_overhead_pct"] = round(
            (t_on - t_off) / t_off * 100.0, 2)
        src.delete(oid)
    finally:
        pool.close()
        srv.close()
        dst.close(unlink=True)

    # -- compressed broadcast chain (the distribution-tree shape) ------------
    bcast_corpus = "sparse-grad"
    payload = corpora[bcast_corpus]
    oid = b"c" * 32
    src.put_bytes(oid, payload)
    stores = [src]
    servers = [TransferServer(
        src, key, chunk, compress_min_bytes=cfg.transfer_compress_min_bytes)]
    chain_pool = ConnectionPool(max_idle_per_peer=cfg.transfer_pool_size)
    try:
        for i in range(n_dests):
            st = NodeObjectStore(f"/rmtc_d{i}_{tag}", cfg)
            stores.append(st)
            servers.append(TransferServer(
                st, key, chunk,
                compress_min_bytes=cfg.transfer_compress_min_bytes))

        def distribute(codecs) -> float:
            t0 = time.perf_counter()
            for i in range(1, n_dests + 1):
                err = fetch_object("127.0.0.1", servers[i - 1].port, key,
                                   oid, stores[i], chunk, pool=chain_pool,
                                   codecs=codecs)
                assert err is None, err
            dt = time.perf_counter() - t0
            for i in range(1, n_dests + 1):
                stores[i].delete(oid)
            return dt

        distribute(offered)  # warmup
        marks = [(s.bytes_served, s.bytes_served_wire) for s in servers]
        dt = distribute(offered)
        _settle_served(
            lambda: sum(s.bytes_served - m[0]
                        for s, m in zip(servers, marks)),
            n_dests * len(payload))
        logical = sum(s.bytes_served - m[0]
                      for s, m in zip(servers, marks))
        wire = sum(s.bytes_served_wire - m[1]
                   for s, m in zip(servers, marks))
        dt = statistics.median(
            [dt] + [distribute(offered) for _ in range(trials - 1)])
        out["broadcast_corpus"] = bcast_corpus
        out["broadcast_effective_gbps"] = round(
            (logical / (1 << 30)) / dt, 3)
        out["broadcast_raw_gbps"] = _sig((wire / (1 << 30)) / dt)
        out["broadcast_ratio"] = round(logical / max(wire, 1), 1)
        out["broadcast_uncompressed_gbps"] = round(
            (logical / (1 << 30)) / statistics.median(
                distribute(None) for _ in range(trials)), 3)
    finally:
        chain_pool.close()
        for s in servers:
            s.close()
        for st in stores:
            st.close(unlink=True)

    # -- quantized allreduce: accuracy vs wire bytes per precision -----------
    world = 4
    rng = np.random.default_rng(7)
    shards = [rng.standard_normal(1 << 18).astype(np.float32)
              for _ in range(world)]
    exact = np.sum(shards, axis=0, dtype=np.float32)
    absmax = float(np.abs(exact).max())
    err_by_p: Dict[str, float] = {}
    wire_by_p: Dict[str, float] = {}
    f32_bytes = sum(s.nbytes for s in shards)
    for p in codec.PRECISIONS:
        payloads = [codec.quantize_array(s, p) for s in shards]
        approx = np.sum([codec.dequantize_array(q) for q in payloads],
                        axis=0, dtype=np.float32)
        if p == "f32":
            assert np.array_equal(approx, exact), "f32 must be bit-exact"
        # max error relative to the result's absmax (elementwise relative
        # error is meaningless where the exact value crosses zero)
        err_by_p[p] = round(
            float(np.abs(approx - exact).max()) / absmax, 6)
        wire_by_p[p] = round(
            f32_bytes / sum(codec.quantized_nbytes(q) for q in payloads),
            2)
    out["allreduce_err"] = err_by_p
    out["allreduce_wire_factor"] = wire_by_p
    return out
