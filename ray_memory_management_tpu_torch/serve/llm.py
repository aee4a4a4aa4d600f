"""LM serving: the KV-cached decode path behind a request surface.

Counterpart of ``serve/llm.py`` in the JAX package:

  - :class:`DynamicBatcher` — a thread-based request coalescer: callers
    block, a background thread collects up to ``max_batch_size``
    requests within ``batch_wait_timeout_s`` and runs them as ONE model
    call (the whole-batch "barrier" mode).
  - :class:`ContinuousBatcher` — decode-step-granular scheduling over a
    fixed slot table, with a paged KV cache (default) or one slab.
  - :class:`LLMServer` — the deployment class: parameters on the card,
    one of the two engines behind ``__call__``.

PyTorch runs eagerly, so there is no compile-once program per shape
bucket here; buckets still bound the prefill shapes. Prefill runs
``forward_with_cache`` at offset 0, which attends with the flash
attention kernel; decode steps attend over the cache in plain PyTorch.
Requests carry token ids (``{"tokens": [...]}``) or text
(``{"text": ...}``, byte-level fallback tokenizer).

:func:`llm_deployment` wraps ``LLMServer`` as a serve deployment, and
:func:`pack_weights` / :func:`unpack_weights` ship its parameters to
replicas quantized, in place of each replica drawing its own.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import gpt
from ..utils import faults
from ..utils.device import resolve_device
from .deployment import deployment


class _Pending:
    __slots__ = ("item", "event", "result", "error")

    def __init__(self, item):
        self.item = item
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


def _device_scope(device: torch.device):
    """Make ``device`` current for CUDA work issued by this thread."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class DynamicBatcher:
    """Coalesce concurrent blocking calls into batched ``fn`` invocations.

    ``fn(items: list) -> list`` runs on the batcher thread; callers park
    in :meth:`submit` until their result is ready. The first arrival opens
    a window of ``batch_wait_timeout_s``; the batch launches when the
    window closes or ``max_batch_size`` is reached, whichever is first."""

    def __init__(self, fn, max_batch_size: int = 8,
                 batch_wait_timeout_s: float = 0.01):
        self._fn = fn
        self.max_batch_size = max_batch_size
        self.batch_wait_timeout_s = batch_wait_timeout_s
        self._q: List[_Pending] = []
        self._cond = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-batcher")
        self._thread.start()

    def submit(self, item, timeout: float = 300.0):
        p = _Pending(item)
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher closed")
            self._q.append(p)
            self._cond.notify()
        if not p.event.wait(timeout):
            raise TimeoutError("batched call timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def _loop(self) -> None:
        while not self._stop:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait(timeout=1.0)
                if self._stop:
                    return
                deadline = time.monotonic() + self.batch_wait_timeout_s
                while (len(self._q) < self.max_batch_size
                       and time.monotonic() < deadline):
                    self._cond.wait(timeout=max(
                        0.0, deadline - time.monotonic()))
                batch = self._q[: self.max_batch_size]
                del self._q[: self.max_batch_size]
            try:
                results = self._fn([p.item for p in batch])
                if len(results) != len(batch):
                    raise ValueError(
                        f"batch fn returned {len(results)} results for "
                        f"{len(batch)} items")
                for p, r in zip(batch, results):
                    p.result = r
                    p.event.set()
            except BaseException as e:  # noqa: BLE001 — deliver to callers
                for p in batch:
                    p.error = e
                    p.event.set()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            drained = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for p in drained:  # fail parked callers promptly, not by timeout
            p.error = RuntimeError("batcher closed")
            p.event.set()


def _bytes_tokenize(text: str, vocab_size: int) -> List[int]:
    """Byte-level fallback: utf-8 bytes offset past the special range."""
    return [2 + (b % (vocab_size - 2)) for b in text.encode()]


class ContinuousBatcher:
    """Decode-step-granular request scheduler (continuous batching).

      - a new request is PREFILLED into a free slot the moment one exists
        (``forward_with_cache`` at offset 0: flash attention writes its
        prompt's KV at positions [0, bucket));
      - every engine iteration decodes ``steps_per_iter`` single tokens
        for all slots (``forward_with_cache_rows``, per-row offsets);
      - a slot that reaches its token budget retires immediately and
        admits the next queued request at the next iteration.

    KV memory is PAGED by default (``kv_cache="paged"``): each admitted
    request reserves page-aligned capacity for its lifetime from a
    :class:`~.kv_cache.KVPagePool` of pinned device objects. Each
    iteration takes the live slots' KV rows out of the pool, copies them
    into one working slab whose sequence capacity is the max over LIVE
    reservations, decodes in it IN PLACE, and pins copies of the
    surviving rows back. ``kv_cache="slab"`` keeps one
    ``max_slots x max_seq`` slab for the engine's life. The engine runs
    on the device that holds ``params``.
    """

    def __init__(self, params, cfg, max_slots: int = 8,
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 pad_multiple: int = 64, seed: int = 0,
                 steps_per_iter: int = 8,
                 kv_cache: str = "paged",
                 kv_page_tokens: Optional[int] = None,
                 kv_pool_bytes: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["tok_embed"].device
        self.max_slots = max_slots
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.pad_multiple = pad_multiple
        # scheduling quantum: each iteration decodes K tokens for every
        # occupied slot; arrivals join and finished rows retire within K
        self.steps_per_iter = max(1, min(steps_per_iter, max_new_tokens))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if kv_cache not in ("paged", "slab"):
            raise ValueError(f"unknown kv_cache mode: {kv_cache!r}")
        self.kv_cache_mode = kv_cache
        if kv_cache == "paged":
            from ..config import global_config
            from .kv_cache import KVPagePool

            gcfg = global_config()
            self.kv_pool: Optional[KVPagePool] = KVPagePool(
                cfg, max_slots=max_slots,
                page_tokens=kv_page_tokens or gcfg.kv_page_tokens,
                pool_bytes=kv_pool_bytes if kv_pool_bytes is not None
                else gcfg.serve_kv_pool_bytes)
            self._cache = None
        else:
            self.kv_pool = None
            self._cache = gpt.init_kv_cache(cfg, max_slots, cfg.max_seq,
                                            device=self.device)

        # slot state (host side)
        self._slot_pending: List[Optional[_Pending]] = [None] * max_slots
        self._slot_offset = np.zeros(max_slots, np.int64)
        self._slot_last = np.ones(max_slots, np.int64)
        self._slot_out: List[List[int]] = [[] for _ in range(max_slots)]
        self._slot_budget = np.zeros(max_slots, np.int64)
        self._slot_cap = np.zeros(max_slots, np.int64)  # paged: reserved
        self.kv_backpressure = 0  # admissions deferred on pool exhaustion

        self._q: List[_Pending] = []
        self._cond = threading.Condition()
        self._stop = False
        self.steps = 0  # decode steps executed (the "batches" analog)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # -- client side ----------------------------------------------------------
    def submit(self, tokens: List[int], timeout: float = 300.0,
               max_new_tokens: Optional[int] = None):
        """Blocking generate. ``max_new_tokens`` may be set PER REQUEST
        (capped by the engine default)."""
        budget = self.max_new_tokens if max_new_tokens is None else \
            max(1, min(int(max_new_tokens), self.max_new_tokens))
        p = _Pending((list(tokens), budget))
        with self._cond:
            if self._stop:
                raise RuntimeError("engine closed")
            self._q.append(p)
            self._cond.notify()
        if not p.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self) -> None:
        """Stop the engine, failing queued AND slot-resident requests
        promptly with "engine closed". Slot state belongs to the engine
        thread, so its exit path fails the resident rows; this thread
        only drains the queue."""
        with self._cond:
            self._stop = True
            drained = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for p in drained:
            p.error = RuntimeError("engine closed")
            p.event.set()

    # -- engine side ----------------------------------------------------------
    def _clip_tokens(self, toks: List[int]) -> List[int]:
        limit = self.cfg.max_seq - self.max_new_tokens
        return toks[-limit:]

    def _prefill_len(self, toks: List[int]) -> int:
        """Length of a prompt's prefill: its pad bucket for a dense
        model, the prompt alone for MoE. MoE pads would route with the
        prompt (their choices take the real tokens' expert places) and
        the bucket would set its dispatch group and capacity, so its
        tokens would leave ``gpt.generate``'s (a fault of the JAX
        engine)."""
        if self.cfg.n_experts:
            return len(toks)
        limit = self.cfg.max_seq - self.max_new_tokens
        bucket = max(self.pad_multiple,
                     ((len(toks) + self.pad_multiple - 1)
                      // self.pad_multiple) * self.pad_multiple)
        return min(bucket, limit)

    def _need_tokens(self, p: _Pending) -> int:
        """Page-aligned KV capacity one request needs for its whole
        lifetime: the prefill (whose junk tail must fit) or prompt +
        token budget, whichever is larger."""
        toks, budget = p.item
        toks = self._clip_tokens(list(toks))
        need = max(self._prefill_len(toks), len(toks) + budget)
        return min(self.kv_pool.round_tokens(need), self.cfg.max_seq)

    def _sample(self, logits):
        return gpt._pick(logits, self.temperature, self._gen)

    def _admit(self, p: _Pending, row: int) -> None:
        act = faults.fire("serve.admit")
        if act is not None:
            if act.mode == "stall":
                act.sleep()
            else:  # error/drop: fail ONLY this request, engine keeps going
                act.raise_()
        toks, budget = p.item
        toks = self._clip_tokens(toks)
        bucket = self._prefill_len(toks)
        arr = torch.ones((1, bucket), dtype=torch.long)
        arr[0, : len(toks)] = torch.tensor(toks, dtype=torch.long)
        # right-pad junk is invisible: causality keeps it out of the real
        # rows, and decode overwrites those cache slots one at a time
        arr = arr.to(self.device)
        if self.kv_pool is not None:
            cap = int(self._slot_cap[row])  # reserved by the admit gate
            row_cache = gpt.init_kv_cache(self.cfg, 1, cap,
                                          device=self.device)
            logits, row_cache = gpt.forward_with_cache(
                self.params, arr, row_cache, 0, self.cfg)
            self.kv_pool.put_row(row, row_cache)
        else:
            # views of the slab's row: the prefill writes it in place
            row_cache = {"k": self._cache["k"][:, row:row + 1],
                         "v": self._cache["v"][:, row:row + 1]}
            logits, _ = gpt.forward_with_cache(
                self.params, arr, row_cache, 0, self.cfg)
        first = int(self._sample(logits[0, len(toks) - 1][None])[0])
        self._slot_pending[row] = p
        self._slot_offset[row] = len(toks)
        self._slot_last[row] = first
        self._slot_out[row] = [first]
        self._slot_budget[row] = budget - 1

    def _retire(self, row: int) -> None:
        p = self._slot_pending[row]
        self._slot_pending[row] = None
        self._slot_offset[row] = 0
        self._slot_last[row] = 1
        if self.kv_pool is not None:
            # pages return to the pool and the slot's KV objects drop out
            # of the device tier; a queued request can now reserve
            self.kv_pool.free(row)
            self._slot_cap[row] = 0
        if p is not None:
            p.result = self._slot_out[row]
            p.event.set()

    def _assemble(self, active: List[int]):
        """Take every active slot's pooled KV rows out of the store and
        copy them into one zeroed working slab whose seq capacity is the
        max over LIVE reservations, not ``max_seq``."""
        cfg = self.cfg
        S = max(int(self._slot_cap[r]) for r in active)
        shape = (cfg.n_layers, self.max_slots, cfg.kv_heads, S, cfg.head_dim)
        slab = {"k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}
        for r in active:
            rc = self.kv_pool.take_row(r)
            if rc is None:
                continue
            cap = int(self._slot_cap[r])
            slab["k"][:, r:r + 1, :, :cap] = rc["k"]
            slab["v"][:, r:r + 1, :, :cap] = rc["v"]
        return slab

    def _disassemble(self, cache, rows: List[int]) -> None:
        """Copy each surviving slot's reserved capacity back out of the
        working slab and pin it in the pool; the slab itself is dropped
        (copies, so no pooled row keeps the whole slab alive)."""
        for r in rows:
            cap = int(self._slot_cap[r])
            self.kv_pool.put_row(r, {
                "k": cache["k"][:, r:r + 1, :, :cap].clone(),
                "v": cache["v"][:, r:r + 1, :, :cap].clone()})

    def _decode(self, cache):
        """``steps_per_iter`` single-token steps over every slot, writing
        ``cache`` in place. Returns the sampled tokens [K, B] on the
        host.

        Every slot decodes, idle ones included, as in the JAX engine; but
        a MoE config routes only the rows that are live at that step (a
        request in the slot with budget left): the JAX engine routes all
        ``max_slots`` rows, so idle and finished slots take expert
        capacity from live requests and change their tokens."""
        last = torch.tensor(self._slot_last, device=self.device)
        offsets = torch.tensor(self._slot_offset, device=self.device)
        occupied = np.array([p is not None for p in self._slot_pending])
        toks = []
        for t in range(self.steps_per_iter):
            live = (torch.from_numpy(occupied & (self._slot_budget > t))
                    .to(self.device) if self.cfg.n_experts else None)
            logits, cache = gpt.forward_with_cache_rows(
                self.params, last[:, None], cache, offsets + t, self.cfg,
                live=live)
            last = self._sample(logits[:, 0])
            toks.append(last)
        return torch.stack(toks).cpu().numpy()

    def _admit_gate(self) -> List:
        """Pop admissible queued requests (head-of-line FIFO) into free
        slots. Paged mode reserves each request's lifetime pages FIRST —
        a failed reserve defers admission (backpressure) until a retiring
        slot frees pages. Caller holds ``_cond``."""
        admits = []
        for row in range(self.max_slots):
            if not self._q:
                break
            if self._slot_pending[row] is not None:
                continue
            if self.kv_pool is None:
                admits.append((self._q.pop(0), row))
                continue
            p = self._q[0]
            need = self._need_tokens(p)
            if self.kv_pool.pages_for(need) > self.kv_pool.capacity_pages:
                # can never fit even in an empty pool: fail fast
                self._q.pop(0)
                p.error = RuntimeError(
                    f"request needs {need} KV tokens "
                    f"({self.kv_pool.pages_for(need)} pages) but the pool "
                    f"capacity is {self.kv_pool.capacity_pages} pages")
                p.event.set()
                continue
            if not self.kv_pool.reserve(row, need):
                # pool exhausted: keep FIFO order, admit nothing past the
                # head — pages free at the next retire
                self.kv_backpressure += 1
                try:
                    from ..core import metrics_defs as mdefs
                    mdefs.serve_kv_backpressure().inc()
                except Exception:  # noqa: BLE001
                    pass
                break
            self._slot_cap[row] = need
            admits.append((self._q.pop(0), row))
        return admits

    def _run(self) -> None:
        # inference mode and the current device are per thread
        with torch.inference_mode(), _device_scope(self.device):
            self._loop()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (not self._stop and not self._q
                       and all(p is None for p in self._slot_pending)):
                    self._cond.wait(timeout=1.0)
                if self._stop:
                    victims = [p for p in self._slot_pending
                               if p is not None]
                    self._slot_pending = [None] * self.max_slots
                    if self.kv_pool is not None:
                        self.kv_pool.free_all()
                        self._slot_cap[:] = 0
                    for p in victims:
                        p.error = RuntimeError("engine closed")
                        p.event.set()
                    return
                admits = self._admit_gate()
            try:
                for p, row in admits:
                    try:
                        self._admit(p, row)
                    except faults.FaultInjected as e:
                        # an injected admit failure takes down ONE
                        # request: release the reservation, keep going
                        if self.kv_pool is not None:
                            self.kv_pool.free(row)
                            self._slot_cap[row] = 0
                        self._slot_pending[row] = None
                        p.error = e
                        p.event.set()
                        continue
                    if self._slot_budget[row] <= 0:
                        self._retire(row)  # max_new_tokens == 1
                active = [r for r in range(self.max_slots)
                          if self._slot_pending[r] is not None]
                if not active:
                    continue
                cache = self._assemble(active) if self.kv_pool is not None \
                    else self._cache
                toks = self._decode(cache)  # [K, B]
                self.steps += self.steps_per_iter
                for r in active:
                    # a row finishing mid-iteration consumes only what its
                    # budget allows; the surplus junk went into its OWN
                    # cache rows beyond its end, which the per-row mask
                    # keeps invisible and retire/prefill discards
                    take = min(self.steps_per_iter,
                               int(self._slot_budget[r]))
                    self._slot_out[r].extend(
                        int(toks[t, r]) for t in range(take))
                    self._slot_last[r] = int(toks[take - 1, r])
                    self._slot_offset[r] += take
                    self._slot_budget[r] -= take
                    if self._slot_budget[r] <= 0:
                        self._retire(r)
                if self.kv_pool is not None:
                    self._disassemble(cache, [
                        r for r in active
                        if self._slot_pending[r] is not None])
            except BaseException as e:  # noqa: BLE001 — fail loudly to
                with self._cond:        # every parked caller, keep serving
                    victims = ([p for p in self._slot_pending
                                if p is not None] + self._q)
                    self._slot_pending = [None] * self.max_slots
                    self._q.clear()
                if self.kv_pool is not None:
                    self.kv_pool.free_all()
                    self._slot_cap[:] = 0
                for p in victims:
                    p.error = e
                    p.event.set()

    def kv_stats(self) -> Dict[str, Any]:
        """Pool occupancy snapshot (paged mode) for metrics/benchmarks."""
        if self.kv_pool is None:
            return {"mode": "slab", "kv_backpressure": 0}
        out = dict(self.kv_pool.stats())
        out["mode"] = "paged"
        out["kv_backpressure"] = self.kv_backpressure
        return out


def _param_leaves(params, prefix=()):
    """(key path, tensor) of every leaf of a nested param dict, in the
    order ``jax.tree_util.tree_flatten`` takes the same dict (keys
    sorted at every level)."""
    for key in sorted(params):
        node = params[key]
        if isinstance(node, dict):
            yield from _param_leaves(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def pack_weights(params, precision: str = "bf16") -> Dict[str, Any]:
    """Quantize a param dict for the movement plane: per-leaf
    :func:`~..core.codec.quantize_array` payloads (bf16 ~2x, int8 ~4x
    smaller than f32), so shipping weights to a cold replica moves a
    fraction of the bytes a full-precision pickle would. The key paths
    stand where the JAX package's payload holds a treedef; the leaves
    are the same, in the same order. Counted under
    ``rmt_collective_quantized_ops_total{op="serve.weights"}``."""
    from ..core import codec

    paths, payloads = [], []
    for path, leaf in _param_leaves(params):
        paths.append(path)
        payloads.append(codec.quantize_array(
            leaf.detach().float().cpu().numpy(), precision))
    codec.count_quantized_op("serve.weights", precision)
    return {"paths": paths, "leaves": payloads, "p": precision}


def unpack_weights(payload: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Inverse of :func:`pack_weights`: dequantize each leaf to fp32 and
    rebuild the param dict on ``device`` (the card unless the caller
    passes another)."""
    from ..core import codec

    device = resolve_device(device)
    params: Dict[str, Any] = {}
    for path, leaf in zip(payload["paths"], payload["leaves"]):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.from_numpy(
            codec.dequantize_array(leaf)).to(device)
    return params


class LLMServer:
    """Deployment class: KV-cached batched generation on one card.

    Parameters are drawn on ``device`` (the card unless the caller passes
    ``device="cpu"``) from a generator seeded ``seed``. ``weights`` (a
    :func:`pack_weights` payload) skips that draw: the cold-start path
    of scale-up replicas; both paths time their init under
    ``rmt_serve_cold_start_seconds{source=shipped|init}``. ``user_config``
    (reconfigure) can retune ``max_new_tokens`` / ``temperature``."""

    def __init__(self, preset: str = "gpt2-small",
                 max_batch_size: int = 8,
                 batch_wait_timeout_s: float = 0.01,
                 max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 pad_multiple: int = 64,
                 seed: int = 0,
                 batching: str = "continuous",
                 steps_per_iter: int = 8,
                 kv_cache: str = "paged",
                 kv_page_tokens: Optional[int] = None,
                 kv_pool_bytes: Optional[int] = None,
                 weights: Optional[Dict[str, Any]] = None,
                 device=None):
        t0 = time.monotonic()
        self.device = resolve_device(device)
        self.cfg = gpt.PRESETS[preset]
        if max_new_tokens + pad_multiple > self.cfg.max_seq:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves no room for a "
                f"{pad_multiple}-token prompt bucket within the model's "
                f"max_seq={self.cfg.max_seq}")
        if weights is not None:
            self.params = unpack_weights(weights, self.device)
            cold_source = "shipped"
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = gpt.init_params(self.cfg, gen, self.device)
            cold_source = "init"
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.pad_multiple = pad_multiple
        self.max_batch_size = max_batch_size
        self.seed = seed
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0,
                       "generated_tokens": 0}  # guarded-by: _stats_lock
        self.batching = batching
        self.steps_per_iter = steps_per_iter
        self.kv_cache = kv_cache
        self.kv_page_tokens = kv_page_tokens
        self.kv_pool_bytes = kv_pool_bytes
        if batching == "continuous":
            self._engine: Optional[ContinuousBatcher] = self._new_engine()
            self._batcher = None
        elif batching == "barrier":
            # whole-batch mode (kept for A/B comparison)
            self._engine = None
            self._batcher = DynamicBatcher(
                self._run_batch, max_batch_size=max_batch_size,
                batch_wait_timeout_s=batch_wait_timeout_s)
        else:
            raise ValueError(f"unknown batching mode: {batching!r}")
        try:
            from ..core import metrics_defs as mdefs
            mdefs.serve_cold_start_seconds().observe(
                time.monotonic() - t0, tags={"source": cold_source})
        except Exception:  # noqa: BLE001 — metrics never fail init
            pass

    def _new_engine(self) -> ContinuousBatcher:
        return ContinuousBatcher(
            self.params, self.cfg, max_slots=self.max_batch_size,
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature, pad_multiple=self.pad_multiple,
            seed=self.seed + 1, steps_per_iter=self.steps_per_iter,
            kv_cache=self.kv_cache, kv_page_tokens=self.kv_page_tokens,
            kv_pool_bytes=self.kv_pool_bytes)

    # -- config ---------------------------------------------------------------
    def reconfigure(self, user_config: Optional[dict]) -> None:
        if not user_config:
            return
        new_tokens = int(user_config.get(
            "max_new_tokens", self.max_new_tokens))
        if new_tokens + self.pad_multiple > self.cfg.max_seq:
            raise ValueError(
                f"max_new_tokens={new_tokens} leaves no room for a "
                f"{self.pad_multiple}-token prompt bucket within "
                f"max_seq={self.cfg.max_seq}")
        new_temp = float(user_config.get("temperature", self.temperature))
        changed = (new_tokens != self.max_new_tokens
                   or new_temp != self.temperature)
        self.max_new_tokens = new_tokens
        self.temperature = new_temp
        if self._engine is not None and changed:
            # the budget is baked into the engine's slot accounting: swap
            # in a fresh engine rather than mutating a live one
            old = self._engine
            self._engine = self._new_engine()
            old.close()

    def close(self) -> None:
        """Stop the engine or batcher thread, failing parked callers."""
        if self._engine is not None:
            self._engine.close()
        if self._batcher is not None:
            self._batcher.close()

    # -- request surface ------------------------------------------------------
    def __call__(self, request: Any = None) -> Dict[str, Any]:
        """{"tokens": [...]} or {"text": "..."} -> {"tokens": [...],
        "prompt_len": n}. An optional per-request "max_new_tokens"
        (capped by the deployment default) is honored in continuous
        mode."""
        if isinstance(request, str):
            request = {"text": request}
        request = request or {}
        tokens = request.get("tokens")
        if tokens is None:
            tokens = _bytes_tokenize(request.get("text", ""),
                                     self.cfg.vocab_size)
        if not tokens:
            tokens = [1]
        out = self.generate(tokens,
                            max_new_tokens=request.get("max_new_tokens"))
        return {"tokens": out, "prompt_len": len(tokens)}

    def generate(self, tokens: Sequence[int],
                 max_new_tokens: Optional[int] = None) -> List[int]:
        """Generate continuation ids for one prompt (batched with whatever
        arrives concurrently)."""
        if self._engine is not None:
            out = self._engine.submit(list(tokens),
                                      max_new_tokens=max_new_tokens)
            with self._stats_lock:
                self._stats["requests"] += 1
                self._stats["generated_tokens"] += len(out)
                self._stats["batches"] = self._engine.steps
            return out
        return self._batcher.submit(list(tokens))

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        if self._engine is not None:
            out["kv"] = self._engine.kv_stats()
        return out

    # -- batched model call ---------------------------------------------------
    def _run_batch(self, prompts: List[List[int]]) -> List[List[int]]:
        """One prefill+decode for a batch of prompts, padded to
        ``max_batch_size`` rows and the next ``pad_multiple`` length.
        Shorter rows are right-padded with their own final token (the
        padded-batch approximation; continuous mode is exact)."""
        n = len(prompts)
        s0 = max(len(p) for p in prompts)
        bucket = ((s0 + self.pad_multiple - 1)
                  // self.pad_multiple) * self.pad_multiple
        bucket = min(bucket, self.cfg.max_seq - self.max_new_tokens)
        arr = np.ones((self.max_batch_size, bucket), np.int64)
        for i, p in enumerate(prompts):
            p = p[-bucket:]  # truncate over-long prompts from the left
            arr[i, : len(p)] = p
            if len(p) < bucket:
                arr[i, len(p):] = p[-1]
        with torch.inference_mode(), _device_scope(self.device):
            out = gpt.generate(
                self.params, self.cfg,
                torch.as_tensor(arr, device=self.device),
                steps=self.max_new_tokens, temperature=self.temperature,
                generator=self._gen)
            out_np = out.cpu().numpy()
        with self._stats_lock:
            self._stats["requests"] += n
            self._stats["batches"] += 1
            self._stats["generated_tokens"] += n * self.max_new_tokens
        return [out_np[i, bucket: bucket + self.max_new_tokens].tolist()
                for i in range(n)]


def llm_deployment(preset: str = "gpt2-small",
                   ray_actor_options: Optional[dict] = None,
                   max_concurrent_queries: int = 64,
                   ship_weights: Optional[str] = None, **kwargs):
    """A ready-to-run Application serving ``preset``:

        from ray_memory_management_tpu_torch import serve
        serve.run(serve.llm_deployment(
            "gpt2-small", ray_actor_options={"num_gpus": 1}))
        serve.get_handle("LLM").remote({"tokens": [1, 2, 3]})

    Pass ``ray_actor_options={"num_gpus": 1}`` so the replica takes a
    card lease (``CUDA_VISIBLE_DEVICES`` isolation) and serves from the
    card. A replica without a lease sees no card and fails to start
    unless ``device="cpu"`` (passed on to :class:`LLMServer` with the
    other ``kwargs``) asks for the CPU.

    ``ship_weights="bf16"|"int8"|"f32"`` draws the params ONCE on the
    driver, with the generator and on the device the replica would use
    (torch's CPU and CUDA generators draw differently for one seed), and
    ships them quantized to every replica (:func:`pack_weights`) instead
    of each replica drawing its own. The payload is also put into the
    object store so the controller can place new replicas near the tier
    holding it (the ``placement_hint`` in the deployment config)."""
    placement_hint = None
    if ship_weights:
        cfg = gpt.PRESETS[preset]
        device = resolve_device(kwargs.get("device"))
        gen = torch.Generator(device=device).manual_seed(
            kwargs.get("seed", 0))
        params = gpt.init_params(cfg, gen, device)
        kwargs["weights"] = pack_weights(params, precision=ship_weights)
        del params
        try:
            from .. import api as core_api

            placement_hint = core_api.put(kwargs["weights"]).hex()
        except Exception:  # noqa: BLE001 — the hint is best-effort; a
            placement_hint = None  # driver without a running runtime
            # still gets weights shipped via the deployment config
    return deployment(
        LLMServer, name="LLM", ray_actor_options=ray_actor_options,
        max_concurrent_queries=max_concurrent_queries,
        placement_hint=placement_hint,
    ).bind(preset=preset, **kwargs)


__all__ = ["ContinuousBatcher", "DynamicBatcher", "LLMServer",
           "llm_deployment", "pack_weights", "unpack_weights"]
