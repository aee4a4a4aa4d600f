"""TransformerLM: the flagship decoder-only language model, in PyTorch.

Counterpart of ``models/gpt.py`` in the JAX package, function for
function and with the same parameter layout, so a JAX parameter tree
converts leaf for leaf (:mod:`.convert`):

  - parameters are a plain dict with LAYER-STACKED weights ([L, ...]);
    the JAX ``lax.scan`` over layers is a Python loop over ``L`` here;
  - compute in ``cfg.dtype`` (bf16 by default), parameters and
    reductions in fp32, and bf16 rounds where the JAX code rounds;
  - attention: "flash" / "auto" go through ``ops.flash_attention`` (the
    CUDA kernels, forward and backward, on a CUDA tensor; the plain
    versions on a CPU tensor), "ref" through the plain version,
    "ring"/"ulysses" through ``ops.ring_attention`` over the ``sp`` axis
    of the ``mesh`` passed to the forward (the same kernels per chunk);
  - the FFN is dense, or the MoE FFN of ``ops/moe.py`` when
    ``n_experts > 0``: its load-balancing aux is returned by the
    ``_with_aux`` functions and weighted into ``loss_fn``; expert weights
    may be each rank's local shard of the ``mesh``'s ep axis;
  - sharded parameters (DTensors, ``parallel.make_train_step``): the same
    functions run on DTensors. Attention runs on each rank's LOCAL rows
    and heads (the kernel never sees a DTensor), the vocab-parallel
    embedding's partial sums are reduced right after the lookup, and
    vocab-sharded logits are gathered before the loss.

The KV-cached path (``forward_with_cache`` / ``forward_with_cache_rows``)
updates the cache tensors IN PLACE and returns the same dict: the JAX
functions return a new cache, which the serve engine then donates; in
PyTorch the engine simply owns the tensors it writes.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import moe
from ..ops.flash_attention import flash_attention, reference_attention
from ..ops.ring_attention import ring_attention, ulysses_attention
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # < n_heads => GQA
    d_ff: Optional[int] = None        # default: SwiGLU 8/3 * d_model
    max_seq: int = 2048
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16       # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    attention: str = "auto"           # auto|flash|ref|ring|ulysses
    remat: bool = False
    scan_unroll: int = 1
    n_experts: int = 0                # MoE FFN (ops/moe.py); 0 = dense
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    expert_group_size: int = 256
    moe_aux_weight: float = 0.01

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        d = int(self.d_model * 8 / 3)
        return (d + 127) // 128 * 128


# presets: the JAX package's names and values
PRESETS: Dict[str, TransformerConfig] = {
    "test": TransformerConfig(vocab_size=512, d_model=64, n_layers=2,
                              n_heads=4, max_seq=128),
    "test-moe": TransformerConfig(vocab_size=512, d_model=64, n_layers=2,
                                  n_heads=4, max_seq=128, n_experts=4,
                                  expert_top_k=2),
    "mixtral-tiny": TransformerConfig(vocab_size=32_000, d_model=1024,
                                      n_layers=8, n_heads=16, n_kv_heads=4,
                                      max_seq=2048, n_experts=8,
                                      expert_top_k=2),
    "gpt2-small": TransformerConfig(vocab_size=50_304, d_model=768,
                                    n_layers=12, n_heads=12, max_seq=1024),
    "gpt2-medium": TransformerConfig(vocab_size=50_304, d_model=1024,
                                     n_layers=24, n_heads=16, max_seq=1024),
    "llama-1b": TransformerConfig(vocab_size=32_000, d_model=2048,
                                  n_layers=16, n_heads=32, n_kv_heads=8,
                                  max_seq=2048),
    "llama-7b": TransformerConfig(vocab_size=32_000, d_model=4096,
                                  n_layers=32, n_heads=32, max_seq=2048),
}

Params = Dict[str, Any]


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attention not in ("auto", "flash", "ref", "ring", "ulysses"):
        raise ValueError(f"unknown attention mode {cfg.attention!r}")


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> Params:
    """Layer-stacked parameter dict, drawn from ``generator`` (a fresh
    generator seeded 0 on ``device`` when None)."""
    _check_supported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.ff_dim
    H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=pd, device=device)
        return w * (fan_in ** -0.5)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    layers = {
        "ln1": ones((L, D)),
        "ln2": ones((L, D)),
        "wq": dense((L, D, H * Dh), D),
        "wk": dense((L, D, Hkv * Dh), D),
        "wv": dense((L, D, Hkv * Dh), D),
        "wo": dense((L, H * Dh, D), H * Dh),
    }
    if cfg.n_experts > 0:
        layers.update(moe.init_moe_params(L, D, F_, cfg.n_experts,
                                          generator, device, pd))
    else:
        layers.update({
            "w1": dense((L, D, F_), D),
            "w3": dense((L, D, F_), D),
            "w2": dense((L, F_, D), F_),
        })
    return {
        "tok_embed": dense((cfg.vocab_size, D), D),
        "layers": layers,
        "final_ln": ones((D,)),
        "lm_head": dense((D, cfg.vocab_size), D),
    }


def _rmsnorm(x, scale):
    # variance in fp32, the multiply in x.dtype (JAX gpt.py _rmsnorm)
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale.to(x.dtype)


def _rope(x, positions, theta: float):
    """Rotary embeddings over [..., S, H, Dh]; cos/sin rounded to x.dtype."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs          # [..., S, half]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)      # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _repeat_kv(t, cfg: TransformerConfig):
    """GQA: repeat each kv head n_heads // kv_heads times along dim 1."""
    if cfg.kv_heads == cfg.n_heads:
        return t
    return t.repeat_interleave(cfg.n_heads // cfg.kv_heads, dim=1)


def _is_dtensor(t) -> bool:
    """A DTensor, asked without importing ``torch.distributed.tensor``
    (no DTensor exists until something imported it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _replicate_where(t, keep):
    """``t`` redistributed so that each mesh dim whose placement fails
    ``keep`` is replicated (a partial sum reduced, a shard gathered)."""
    from torch.distributed.tensor import Replicate

    placements = [p if keep(p) else Replicate() for p in t.placements]
    if list(t.placements) == placements:
        return t
    return t.redistribute(placements=placements)


def _attention_local(q, k, v, cfg: TransformerConfig):
    """Attention of DTensor q/k/v [B, H, S, Dh] on each rank's local rows
    (dp/fsdp) and heads (tp, column-parallel wq/wk/wv): a shard of the
    batch or head dim stays, anything else (sequence, head dim, partial
    sums) is replicated first. The local tensors go through
    :func:`_attention`, so the kernel sees plain tensors; kv heads repeat
    locally, which is right when tp divides the kv heads."""
    from torch.distributed.tensor import DTensor

    q = _replicate_where(q, lambda p: p.is_shard(0) or p.is_shard(1))
    k, v = (t.redistribute(placements=q.placements) for t in (k, v))
    o = _attention(q.to_local(), k.to_local(), v.to_local(), cfg)
    return DTensor.from_local(o, q.device_mesh, q.placements,
                              run_check=False)


def _attention(q, k, v, cfg: TransformerConfig, mesh=None, sp_axis=None):
    """Causal attention over [B, H, S, Dh] (kv possibly fewer heads)."""
    if _is_dtensor(q):
        return _attention_local(q, k, v, cfg)
    k, v = _repeat_kv(k, cfg), _repeat_kv(v, cfg)
    if cfg.attention in ("ring", "ulysses"):
        fn = ring_attention if cfg.attention == "ring" else ulysses_attention
        return fn(q, k, v, mesh, axis=sp_axis or "sp", causal=True)
    if cfg.attention == "ref":
        return reference_attention(q, k, v, causal=True)
    return flash_attention(q, k, v, causal=True)


def _layer(params: Params, i: int) -> Params:
    return {name: w[i] for name, w in params["layers"].items()}


def _logits(x, lm_head, cfg: TransformerConfig):
    """bf16-rounded operands, fp32 products and output (the JAX
    dot_general with preferred_element_type=float32)."""
    return x.float() @ lm_head.to(cfg.dtype).float()


def apply_block_with_aux(x, layer, cfg: TransformerConfig, attn_fn=None,
                         positions=None, mesh=None, sp_axis=None,
                         live=None):
    """One transformer block; returns (x, attn_aux, moe_aux).

    ``attn_fn``, if given, replaces the standard attention middle: it
    takes post-rope q/k/v as [B, S, H(kv), Dh] and returns
    (o [B, S, H, Dh], attn_aux); the cached paths use it to read and
    write their cache. The FFN is dense or MoE per ``cfg.n_experts``;
    moe_aux is the layer's load-balancing loss (0.0 when dense), and
    ``live`` [B, S], if given, keeps masked tokens out of MoE routing."""
    _check_supported(cfg)
    B, S = x.shape[0], x.shape[1]
    H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    h = _rmsnorm(x, layer["ln1"])
    q = (h @ layer["wq"].to(cfg.dtype)).reshape(B, S, H, Dh)
    k = (h @ layer["wk"].to(cfg.dtype)).reshape(B, S, Hkv, Dh)
    v = (h @ layer["wv"].to(cfg.dtype)).reshape(B, S, Hkv, Dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn_aux = None
    if attn_fn is not None:
        o, attn_aux = attn_fn(q, k, v)
    else:
        o = _attention(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), cfg, mesh, sp_axis).transpose(1, 2)
    x = x + o.reshape(B, S, H * Dh) @ layer["wo"].to(cfg.dtype)
    h = _rmsnorm(x, layer["ln2"])
    if cfg.n_experts > 0:
        y, moe_aux = moe.moe_ffn(h, layer, cfg, mesh, live)
        return x + y, attn_aux, moe_aux
    gate = F.silu(h @ layer["w1"].to(cfg.dtype))
    up = h @ layer["w3"].to(cfg.dtype)
    x = x + (gate * up) @ layer["w2"].to(cfg.dtype)
    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, attn_aux, moe_aux


def apply_block(x, layer, cfg: TransformerConfig, attn_fn=None,
                positions=None, mesh=None, sp_axis=None, live=None):
    """apply_block_with_aux returning x, or (x, attn_aux) with attn_fn."""
    x, attn_aux, _ = apply_block_with_aux(x, layer, cfg, attn_fn, positions,
                                          mesh, sp_axis, live)
    if attn_fn is not None:
        return x, attn_aux
    return x


def forward_with_aux(params: Params, tokens, cfg: TransformerConfig,
                     mesh=None, sp_axis=None):
    """tokens [B, S] -> (logits [B, S, V] fp32, aux scalar: the mean
    per-layer MoE load-balancing loss, 0.0 for dense configs). With
    ``cfg.remat`` each block is checkpointed (the JAX ``jax.checkpoint``
    per block): its activations are recomputed in the backward pass
    instead of kept. ``mesh`` (and ``sp_axis``, "sp" by default) serve
    ring/Ulysses attention and expert weights sharded over ep."""
    embed = params["tok_embed"]
    if _is_dtensor(embed):
        # a vocab-sharded table (tp's vocab-parallel rows, or fsdp's) is
        # gathered first: DTensor's masked-partial lookup does not
        # survive its backward; F.embedding because DTensor has no
        # sharding rule for index_put (the lookup's backward) in every
        # torch version
        x = F.embedding(tokens, _replicate_where(
            embed, lambda p: not p.is_shard(0)))
    else:
        x = embed[tokens]
    x = x.to(cfg.dtype)
    # sharded: the activations between blocks keep the batch's layout
    # (rows over the data axes, whole across tp), as the JAX step
    # constrains its batch; DTensor may otherwise pick layouts that some
    # torch versions cannot take through the next block's views
    layout = tuple(tokens.placements) if _is_dtensor(tokens) else None

    def settle(x):
        if layout is None or tuple(x.placements) == layout:
            return x
        return x.redistribute(placements=layout)

    def block(x, layer):
        x, _, moe_aux = apply_block_with_aux(x, layer, cfg, mesh=mesh,
                                             sp_axis=sp_axis)
        return x, moe_aux

    x = settle(x)
    aux = []
    for i in range(cfg.n_layers):
        if cfg.remat:
            x, moe_aux = checkpoint(block, x, _layer(params, i),
                                    use_reentrant=False)
        else:
            x, moe_aux = block(x, _layer(params, i))
        x = settle(x)
        aux.append(moe_aux)
    x = _rmsnorm(x, params["final_ln"])
    return _logits(x, params["lm_head"], cfg), torch.stack(aux).mean()


def forward(params: Params, tokens, cfg: TransformerConfig, mesh=None,
            sp_axis=None):
    """tokens [B, S] -> logits [B, S, V] (fp32)."""
    return forward_with_aux(params, tokens, cfg, mesh, sp_axis)[0]


def loss_fn(params: Params, batch, cfg: TransformerConfig, mesh=None,
            sp_axis=None):
    """batch: {"tokens": [B, S], "targets": [B, S]} -> mean cross-entropy
    (+ the MoE load-balancing aux, weighted by ``moe_aux_weight``, for
    expert configs).

    The fused form of the JAX ``loss_fn``: mean(logsumexp(logits) -
    logits[target]), never log_softmax's [B, S, V] residual.
    Vocab-sharded DTensor logits (tp's column-parallel ``lm_head``, or
    partial sums) are gathered over the vocab first, so the loss is this
    formula on every layout."""
    logits, aux = forward_with_aux(params, batch["tokens"], cfg, mesh,
                                   sp_axis)
    if _is_dtensor(logits):
        # keep the batch shards; gather the vocab and reduce partial sums
        last = logits.ndim - 1
        logits = _replicate_where(
            logits, lambda p: p.is_shard() and not p.is_shard(last))
    lse = torch.logsumexp(logits, dim=-1)
    take = logits.gather(-1, batch["targets"][..., None])[..., 0]
    xent = (lse - take).mean()
    if cfg.n_experts > 0:
        xent = xent + cfg.moe_aux_weight * aux
    return xent


def param_leaves(params: Params):
    """The parameter tensors of the nested dict, in its key order."""
    for v in params.values():
        if isinstance(v, dict):
            yield from param_leaves(v)
        else:
            yield v


def count_params(params: Params) -> int:
    return sum(t.numel() for t in param_leaves(params))


# ------------------------------------------------------------ cached decode
def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device: Optional[Union[str, torch.device]] = None):
    """Per-layer KV cache: {"k","v"} of [L, B, Hkv, max_len, Dh] in the
    activation dtype."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _masked_cache_attention(q, kc, vc, mask, cfg: TransformerConfig):
    """Attention of q [B, S, H, Dh] over the whole cache [B, Hkv, T, Dh]
    under ``mask`` (broadcastable to [B, H, S, T]). Scores are fp32 from
    the activation-dtype operands; probs round to cfg.dtype before P.V
    (JAX gpt.py cached_attn)."""
    kk, vv = _repeat_kv(kc, cfg), _repeat_kv(vc, cfg)
    qh = q.transpose(1, 2)                                   # [B, H, S, Dh]
    scores = (qh.float() @ kk.float().transpose(-1, -2)) \
        * (cfg.head_dim ** -0.5)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    return (probs @ vv).transpose(1, 2)                     # [B, S, H, Dh]


def forward_with_cache(params: Params, tokens, cache, offset,
                       cfg: TransformerConfig):
    """Incremental forward: ``tokens`` [B, S] occupy absolute positions
    [offset, offset+S), reading and writing ``cache`` in place.

    Serves prefill (offset 0) and decode. With the Python int
    ``offset == 0`` the cache mask admits exactly the S keys just
    written, causally, so attention is ``flash_attention`` over them (the
    CUDA kernel on the card); any other offset attends over the masked
    cache in plain PyTorch. Returns (logits [B, S, V] fp32, cache)."""
    B, S = tokens.shape
    T = cache["k"].shape[3]
    device = tokens.device
    prefill = isinstance(offset, int) and offset == 0
    offset = int(offset)
    positions = torch.arange(offset, offset + S, device=device)[None, :]
    # the write window is clamped into the cache, as lax.dynamic_update_slice
    # clamps it; rope phases and the mask keep the unclamped positions
    start = min(max(offset, 0), T - S)
    mask = None if prefill else (torch.arange(T, device=device)[None, :]
                                 <= positions[0][:, None])  # [S, T]
    x = params["tok_embed"][tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        kc, vc = cache["k"][i], cache["v"][i]               # [B, Hkv, T, Dh]

        def cached_attn(q, k, v, kc=kc, vc=vc):
            kc[:, :, start:start + S] = k.transpose(1, 2)
            vc[:, :, start:start + S] = v.transpose(1, 2)
            if prefill:
                o = _attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), cfg).transpose(1, 2)
            else:
                o = _masked_cache_attention(q, kc, vc, mask, cfg)
            return o, None

        x, _ = apply_block(x, _layer(params, i), cfg, attn_fn=cached_attn,
                           positions=positions)
    x = _rmsnorm(x, params["final_ln"])
    return _logits(x, params["lm_head"], cfg), cache


def forward_with_cache_rows(params: Params, tokens, cache, offsets,
                            cfg: TransformerConfig, live=None):
    """Incremental forward with PER-ROW positions: row ``i`` of ``tokens``
    [B, S] occupies absolute positions [offsets[i], offsets[i]+S) of its
    cache row, attends only to its own history under its own rope phases,
    and writes the cache in place. ``live`` [B] (bool), if given, keeps
    the tokens of rows that are not live out of MoE routing, so idle rows
    take no expert capacity from live ones. Returns (logits [B, S, V]
    fp32, cache)."""
    B, S = tokens.shape
    T = cache["k"].shape[3]
    device = tokens.device
    offsets = torch.as_tensor(offsets, device=device).reshape(B)
    positions = offsets[:, None] + torch.arange(S, device=device)[None, :]
    start = offsets.clamp(0, T - S)                         # per-row window
    write_pos = start[:, None] + torch.arange(S, device=device)[None, :]
    rows = torch.arange(B, device=device)[:, None].expand(B, S)
    mask = (torch.arange(T, device=device)[None, None, :]
            <= positions[:, :, None])                       # [B, S, T]
    if live is not None:
        live = torch.as_tensor(live, device=device).reshape(B, 1).expand(
            B, S)
    x = params["tok_embed"][tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        kc, vc = cache["k"][i], cache["v"][i]               # [B, Hkv, T, Dh]

        def cached_attn(q, k, v, kc=kc, vc=vc):
            kc[rows, :, write_pos] = k                      # k: [B,S,Hkv,Dh]
            vc[rows, :, write_pos] = v
            o = _masked_cache_attention(q, kc, vc, mask[:, None], cfg)
            return o, None

        x, _ = apply_block(x, _layer(params, i), cfg, attn_fn=cached_attn,
                           positions=positions, live=live)
    x = _rmsnorm(x, params["final_ln"])
    return _logits(x, params["lm_head"], cfg), cache


def _pick(logits, temperature: float,
          generator: Optional[torch.Generator]):
    """Greedy argmax at temperature 0, else a categorical draw from
    ``generator`` (its own stream: token-for-token parity with the JAX
    package holds only for greedy decoding)."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(params: Params, cfg: TransformerConfig, prompt, steps: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """KV-cached decoding: one prefill pass over the prompt (flash
    attention), then ``steps`` single-token steps against the cache.
    prompt: [B, S0] -> [B, S0+steps]."""
    B, S0 = prompt.shape
    cache = init_kv_cache(cfg, B, S0 + steps, device=prompt.device)
    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg)
    last = logits[:, -1]
    toks = []
    for i in range(steps):
        nxt = _pick(last, temperature, generator)
        toks.append(nxt)
        logits, cache = forward_with_cache(params, nxt[:, None], cache,
                                           S0 + i, cfg)
        last = logits[:, -1]
    if not toks:
        return prompt
    return torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)],
                     dim=1)
