"""Card-only cases of the PyTorch port: the CUDA kernels and the paths that
launch them. Every case skips without a CUDA card (decided in the
fixture). The file imports no JAX, so it runs on the card as it is:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: the kernels compute in fp32 and round only their outputs, so
they are held to the plain versions evaluated in fp32 on the same values,
at 1e-4 for fp32 inputs (sums of up to ~1k terms taken in another order)
and 1e-2 (atol and rtol) for bf16 outputs (one bf16 rounding, 2^-8
relative). The bf16 forward with a head dim of 64 or 128 (the wgmma
design) also rounds p to bf16 before P V; tests/test_torch_flash_tiled.py
shows on the CPU that this fits the same 1e-2. The bf16 backward's wgmma
design splits p and ds into bf16 hi + lo halves; its outputs are also held
to chip_smoke.py's bf16 backward bound, 2^-8 |ref| + 1e-3 max|ref|, which
tests/test_torch_flash_bwd_tiled.py shows on the CPU that the split keeps.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_memory_management_tpu_torch.models import gpt
from ray_memory_management_tpu_torch.ops.flash_attention import (
    DKV,
    DQ,
    FWD,
    SIMT,
    WGMMA,
    bwd_design,
    bwd_design_counts,
    flash_attention,
    flash_attention_bwd,
    flash_attention_dkv,
    flash_attention_dkv_simt,
    flash_attention_dq,
    flash_attention_dq_simt,
    flash_attention_fwd,
    flash_attention_fwd_simt,
    fwd_design,
    fwd_design_counts,
    launch_count,
    launch_counts,
    reference_attention,
    reference_delta,
    reference_flash_bwd,
    reset_launch_count,
)
from ray_memory_management_tpu_torch.serve.llm import LLMServer
from ray_memory_management_tpu_torch.utils import gpu_bench
from _port_fixtures import one_intra_op_thread  # noqa: F401

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_RTOL, BWD_ATOL_OF_MAX = 2.0 ** -8, 1e-3  # chip_smoke.py BWD_TOL, bf16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(bh, s, skv, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.normal(size=(bh, n, d)).astype(np.float32)).to(device, dtype)
    return mk(s), mk(skv), mk(skv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,skv,d,causal,bh", [
    (64, 64, 64, True, 3), (200, 200, 64, True, 3), (200, 200, 64, False, 3),
    (64, 200, 64, True, 3), (67, 67, 16, True, 3), (130, 131, 32, False, 3),
    (96, 160, 128, True, 3), (1, 77, 64, True, 3),
    # edges of the wgmma design (bf16, D = 64 or 128): S off the 64-row
    # tile, S < Skv and S > Skv, one query row, D = 128 off the tile, and
    # more CTAs than the card holds at once (2 per SM on 132 SMs)
    (67, 67, 64, True, 3), (1000, 1000, 64, True, 3),
    (1000, 1000, 128, False, 3), (67, 200, 128, True, 3),
    (200, 64, 64, False, 3), (131, 67, 128, False, 3),
    (1, 1, 64, True, 3), (1, 300, 128, False, 3),
    (256, 256, 64, True, 300)])
def test_kernel_matches_plain(cuda, dtype, s, skv, d, causal, bh):
    q, k, v = _qkv(bh, s, skv, d, dtype, cuda)
    reset_launch_count()
    out, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
    torch.cuda.synchronize()
    assert launch_count() == 1
    assert fwd_design_counts()[fwd_design(dtype, d)] == 1
    assert out.dtype == dtype and lse.shape == (bh, s, 1)
    ref = reference_attention(q.float(), k.float(), v.float(), causal)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    scores = (q.float() @ k.float().transpose(1, 2)) * d ** -0.5
    if causal:
        keep = (torch.arange(skv, device=cuda)[None, :]
                <= torch.arange(s, device=cuda)[:, None] + (skv - s))
        scores = scores.masked_fill(~keep, float("-inf"))
    torch.testing.assert_close(lse[..., 0], torch.logsumexp(scores, -1),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype,d,design", [
    (torch.bfloat16, 64, WGMMA), (torch.bfloat16, 128, WGMMA),
    (torch.float32, 64, SIMT), (torch.bfloat16, 32, SIMT)],
    ids=["bf16-d64", "bf16-d128", "fp32-d64", "bf16-d32"])
def test_forward_design_by_dtype_and_head_dim(cuda, dtype, d, design):
    # the count says which design the wrapper expects; the outputs show
    # which one the library ran: the SIMT design gives the same bits as
    # its own symbol, the wgmma design (p rounded to bf16) does not
    q, k, v = _qkv(2, 130, 130, d, dtype, cuda, seed=5)
    reset_launch_count()
    out = flash_attention_fwd(q, k, v, causal=True)
    simt = flash_attention_fwd_simt(q, k, v, causal=True)
    torch.cuda.synchronize()
    other = SIMT if design == WGMMA else WGMMA
    assert fwd_design_counts() == {design: 1, other: 0}
    assert launch_count() == 1  # the SIMT symbol is not counted
    assert torch.equal(out, simt) == (design == SIMT)


def test_four_dim_route_and_count(cuda):
    q, k, v = _qkv(6, 80, 80, 32, torch.bfloat16, cuda, seed=1)
    reset_launch_count()
    out4 = flash_attention(q.view(2, 3, 80, 32), k.view(2, 3, 80, 32),
                           v.view(2, 3, 80, 32), causal=True)
    out3 = flash_attention(q, k, v, causal=True)
    assert launch_count() == 2
    torch.testing.assert_close(out4.reshape(6, 80, 32), out3, rtol=0,
                               atol=0)
    plain = flash_attention(q, k, v, causal=True, use_kernel="off")
    assert launch_count() == 2  # the explicit plain switch launches nothing
    torch.testing.assert_close(out3.float(), plain.float(), atol=3e-2,
                               rtol=3e-2)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(2, 32, 32, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), k, v)
    big = torch.zeros(2, 8, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(big, big, big)
    do = torch.ones_like(q)
    lse = torch.zeros(2, 32, 1, device=cuda)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_bwd(q, k, v, q.cpu(), lse, do)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, q, lse[:, :16], do)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, q, lse, do.bfloat16())
    # an input that requires grad now goes through the backward kernels
    assert flash_attention(q.requires_grad_(), k, v).grad_fn is not None


@pytest.mark.parametrize("dtype,d,design", [
    (torch.bfloat16, 64, WGMMA), (torch.bfloat16, 128, WGMMA),
    (torch.float32, 64, SIMT), (torch.bfloat16, 32, SIMT)],
    ids=["bf16-d64", "bf16-d128", "fp32-d64", "bf16-d32"])
def test_backward_design_by_dtype_and_head_dim(cuda, dtype, d, design):
    # as for the forward: the counts say which design the wrappers expect;
    # the outputs show which one the library ran (the SIMT design gives
    # the same bits as its own symbols, the wgmma design does not)
    q, k, v = _qkv(2, 130, 130, d, dtype, cuda, seed=6)
    do = _qkv(2, 130, 130, d, dtype, cuda, seed=7)[0]
    o, lse = flash_attention_fwd(q, k, v, causal=True, save_lse=True)
    delta = reference_delta(o, do)
    reset_launch_count()
    got = (flash_attention_dq(q, k, v, do, lse, delta),
           *flash_attention_dkv(q, k, v, do, lse, delta))
    simt = (flash_attention_dq_simt(q, k, v, do, lse, delta),
            *flash_attention_dkv_simt(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    assert bwd_design(dtype, d) == design
    other = SIMT if design == WGMMA else WGMMA
    assert bwd_design_counts() == dict.fromkeys((DQ, DKV),
                                                {design: 1, other: 0})
    assert launch_counts() == {FWD: 0, DQ: 1, DKV: 1}  # _simt: not counted
    for name, g, t in zip(("dq", "dk", "dv"), got, simt):
        assert torch.equal(g, t) == (design == SIMT), name


def _within_bwd_bound(got, ref):
    """chip_smoke.py's bf16 backward check: |got - ref| <= 2^-8 |ref| +
    1e-3 max|ref| everywhere. A reference that is exactly 0 everywhere
    (one query row and one key: ds = p (dp - delta) cancels exactly) gives
    that bound no scale, only the order of two fp32 sums; the 1e-2 check
    holds such an output."""
    if not ref.abs().max():
        return True
    limit = BWD_RTOL * ref.abs() + BWD_ATOL_OF_MAX * ref.abs().max()
    return bool(((got.float() - ref).abs() <= limit).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,skv,d,causal", [
    (64, 64, 64, True), (200, 200, 64, True), (200, 200, 64, False),
    (64, 200, 64, True), (67, 67, 16, True), (130, 131, 32, False),
    (96, 160, 128, True), (1, 77, 64, True),
    # edges of the wgmma design (bf16, D = 64 or 128): a ragged last tile
    # of 40 rows, one query row and one key, S > Skv, one query row
    # against 300 keys at D = 128
    (1000, 1000, 64, True), (1, 1, 64, True), (200, 64, 64, False),
    (1, 300, 128, False)])
def test_backward_kernels_match_plain(cuda, dtype, s, skv, d, causal):
    q, k, v = _qkv(3, s, skv, d, dtype, cuda, seed=2)
    do = _qkv(3, s, s, d, dtype, cuda, seed=3)[0]
    o, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
    reset_launch_count()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert launch_counts() == {FWD: 0, DQ: 1, DKV: 1}
    design = bwd_design(dtype, d)
    assert all(c[design] == 1 for c in bwd_design_counts().values())
    want = reference_flash_bwd(q.float(), k.float(), v.float(), o.float(),
                               lse, do.float(), causal)
    tol = TOL[dtype]
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w, atol=tol, rtol=tol,
                                   msg=lambda m: f"d{name}: {m}")
        if design == WGMMA:
            assert _within_bwd_bound(g, w), f"d{name}"


def test_autograd_on_the_card_matches_the_plain_route(cuda):
    q, k, v = (t.requires_grad_() for t in
               _qkv(4, 90, 90, 32, torch.float32, cuda, seed=4))
    do = torch.randn_like(q)
    reset_launch_count()
    out = flash_attention(q.view(2, 2, 90, 32), k.view(2, 2, 90, 32),
                          v.view(2, 2, 90, 32)).reshape(4, 90, 32)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert launch_counts() == {FWD: 1, DQ: 1, DKV: 1}
    want = torch.autograd.grad(
        flash_attention(q, k, v, use_kernel="off"), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_one_train_step_on_the_card(cuda):
    cfg = dataclasses.replace(gpt.PRESETS["test"], attention="flash")
    gen = torch.Generator(cuda).manual_seed(0)
    params = gpt.init_params(cfg, gen, cuda)
    opt = gpu_bench.make_optimizer(params)
    batch = gpu_bench.make_batch(cfg, 2, 100, gen, cuda)
    before = [t.detach().clone() for t in gpt.param_leaves(params)]
    reset_launch_count()
    loss = gpu_bench.train_step(params, opt, batch, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert launch_counts() == dict.fromkeys((FWD, DQ, DKV), cfg.n_layers)
    assert all(not torch.equal(a, b) for a, b in
               zip(before, gpt.param_leaves(params)))


def test_model_forward_kernel_matches_ref(cuda):
    cfg = dataclasses.replace(gpt.PRESETS["test"], dtype=torch.float32)
    params = gpt.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                             cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=cuda)
    reset_launch_count()
    out = gpt.forward(params, toks, cfg)
    assert launch_count() == cfg.n_layers
    ref = gpt.forward(params, toks, dataclasses.replace(cfg,
                                                        attention="ref"))
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_llm_server_on_card_prefills_through_the_kernel(cuda):
    srv = LLMServer(preset="test", max_batch_size=2, max_new_tokens=8)
    try:
        reset_launch_count()
        out = [srv({"tokens": list(range(2, 2 + n))}) for n in (5, 70)]
        stats = srv.stats()
    finally:
        srv.close()
    assert srv.device.type == "cuda"
    assert [len(r["tokens"]) for r in out] == [8, 8]
    assert launch_count() == 2 * srv.cfg.n_layers
    assert stats["kv"]["pages_in_use"] == 0
