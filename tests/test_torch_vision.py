"""PyTorch port vs JAX package: the vision models (ResNet, ViT), on the CPU.

The flax models' weights (and ResNet's batch statistics) cross into the
port through ``convert.resnet_state_from_flax`` / ``vit_state_from_flax``
(HWIO -> OIHW, NHWC images -> NCHW), and both sides take one training
forward and backward on the same batch from a numpy seed: the logits, the
loss, every gradient and (ResNet) the new batch statistics are compared.

- fp32: the loss to 1e-5 relative, the logits, the statistics and each
  gradient to 1e-4 of that array's largest value. ViT's key-projection
  bias has an exact gradient of 0 (the softmax ignores a shift shared by
  every key), so both sides' are rounding noise: it is held to 1e-6 of
  the tree's largest gradient instead.
- bf16: the port rounds where flax rounds, but not always alike (PyTorch
  takes a bf16 softmax and GELU with one rounding, JAX with one a step;
  a bf16 conv or matmul may sum in another order), and BatchNorm over a
  few positions amplifies a rounding. So each array is held to a multiple
  of the JAX model's own bf16 rounding distance (its bf16 run against
  its fp32 run, array by array, as ``chip_smoke.py`` phase 4 holds the
  kernels): twice it for ResNet, three times for ViT, whose softmax and
  GELU round more steps in JAX. The JAX side is compiled with XLA's
  ``xla_allow_excess_precision`` off, so that it rounds to bf16 wherever
  the model says bf16, as its op-by-op run does (XLA otherwise keeps some
  fused bf16 values in fp32, which moves the stem conv's gradient three
  times closer to fp32 than the model's own arithmetic).

ResNet runs at 32x32 (fp32 and bf16), where every stride-2 "SAME" window
pads (0, 1), and at 37x37 (fp32), where the 3x3 max pool and the
stride-2 convs of stages 3 and 4 see odd inputs and pad (1, 1). Copied from ``tests/test_models.py``:
``test_resnet_trains``, ``TestViT::test_forward_shape_and_params`` and
``::test_trains``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_memory_management_tpu.models import resnet as jresnet
from ray_memory_management_tpu.models import vit as jvit
from ray_memory_management_tpu_torch.models import resnet, vit
from ray_memory_management_tpu_torch.models.convert import (
    resnet_state_from_flax,
    vit_state_from_flax,
)
from ray_memory_management_tpu_torch.models.layers import same_pads
from _port_fixtures import one_intra_op_thread  # noqa: F401

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
RESNET_CASES = [(32, "fp32"), (32, "bf16"), (37, "fp32")]
FLOOR_FACTOR = {"resnet": 2.0, "vit": 3.0}


def _run(fn, *args):
    """``fn(*args)`` compiled by XLA with bf16 rounded where the program
    says bf16 (no excess precision)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _images(size, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, 8))


def _port_batch(img, lab):
    return {"image": torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
            "label": torch.from_numpy(lab)}


def _f64(t):
    return (t.detach().double().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float64))


@pytest.fixture(scope="module")
def resnet_runs():
    """{(size, dtype): (flax side, port side)}; each side is (loss,
    logits, {name: grad}, {name: new statistic}) under the port's names."""
    out = {}
    # the weights depend on neither the compute dtype nor the image size
    params, stats = jax.jit(lambda key: jresnet.init_resnet(
        jresnet.ResNet((1, 1, 1, 1), 10), key, (32, 32, 3)))(
            jax.random.PRNGKey(0))
    for size, dt in RESNET_CASES:
        jdt, tdt = DTYPES[dt]
        img, lab = _images(size, size)
        model = jresnet.ResNet((1, 1, 1, 1), 10, jdt)
        batch = {"image": jnp.asarray(img), "label": jnp.asarray(lab)}
        ((loss, new_stats), grads), (logits, _) = _run(lambda p: (
            jax.value_and_grad(
                lambda q: jresnet.resnet_loss_fn(model, q, stats, batch),
                has_aux=True)(p),
            model.apply({"params": p, "batch_stats": stats},
                        batch["image"], train=True,
                        mutable=["batch_stats"])), params)
        flax_side = (float(loss), np.asarray(logits.astype(jnp.float32)),
                     resnet_state_from_flax(jax.tree.map(np.asarray, grads),
                                            {}),
                     resnet_state_from_flax(
                         {}, jax.tree.map(np.asarray, new_stats)))
        port = resnet.ResNet((1, 1, 1, 1), 10, tdt)
        port.load_state_dict(resnet_state_from_flax(
            jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)),
            strict=True)
        start = {k: v.clone() for k, v in port.state_dict().items()}
        pb = _port_batch(img, lab)
        loss_t, stats_t = resnet.resnet_loss_fn(port, pb)
        loss_t.backward()
        port.load_state_dict(start)  # the logits from the same statistics
        with torch.no_grad():
            logits_t = port(pb["image"], train=True)
        port_side = (float(loss_t.detach()), _f64(logits_t),
                     {k: p.grad for k, p in port.named_parameters()},
                     stats_t)
        out[size, dt] = (flax_side, port_side)
    return out


@pytest.fixture(scope="module")
def vit_runs():
    out = {}
    img, lab = _images(32, 1)
    batch = {"image": jnp.asarray(img), "label": jnp.asarray(lab)}
    params = jax.jit(lambda key: jvit.init_vit(
        jvit.PRESETS["vit-tiny-test"], key)[1])(jax.random.PRNGKey(0))
    for dt, (jdt, tdt) in DTYPES.items():
        cfg = dataclasses.replace(jvit.PRESETS["vit-tiny-test"], dtype=jdt)
        model = jvit.ViT(cfg)
        (loss, grads), logits = _run(lambda p: (
            jax.value_and_grad(lambda q: jvit.vit_loss_fn(model, q, batch))(p),
            model.apply({"params": p}, batch["image"])), params)
        flax_side = (float(loss), np.asarray(logits),
                     vit_state_from_flax(jax.tree.map(np.asarray, grads)))
        port = vit.ViT(dataclasses.replace(vit.PRESETS["vit-tiny-test"],
                                           dtype=tdt))
        port.load_state_dict(vit_state_from_flax(
            jax.tree.map(np.asarray, params)), strict=True)
        pb = _port_batch(img, lab)
        loss_t = vit.vit_loss_fn(port, pb)
        loss_t.backward()
        with torch.no_grad():
            logits_t = port(pb["image"])
        out[dt] = (flax_side, (float(loss_t.detach()), _f64(logits_t),
                               {k: p.grad
                                for k, p in port.named_parameters()}))
    return out


def _hold_fp32(got, want, name, atol_of_max=1e-4):
    got, want = _f64(got), _f64(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol_of_max * np.abs(want).max(),
                               err_msg=name)


def _hold_bf16(got, want16, want32, name, factor):
    got, want16, want32 = _f64(got), _f64(want16), _f64(want32)
    err = np.abs(got - want16).max()
    floor = np.abs(want16 - want32).max()
    assert err <= factor * floor, (name, err, floor)


@pytest.mark.parametrize("size,dt", RESNET_CASES,
                         ids=[f"{s}-{d}" for s, d in RESNET_CASES])
def test_resnet_matches_flax(resnet_runs, size, dt):
    (f_loss, f_logits, f_grads, f_stats), (loss, logits, grads, stats) = \
        resnet_runs[size, dt]
    assert set(grads) == set(f_grads) and set(stats) == set(f_stats)
    assert logits.shape == (8, 10)
    if dt == "fp32":
        np.testing.assert_allclose(loss, f_loss, rtol=1e-5)
        _hold_fp32(logits, f_logits, "logits")
        for name in f_grads:
            _hold_fp32(grads[name], f_grads[name], name)
        for name in f_stats:
            _hold_fp32(stats[name], f_stats[name], name)
        return
    (g_loss, g_logits, g_grads, g_stats), _ = resnet_runs[size, "fp32"]
    k = FLOOR_FACTOR["resnet"]
    _hold_bf16(np.float64(loss), f_loss, g_loss, "loss", k)
    _hold_bf16(logits, f_logits, g_logits, "logits", k)
    for name in f_grads:
        _hold_bf16(grads[name], f_grads[name], g_grads[name], name, k)
    for name in f_stats:
        _hold_bf16(stats[name], f_stats[name], g_stats[name], name, k)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_vit_matches_flax(vit_runs, dt):
    (f_loss, f_logits, f_grads), (loss, logits, grads) = vit_runs[dt]
    assert set(grads) == set(f_grads)
    top = max(np.abs(_f64(g)).max() for g in f_grads.values())
    if dt == "fp32":
        np.testing.assert_allclose(loss, f_loss, rtol=1e-5)
        _hold_fp32(logits, f_logits, "logits")
        for name in f_grads:
            if name.endswith("SelfAttention_0.key.bias"):
                for g in (grads[name], f_grads[name]):
                    assert np.abs(_f64(g)).max() <= 1e-6 * top, name
            else:
                _hold_fp32(grads[name], f_grads[name], name)
        return
    (g_loss, g_logits, g_grads), _ = vit_runs["fp32"]
    k = FLOOR_FACTOR["vit"]
    _hold_bf16(np.float64(loss), f_loss, g_loss, "loss", k)
    _hold_bf16(logits, f_logits, g_logits, "logits", k)
    for name in f_grads:
        _hold_bf16(grads[name], f_grads[name], g_grads[name], name, k)


def test_same_padding_is_xlas():
    """XLA's SAME split: (0, 1) for a stride-2 3x3 window on an even
    length, (1, 1) on an odd one, nothing for a 1x1 or a whole patch."""
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(19, 3, 2) == (1, 1)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(224, 16, 16) == (0, 0)
    for n, k, s in ((112, 3, 2), (19, 3, 2), (7, 3, 2), (224, 16, 16)):
        lo, hi = same_pads(n, k, s)
        assert (n + lo + hi - k) // s + 1 == -(-n // s)


def test_an_unmapped_flax_leaf_raises():
    with pytest.raises(ValueError, match="no port leaf"):
        resnet_state_from_flax({"Conv_0": {"kernel": np.zeros((3, 3, 3))}},
                               {})
    with pytest.raises(ValueError, match="no port leaf"):
        vit_state_from_flax({"block_0": {"extra": np.zeros((2, 2, 2))}})


# ------------------------------ copies of tests/test_models.py (vision)
def test_resnet_trains():
    model = resnet.init_resnet(resnet.resnet18_like(num_classes=10),
                               torch.Generator().manual_seed(0), "cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = resnet.make_resnet_train_step(model, opt)
    gen = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(8, 3, 32, 32, generator=gen),
             "label": torch.randint(0, 10, (8,), generator=gen)}
    losses = [float(step(batch)) for _ in range(4)]
    assert losses[-1] < losses[0]


class TestViT:
    def test_forward_shape_and_params(self):
        cfg = vit.PRESETS["vit-tiny-test"]
        model = vit.init_vit(cfg, torch.Generator().manual_seed(0), "cpu")
        images = torch.randn(4, 3, 32, 32,
                             generator=torch.Generator().manual_seed(1))
        logits = model(images)
        assert logits.shape == (4, 10)
        assert logits.dtype == torch.float32  # fp32 head
        # sanity: tokens = patches + cls
        assert model.pos_embed.shape == (1, cfg.n_patches + 1, cfg.d_model)

    def test_trains(self):
        cfg = vit.PRESETS["vit-tiny-test"]
        model = vit.init_vit(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        step = vit.make_vit_train_step(model, opt)
        gen = torch.Generator().manual_seed(2)
        batch = {"image": torch.randn(8, 3, 32, 32, generator=gen),
                 "label": torch.randint(0, 10, (8,), generator=gen)}
        losses = [float(step(batch)) for _ in range(5)]
        assert losses[-1] < losses[0]
