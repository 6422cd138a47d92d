"""The image front: the port's ``ResNet18Encoder`` against JAX
``ess_tpu.models.resnet.ResNet18Encoder`` with the same weights
(``front_from_jax``).

Two geometries: 24x32, where the JAX encoder runs its stem and layer1 in
2x2 block space (H and W divide by 4), and 18x22, where it runs them as
plain convs; base width 16, B=2, f32, seeded JAX init with the batch-norm
parameters and running statistics set away from 1 and 0 so each of them
counts. Train mode normalizes with batch statistics and updates the
running ones (torch's unbiased running variance in both), eval mode reads
the running ones.

Bounds: latents atol 2e-5 (same f32 math, other summation orders and, in
block space, another conv formulation); running statistics after one
train pass atol 1e-5 / rtol 1e-5. The bf16 front (f32 parameters and
statistics) against the f32 one: latents within 5 % of their absmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.models.resnet import ResNet18Encoder as JaxEncoder

from ess_tpu_torch.io.convert import front_from_jax
from ess_tpu_torch.models.layers import BatchNorm2d
from ess_tpu_torch.models.resnet import ResNet18Encoder


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


WIDTH = 16


def jax_front(hw, seed=0):
    """A JAX encoder, its variables with perturbed BN tensors, and one
    seeded NHWC input batch."""
    enc = JaxEncoder(base_width=WIDTH)
    x = np.random.default_rng(seed).normal(size=(2, *hw, 1)).astype(
        np.float32)
    variables = jax.device_get(enc.init(jax.random.PRNGKey(seed),
                                        jnp.asarray(x)))
    rng = np.random.default_rng(seed + 1)
    perturb = lambda tree, lo, hi: jax.tree.map(
        lambda a: (a + rng.uniform(lo, hi, a.shape)).astype(np.float32),
        tree)
    params = dict(variables["params"])
    for name, p in params.items():
        params[name] = {k: perturb(v, -0.2, 0.2) if "bn" in k else v
                        for k, v in p.items()}
    stats = perturb(variables["batch_stats"], 0.0, 0.5)
    return enc, params, stats, x


def port_front(params, stats, dtype=torch.float32):
    front = ResNet18Encoder(base_width=WIDTH, dtype=dtype)
    front.load_state_dict(front_from_jax(params, stats))
    return front


@pytest.mark.parametrize("hw", [(24, 32), (18, 22)], ids=["block", "plain"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_matches_jax(hw, train):
    enc, params, stats, x = jax_front(hw)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, mut = enc.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        want_stats = front_from_jax(params, jax.device_get(
            mut["batch_stats"]))
    else:
        want = enc.apply(variables, jnp.asarray(x), train=False)
    front = port_front(params, stats)
    before = {k: v.clone() for k, v in front.state_dict().items()}
    with torch.no_grad():
        got = front(torch.from_numpy(x).permute(0, 3, 1, 2), train=train)

    assert sorted(got) == [1, 2, 4, 8]
    for s in (2, 4, 8):
        assert got[s].shape == (2, WIDTH * s // 2, -(-hw[0] // s),
                                -(-hw[1] // s))
    np.testing.assert_array_equal(got[1].permute(0, 2, 3, 1).numpy(), x)
    for s in (2, 4, 8):
        np.testing.assert_allclose(got[s].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[s]), atol=2e-5, err_msg=s)
    for k, v in front.state_dict().items():
        if "running" not in k:
            continue
        if train:
            np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
            assert not torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, before[k]), k


def test_state_dict_names_are_torchvision():
    """The front's state dict has torchvision resnet18's names (without
    the max-pool, layer4 and fc it does not have), all of which
    ``front_from_jax`` fills."""
    enc, params, stats, _ = jax_front((24, 32))
    front = port_front(params, stats)
    keys = set(front.state_dict())
    assert keys == set(front_from_jax(params, stats))
    assert {"conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
            "layer2.0.downsample.0.weight", "layer2.0.downsample.1.bias",
            "layer3.1.bn2.num_batches_tracked"} <= keys
    assert not any(k.startswith("layer1.0.downsample") for k in keys)
    assert not any(k.startswith(("layer4", "fc", "maxpool")) for k in keys)


def test_skip_connect_off_returns_scale_8_only():
    enc, params, stats, x = jax_front((24, 32))
    front = ResNet18Encoder(base_width=WIDTH, skip_connect=False)
    front.load_state_dict(front_from_jax(params, stats))
    want = JaxEncoder(base_width=WIDTH, skip_connect=False).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = front(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == [1, 8]
    np.testing.assert_allclose(got[8].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[8]), atol=2e-5)


def test_bf16_front_normalizes_in_f32():
    """In bf16 the convs run in bf16 while every batch norm normalizes in
    f32 with f32 parameters and statistics, then casts back."""
    _, params, stats, x = jax_front((24, 32))
    f32, bf16 = port_front(params, stats), port_front(params, stats,
                                                      torch.bfloat16)
    img = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = f32(img, train=True)
        got = bf16(img, train=True)
    for s in (2, 4, 8):
        assert got[s].dtype == torch.bfloat16
        err = (got[s].float() - want[s]).abs().max()
        assert err <= 0.05 * want[s].abs().max(), (s, float(err))
    for mod in bf16.modules():
        if isinstance(mod, BatchNorm2d):
            assert mod.running_mean.dtype == mod.weight.dtype == torch.float32
    bn = bf16.bn1
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               f32.bn1.running_mean.numpy(), rtol=0.02,
                               atol=0.02)
