"""The port's reference-format loaders (``ess_tpu_torch.io.convert``)
against the JAX package's: an upstream-format state dict, built here with
``module.`` prefixes from random values, loads into the port's modules and
through the JAX loaders, and ``params_from_jax`` / ``front_from_jax`` of
the JAX result equals the port's state dict exactly. A missing or an
unexpected key raises.

The config is ``tiny_config('ess')`` (E2VID base 8, so a 16-wide image
front): the loaders map names and layouts, whatever the widths.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ess_tpu.io import convert as jax_convert
from ess_tpu.train.builder import build_modules as jax_build
from ess_tpu.train.builder import init_state as jax_init_state

from ess_tpu_torch.io import convert
from ess_tpu_torch.train.builder import build_modules
from tests.test_torch_eval_step import port_config
from tests.test_train_steps import tiny_config
from tests.test_torch_loop import one_torch_thread

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config("ess")
    state = jax.device_get(jax_init_state(jax_build(cfg),
                                          jax.random.PRNGKey(0)))
    return cfg, state


def port_mods(cfg):
    return build_modules(port_config(cfg), device="cpu")


def randomized(sd, seed):
    """The state dict's keys and shapes with random values (integer
    counters kept at 0)."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if v.is_floating_point()
                else torch.zeros_like(v)) for k, v in sd.items()}


def prefixed(sd, prefix="module."):
    return {prefix + k: v for k, v in sd.items()}


def assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].float(), v.float()), k


def head_reference(cfg):
    return randomized(port_mods(cfg).head.state_dict(), 2)


def e2vid_checkpoint(cfg, path):
    """An upstream E2VID ``.pth.tar`` of the config's geometry."""
    sd = randomized(port_mods(cfg).e2vid.state_dict(), 1)
    torch.save({"model": {"num_encoders": 3, "num_residual_blocks": 2},
                "state_dict": prefixed(prefixed(sd, "unetrecurrent."))},
               path)
    return sd


def test_e2vid_and_head_match_jax(setup, tmp_path):
    cfg, state = setup
    path = str(tmp_path / "e2vid.pth.tar")
    want_e2vid = e2vid_checkpoint(cfg, path)
    head_src = prefixed(head_reference(cfg))

    mods = port_mods(cfg)
    got_e2vid, config = convert.load_e2vid_checkpoint(path, mods.e2vid)
    assert config == {"num_encoders": 3, "num_residual_blocks": 2}
    assert_state_equal(got_e2vid, want_e2vid)
    assert_state_equal(mods.e2vid.state_dict(), want_e2vid)
    convert.load_semseg_head_torch(head_src, mods.head)

    jax_e2vid, _ = jax_convert.load_e2vid_checkpoint(path)
    jax_head = jax_convert.load_semseg_head_torch(head_src, state.back_params)
    e2vid_sd, head_sd = convert.params_from_jax(jax_e2vid, jax_head)
    assert_state_equal(mods.e2vid.state_dict(), e2vid_sd)
    assert_state_equal(mods.head.state_dict(), head_sd)


def resnet_reference(front_sd, seed=3):
    """A torchvision-resnet18-format state dict of the front's widths: a
    3-channel stem, and the layer4 and fc the front has no use for."""
    sd = randomized(front_sd, seed)
    w = sd["conv1.weight"].shape[0]
    g = torch.Generator().manual_seed(seed + 1)
    sd["conv1.weight"] = torch.randn((w, 3, 7, 7), generator=g)
    sd["layer4.0.conv1.weight"] = torch.randn((8 * w, 4 * w, 3, 3),
                                              generator=g)
    sd["fc.weight"] = torch.randn((1000, 8 * w), generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("adapt_stem", [False, True])
def test_resnet18_matches_jax(setup, adapt_stem):
    cfg, state = setup
    mods = port_mods(cfg)
    template = convert.front_from_jax(state.front_params,
                                      state.front_batch_stats)
    mods.front_a.load_state_dict(template)
    src = resnet_reference(mods.front_a.state_dict())
    convert.load_resnet18_torch(prefixed(src), mods.front_a,
                                adapt_stem=adapt_stem)
    got = mods.front_a.state_dict()
    stem = (src["conv1.weight"].mean(1, keepdim=True) if adapt_stem
            else template["conv1.weight"])
    assert torch.equal(got["conv1.weight"], stem)
    for k, v in got.items():
        if k != "conv1.weight":
            assert torch.equal(v.float(), src[k].float()), k

    params, stats = jax_convert.load_resnet18_torch(
        prefixed(src), state.front_params, state.front_batch_stats,
        adapt_stem=adapt_stem)
    want = convert.front_from_jax(params, stats)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), v.float().numpy(),
                                   rtol=0, atol=1e-7 if k == "conv1.weight"
                                   else 0, err_msg=k)


STYLE = (("conv1.", "encoder_scale_1.0."), ("bn1.", "encoder_scale_1.1."),
         ("layer1.", "encoder_scale_1.3."), ("layer2.", "encoder_scale_2."),
         ("layer3.", "encoder_scale_3."))


def style_reference(front_sd):
    out = {}
    for k, v in randomized(front_sd, 5).items():
        for new, old in STYLE:
            if k.startswith(new):
                out[old + k[len(new):]] = v
    return out


def test_style_encoder_matches_jax(setup):
    cfg, state = setup
    mods = port_mods(cfg)
    src = style_reference(mods.front_a.state_dict())
    convert.load_style_encoder_torch(prefixed(src), mods.front_a)
    params, stats = jax_convert.load_style_encoder_torch(
        prefixed(src), state.front_params, state.front_batch_stats)
    assert_state_equal(mods.front_a.state_dict(),
                       convert.front_from_jax(params, stats))
    assert torch.equal(mods.front_a.state_dict()["conv1.weight"],
                       src["encoder_scale_1.0.weight"])


def test_strip_module_prefix_matches_jax():
    sd = {"module.a.b": 1, "c": 2, "module.module.d": 3, "x.module.e": 4}
    assert convert.strip_module_prefix(sd) == \
        jax_convert.strip_module_prefix(sd)


@pytest.mark.parametrize("what", ["e2vid", "head", "resnet18", "style"])
@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_bad_keys_raise(setup, tmp_path, what, fault):
    cfg, _ = setup
    mods = port_mods(cfg)
    if what == "e2vid":
        sd = randomized(mods.e2vid.state_dict(), 1)
    elif what == "head":
        sd = head_reference(cfg)
    elif what == "resnet18":
        sd = resnet_reference(mods.front_a.state_dict())
    else:
        sd = style_reference(mods.front_a.state_dict())
    victim = sorted(k for k in sd if k.endswith("weight")
                    and "fc" not in k and "layer4" not in k)[-1]
    if fault == "missing":
        del sd[victim]
    elif fault == "unexpected":
        sd[("encoder_scale_2." if what == "style" else "") + "extra.weight"] \
            = torch.zeros(3)
    else:
        sd[victim] = torch.zeros(1, 2, 3)
    err = KeyError if fault != "shape" else (ValueError, RuntimeError)
    with pytest.raises(err):
        if what == "e2vid":
            path = str(tmp_path / "e.pth.tar")
            torch.save({"model": {}, "state_dict": prefixed(
                prefixed(sd, "unetrecurrent."))}, path)
            convert.load_e2vid_checkpoint(path)
        elif what == "head":
            convert.load_semseg_head_torch(prefixed(sd), mods.head)
        elif what == "resnet18":
            convert.load_resnet18_torch(prefixed(sd), mods.front_a)
        else:
            convert.load_style_encoder_torch(prefixed(sd), mods.front_a)


def test_plain_head_is_not_built(setup):
    """The plain head (``skip_connect_task=False``) is built only as the
    plain head: an upstream plain ``SemSegE2VID`` state dict loads into it
    as JAX's ``load_semseg_head_torch(skip_connect=False)`` maps it (every
    parameter equal through ``params_from_jax``), and a state dict of one
    kind does not load into a head of the other."""
    cfg, state = setup
    plain = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  skip_connect_task=False))
    jstate = jax.device_get(jax_init_state(jax_build(plain),
                                           jax.random.PRNGKey(1)))
    mods = port_mods(plain)
    src = prefixed(randomized(mods.head.state_dict(), 4))
    assert any(k.startswith("module.decoder_scale_4.1.") for k in src)
    convert.load_semseg_head_torch(src, mods.head, skip_connect=False)
    jax_head = jax_convert.load_semseg_head_torch(
        src, jstate.back_params, skip_connect=False)
    _, head_sd = convert.params_from_jax(jstate.e2vid_params, jax_head)
    assert_state_equal(mods.head.state_dict(), head_sd)
    with pytest.raises(ValueError, match="skip_connect"):
        convert.load_semseg_head_torch(src, port_mods(cfg).head,
                                       skip_connect=False)
    with pytest.raises(ValueError, match="skip_connect"):
        convert.load_semseg_head_torch(prefixed(head_reference(cfg)),
                                       mods.head)
