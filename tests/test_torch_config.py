"""Every configs/*.yaml loads to equal fields through both packages."""

import dataclasses
import glob
import os

import pytest

from ess_tpu.core.config import load_config as jax_load_config

from ess_tpu_torch.core.config import load_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


YAMLS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                      "configs", "*.yaml")))


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_loads_equal_fields(path):
    got, want = load_config(path), jax_load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.train_input_size_b == want.train_input_size_b
    assert got.val_input_size_b == want.val_input_size_b
    assert (got.dataset.sensor_b.input_channels
            == want.dataset.sensor_b.input_channels)
    assert got.task.class_names == want.task.class_names
    assert (got.task.color_map == want.task.color_map).all()


def test_defaults_equal():
    assert dataclasses.asdict(load_config({})) == dataclasses.asdict(
        jax_load_config({}))
