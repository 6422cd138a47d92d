"""The port's training-sanity tool (``ess_tpu_torch/tools/sanity_train.py``)
against the JAX package's ``tools/sanity_train.py``, on the CPU.

- ``make_scene_batch`` gives the JAX tool's batch for one seed at a small
  size (B=2, T=2, 3000 events on 48x64, 4 classes, 8 rows cropped): every
  column, the tile offsets and the labels equal (the host tile binning of
  both packages is the same native code).
- ``overfit`` runs its train and eval steps on the CPU at the tool's DSEC
  geometry with a narrow model (base 8, B=1, T=2, 2000 events), on the
  exact and int8 train cells and the histogram representation: finite
  losses and an mIoU in [0, 100]. Whether the loss falls is the card's
  check (``chip_smoke.py`` phase 5g): it needs the full batch.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ess_tpu_torch.tools import sanity_train
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread

_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

JAX_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "sanity_train.py")


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_sanity_train",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scene_batch_matches_jax():
    args = (2, 2, 3000, 48, 64, 4, 8)
    want = jax_tool().make_scene_batch(np.random.default_rng(5), *args)
    got = sanity_train.make_scene_batch(np.random.default_rng(5), *args)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert got["label"].shape == (2, 40, 64)
    assert set(np.unique(got["label"])) == {0, 1, 2, 3}


@pytest.mark.parametrize("lstm_impl_train,representation", [
    (None, "voxel_grid"), ("pallas_int8", "voxel_grid"),
    ("pallas_int8", "histogram")])
def test_overfit_runs_on_cpu(lstm_impl_train, representation):
    cfg = sanity_train.sanity_config(lstm_impl_train=lstm_impl_train,
                                     representation=representation, b=1,
                                     t=2, n=2000, classes=4, base=8)
    host = sanity_train.make_scene_batch(
        np.random.default_rng(0), 1, 2, 2000, sanity_train.SENSOR_H,
        sanity_train.SENSOR_W, 4, sanity_train.CROP_BOTTOM)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in host.items()}
    lines = []
    losses, miou = sanity_train.overfit(cfg, batch, 2, device="cpu",
                                        log=lines.append)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert 0.0 <= miou <= 100.0
    assert lines == [f"step   0: loss {losses[0]:.4f}",
                     f"step   1: loss {losses[1]:.4f}"]
