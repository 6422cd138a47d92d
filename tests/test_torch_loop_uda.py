"""The port's ``Trainer`` against the JAX ``Trainer`` on ESS UDA, on the
CPU: ``tests/test_torch_loop.py``'s comparison (its docstring gives the
setup and the bounds) with the image loaders and the ResNet18 front, in a
file of its own so that it runs beside the supervised one."""

import pytest

from tests.test_torch_loop import check_pair, one_torch_thread, run_pair

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)


def test_uda_run_matches_jax(tmp_path):
    jtr, want, tr, got = run_pair(tmp_path, "ess")
    check_pair(jtr, want, tr, got)
    for k in ("semseg_sensor_a_mean_iou", "semseg_sensor_b_mean_iou",
              "semseg_sensor_cycle_mean_iou"):
        assert k in got
    # the front's batch norms ran in train mode: 2 passes a step
    assert int(tr.state.front.bn1.num_batches_tracked) == 2 * 6
