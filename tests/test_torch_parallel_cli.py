"""Data parallel through the train CLI and the loaders, on the CPU.

``cli.train.main([... "--num_devices", "2"], device="cpu")`` starts two
gloo ranks on ``tests/test_torch_cli.py``'s DDD17 tree and YAML, with the
batch of the 10 training samples (one step an epoch, so the JSONL's
per-epoch train loss is the step's) for two epochs, validating before the
first and after the last:

- its per-step losses and its checkpoints' state equal ``--num_devices
  0``'s within 1e-5 (relative; a parameter within 1e-5 of its tensor's
  largest magnitude plus 1e-6, as ``tests/test_torch_parallel.py`` bounds
  the steps), and its last validation's mIoU and accuracy within 1e-4
  (relative): after two updates the parameters differ by ~1e-7, which
  flips the argmax of a few of the 140,800 validation pixels (4.9e-5 seen);
- one JSONL, written once (rank 0), and one set of checkpoints;
- resumed from the first epoch's checkpoint, the second epoch equals the
  uninterrupted run's within the same bound. The resumed epoch restarts
  its shuffle, as the JAX Trainer's does, so its batch holds the same
  samples in another order and other rows a rank; the step-level
  continuation is held bit for bit by ``test_dp_checkpoint_resume``.

The loaders: a loader's rows on each rank concatenate to the one-device
batch, in order, for shuffled, partial and paired batches. And
``parallel.multihost.initialize`` raises on explicit arguments that cannot
join.
"""

import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

from ess_tpu_torch.data.loader import BatchLoader, PairedLoader
from tests.test_torch_cli import summary_lines, tree, yaml_for  # noqa: F401
from tests.test_torch_loop import one_torch_thread

pytest.importorskip("cv2")

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

REL, ATOL = 1e-5, 1e-6
SUMMARY = 1e-4   # the last validation's mIoU and accuracy (docstring)
EDITS = {"batch_size_b: 2": "batch_size_b: 10", "num_epochs: 1":
         "num_epochs: 2", "val_epoch_step: 1": "val_epoch_step: 2",
         "save_checkpoint: False": "save_checkpoint: True"}


@contextlib.contextmanager
def all_stdout(out: io.StringIO):
    """Collect what this process prints and what the ranks it starts
    write to the standard output they inherit (file descriptor 1)."""
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile("w+") as f:
        os.dup2(f.fileno(), 1)
        try:
            with contextlib.redirect_stdout(out):
                yield
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            out.write(f.read())


def run_cli(tmp, tree, name, num_devices, edits=None):
    """(run directory, stdout) of one CLI run, its ranks' output included."""
    from ess_tpu_torch.cli import train

    path = yaml_for(tmp, tree, name, edits={**EDITS, **(edits or {})})
    out = io.StringIO()
    with all_stdout(out):
        train.main(["--settings_file", path, "--num_devices",
                    str(num_devices)], device="cpu")
    logs = os.path.join(str(tmp), f"logs_{name}")
    (run,) = os.listdir(logs)
    return os.path.join(logs, run), out.getvalue()


def records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def losses(run):
    return [r["train/loss"] for r in records(run) if "train/loss" in r]


def head(run, key):
    blob = torch.load(os.path.join(run, "checkpoints", str(key), "state.pt"),
                      weights_only=True)
    return blob["head"], blob["opt_back"]["step_count"]


def close_heads(got, want):
    for k, v in want.items():
        if v.is_floating_point():
            bound = REL * float(v.abs().max()) + ATOL
            assert float((got[k] - v).abs().max()) <= bound, k
        else:
            assert torch.equal(got[k], v), k


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    """No TensorBoard writer in this module's runs: where TensorFlow is
    installed, its import costs a freshly spawned rank ~12 s a run."""
    saved = os.environ.get("ESS_TENSORBOARD")
    os.environ["ESS_TENSORBOARD"] = "0"
    yield
    if saved is None:
        del os.environ["ESS_TENSORBOARD"]
    else:
        os.environ["ESS_TENSORBOARD"] = saved


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, tree):
    tmp = tmp_path_factory.mktemp("dp_cli")
    one = run_cli(tmp, tree, "one.yaml", 0)
    two = run_cli(tmp, tree, "two.yaml", 2)
    return tmp, one, two


def test_dp_cli_matches_one_device(cli_runs):
    _, (run1, out1), (run2, out2) = cli_runs
    got, want = losses(run2), losses(run1)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=REL)
    s1, s2 = summary_lines(out1), summary_lines(out2)
    assert sorted(s1) == sorted(s2) and s1
    for k, v in s1.items():
        np.testing.assert_allclose(float(s2[k]), float(v), rtol=SUMMARY,
                                   err_msg=k)
    for key in (0, 1):
        (h2, n2), (h1, n1) = head(run2, key), head(run1, key)
        assert n1 == n2 == key + 1
        close_heads(h2, h1)


def test_dp_cli_writes_once(cli_runs):
    _, (run1, out1), (run2, out2) = cli_runs
    names = lambda run: sorted(n for n in os.listdir(run)
                               if not n.startswith("events.out"))
    assert names(run2) == [n.replace("one", "two") for n in names(run1)]
    assert sum(n.startswith("events.out") for n in os.listdir(run2)) <= 1
    assert sorted(os.listdir(os.path.join(run2, "checkpoints"))) == ["0", "1"]
    tags = lambda run: [sorted(r) for r in records(run)]
    assert tags(run2) == tags(run1)
    assert out2.count("back_end") == out1.count("back_end") == 1


def test_dp_cli_resume(cli_runs, tree):
    tmp, _, (run2, _) = cli_runs
    half = str(tmp / "half")
    shutil.copytree(run2, half)
    shutil.rmtree(os.path.join(half, "checkpoints", "1"))
    run3, out3 = run_cli(tmp, tree, "resume.yaml", 2, edits={
        "resume_training: False": "resume_training: True",
        "resume_file: ''": f"resume_file: '{half}'"})
    assert "resumed from checkpoint 0 (epoch 1, step 1)" in out3
    np.testing.assert_allclose(losses(run3), losses(run2)[1:], rtol=REL)
    (h3, n3), (h2, n2) = head(run3, 1), head(run2, 1)
    assert n3 == n2 == 2
    close_heads(h3, h2)


class Samples:
    """A map-style dataset of numbered samples."""

    def __init__(self, n, offset=0):
        self.n, self.offset = n, offset

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i + self.offset, np.float32),
                "i": np.int64(i + self.offset)}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_rows_concatenate_to_the_batch(world, drop_last):
    def batches(replica, b=6):
        # drop_last drops a partial batch; else a last batch of N rows
        n = 2 * b - 1 if drop_last else b + world
        return list(BatchLoader(Samples(n), b, shuffle=True, seed=3,
                                drop_last=drop_last, num_workers=2,
                                replica=replica))

    one = batches((0, 1))
    ranks = [batches((r, world)) for r in range(world)]
    assert all(len(r) == len(one) == (1 if drop_last else 2) for r in ranks)
    for i, want in enumerate(one):
        for key in want:
            got = np.concatenate([r[i][key] for r in ranks])
            np.testing.assert_array_equal(got, want[key])
        assert [len(r[i]["i"]) for r in ranks] == \
            [len(want["i"]) // world] * world

    paired = lambda rep: list(PairedLoader(
        BatchLoader(Samples(4 * world, 100), 2 * world, seed=1,
                    replica=rep),
        BatchLoader(Samples(9), 2 * world, seed=2, replica=rep)))
    one = paired((0, 1))
    ranks = [paired((r, world)) for r in range(world)]
    for i, (a, b) in enumerate(one):
        np.testing.assert_array_equal(
            np.concatenate([r[i][0]["i"] for r in ranks]), a["i"])
        np.testing.assert_array_equal(
            np.concatenate([r[i][1]["i"] for r in ranks]), b["i"])


def test_loader_refuses_an_uneven_batch():
    """A last partial batch that does not divide over the ranks raises,
    as the JAX package's mesh sharding does; so does ``dp.shard_batch``
    on a world of 3 given 4 rows."""
    from ess_tpu_torch.parallel import dp

    loader = BatchLoader(Samples(10), 6, shuffle=False, drop_last=False,
                         replica=(0, 3))
    it = iter(loader)
    next(it)
    with pytest.raises(ValueError, match="does not divide over 3"):
        next(it)
    with pytest.raises(ValueError, match="does not divide over 3"):
        dp.check_divides(4, 3)


def test_multihost_initialize(monkeypatch):
    """Explicit arguments that cannot join raise (a run asked for a
    topology never goes on as a single process); without them, and
    without ``torchrun``'s environment, ``initialize`` does nothing and
    this process is rank 0 of 1."""
    import torch.distributed as dist

    from ess_tpu_torch.parallel import multihost

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("file:///nonexistent/store", world_size=2)
    with pytest.raises(RuntimeError, match="rendezvous"):
        multihost.initialize("nowhere://store", world_size=2, rank=0)
    multihost.initialize()
    assert not dist.is_initialized()
    assert multihost.process_shard() == (0, 1)
    cm = np.arange(4.0).reshape(2, 2)
    assert multihost.all_reduce_host(cm) is cm
