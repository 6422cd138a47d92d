"""The plain reference against the port's plain path on the CPU: the whole
checked stretch of a run in float32 (the program's CPU path runs the plain
versions of its kernels), then each part alone."""

import numpy as np
import pytest
import torch

from benchmark import program, traffic, weights
from benchmark.reference import losses, model, voxel
from benchmark.reference.precision import f32_matmuls
from benchmark.tests.small import small_files


def _f32(files):
    files.conf.update(compute_dtype="float32", train_cells="exact")
    return files


@pytest.mark.parametrize("cell,config,limit", [
    ("ddd17_sup_train_b16", "ess_ddd17", 2e-4),
    ("dsec_stream_b8", "ess_ddd17", 2e-4),
    ("dsec_uda_train_b8", "ess_dsec", 2e-4)])
def test_checked_stretch_in_f32(cell, config, limit):
    import importlib

    files = _f32(small_files(cell, config=config,
                             batch=1 if config == "ess_dsec" else 2))
    step = files.traffic["step"]
    drivers = importlib.import_module(f"benchmark.drivers.{step}")
    d = drivers.Driver(files.conf, files.traffic, torch.device("cpu"))
    d.prepare(2 ** 31 + 11)
    while d.cursor < files.traffic["ring"]:
        d.request()
    with f32_matmuls():
        numbers = d.compare(d.program_outputs(), d.reference())
    for k, v in numbers.items():
        bound = 5e-3 if k == "cm_moved" else limit
        assert v <= bound, (k, v)


def test_voxel_input_matches_pipeline():
    files = small_files("ddd17_sup_train_b16")
    conf = files.conf
    raw = traffic.events(np.random.default_rng(1), conf, 1, 2)
    mods = program.build(conf, "ess_supervised", "cpu")
    batch = program.to_device(program.wire(conf, raw, "band"), "cpu")
    built, _ = program.pipeline(mods, False).build_all(
        batch, out_dtype=torch.float32)
    ours = voxel.model_input(
        torch.from_numpy(raw[0]), bins=5, sensor=(260, 346), crop_bottom=60,
        integer=True, resize_to=(200, 352))
    torch.testing.assert_close(built[:, 0].float(), ours, atol=1e-4,
                               rtol=1e-4)


def test_radam_matches_program():
    from ess_tpu_torch.train.state import make_radam

    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(50, generator=gen)
    grads = [torch.randn(50, generator=gen) for _ in range(7)]
    a, b = p0.clone(), p0.clone().requires_grad_(False)
    ours = losses.RAdam([a], 1e-3)
    theirs = make_radam([b], 1e-3)
    for g in grads:
        ours.step([g])
        b.grad = g
        theirs.step()
    torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_heads_and_front_match_program():
    conf = small_files("dsec_uda_train_b8", config="ess_dsec").conf
    conf.update(compute_dtype="float32")
    p = weights.make(conf, True, 3, "cpu")
    mods = program.build(conf, "ess", "cpu")
    program.load(mods, p)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(1, 1, 48, 64, generator=gen)
    with torch.no_grad():
        theirs = mods.front_a(img, train=True)
        ours = model.front(p, img)
        for s in (2, 4, 8):
            torch.testing.assert_close(theirs[s].float(), ours[s],
                                       atol=1e-4, rtol=1e-4)
        h_theirs = mods.head(theirs)
        h_ours = model.seghead(p, ours)
        for s in (1, 2, 4):
            torch.testing.assert_close(h_theirs[s].float(), h_ours[s],
                                       atol=1e-4, rtol=1e-4)
