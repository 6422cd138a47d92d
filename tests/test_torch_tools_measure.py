"""The measurement tools of ``ess_tpu_torch/tools`` (CPU): the roofline's
arithmetic and each tool's ``main`` at a tiny shape.

- ``roofline``: every row's FLOPs equal the JAX package's
  ``tools/roofline.py`` row of the same name at ``bench.py``'s shape, for
  the supervised and the UDA step (the JAX tool, which imports only
  ``argparse`` and ``json``, is loaded by path); the conv rows' FLOPs equal
  a MAC count taken with forward hooks on the port's modules at a small
  geometry in the standard layout (the head conv is the real 5x5 there,
  not the block conv with its zero taps): the E2VID head, encoder, gate,
  residual and decoder convs and the ResNet18 front exactly; the task
  head's row, as JAX writes it, counts its last conv and classifier at
  half resolution and so stays below the real head's count (a bound that
  is lower is still a bound); a profile's kernels map onto the groups by
  name, the rest onto ``unattributed``;
- ``bench_kernel``, ``profile_kernel``, ``bench_lstm``, ``profile_lstm``,
  ``bench_increments`` and ``bench_uda_increments`` run on the CPU at a
  tiny shape (plain versions, host clock).
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ess_tpu_torch.core.config import (
    Config, DatasetConfig, EventDatasetConfig, ImageDatasetConfig,
    ModelConfig, OptimConfig, TaskConfig)
from ess_tpu_torch.ops import voxel_folded as vf
from ess_tpu_torch.ops import voxel_tiled as vt
from ess_tpu_torch.tools import (
    bench_increments, bench_kernel, bench_lstm, bench_uda_increments,
    profile_kernel, profile_lstm, roofline)
from ess_tpu_torch.train.builder import build_modules, init_params


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_roofline():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_roofline", os.path.join(ROOT, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("step", ["supervised", "uda"])
def test_roofline_flops_equal_the_jax_rows(step):
    jr = jax_roofline()
    want = {r[0]: r[2] for r in (jr.components() if step == "supervised"
                                 else jr.uda_components())}
    got = {r[0]: r[2] for r in (roofline.components() if step == "supervised"
                                else roofline.uda_components())}
    assert got == want
    # the bound: the larger of operations over the peak and bytes over the
    # memory rate, summed over the rows the step runs
    res = roofline.table(step)
    assert res["total_bound_ms"] == pytest.approx(sum(
        max(r["gflops"] * 1e9 / roofline.PEAK_OPS_PER_S[r["peak"]],
            r["mb"] * 1e6 / roofline.HBM_BYTES_PER_S) * 1e3
        for r in res["rows"] if r["run"]))
    run = {r["component"] for r in res["rows"] if r["run"]}
    assert ({"resblocks", "decoders"} <= run) == (step == "uda")


def hook_macs(shape=(64, 128), b=2, classes=6) -> dict:
    """2 x MACs of each conv module of seeded ESS UDA modules over one
    decoded window in the standard layout, the task head on its latent
    and the front on one image batch: {module path: FLOPs}. The cells'
    gate convs are functional; their count is taken on the cell module
    (output pixels x the gate weight). The head conv runs as the plain 5x5
    conv (``head_conv_impl='xla'``; ``'auto'`` would evaluate it in block
    space, outside the conv module)."""
    cfg = Config(
        dataset=DatasetConfig(
            sensor_a=ImageDatasetConfig(shape=shape),
            sensor_b=EventDatasetConfig(
                name="synthetic_events", shape=shape, nr_events_data=1,
                nr_temporal_bins=5, nr_events_window=500)),
        model=ModelConfig(model_name="ess", compute_dtype="float32",
                          head_conv_impl="xla"),
        task=TaskConfig(semseg_num_classes=classes),
        optim=OptimConfig(batch_size_a=b, batch_size_b=b))
    mods = build_modules(cfg, device="cpu")
    init_params(mods, torch.Generator().manual_seed(0))
    counts = {}

    def count(name, weight):
        def hook(mod, args, out):
            o = out[0] if isinstance(out, tuple) else out
            counts[name] = counts.get(name, 0) + (
                2 * (o.numel() // o.shape[1]) * weight(mod).numel())
        return hook

    for root, model in (("e2vid", mods.e2vid), ("head", mods.head),
                        ("front", mods.front_a)):
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                assert m.groups == 1
                m.register_forward_hook(count(f"{root}.{name}",
                                              lambda m: m.weight))
            elif hasattr(m, "Gates"):
                m.register_forward_hook(count(f"{root}.{name}",
                                              lambda m: m.Gates.weight))
    rec = dataclasses.replace(mods.recon_val, block_space=False)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        _, _, latent = rec.step(torch.randn(b, 5, *shape, generator=g),
                                rec.init_state(b, "cpu"), decode=True)
        mods.head(latent)
        mods.front_a(torch.randn(b, 1, *shape, generator=g))
    return counts


def test_roofline_conv_rows_equal_hook_macs():
    b, (h, w), classes = 2, (64, 128), 6
    counts = hook_macs((h, w), b, classes)
    total = lambda prefix: sum(v for k, v in counts.items()
                               if k.startswith(prefix))
    g = roofline.Geometry(batch=b, windows=1, height=h, width=w,
                          classes=classes)
    rows = {r[0]: r[2] for r in roofline.uda_components(g)}
    assert rows["head_conv"] == total("e2vid.head.")
    for i in range(3):
        assert rows[f"enc{i}_conv"] == total(f"e2vid.encoders.{i}.conv.")
        assert rows[f"lstm{i}_gates"] == total(
            f"e2vid.encoders.{i}.recurrent_block")
    assert rows["resblocks"] == total("e2vid.resblocks.")
    assert rows["decoders"] == total("e2vid.decoders.")
    assert rows["front_a_x2"] == 2 * 3 * total("front.")       # fwd + bwd
    head_fwd = roofline.head_flops(g) * b
    assert rows["head_x3_fwd_bwd"] == 3 * 3 * head_fwd
    assert head_fwd < total("head.") < 1.5 * head_fwd


def test_roofline_maps_a_profile_onto_its_groups(tmp_path, capsys):
    summary = {"top": [
        {"name": "void (anonymous namespace)::scatter::scatter_kernel<0, "
                 "512>(...)", "ms": 0.5, "calls": 1},
        {"name": "void cell_kernel<true, 0>(...)", "ms": 24.0, "calls": 60},
        {"name": "void prep_kernel<64>(...)", "ms": 3.5, "calls": 60},
        {"name": "absmax_kernel(...)", "ms": 0.4, "calls": 60},
        {"name": "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc",
         "ms": 7.0, "calls": 40},
        {"name": "void at::native::vectorized_elementwise_kernel<...>",
         "ms": 9.0, "calls": 100}]}
    path = tmp_path / "summary.json"
    path.write_text(json.dumps({"profile": summary}))
    assert roofline.trace_groups(str(path)) == pytest.approx(
        {"voxelize": 0.5, "lstm": 27.9, "convs": 7.0, "unattributed": 9.0})
    res = roofline.main(["--trace", str(path), "--measured",
                         "fold_norm=0.25"])
    got = {gr["group"]: gr["measured_ms"] for gr in res["groups"]}
    assert got == pytest.approx({"voxelize": 0.5, "fold_norm": 0.25,
                                 "lstm": 27.9, "convs": 7.0,
                                 "unattributed": 9.0})
    assert "Total bound" in capsys.readouterr().out
    with pytest.raises(ValueError):
        roofline.main(["--measured", "nothing=1"])


def test_bench_kernel_runs_on_cpu():
    out = bench_kernel.main(["--repeat=3"], device="cpu",
                            shape=(2, 2000, 48, 256))
    assert set(out) == set(bench_kernel.CASES)
    for lines in out.values():
        assert lines[0]["repeat"]["bit_for_bit"]
        assert np.isfinite(lines[0]["host_ms"])


def test_profile_kernel_runs_on_cpu(tmp_path):
    out = profile_kernel.main([f"--out={tmp_path}"], device="cpu",
                              shape=(1, 1500, 48, 256))
    assert set(out) == set(bench_kernel.CASES)
    assert all(rows and np.isfinite(rows[0]["ms"]) for rows in out.values())


def test_bench_lstm_runs_on_cpu():
    out = bench_lstm.main(["--layers=0,1"], device="cpu",
                          shapes=[(2, 32, 8, 10), (1, 64, 6, 6)], steps=3)
    for by_cell in out.values():
        assert by_cell["pallas"]["dh"] == 0.0             # plain == library
        assert 0.0 < by_cell["int8"]["dh"] < 0.1
        assert all(r["repeat_bit_for_bit"] and np.isfinite(r["ms_per_step"])
                   for r in by_cell.values())


def test_profile_lstm_runs_on_cpu(tmp_path):
    out = profile_lstm.main([f"--out={tmp_path}"], device="cpu",
                            shapes=[(1, 32, 6, 8)], steps=2)
    assert set(out[0]) == set(bench_lstm.CELLS)


SHAPE, B, T, N = (24, 128), 2, 2, 600


def tiny_cfg(model_name: str = "ess_supervised", shape=SHAPE) -> Config:
    return Config(
        dataset=DatasetConfig(
            sensor_a=ImageDatasetConfig(shape=shape),
            sensor_b=EventDatasetConfig(
                name="synthetic_events", shape=shape, nr_events_data=T,
                nr_temporal_bins=5, nr_events_window=N)),
        model=ModelConfig(model_name=model_name, compute_dtype="bfloat16",
                          lstm_impl_train="pallas_int8",
                          data_augmentation_train=False),
        task=TaskConfig(semseg_num_classes=6),
        optim=OptimConfig(batch_size_a=B, batch_size_b=B))


def tiny_batch(wire: str, seed: int = 0, shape=SHAPE) -> dict:
    """B x T windows of N events binned on the host on ``wire``, labels."""
    rng = np.random.default_rng(seed)
    raw = np.zeros((B, T, N, 4), np.float32)
    raw[..., 0] = rng.uniform(0, shape[1] - 1, (B, T, N))
    raw[..., 1] = rng.uniform(0, shape[0] - 1, (B, T, N))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (B, T, N)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (B, T, N))
    valid = np.ones((B, T, N), bool)
    fn = vt.host_tile_bin if wire == "tile" else vf.host_band_bin_folded
    rs, vs_, os_ = zip(*(fn(raw[i], valid[i], height=shape[0],
                            width=shape[1], bins=5) for i in range(B)))
    cap = max(r.shape[1] for r in rs)
    pad = lambda a: np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2))
    rs, vs_ = np.stack([pad(r) for r in rs]), np.stack([pad(v) for v in vs_])
    out = {"ev_x": rs[..., 0], "ev_y": rs[..., 1], "ev_t": rs[..., 2],
           "ev_p": rs[..., 3], "ev_valid": vs_,
           f"ev_{wire}_offsets": np.stack(os_),
           "label": rng.integers(0, 6, (B,) + tuple(shape))}
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def test_ladder_pin_rungs_take_their_branch(monkeypatch):
    """The voxelizer-pin rungs of both ladders run their steps through the
    pins' rollout branches (``supervised.rollout_form``) at a sensor of two
    x-slots, where the stack build is possible: raw, stack and the int8
    planes (the standard branch, the voxelizer's int8 form)."""
    from ess_tpu_torch.ops import batch_voxel
    from ess_tpu_torch.train import supervised

    shape = (24, 256)
    forms, planes = [], []
    form_of = supervised.rollout_form
    monkeypatch.setattr(supervised, "rollout_form", lambda *a, **k: (
        forms.append(form_of(*a, **k)) or forms[-1]))
    band = batch_voxel.voxelize_band
    monkeypatch.setattr(batch_voxel, "voxelize_band", lambda *a, **k: (
        planes.append(k.get("oh_dtype")) or band(*a, **k)))
    lines = bench_increments.main(
        ["--iters=1", "--only=2,3,4,5"], device="cpu",
        cfg=tiny_cfg(shape=shape),
        batches={"band": tiny_batch("band", shape=shape)})
    assert [ln["rung"] for ln in lines] == [2, 3, 4, 5]
    # two calls a rung (the warm-up and one timed step)
    assert forms == ["standard"] * 2 + ["raw"] * 2 + ["stack"] * 2 + [
        "standard"] * 2
    assert planes[-2:] == ["int8"] * 2 and "int8" not in planes[:-2]
    batch = tiny_batch("band", shape=shape)
    del batch["label"]
    g = torch.Generator().manual_seed(2)
    batch["image_a"] = torch.randn(B, 1, *shape, generator=g)
    batch["label_a"] = torch.randint(0, 6, (B,) + shape, generator=g)
    forms.clear()
    bench_uda_increments.main(["--iters=1", "--only=1,3"], device="cpu",
                              cfg=tiny_cfg("ess", shape=shape), batch=batch)
    assert forms == ["standard"] * 2 + ["raw"] * 2


def test_uda_ladder_blocked_stem_rung_takes_its_branch(monkeypatch):
    """The UDA ladder's ``+blocked-stem`` rung runs the image front's stem
    in block space, the rungs before it the plain stem (JAX's ladder)."""
    from ess_tpu_torch.models.resnet import ResNet18Encoder

    seen = []
    blocked = ResNet18Encoder.blocked
    monkeypatch.setattr(ResNet18Encoder, "blocked", lambda self, x: (
        seen.append(blocked(self, x)) or seen[-1]))
    batch = tiny_batch("band")
    del batch["label"]
    g = torch.Generator().manual_seed(2)
    batch["image_a"] = torch.randn(B, 1, *SHAPE, generator=g)
    batch["label_a"] = torch.randint(0, 6, (B,) + SHAPE, generator=g)
    lines = bench_uda_increments.main(["--iters=1", "--only=1,2"],
                                      device="cpu", cfg=tiny_cfg("ess"),
                                      batch=batch)
    assert [ln["name"] for ln in lines] == [
        "int8-cells (default)", "+blocked-stem"]
    # two front passes a step, two steps a rung
    assert seen == [False] * 4 + [True] * 4


def test_bench_increments_runs_on_cpu():
    lines = bench_increments.main(
        ["--iters=1"], device="cpu", cfg=tiny_cfg(),
        batches={w: tiny_batch(w) for w in ("tile", "band")})
    assert [ln["rung"] for ln in lines] == list(
        range(len(bench_increments.LADDER)))
    assert all(np.isfinite(ln["windows_per_sec"]) for ln in lines)
    assert lines[0]["delta"] is None and lines[1]["delta"] is not None


def test_bench_uda_increments_runs_on_cpu():
    batch = tiny_batch("band")
    del batch["label"]
    g = torch.Generator().manual_seed(2)
    batch["image_a"] = torch.randn(B, 1, *SHAPE, generator=g)
    batch["label_a"] = torch.randint(0, 6, (B,) + SHAPE, generator=g)
    lines = bench_uda_increments.main(["--iters=1", "--only=0,2"],
                                      device="cpu", cfg=tiny_cfg("ess"),
                                      batch=batch)
    assert [ln["rung"] for ln in lines] == [0, 2]
    assert all(np.isfinite(ln["windows_per_sec"]) for ln in lines)
