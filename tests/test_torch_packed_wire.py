"""The packed u16 event wire (``wire_format: packed``) of the port's host
path against the JAX package's.

The packed wire carries x and y in 1/64 px (u16), the time normalized over
its window (u16), the polarity (u8, or the pre-weighted i8 of the folded
records) and the offsets; validity follows from the offsets. Inputs are
seeded event columns on the 480x640 sensor with a rectify map that moves
events by up to a few tenths of a pixel (some off the frame), and DSEC
sequences written by ``tests.test_datasets_integration.make_dsec_seq``
with such a map.

Bounds:
- bit-equal: both native packed ingests (the folded one also where a
  window overflows the record capacity and grows it), ``DSECSequence``
  samples on the folded and tile wires for fixed-count and fixed-duration
  windows (and the slicer chain that out-of-range fixed-duration windows
  take, f32 in both packages), ``SequenceRecurrent`` samples, ``to_soa``;
- ``decode_packed``: equal to JAX's (the same f32 products);
- ``build_all`` windows on both packed wires against JAX ``build_all``
  (its Pallas voxelizers in interpret mode with f32 tent planes): atol
  2e-3 / rtol 1e-4, the f32-wire bound of tests/test_torch_voxel.py; with
  ``normalize`` rtol 2e-3 (tests/test_torch_voxel_tiled.py's);
- the collate of packed folded samples of mixed record capacity, which
  the JAX collate refuses: each sample's windows as built alone, exactly;
- the train CLI on a DSEC YAML with ``wire_format: packed`` (two written
  sequences, base 8, f32): it trains and validates, and its first step's
  loss is within 1e-3 (relative) of the JAX CLI's from the same initial
  weights and augmentation draws (tests/test_torch_cli.py's CLI bound; the
  JAX CLI runs its band kernel in interpret mode with its default bf16 tent
  planes). ``build_loaders`` on such a YAML is held against JAX's by
  ``tests/test_torch_cli.py::test_build_loaders_match_jax``.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.data import dsec as jdsec
from ess_tpu.data import loader as jloader
from ess_tpu.data import native as jnative
from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from ess_tpu.data.pipeline import to_soa as jax_to_soa

from ess_tpu_torch.data import dsec, loader, native
from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig, to_soa
from tests.test_datasets_integration import make_dsec_seq
from tests.test_torch_data import assert_dicts_equal, raw_columns
from tests.test_torch_host_bin import use_private_jax_native
from tests.test_torch_loop import one_torch_thread

# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    one_torch_thread)

H, W, TH = 480, 640, 24
F32 = dict(atol=2e-3, rtol=1e-4)
F32_NORM = dict(atol=2e-3, rtol=2e-3)


def jittered_map(seed=0, h=H, w=W):
    """A rectify map moving each pixel by N(0, 0.4) px: sub-pixel
    coordinates, some in (-1, 0) and some off the frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([xx + rng.normal(0, 0.4, xx.shape),
                     yy + rng.normal(0, 0.4, yy.shape)],
                    -1).astype(np.float32)


def bounds(rng, n, t_dim, cap):
    """[start, end) bounds of ``t_dim`` windows: one empty, one longer than
    ``cap`` (it keeps its last ``cap`` events)."""
    cuts = np.sort(rng.integers(0, n, t_dim + 1))
    cuts[1] = cuts[0]
    cuts[-1] = min(cuts[-2] + 2 * cap, n)
    return cuts[:-1].astype(np.int64), cuts[1:].astype(np.int64)


def packed(mod, wire, ev, starts, ends, cap, rmap, **kw):
    if wire == "tile":
        return mod.ingest_rectify_bin_packed(ev, starts, ends, cap, rmap,
                                             tile_h=TH)
    return mod.ingest_rectify_bin_packed_folded(
        ev, starts, ends, cap, rmap, tile_h=TH, slot_w=128, **kw)


# ---------------------------------------------------------------- native


@pytest.mark.parametrize("wire,kw", [
    ("tile", {}),
    ("folded", dict(ntx=5)),
    ("folded", dict(ntx=1)),
    ("folded", dict(ntx=5, out_capacity=720)),
])
def test_native_packed_ingest_matches_jax(wire, kw):
    """Both packed entries, bit for bit; ``out_capacity`` below what the
    ghosts need grows to the next quantized level in both packages."""
    rng = np.random.default_rng(3)
    ev = raw_columns(rng, 6000)
    starts, ends = bounds(rng, 6000, 5, 700)
    got = packed(native, wire, ev, starts, ends, 700, jittered_map(), **kw)
    want = packed(jnative, wire, ev, starts, ends, 700, jittered_map(), **kw)
    assert_dicts_equal(got, want)
    offs = got["tile_offsets" if wire == "tile" else "band_offsets"]
    groups = 20 * (5 if wire == "tile" else kw["ntx"])
    assert offs.shape == (5, groups + 1)
    assert got["ev_xq"].dtype == np.uint16
    assert got["ev_pq"].dtype == (np.uint8 if wire == "tile" else np.int8)
    if "out_capacity" in kw:
        assert got["ev_xq"].shape[1] > kw["out_capacity"]
    # nothing past a window's count
    n = got["ev_xq"].shape[1]
    tail = np.arange(n) >= offs[:, -1:]
    for k in ("ev_xq", "ev_yq", "ev_tq", "ev_pq"):
        assert not got[k][tail].any(), k


def test_native_packed_folded_keeps_the_f32_records():
    """The packed folded wire holds the f32 folded wire's groups: the same
    offsets' record counts to within the records that quantization moves
    across a group edge, and the same capacity."""
    rng = np.random.default_rng(4)
    ev = raw_columns(rng, 6000)
    starts, ends = bounds(rng, 6000, 5, 700)
    rmap = jittered_map()
    pk = native.ingest_rectify_bin_packed_folded(
        ev, starts, ends, 700, rmap, tile_h=TH, ntx=5, slot_w=128)
    recs, _, offs = native.ingest_rectify_bin_folded(
        ev, starts, ends, 700, rmap, tile_h=TH, ntx=5, slot_w=128)
    assert pk["ev_xq"].shape == recs.shape[:2]
    moved = np.abs(pk["band_offsets"][:, -1] - offs[:, -1])
    assert (moved <= 0.02 * offs[:, -1] + 2).all()


# ------------------------------------------------------------------ DSEC

SEQ_KW = dict(nr_events_data=4, nr_events_window=1024, wire_format="packed")


@pytest.fixture(scope="module")
def seq_root(tmp_path_factory):
    """One train sequence with a jittered rectify map."""
    import h5py

    root = tmp_path_factory.mktemp("dsec_packed")
    seq = os.path.join(root, "train", "zurich_city_00_a")
    make_dsec_seq(seq, n_events=20000, n_labels=10, seed=2)
    path = os.path.join(seq, "events", "left", "rectify_map.h5")
    with h5py.File(path, "r+") as f:
        f["rectify_map"][...] = jittered_map(1)
    return seq


@pytest.mark.parametrize("fixed_duration", [False, True])
@pytest.mark.parametrize("binning", ["folded", "tile"])
def test_dsec_sequence_packed_matches_jax(seq_root, binning,
                                          fixed_duration):
    kw = dict(SEQ_KW, binning=binning, fixed_duration=fixed_duration)
    got, want = dsec.DSECSequence(seq_root, **kw), \
        jdsec.DSECSequence(seq_root, **kw)
    assert len(got) == len(want) == 2
    for i in range(len(want)):
        sample = got[i]
        assert_dicts_equal(sample, want[i])
        assert "ev_xq" in sample and "raw_events" not in sample
        assert ("band_offsets" if binning == "folded"
                else "tile_offsets") in sample


@pytest.mark.parametrize("binning", ["folded", "tile"])
def test_dsec_packed_takes_the_f32_chain_like_jax(seq_root, binning):
    """Where the fused ingest does not run (fixed-duration windows outside
    the recording's index; ``tile_bin=False``), both packages fall back to
    the f32 slicer chain."""
    kw = dict(SEQ_KW, binning=binning, fixed_duration=True)
    got, want = dsec.DSECSequence(seq_root, **kw), \
        jdsec.DSECSequence(seq_root, **kw)
    got._fused_ingest_duration = lambda *a, **k: None
    want._fused_ingest_duration = lambda *a, **k: None
    sample = got[1]
    assert_dicts_equal(sample, want[1])
    assert "raw_events" in sample
    kw = dict(SEQ_KW, tile_bin=False)
    raw = dsec.DSECSequence(seq_root, **kw)[0]
    assert_dicts_equal(raw, jdsec.DSECSequence(seq_root, **kw)[0])
    assert sorted(raw) == ["label", "raw_events", "valid"]


def test_dsec_unknown_wire_raises(seq_root):
    """``'f32'`` and ``'packed'`` are the wires (``'folded_bands'`` with
    ``'packed'`` raises: tests/test_torch_data.py)."""
    with pytest.raises(ValueError, match="wire_format"):
        dsec.DSECSequence(seq_root, nr_events_data=4, wire_format="u8")


@pytest.mark.parametrize("align_labels", [False, True])
@pytest.mark.parametrize("binning", ["folded", "tile"])
def test_sequence_recurrent_packed_matches_jax(seq_root, binning,
                                               align_labels):
    kw = dict(SEQ_KW, nr_events_data=1, binning=binning)
    got = dsec.SequenceRecurrent(dsec.DSECSequence(seq_root, **kw),
                                 nr_events_window=1024,
                                 align_labels=align_labels)
    want = jdsec.SequenceRecurrent(jdsec.DSECSequence(seq_root, **kw),
                                   nr_events_window=1024,
                                   align_labels=align_labels)
    assert len(got) == len(want) > 0 and got.label_idx == want.label_idx
    for i in range(len(want)):
        sample = got[i]
        assert_dicts_equal(sample, want[i])
        assert sample["ev_xq"].shape[0] == 1


def test_packed_folded_capacity_grows_like_jax():
    """A sequence whose windows overflow the default record capacity grows
    it to the quantized level that JAX's ingest reaches, and keeps it for
    its later samples (the sticky capacity), as JAX's ``_fused_ingest``
    passes it on."""
    from ess_tpu_torch.data.slicer import ArrayEventStore

    rng = np.random.default_rng(5)
    n, t_dim, cap = 30000, 2, 2000
    # every event on a band's last row: nearly each one gets a ghost record
    cols = dict(x=rng.integers(0, W, n), y=rng.integers(0, 20, n) * 24 + 23,
                t=np.arange(n) * 30, p=rng.integers(0, 2, n))
    ts = cols["t"][[0, 10, 20, 30, 40, 50, 9000, 9100, 20000, 20100]]
    rmap = np.stack(np.meshgrid(np.arange(W), np.arange(H)),
                    -1).astype(np.float32) + 0.5
    seq = dsec.DSECSequence.from_store(
        ArrayEventStore(**cols), rmap, ts, np.zeros((10, 440, 640), np.uint8),
        nr_events_data=t_dim, nr_events_window=cap, wire_format="packed")
    sticky = None
    for i in range(len(seq)):
        sample = seq[i]
        ev = seq.slicer.get_events_fixed_num(int(seq.timestamps[2 * i]),
                                             t_dim * cap)
        starts = np.arange(t_dim, dtype=np.int64) * cap
        want = jnative.ingest_rectify_bin_packed_folded(
            ev, starts, starts + cap, cap, rmap, tile_h=TH, ntx=5,
            slot_w=128, out_capacity=sticky)
        sticky = want["ev_xq"].shape[1]
        sample.pop("label")
        assert_dicts_equal(sample, want)
        assert sticky > native.folded_capacity(cap)
        assert seq._folded_cap == sticky


# -------------------------------------------------------------- pipeline


def ingest(wire, seed=6, t_dim=3, n=1500, h=48, w=256):
    """A (T, ...) packed sample and its f32 counterpart on a 48x256 sensor
    (2 bands x 2 x-slots), from the same event columns."""
    rng = np.random.default_rng(seed)
    ev = raw_columns(rng, t_dim * n, h, w)
    starts = np.arange(t_dim, dtype=np.int64) * n
    rmap = jittered_map(seed, h, w)
    if wire == "tile":
        pk = native.ingest_rectify_bin_packed(ev, starts, starts + n, n,
                                              rmap, tile_h=TH)
        raw, valid, offs = native.ingest_rectify_bin(
            ev, starts, starts + n, n, rmap, tile_h=TH)
        f32 = {"raw_events": raw, "valid": valid, "tile_offsets": offs}
    else:
        kw = dict(tile_h=TH, ntx=w // 128, slot_w=128)
        pk = native.ingest_rectify_bin_packed_folded(ev, starts, starts + n,
                                                     n, rmap, **kw)
        raw, valid, offs = native.ingest_rectify_bin_folded(
            ev, starts, starts + n, n, rmap, **kw)
        f32 = {"raw_events": raw, "valid": valid, "band_offsets": offs}
    return pk, f32


def batched(sample, lib="torch"):
    soa = to_soa(sample) if lib == "torch" else jax_to_soa(sample)
    if lib == "torch":
        return {k: torch.from_numpy(np.asarray(v)[None])
                for k, v in soa.items()}
    return {k: jnp.asarray(np.asarray(v)[None]) for k, v in soa.items()}


def test_to_soa_renames_packed_offsets_like_jax():
    for wire in ("folded", "tile"):
        pk, _ = ingest(wire)
        sample = dict(pk, label=np.zeros((4, 4), np.uint8))
        got, want = to_soa(sample), jax_to_soa(sample)
        assert_dicts_equal(got, want)
        assert f"ev_{'band' if wire == 'folded' else 'tile'}_offsets" in got


@pytest.mark.parametrize("wire", ["folded", "tile"])
def test_decode_packed_matches_jax(wire):
    pk, _ = ingest(wire)
    geo = dict(sensor_height=48, sensor_width=256, num_bins=5,
               trilinear=True)
    got = EventPipeline(PipelineConfig(**geo)).decode_packed(batched(pk))
    want = JaxPipeline(JaxPipelineConfig(**geo)).decode_packed(
        batched(pk, "jax"))
    assert sorted(got) == sorted(want)
    assert got.pop("ev_t_prenormalized") is want.pop("ev_t_prenormalized")
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)
    t = got["ev_t"][got["ev_valid"]]
    assert float(t.min()) >= 0 and float(t.max()) <= 4
    with pytest.raises(ValueError, match="offsets"):
        EventPipeline(PipelineConfig(**geo)).decode_packed(
            {k: v for k, v in batched(pk).items() if "offsets" not in k})


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("wire", ["folded", "tile"])
def test_build_all_packed_matches_jax(wire, normalize):
    """``build_all`` on a packed batch (B=2: the sample and its mirror
    image in time order) against JAX's, with a bottom crop."""
    pk, f32 = ingest(wire)
    geo = dict(sensor_height=48, sensor_width=256, num_bins=5,
               trilinear=True, normalize=normalize, crop_bottom=8)
    pipe = EventPipeline(PipelineConfig(**geo))
    jpipe = JaxPipeline(JaxPipelineConfig(
        use_pallas=True, pallas_interpret=True, voxel_oh_dtype="float32",
        **geo))
    pk2 = loader._collate([pk, ingest(wire, seed=7)[0]])
    got, _ = pipe.build_all({k: torch.from_numpy(v)
                             for k, v in to_soa(pk2).items()})
    want, _ = jpipe.build_all({k: jnp.asarray(v)
                               for k, v in jax_to_soa(pk2).items()})
    want = np.moveaxis(np.asarray(want), -1, 2).swapaxes(0, 1)
    assert got.shape == want.shape == (3, 2, 5, 40, 256)
    np.testing.assert_allclose(got.numpy(), want,
                               **(F32_NORM if normalize else F32))
    # the packed wire quantizes what the f32 wire carries: close, not equal
    ref, _ = pipe.build_all(batched(f32))
    diff = (got[:, :1] - ref).abs()
    assert 0 < float(diff.mean()) < 5e-3 * (20 if normalize else 1)


# ---------------------------------------------------------------- loader


def test_collate_pads_packed_folded_capacity_skew():
    """Packed folded samples binned at two record capacities (a worker that
    grew its sequence's capacity and one that did not): the JAX collate
    refuses them, with and without a ring buffer; the port pads the four
    columns with zeros, and each sample's windows come out as built
    alone."""
    rng = np.random.default_rng(8)
    n, t_dim = 1500, 3
    ev = raw_columns(rng, t_dim * n, 48, 256)
    starts = np.arange(t_dim, dtype=np.int64) * n
    kw = dict(tile_h=TH, ntx=2, slot_w=128)
    rmap = jittered_map(8, 48, 256)
    small = native.ingest_rectify_bin_packed_folded(ev, starts, starts + n,
                                                    n, rmap, **kw)
    big = native.ingest_rectify_bin_packed_folded(
        ev, starts, starts + n, n, rmap, out_capacity=2 * n, **kw)
    assert small["ev_xq"].shape[1] < big["ev_xq"].shape[1] == 2 * n
    pair = [dict(small, label=np.zeros((8, 8), np.uint8)),
            dict(big, label=np.ones((8, 8), np.uint8))]
    with pytest.raises(ValueError):
        jloader._collate(pair)
    with pytest.raises(ValueError):
        jloader._collate(pair, out=jloader._alloc_like(pair[:1] * 2))
    got = loader._collate(pair)
    ring = loader._collate(pair, out=loader._alloc_like(pair[:1] * 2))
    assert_dicts_equal(ring, got)
    assert got["ev_xq"].shape == (2, t_dim, 2 * n)
    for k in ("ev_xq", "ev_yq", "ev_tq", "ev_pq"):
        assert not got[k][0, :, small[k].shape[1]:].any()
    pipe = EventPipeline(PipelineConfig(sensor_height=48, sensor_width=256,
                                        num_bins=5, trilinear=True))
    both, _ = pipe.build_all({k: torch.from_numpy(v)
                              for k, v in to_soa(got).items()})
    for i, sample in enumerate((small, big)):
        alone, _ = pipe.build_all(batched(sample))
        torch.testing.assert_close(both[:, i], alone[:, 0], rtol=0, atol=0)


def test_prefetch_moves_packed_columns_as_they_are():
    """``prefetch_to_device`` copies the u16, u8 and i8 columns without a
    cast."""
    batches = [loader._collate([ingest(w)[0], ingest(w, seed=9)[0]])
               for w in ("folded", "tile")]
    got = list(loader.prefetch_to_device(iter(batches), device="cpu"))
    for g, w in zip(got, batches):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            assert g[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(g[k].numpy(), v, err_msg=k)


# ------------------------------------------------------------------- CLI


def test_train_cli_trains_dsec_on_the_packed_wire_like_jax(monkeypatch,
                                                           tmp_path):
    """``configs/settings_DSEC.yaml`` (supervised, B=2, T=4 windows of
    1024 events) with ``wire_format: packed`` on two written sequences:
    the port's CLI trains one epoch from packed batches and validates; its
    first loss is the JAX CLI's within 1e-3."""
    import yaml

    from ess_tpu.cli import train as jax_train
    from ess_tpu.core.config import load_config as jax_load_config
    from ess_tpu.train import loop as jax_loop
    from ess_tpu.train.builder import make_pipeline as jax_make_pipeline
    from ess_tpu_torch.cli import train
    from ess_tpu_torch.train import loop
    from ess_tpu_torch.io.convert import params_from_jax
    from ess_tpu_torch.train import supervised as sup
    from tests.test_torch_cli import dsec_config, jax_draws, summary_lines
    from tests.test_torch_loop import scalars

    raw = dsec_config(tmp_path, "voxel_grid", "packed")
    raw["model"].update(e2vid_base_channels=8, compute_dtype="float32")
    raw["optim"].update(num_epochs=1, val_epoch_step=1)
    raw["checkpoint"]["save_checkpoint"] = False
    paths = {}
    for name in ("jax", "port", "draws"):
        raw["dir"]["log"] = str(tmp_path / f"logs_{name}")
        paths[name] = str(tmp_path / f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(raw, f)
    initial, seen = {}, {}

    class JaxTrainer(jax_loop.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.writer.flush_every = 1
            initial["state"] = jax.device_get(self.state)
            initial["log_dir"] = self.log_dir

    class Trainer(loop.Trainer):
        def __init__(self, cfg, **kw):
            e2vid, head = params_from_jax(initial["state"].e2vid_params,
                                          initial["state"].back_params)
            super().__init__(cfg, e2vid_state=e2vid,
                             **{k: v for k, v in kw.items()
                                if k != "e2vid_state"})
            self.state.head.load_state_dict(head)
            self.writer.flush_every = 1
            initial["port_log_dir"] = self.log_dir
            step = self.train_step

            def tapped(state, batch, *args):
                seen.setdefault("batch", sorted(batch))
                return step(state, batch, *args)

            self.train_step = tapped

    monkeypatch.setattr(jax_loop, "Trainer", JaxTrainer)
    monkeypatch.setattr(loop, "Trainer", Trainer)
    jax_train.main(["--settings_file", paths["jax"]])
    monkeypatch.setattr(sup, "draw_augment", jax_draws(jax_make_pipeline(
        jax_load_config(paths["draws"]), train=True)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--settings_file", paths["port"]], device="cpu")
    summary = summary_lines(out.getvalue())
    assert "semseg_sensor_b_mean_iou" in summary
    assert all(np.isfinite(float(v)) for v in summary.values())
    assert {"ev_xq", "ev_band_offsets"} <= set(seen["batch"])
    want = scalars(initial["log_dir"], "train/loss")["train/loss"]
    got = scalars(initial["port_log_dir"], "train/loss")["train/loss"]
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
