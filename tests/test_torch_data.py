"""The host event path: the port's slicer, native ingest, DSEC datasets,
loaders and device prefetch against the JAX package's.

Inputs: the in-memory stores of tests/test_data.py and DSEC sequences
written by ``tests.test_datasets_integration.make_dsec_seq`` (``events.h5``,
``rectify_map.h5``, label PNGs), here with a rectify map that shifts every
event by a sub-pixel offset. Each package builds its own copy of the same
native library, so every array below must be equal, bit for bit; the
synthetic datasets and the loaders' data order for a seed too.

End to end, a written sequence streams through the port's
``SequenceRecurrent`` -> ``run_streaming_eval`` and through the JAX
package's, on the same seeded weights carried over by ``params_from_jax``
(E2VID base 8, f32, the band wire; JAX runs its fold-free Pallas kernel in
interpret mode with f32 tent planes, the port the plain version). Bound:
PERF.md section 2's streaming bound, at most 10 % of the scored pixels
moved in the confusion matrix; the final recurrent state within 1e-4.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from ess_tpu.data import dsec as jdsec
from ess_tpu.data import loader as jloader
from ess_tpu.data import native as jnative
from ess_tpu.data import slicer as jslicer
from ess_tpu.data import synthetic as jsynthetic

from ess_tpu_torch.data import dsec, loader, native, slicer, synthetic
from tests.test_datasets_integration import make_dsec_seq
from tests.test_torch_host_bin import use_private_jax_native


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


# the JAX side loads its own copy of the native library (test_torch_host_bin)
_private_jax_native = pytest.fixture(scope="module", autouse=True)(
    use_private_jax_native)

SHIFT = (0.25, 0.5)   # sub-pixel rectify offsets (x, y)


def make_store(mod, n=5000, t_max_us=20000, seed=0, t_offset=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, t_max_us, n)).astype(np.int64)
    x, y, p = (rng.integers(0, 64, n), rng.integers(0, 48, n),
               rng.integers(0, 2, n))
    return mod.ArrayEventStore(x, y, t, p, t_offset=t_offset)


def assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


QUERIES = {
    "window": lambda s: s.get_events(3000, 7000),
    "offset": lambda s: s.get_events(1_003_000, 1_007_000),
    "fixed_num": lambda s: s.get_events_fixed_num(10000, 256),
    "fixed_num_start": lambda s: s.get_events_fixed_num(500, 256),
    "recurrent": lambda s: s.get_events_fixed_num_recurrent(10, 20),
    "outside": lambda s: s.get_events(3000, 90_000),
    "final": lambda s: {"t": np.asarray([s.final_time_us(),
                                         s.start_time_us()])},
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_slicer_queries_match_jax(query):
    off = 1_000_000 if query == "offset" else 0
    got = QUERIES[query](slicer.EventSlicer(make_store(slicer, t_offset=off)))
    want = QUERIES[query](jslicer.EventSlicer(make_store(jslicer,
                                                         t_offset=off)))
    if want is None:
        assert got is None
        return
    assert_dicts_equal(got, want)
    if query == "window":
        assert got["t"].min() >= 3000 and got["t"].max() < 7000


def test_ms_to_idx_and_index_of_time_match_jax():
    store, jstore = make_store(slicer), make_store(jslicer)
    np.testing.assert_array_equal(store.ms_to_idx, jstore.ms_to_idx)
    t = store.t
    for ms in range(1, len(store.ms_to_idx)):
        i = store.ms_to_idx[ms]
        assert i == len(t) or t[i] >= ms * 1000
        assert i == 0 or t[i - 1] < ms * 1000
    sl, jsl = slicer.EventSlicer(store), jslicer.EventSlicer(jstore)
    for q in (-5, 0, 999, 1000, 7321, 19999, 20_500, 10**6):
        assert sl.index_of_time(q) == jsl.index_of_time(q)


def test_pad_windows_and_xytp_match_jax():
    rng = np.random.default_rng(1)
    wins = [np.stack([rng.uniform(0, 9, n), rng.uniform(0, 9, n),
                      np.sort(rng.uniform(1e9, 2e9, n)),
                      rng.integers(0, 2, n)], 1) for n in (0, 3, 9, 40)]
    for cap in (4, 64):
        for g, w in zip(slicer.pad_windows(wins, cap),
                        jslicer.pad_windows(wins, cap)):
            np.testing.assert_array_equal(g, w)
    ev = make_store(slicer).read(5, 50)
    np.testing.assert_array_equal(slicer.events_dict_to_xytp(ev),
                                  jslicer.events_dict_to_xytp(ev))


# ---------------------------------------------------------------- native


def raw_columns(rng, n, h=480, w=640):
    return {"x": rng.integers(0, w, n).astype(np.uint16),
            "y": rng.integers(0, h, n).astype(np.uint16),
            "t": np.sort(rng.integers(0, 10**6, n)).astype(np.int64),
            "p": rng.integers(0, 2, n).astype(np.uint8)}


def shifted_map(h=480, w=640):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([np.clip(xx + SHIFT[0], 0, w - 1),
                     np.clip(yy + SHIFT[1], 0, h - 1)], -1).astype(np.float32)


def window_bounds(rng, n, t_dim, cap):
    """Per-window [start, end) bounds: one empty, one longer than ``cap``."""
    cuts = np.sort(rng.integers(0, n, t_dim + 1))
    cuts[1] = cuts[0]
    cuts[-1] = min(cuts[-2] + 2 * cap, n)
    return cuts[:-1].astype(np.int64), cuts[1:].astype(np.int64)


def test_searchsorted_i64_matches_jax():
    rng = np.random.default_rng(2)
    t = np.sort(rng.integers(0, 10**6, 5000)).astype(np.int64)
    q = rng.integers(-10, 10**6 + 10, 300)
    got = native.searchsorted_i64(t, q)
    np.testing.assert_array_equal(got, jnative.searchsorted_i64(t, q))
    np.testing.assert_array_equal(got, np.searchsorted(t, q))


def test_pad_windows_from_bounds_matches_jax():
    rng = np.random.default_rng(3)
    ev = slicer.events_dict_to_xytp(raw_columns(rng, 4000))
    starts, ends = window_bounds(rng, 4000, 6, 300)
    got = native.pad_windows_from_bounds(ev, starts, ends, 300)
    want = jnative.pad_windows_from_bounds(ev, starts, ends, 300)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    chain = slicer.pad_windows([ev[s:e] for s, e in zip(starts, ends)], 300)
    for g, w in zip(got, chain):
        np.testing.assert_array_equal(g, w)


def test_ingest_rectify_bin_matches_jax():
    rng = np.random.default_rng(4)
    ev = raw_columns(rng, 6000)
    starts, ends = window_bounds(rng, 6000, 5, 700)
    kw = dict(tile_h=24)
    got = native.ingest_rectify_bin(ev, starts, ends, 700, shifted_map(),
                                    **kw)
    want = jnative.ingest_rectify_bin(ev, starts, ends, 700, shifted_map(),
                                      **kw)
    assert got[2].shape == (5, 20 * 5 + 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ntx,out_capacity", [(1, None), (5, None),
                                              (1, 720), (5, 720)])
def test_ingest_rectify_bin_folded_matches_jax(ntx, out_capacity):
    """Both band wires (``ntx=1``: full-width bands; 5: 128-column slots),
    and a record capacity too small for the ghosts, which grows to the
    next quantized level in both packages."""
    rng = np.random.default_rng(5 + ntx)
    ev = raw_columns(rng, 6000)
    starts, ends = window_bounds(rng, 6000, 5, 700)
    kw = dict(tile_h=24, ntx=ntx, slot_w=128, out_capacity=out_capacity)
    got = native.ingest_rectify_bin_folded(ev, starts, ends, 700,
                                           shifted_map(), **kw)
    want = jnative.ingest_rectify_bin_folded(ev, starts, ends, 700,
                                             shifted_map(), **kw)
    assert got[2].shape == (5, 20 * ntx + 1)
    if out_capacity is not None:
        assert got[0].shape[1] > out_capacity
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ DSEC


@pytest.fixture(scope="module")
def seq_root(tmp_path_factory):
    """A DSEC tree with one train and one val sequence, sub-pixel map."""
    import h5py

    root = tmp_path_factory.mktemp("dsec")
    for sub, name, seed in (("train", "zurich_city_00_a", 0),
                            ("test", "zurich_city_13_a", 1)):
        seq_dir = os.path.join(root, sub, name)
        make_dsec_seq(seq_dir, n_events=20000, n_labels=10, seed=seed)
        path = os.path.join(seq_dir, "events", "left", "rectify_map.h5")
        with h5py.File(path, "r+") as f:
            f["rectify_map"][...] = shifted_map()
    return str(root)


def seq_dir(root):
    return os.path.join(root, "train", "zurich_city_00_a")


SEQ_KW = dict(nr_events_data=4, nr_events_window=1024)


@pytest.mark.parametrize("fixed_duration", [False, True])
@pytest.mark.parametrize("binning", ["folded", "tile", "raw"])
def test_dsec_sequence_matches_jax(seq_root, binning, fixed_duration):
    kw = dict(SEQ_KW, fixed_duration=fixed_duration)
    if binning == "raw":
        kw["tile_bin"] = False
    else:
        kw["binning"] = binning
    got = dsec.DSECSequence(seq_dir(seq_root), **kw)
    want = jdsec.DSECSequence(seq_dir(seq_root), **kw)
    assert len(got) == len(want) == 2
    np.testing.assert_array_equal(got.rectify_map, want.rectify_map)
    for i in range(len(want)):
        assert_dicts_equal(got[i], want[i])


@pytest.mark.parametrize("binning", ["folded", "tile"])
def test_dsec_duration_slicer_chain_matches_jax(seq_root, binning):
    """Windows outside the recording's index leave the fused fixed-duration
    ingest for the per-window slicer chain and its host binning."""
    kw = dict(SEQ_KW, fixed_duration=True, binning=binning)
    got = dsec.DSECSequence(seq_dir(seq_root), **kw)
    want = jdsec.DSECSequence(seq_dir(seq_root), **kw)
    got._fused_ingest_duration = lambda *a, **k: None
    want._fused_ingest_duration = lambda *a, **k: None
    assert_dicts_equal(got[1], want[1])


def test_dsec_full_width_bands_match_jax_ingest(seq_root):
    """``binning='folded_bands'``: the fixed-count windows of a sample
    through the JAX native ingest with ``ntx=1`` (the legacy wire)."""
    got = dsec.DSECSequence(seq_dir(seq_root), binning="folded_bands",
                            **SEQ_KW)
    want_seq = jdsec.DSECSequence(seq_dir(seq_root), **SEQ_KW)
    sample = got[1]
    assert sample["band_offsets"].shape == (4, 20 + 1)
    ev = want_seq.slicer.get_events_fixed_num(int(want_seq.timestamps[2]),
                                              4 * 1024)
    per = len(ev["t"]) // 4
    starts = np.arange(4, dtype=np.int64) * per
    raw, valid, offs = jnative.ingest_rectify_bin_folded(
        ev, starts, starts + per, 1024, want_seq.rectify_map, tile_h=24,
        ntx=1, slot_w=128)
    assert_dicts_equal(sample, {"raw_events": raw, "valid": valid,
                                "band_offsets": offs,
                                "label": want_seq[1]["label"]})


def test_dsec_events_match_jax(seq_root):
    for mode in ("train", "val"):
        got = dsec.DSECEvents(seq_root, mode=mode, **SEQ_KW)
        want = jdsec.DSECEvents(seq_root, mode=mode, **SEQ_KW)
        assert len(got) == len(want) == 2
        assert_dicts_equal(got[1], want[1])
    with pytest.raises(ValueError):
        dsec.DSECSequence(seq_dir(seq_root), binning="folded_bands",
                          wire_format="packed", **SEQ_KW)
    with pytest.raises(ValueError):
        dsec.DSECSequence(seq_dir(seq_root), binning="dense", **SEQ_KW)


def test_dsec_from_store_matches_files(seq_root):
    """A sequence built from memory gives the file-backed sequence's
    samples."""
    import cv2

    files = dsec.DSECSequence(seq_dir(seq_root), **SEQ_KW)
    store = files.store
    mem_store = slicer.ArrayEventStore(
        store.x[:], store.y[:], store.t[:], store.p[:],
        t_offset=store.t_offset, ms_to_idx=store.ms_to_idx)
    sem = os.path.join(seq_dir(seq_root), "semantic")
    ts = np.loadtxt(os.path.join(sem, "timestamps.txt"), dtype="int64")
    labels = [cv2.imread(os.path.join(sem, "11classes", "data",
                                      f"{i:06d}.png"), 0) for i in range(10)]
    mem = dsec.DSECSequence.from_store(mem_store, files.rectify_map, ts,
                                       labels, **SEQ_KW)
    assert len(mem) == len(files)
    for i in range(len(files)):
        assert_dicts_equal(mem[i], files[i])


@pytest.mark.parametrize("align_labels", [False, True])
@pytest.mark.parametrize("binning", ["folded", "tile", "raw"])
def test_sequence_recurrent_matches_jax(seq_root, binning, align_labels):
    kw = dict(nr_events_data=1, nr_events_window=1024)
    if binning == "raw":
        kw["tile_bin"] = False
    else:
        kw["binning"] = binning
    got = dsec.SequenceRecurrent(dsec.DSECSequence(seq_dir(seq_root), **kw),
                                 nr_events_window=1024,
                                 align_labels=align_labels)
    want = jdsec.SequenceRecurrent(jdsec.DSECSequence(seq_dir(seq_root),
                                                      **kw),
                                   nr_events_window=1024,
                                   align_labels=align_labels)
    assert len(got) == len(want) > 0
    assert got.label_idx == want.label_idx and got.label_idx
    assert got.bounds == want.bounds
    for i in range(len(want)):
        assert_dicts_equal(got[i], want[i])
    with pytest.raises(IndexError):
        got[len(got)]


# --------------------------------------------------------------- loaders


def test_synthetic_datasets_match_jax():
    for cls, jcls, kw in (
            (synthetic.SyntheticEvents, jsynthetic.SyntheticEvents,
             dict(length=3, nr_events_data=3, nr_events_window=128,
                  with_image=True)),
            (synthetic.SyntheticImages, jsynthetic.SyntheticImages,
             dict(length=3))):
        got, want = cls(**kw), jcls(**kw)
        assert len(got) == len(want)
        for i in range(len(want)):
            assert_dicts_equal(got[i], want[i])


def batches(mod, syn, **kw):
    ds = syn.SyntheticEvents(length=10, nr_events_data=3,
                             nr_events_window=128)
    return list(mod.BatchLoader(ds, **kw))


@pytest.mark.parametrize("case", [
    dict(batch_size=4, seed=3),
    dict(batch_size=3, shuffle=False, drop_last=False),
    dict(batch_size=2, seed=5, shard_index=1, num_shards=2),
    dict(batch_size=2, seed=5, collate_buffers=4, prefetch_size=2),
])
def test_batch_loader_matches_jax(case):
    """Order for a seed, shapes, sharding and the collate ring: the same
    batches as the JAX loader's (the ring's batches are compared as they
    come, before the ring recycles them)."""
    ds = synthetic.SyntheticEvents(length=10, nr_events_data=3,
                                   nr_events_window=128)
    jds = jsynthetic.SyntheticEvents(length=10, nr_events_data=3,
                                     nr_events_window=128)
    dl, jdl = loader.BatchLoader(ds, **case), jloader.BatchLoader(jds, **case)
    assert len(dl) == len(jdl)
    got = [{k: np.copy(v) for k, v in b.items()} for b in dl]
    want = [{k: np.copy(v) for k, v in b.items()} for b in jdl]
    assert len(got) == len(want) == len(dl)
    for g, w in zip(got, want):
        assert_dicts_equal(g, w)
    assert got[0]["raw_events"].shape[1:] == (3, 128, 4)
    assert got[0]["label"].shape[1:] == (32, 32)


def test_batch_loader_ring_rule():
    ds = synthetic.SyntheticEvents(length=4)
    with pytest.raises(ValueError):
        loader.BatchLoader(ds, batch_size=2, collate_buffers=3,
                           prefetch_size=2)
    dl = loader.BatchLoader(ds, batch_size=2, shuffle=False,
                            collate_buffers=4, prefetch_size=2)
    a, b = list(dl), list(dl)
    assert len(dl._ring) == 4 and a[0] is dl._ring[0] and b[0] is dl._ring[2]


def test_collate_pads_mixed_folded_capacity_like_jax():
    t_dim, small, big = 3, 100, 150

    def sample(cap):
        return {"raw_events": np.full((t_dim, cap, 4), 2.0, np.float32),
                "valid": np.ones((t_dim, cap), bool),
                "band_offsets": np.zeros((t_dim, 4), np.int32),
                "label": np.zeros((8, 8), np.uint8)}

    pair = [sample(small), sample(big)]
    got = loader._collate(pair)
    assert_dicts_equal(got, jloader._collate(pair))
    assert got["raw_events"].shape == (2, t_dim, big, 4)
    assert not got["valid"][0, :, small:].any()
    ring = loader._collate(pair, out=loader._alloc_like(
        [sample(small), sample(small)]))
    jring = jloader._collate(pair, out=jloader._alloc_like(
        [sample(small), sample(small)]))
    assert_dicts_equal(ring, jring)


def test_paired_loader_restarts_shorter_like_jax():
    def pairs(mod, syn):
        long = mod.BatchLoader(syn.SyntheticEvents(length=8), batch_size=2,
                               shuffle=False)
        short = mod.BatchLoader(syn.SyntheticImages(length=4), batch_size=2,
                                shuffle=False)
        return list(mod.PairedLoader(short, long))

    got, want = pairs(loader, synthetic), pairs(jloader, jsynthetic)
    assert len(got) == len(want) == 4
    for (a, b), (ja, jb) in zip(got, want):
        assert_dicts_equal(a, ja)
        assert_dicts_equal(b, jb)
    np.testing.assert_array_equal(got[0][0]["image"], got[2][0]["image"])


@pytest.mark.parametrize("ring", [0, 4])
def test_prefetch_to_device_on_cpu(ring):
    """Batches arrive as CPU tensors equal to the loader's arrays, in
    order, and stay intact after a recycled ring buffer is rewritten;
    non-array values pass through."""
    ds = synthetic.SyntheticEvents(length=12, nr_events_data=2,
                                   nr_events_window=64)
    want = [{k: np.copy(v) for k, v in b.items()}
            for b in loader.BatchLoader(ds, batch_size=2, shuffle=False)]
    dl = loader.BatchLoader(ds, batch_size=2, shuffle=False,
                            collate_buffers=ring, prefetch_size=2)
    src = ({**b, "note": "x"} for b in dl)
    got = list(loader.prefetch_to_device(src, size=2, device="cpu"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.pop("note") == "x"
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in g.values())
        assert_dicts_equal({k: v.numpy() for k, v in g.items()}, w)


def test_prefetch_to_device_raises_without_a_device_and_on_errors():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            next(loader.prefetch_to_device(iter([{"a": np.zeros(2)}])))

    def broken():
        yield {"a": np.zeros(2)}
        raise KeyError("worker failed")

    it = loader.prefetch_to_device(broken(), device="cpu")
    assert torch.equal(next(it)["a"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(KeyError):
        next(it)


# ---------------------------------------------------- streaming end to end


def test_streaming_eval_over_a_written_sequence_matches_jax(seq_root,
                                                            monkeypatch):
    """A written DSEC sequence (band wire, free-running labels) through
    ``SequenceRecurrent`` -> ``run_streaming_eval`` in both packages."""
    from ess_tpu.data.pipeline import EventPipeline as JaxPipeline
    from ess_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
    from ess_tpu.train import streaming as jax_streaming
    from ess_tpu.train.builder import build_modules as jax_build
    from ess_tpu.train.builder import init_state as jax_init_state

    from ess_tpu_torch.data.pipeline import EventPipeline, PipelineConfig
    from ess_tpu_torch.io.convert import params_from_jax
    from ess_tpu_torch.train import streaming
    from ess_tpu_torch.train.builder import build_modules
    from tests.test_torch_eval_step import port_config
    from tests.test_torch_streaming import (
        assert_states_close, capture_final_state)
    from tests.test_train_steps import tiny_config

    cfg = tiny_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset,
            sensor_a=dataclasses.replace(cfg.dataset.sensor_a,
                                         shape=(440, 640)),
            sensor_b=dataclasses.replace(cfg.dataset.sensor_b,
                                         shape=(440, 640), nr_events_data=1,
                                         nr_events_window=2048)),
        task=dataclasses.replace(cfg.task, semseg_num_classes=11))
    jmods = jax_build(cfg)
    jstate = jax_init_state(jmods, jax.random.PRNGKey(0))
    geo = dict(sensor_height=480, sensor_width=640, num_bins=5,
               crop_bottom=40, trilinear=True, normalize=True)
    jpipe = JaxPipeline(JaxPipelineConfig(
        use_pallas=True, pallas_interpret=True, voxel_oh_dtype="float32",
        **geo))
    mods = build_modules(port_config(cfg), device="cpu")
    sd_e, sd_h = params_from_jax(jax.device_get(jstate.e2vid_params),
                                 jax.device_get(jstate.back_params))
    mods.e2vid.load_state_dict(sd_e)
    mods.head.load_state_dict(sd_h)

    kw = dict(mode="val", nr_events_data=1, nr_events_window=2048)
    jstream = jdsec.SequenceRecurrent(
        jdsec.DSECSequence(seq_dir(seq_root), **kw), nr_events_window=2048)
    stream = dsec.SequenceRecurrent(
        dsec.DSECSequence(seq_dir(seq_root), **kw), nr_events_window=2048)
    n_scored = sum(w < len(stream) for w in stream.label_idx)
    assert len(stream) == 9 and n_scored >= 2

    seen_j = capture_final_state(monkeypatch, jax_streaming)
    want = jax_streaming.run_streaming_eval(jmods, jstate, iter(jstream),
                                            jpipe)
    seen_p = capture_final_state(monkeypatch, streaming)
    got = streaming.run_streaming_eval(mods, iter(stream),
                                       EventPipeline(PipelineConfig(**geo)))

    scored_px = n_scored * 440 * 640
    assert got.confusion.sum() == want.confusion.sum() == scored_px
    moved = np.abs(got.confusion.astype(np.int64)
                   - want.confusion.astype(np.int64)).sum() / 2
    assert moved <= 0.10 * scored_px
    assert_states_close(seen_p["state"], jax.device_get(seen_j["state"]))
