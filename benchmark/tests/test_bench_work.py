"""The frozen work counts against hand counts."""

import importlib

import pytest

from benchmark import trace, work
from benchmark.drivers import base, streaming, supervised_train, uda_train
from benchmark.run import cell_files

DSEC = cell_files("dsec_sup_train_b8")
DDD17 = cell_files("ddd17_sup_train_b16")
STREAM = cell_files("dsec_stream_b8")


def test_cells_dsec_train():
    # level i: (220 x 320) / 4**i pixels, 3x3 gates 2C -> 4C, C = 64 * 2**i
    macs = sum((220 * 320 // 4 ** i) * 9 * 2 * (64 << i) * 4 * (64 << i)
               for i in range(3))
    w = work.cell_work(DSEC.conf, 160, int8=True)
    assert w.ops == {"int8": 160 * 2 * macs}
    state = sum((220 * 320 // 4 ** i) * (64 << i) for i in range(3))
    weights = sum(9 * 2 * (64 << i) * 4 * (64 << i) for i in range(3))
    assert w.bytes == 160 * 5 * 2 * state + weights
    assert w.least_seconds() == pytest.approx(160 * 2 * macs / 1979e12)


def test_rollout_convs_dsec():
    convs = work.rollout_convs(DSEC.conf)
    assert [(c.k, c.cin, c.cout, c.hw_out) for c in convs] == [
        (5, 5, 32, 440 * 640), (5, 32, 64, 220 * 320),
        (5, 64, 128, 110 * 160), (5, 128, 256, 55 * 80)]
    head = convs[0].work(1)
    assert head.ops["bf16"] == 2 * 440 * 640 * 25 * 5 * 32
    assert head.bytes == 2 * (440 * 640 * 5 + 440 * 640 * 32 + 25 * 5 * 32)


def test_conv_backward_counts_only_needed_gradients():
    c = work.Conv(100, 3, 8, 16, 100, backward=True, grad_in=0.5, wgrad=True)
    fwd = 2 * 100 * 9 * 8 * 16
    assert c.work(2).ops["bf16"] == 2 * fwd * (1 + 0.5 + 1)
    assert work.Conv(100, 3, 8, 16, 100).work(2).ops["bf16"] == 2 * fwd


def test_head_train_dsec():
    convs = work.head_convs(DSEC.conf, train=True)
    assert len(convs) == 17
    assert convs[0].grad_in == 0.0 and convs[1].grad_in == 1.0
    assert (convs[-1].cin, convs[-1].cout, convs[-1].hw_out) == (
        32, 11, 440 * 640)
    assert work.head_convs(DSEC.conf, train=True, input_grad=True)[0] \
        .grad_in == 1.0


def test_voxelizer_bytes_ddd17():
    w = supervised_train.Driver.work(DDD17.conf, DDD17.traffic)["voxelizer"]
    assert w.ops == {"bf16": 0.0}
    assert w.bytes == 16 * 20 * (32_000 * 16 + 5 * 200 * 352 * 2)


def test_streaming_request_windows_and_cells():
    assert streaming.Driver.windows_per_request(STREAM.conf,
                                                STREAM.traffic) == 160
    layers = streaming.Driver.work(STREAM.conf, STREAM.traffic)
    assert set(layers["cells"].ops) == {"bf16"}


def test_uda_counts_front_decode_and_three_heads():
    uda = uda_train.Driver.work(DSEC.conf, {})["convs"]
    sup = supervised_train.Driver.work(DSEC.conf, {})["convs"]
    extra = work.convs_work(
        work.decode_convs(DSEC.conf) + work.front_convs(DSEC.conf, train=False)
        + work.front_convs(DSEC.conf, train=True)
        + work.head_convs(DSEC.conf, train=False, input_grad=True)
        + work.head_convs(DSEC.conf, train=True), 8)
    assert uda.ops["bf16"] == pytest.approx(sup.ops["bf16"]
                                            + extra.ops["bf16"])
    assert uda_train.Driver.windows_per_request(DSEC.conf, {}) == 160


@pytest.mark.parametrize("step", ["supervised_train", "uda_train",
                                  "streaming"])
def test_drivers_count_every_kernel_layer(step):
    files = STREAM if step == "streaming" else DSEC
    driver = importlib.import_module(f"benchmark.drivers.{step}").Driver
    assert set(driver.work(files.conf, files.traffic)) == set(
        trace.kernel_layers())


@pytest.mark.parametrize("counts", ["windows_per_request", "work"])
def test_step_kind_without_its_own_counts_raises(counts):
    class NewStep(base.Driver):
        pass

    with pytest.raises(NotImplementedError):
        getattr(NewStep, counts)(DSEC.conf, DSEC.traffic)


def test_trace_summary_reads_every_kernel_layer():
    def x(name, ts, dur, cat):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}

    events = [x("ProfilerStep#1", 0, 100, "cpu_op"),
              x("ProfilerStep#2", 100, 100, "cpu_op"),
              x("cell_kernel<1>", 10, 20, "kernel"),
              x("cell_kernel<1>", 110, 20, "kernel"),
              x("cell_kernel<1>", 140, 20, "kernel"),
              x("scatter_kernel", 40, 10, "kernel"),
              x("sm90_xmma_fprop", 60, 30, "kernel"),
              x("aten::add", 50, 40, "cpu_op")]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(100e-6)
    # two launches recorded in the second request: 20 us a launch x 2
    assert s["layer_s"] == pytest.approx(
        {"cells": 40e-6, "voxelizer": 10e-6, "convs": 30e-6})
    assert len(s["device"]) == 5 and s["breakdown"]["device_ops"][0] == [
        "cell_kernel<1>", pytest.approx(60e-6)]


def test_front_dsec():
    convs = work.front_convs(DSEC.conf, train=True)
    assert len(convs) == 1 + 4 + 2 * 5
    assert (convs[0].k, convs[0].cin, convs[0].cout, convs[0].hw_out) == (
        7, 1, 64, 220 * 320)
