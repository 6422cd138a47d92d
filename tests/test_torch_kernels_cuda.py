"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no GPU is visible (the CPU test run);
on a machine with an H100 run ``python -m pytest tests/test_torch_kernels_cuda.py``.
Bounds:
- voxelizers (fold-free B1, its full-width band wire and halo-tiled B3):
  atol/rtol 1e-5 on the grid and the stats, 1e-4 on normalized grids at
  100k events per window: both sum the same f32 corner weights, the plain
  version in f32, the kernel in 64-bit fixed point (each corner rounded to
  2^-32, the sum exact in any order, so two launches agree bit for bit,
  also with 15k events on one pixel; B3's per-tile stats within 1e-3 /
  1e-5 of the grid's and the same bits for 8 windows in one call or one
  at a time); the band wire also
  against the x-slot wire on the same events (normalized grids, 1e-4); B1
  and B3 on the persistent scatter core also at one step's 160 windows,
  at the streaming B=1 and B=8, at grid widths of one, two and three
  tiles, and with a window whose 100k events fall in one tile (raw grid
  atol 1e-4: tens of thousands of deposits a cell in run-dependent
  order); a direct launch into a NaN-filled grid leaves no NaN (every
  element stored once); B3 allocates nothing but its grid; both launchers
  refuse a plan that disagrees with their layout; a packed u16 batch
  (native ingest, folded and tile wires) decodes on the card to the CPU's
  decode bit for bit, and its windows through B1 / B3 match the plain
  versions (atol/rtol 1e-5);
- ConvLSTM cell (bf16): h atol 2e-2, c atol 3e-2, the bounds of
  tests/test_conv_lstm_pallas.py: both accumulate bf16 products in f32,
  in other orders, and round the state to bf16 once;
- int8 ConvLSTM cell against the plain int8 cell: the integer accumulators
  are exact in both and the epilogue rounds each f32 operation as the plain
  version does, so h' and c' can differ only where the kernel's expf/tanhf
  and torch's round differently: at most one bf16 ulp (+1e-6); its two prep
  kernels against the plain prep (``int8_prep_ref``): bit-identical (the
  same f32 operations); both cells' launchers refuse a plan whose layout
  disagrees, and the exact cell's wrapper a prepared weight that is not
  its weight image;
- fused 3x3 conv (bf16) and the C-major head conv with its normalize fused
  (T1, both output layouts): at most one bf16 ulp off the plain conv on at
  least 99.9 % of the values and max |d| within 2^-7 of the plain output's
  absmax (both accumulate bf16 products in f32, in other orders, and round
  once; a sum next to a rounding boundary may land one step further);
- int8 3x3 conv against the plain int8 conv: bit-identical (exact integer
  accumulators, the same f32 operations in the same order), at every conv
  shape and at the two DSEC convs at B=8; its two prep kernels against the
  plain prep (``conv3x3.int8_prep_ref``): bit-identical; the plain int8
  conv's weight scales and weights on the card equal to the CPU's (both
  divide, never multiply by a reciprocal);
- both convs never reach ``F.conv2d`` or the plain version on a CUDA tensor,
  raise on shapes the kernel does not take, and under autograd give
  ``conv3x3_ref``'s gradients (atol 1e-2 / rtol 1e-2 in bf16);
- both cells under autograd: the backward is conv_lstm_ref's at the saved
  inputs, so gradients match conv_lstm_ref's with the same cotangents
  (atol 1e-2 / rtol 1e-2 in bf16: cuDNN may pick other algorithms);
- fused encoder level against its plain version: the conv's output x
  (its group layout, written into a caller's buffer) and the group scales
  amax_u and amax_x identical (x is the same f32 operations on exact
  integers, the scales maxima of the same values; the quantized operands,
  rounded from them by the same f32 product, are then identical too), h'
  and c' within one bf16 ulp (+1e-6), as the int8 cell; after a 20-step
  carried chain, each on its own state, at least 99.9 % of the values
  within one bf16 ulp and max |d| <= 0.05 (a state value that differs by
  an ulp can move an int8 code of h at the next step); its launcher refuses
  a plan that disagrees with its layout; its weight prep
  (``prepare_level_weights``, ``quant_cols``) on the card equals the CPU's
  bits;
- cell variants against their plain versions: int8 body within one bf16 ulp
  (+1e-6) for ``ptw_mul`` and ``no_ptw`` (the same f32 operations on exact
  integers) and on at least 99.9 % of the values for ``ptw_bf16`` (a tanhf
  that rounds to the other bf16 neighbour moves the result by an ulp or
  two; all within 2^-5); bf16 body: max |d| within 2^-6 of the plain
  output's absmax (f32 accumulation in another order, then one bf16
  rounding of values of any size), ``ptw_bf16`` within 2^-4 absolute;
- the reconstruction program's windows (B=1 on the 260x346 DAVIS346
  sensor, integer coordinates, temporal bilinear, 10k and a ragged 7919
  events, device-side tile binning): B3 under the voxelizers' bounds
  (raw grid 1e-5, normalized 1e-4), and the padded f32 ``Reconstructor``
  step (264x352) over five carried windows, the kernel path against the
  plain path (B3's plain version): images within 1e-3 absolute, their 8-bit
  frames within 1 grey level on at most 1 % of the pixels;
- the dense and in-loop forms: B3 on raw sensor-coordinate events
  rectified on the card (a map with sub-pixel offsets whose bands leave
  the frame on every side, 8 windows of 100k events, tile sort on the
  card) against its plain version on the CPU, and ``voxelize_windows``
  through it (the voxelizers' bounds: raw grid 1e-5, normalized 1e-4);
  B1 (folded wire) and B3 (tile and raw wires) launched one window at a
  time (``make_window_fn``, the in-loop rollout's voxelizer) against one
  batched ``build_all`` launch of the same windows: normalized grids
  within 1e-4 where both are nonzero, at most 16 cells zero in one only
  (+ and - deposits that cancel in one sum order: ``chip_smoke.py``'s
  VOXEL_PATTERN_MAX), one launch a window.
"""

import numpy as np
import pytest
import torch

from ess_tpu_torch.cli import reconstruct
from ess_tpu_torch.models import layers
from ess_tpu_torch.ops import batch_voxel
from ess_tpu_torch.ops import conv3x3 as c3
from ess_tpu_torch.ops import conv_halo as chp
from ess_tpu_torch.ops import conv_lstm as cl
from ess_tpu_torch.ops import head_cmajor as hc
from ess_tpu_torch.ops import level as lv
from ess_tpu_torch.ops import voxel_folded as vf
from ess_tpu_torch.ops import voxel_scatter as vs
from ess_tpu_torch.ops import voxel_tiled as vt
from ess_tpu_torch.ops.conv_lstm import input_scale
from ess_tpu_torch.ops.batch_voxel import (band_operands, voxelize_band,
                                          voxelize_tile, voxelize_window_soa)
from ess_tpu_torch.ops.pad import crop_output
from ess_tpu_torch.recon.reconstructor import Reconstructor
from ess_tpu_torch.ops.voxel import (
    grid_stats, masked_time_norm, normalize_from_stats, normalize_nonzero,
    voxel_grid_trilinear)
from ess_tpu_torch.tools import bench_head, bench_level
from ess_tpu_torch.tools import bench_lstm_breakdown as bd

pytestmark = pytest.mark.cuda

# The int8 cell and conv at every shape: these tests hold the int8 kernels at
# shapes below the JAX package's size rule, where 'pallas_int8' is the exact
# op (tests/test_torch_int8_rule.py).
INT8 = "pallas_int8_interpret"
EVERY_SHAPE = {"pallas": "pallas", "pallas_int8": INT8}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def folded(rng, b, n, h, w):
    raw = np.zeros((b, n, 4), np.float32)
    raw[..., 0] = rng.uniform(-0.5, w - 0.5, (b, n))
    raw[..., 1] = rng.uniform(-0.5, h - 0.5, (b, n))
    raw[..., 2] = np.sort(rng.uniform(0, 1e4, (b, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, n - n // 10:] = False
    r, v, o = vf.host_band_bin_folded(raw, valid, height=h, width=w, bins=5)
    cols = [torch.from_numpy(np.ascontiguousarray(r[..., i])) for i in range(4)]
    return raw, valid, cols + [torch.from_numpy(v)], torch.from_numpy(o)


@pytest.mark.parametrize("wire", ["folded", "tile"])
def test_packed_wire_on_the_card(dev, wire):
    """B=2 x T=3 windows of 100k events on 480x640 through the packed
    ingest: decoded where they lie (the card, the CPU), then ``build_all``
    with one voxelizer launch."""
    from ess_tpu_torch.data import loader, native
    from ess_tpu_torch.data.pipeline import (EventPipeline, PipelineConfig,
                                             to_soa)

    rng = np.random.default_rng(12)
    t_dim, n = 3, 100_000
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    rmap = np.stack([xx + rng.uniform(-0.4, 0.4, xx.shape),
                     yy + rng.uniform(-0.4, 0.4, yy.shape)],
                    -1).astype(np.float32)
    starts = np.arange(t_dim, dtype=np.int64) * n
    samples = []
    for _ in range(2):
        ev = {"x": rng.integers(0, 640, t_dim * n).astype(np.uint16),
              "y": rng.integers(0, 480, t_dim * n).astype(np.uint16),
              "t": np.sort(rng.integers(0, 10**6, t_dim * n)),
              "p": rng.integers(0, 2, t_dim * n).astype(np.uint8)}
        samples.append(
            native.ingest_rectify_bin_packed(ev, starts, starts + n, n, rmap,
                                             tile_h=24) if wire == "tile"
            else native.ingest_rectify_bin_packed_folded(
                ev, starts, starts + n, n, rmap, tile_h=24, ntx=5))
    batch = {k: torch.from_numpy(v)
             for k, v in to_soa(loader._collate(samples)).items()}
    on_card = {k: v.to(dev) for k, v in batch.items()}
    pipe = EventPipeline(PipelineConfig(sensor_height=480, sensor_width=640,
                                        num_bins=5, trilinear=True))
    want = pipe.decode_packed(batch)
    got = pipe.decode_packed(on_card)
    assert got.pop("ev_t_prenormalized") and want.pop("ev_t_prenormalized")
    for k, v in want.items():
        assert got[k].device.type == "cuda", k
        assert torch.equal(got[k].cpu(), v), k
    counter = (vf, "launches") if wire == "folded" else (vt, "launches")
    n0 = getattr(*counter)
    grids, _ = pipe.build_all(on_card)
    torch.cuda.synchronize()
    assert getattr(*counter) == n0 + 1
    ref, _ = pipe.build_all(batch)
    torch.testing.assert_close(grids.cpu(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w", [(48, 256), (26, 170), (480, 640)])
def test_voxel_kernel_matches_plain(dev, h, w):
    raw, valid, cols, offs = folded(np.random.default_rng(0), 3, 20000, h, w)
    kw = dict(num_bins=5, height=h, width=w, normalize=True)
    n0 = vf.launches
    got = voxelize_band(*[c.to(dev) for c in cols], offs.to(dev), **kw)
    torch.cuda.synchronize()
    assert vf.launches == n0 + 1
    want = voxelize_band(*cols, offs, **kw)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    plain = voxel_grid_trilinear(
        *map(torch.from_numpy, (raw[..., 0], raw[..., 1], raw[..., 2],
                                raw[..., 3], valid)), **kw)
    torch.testing.assert_close(got.cpu(), plain, atol=2e-3, rtol=1e-4)


def test_voxel_kernel_stats(dev):
    h, w = 48, 256
    _, _, (x, y, t, p, _), offs = folded(np.random.default_rng(1), 2, 5000,
                                         h, w)
    ts = t / t.amax(dim=1, keepdim=True) * 4.0
    args = [a.to(dev).contiguous() for a in (x, y, ts, p)] + [offs.to(dev)]
    grid, stats = vf.voxelize_folded(*args, bins=5, height=h, width=w)
    grid_r, stats_r = vf.voxelize_folded_ref(*[a.cpu() for a in args],
                                             bins=5, height=h, width=w)
    torch.testing.assert_close(grid.cpu(), grid_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats.cpu(), stats_r, atol=1e-3, rtol=1e-5)
    with pytest.raises(ValueError):
        vf.voxelize_folded(*args[:4], args[4].long(), bins=5, height=h,
                           width=w)


def test_voxel_kernel_one_slot_sensor(dev):
    """B1 at a 128-wide sensor: one x-slot per band."""
    h, w = 120, 128
    _, _, cols, offs = folded(np.random.default_rng(2), 4, 20000, h, w)
    assert offs.shape[1] == h // 24 + 1
    kw = dict(num_bins=5, height=h, width=w, normalize=True)
    n0 = vf.launches
    got = voxelize_band(*[c.to(dev) for c in cols], offs.to(dev), **kw)
    torch.cuda.synchronize()
    assert vf.launches == n0 + 1
    torch.testing.assert_close(got.cpu(), voxelize_band(*cols, offs, **kw),
                               atol=1e-5, rtol=1e-5)


def ddd17_records(rng, b, n, bins):
    """``b`` windows of ``n`` integer-coordinate events on DDD17's 260x346
    sensor (a tenth invalid, a few off the sensor), binned into integer
    band records for ``bins`` channels."""
    h, w = 260, 346
    raw = np.zeros((b, n, 4), np.float32)
    raw[..., 0] = rng.integers(-1, w + 1, (b, n))
    raw[..., 1] = rng.integers(0, h, (b, n))
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, (b, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, n - n // 10:] = False
    r, v, o = vf.host_band_bin_folded(raw, valid, height=h, width=w,
                                      bins=bins, trilinear=False)
    cols = [torch.from_numpy(np.ascontiguousarray(r[..., i]))
            for i in range(4)]
    return cols + [torch.from_numpy(v)], torch.from_numpy(o)


@pytest.mark.parametrize("separate_pol", [False, True])
def test_voxel_kernel_integer_records_ddd17(dev, separate_pol):
    """B1 on ghost-free integer records at 260x346 (padded to 264x384 at 5
    bins, 260x384 at 10: 11 or 26 bands of three x-slots, the last only
    90 columns live), one sample's 20 windows of 32k events: the grid and
    the normalized grid against the plain version (atol/rtol 1e-5), the
    padded columns and rows empty, and the stats those of the sensor
    grid alone."""
    bins = 10 if separate_pol else 5
    cols, offs = ddd17_records(np.random.default_rng(3), 20, 32_000, bins)
    assert offs.shape[1] == (11 if bins == 5 else 26) * 3 + 1
    kw = dict(num_bins=5, height=260, width=346, separate_pol=separate_pol,
              trilinear=False)
    for normalize in (False, True):
        n0 = vf.launches
        got = voxelize_band(*[c.to(dev) for c in cols], offs.to(dev),
                            normalize=normalize, **kw)
        torch.cuda.synchronize()
        assert vf.launches == n0 + 1
        want = voxelize_band(*cols, offs, normalize=normalize, **kw)
        assert got.shape == (20, bins, 260, 346)
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    # the kernel's own grid: nothing in the pad, stats of the sensor grid
    args, kwf = band_operands(*[c.to(dev) for c in cols], offs.to(dev), **kw)
    assert kwf == dict(bins=bins, height=264 if bins == 5 else 260,
                       width=384)
    grid, stats = vf.voxelize_folded(*args, **kwf)
    assert not grid[..., 346:].any() and not grid[:, :, 260:].any()
    live = grid[:, :, :260, :346].double()
    torch.testing.assert_close(stats.double(), torch.stack(
        [live.sum((1, 2, 3)), (live * live).sum((1, 2, 3)),
         (live != 0).sum((1, 2, 3)).double()], -1), atol=1e-2, rtol=1e-5)


def raw_windows(rng, b, n, h, w, edges=False):
    raw = np.zeros((b, n, 4), np.float32)
    raw[..., 0] = rng.uniform(-0.9, w - 0.1, (b, n))
    raw[..., 1] = rng.uniform(-0.9, h - 0.1, (b, n))
    if edges:
        # just below tile boundaries (24 rows, 128 columns) and the borders
        k = n // 3
        frac = rng.uniform(0.02, 0.98, (2, b, k)).astype(np.float32)
        raw[:, :k, 0] = np.minimum(
            rng.integers(1, w // 128 + 1, (b, k)) * 128 - 1 + frac[0],
            w - 0.01)
        raw[:, k:2 * k, 1] = np.minimum(
            rng.integers(1, h // 24 + 1, (b, k)) * 24 - 1 + frac[1],
            h - 0.01)
    raw[..., 2] = np.sort(rng.uniform(0, 5e4, (b, n)), axis=-1)
    raw[..., 3] = rng.integers(0, 2, (b, n))
    valid = np.ones((b, n), bool)
    valid[:, n - n // 10:] = False
    return raw, valid


@pytest.mark.parametrize("host", [True, False])
@pytest.mark.parametrize("h,w,n,edges", [(480, 640, 100_000, False),
                                         (480, 640, 100_000, True),
                                         (48, 256, 5000, True),
                                         (16, 16, 500, False)])
def test_voxel_tiled_kernel_matches_plain(dev, h, w, n, edges, host):
    """B3 through voxelize_tile at the DSEC shape (8 windows x 100k events)
    and small sensors, host offsets and device-side binning."""
    raw, valid = raw_windows(np.random.default_rng(0), 8, n, h, w, edges)
    offs = None
    if host:
        raw, valid, o = vt.host_tile_bin(raw, valid, height=h, width=w)
        offs = torch.from_numpy(o)
    cols = [torch.from_numpy(np.ascontiguousarray(raw[..., i]))
            for i in range(4)] + [torch.from_numpy(valid)]
    kw = dict(num_bins=5, height=h, width=w, trilinear=True)
    n0 = vt.launches
    got = voxelize_tile(*[c.to(dev) for c in cols],
                        None if offs is None else offs.to(dev), **kw)
    torch.cuda.synchronize()
    assert vt.launches == n0 + 1
    want = voxelize_tile(*cols, offs, **kw)
    assert vt.launches == n0 + 1                      # CPU: the plain version
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(normalize_nonzero(got).cpu(),
                               normalize_nonzero(want), atol=1e-4, rtol=1e-4)
    plain = voxel_grid_trilinear(*cols, num_bins=5, height=h, width=w)
    torch.testing.assert_close(got.cpu(), plain, atol=2e-3, rtol=1e-4)


def test_voxel_tiled_kernel_ten_bins_integer(dev):
    """bins 10 / tile height 10: the separate_pol temporal grid."""
    h, w = 480, 640
    raw, valid = raw_windows(np.random.default_rng(1), 8, 100_000, h, w)
    raw[..., :2] = np.floor(raw[..., :2])
    cols = [torch.from_numpy(np.ascontiguousarray(raw[..., i]))
            for i in range(4)] + [torch.from_numpy(valid)]
    kw = dict(num_bins=5, height=h, width=w, separate_pol=True,
              trilinear=False, normalize=True)
    got = voxelize_tile(*[c.to(dev) for c in cols], **kw)
    assert got.shape == (8, 10, h, w)
    torch.testing.assert_close(got.cpu(), voxelize_tile(*cols, **kw),
                               atol=1e-4, rtol=1e-4)


def test_voxel_tiled_wrapper(dev):
    """Kernel-level call: empty tiles write zeros, offsets stay on the
    device, and the wrapper raises on what the kernel does not take."""
    h, w = 48, 256
    x = torch.tensor([[3.5, 200.25, 0.0]], device=dev)
    y = torch.tensor([[2.0, 47.5, 0.0]], device=dev)
    ts = torch.tensor([[0.5, 4.0, 0.0]], device=dev)
    pol = torch.tensor([[1.0, -1.0, 0.0]], device=dev)
    offs = torch.tensor([[0, 1, 1, 1, 2]], dtype=torch.int32, device=dev)
    grid = vt.voxelize_tiled(x, y, ts, pol, offs, bins=5, height=h, width=w)
    want = vt.voxelize_tiled_ref(x.cpu(), y.cpu(), ts.cpu(), pol.cpu(),
                                 offs.cpu(), bins=5, height=h, width=w)
    torch.testing.assert_close(grid.cpu(), want, atol=1e-6, rtol=0)
    assert grid[0, :, :24, 128:].abs().sum().item() == 0      # empty tile
    assert grid[0, 4, 47, 200].item() == pytest.approx(-0.375)
    with pytest.raises(ValueError):
        vt.voxelize_tiled(x, y, ts, pol, offs.long(), bins=5, height=h,
                          width=w)
    with pytest.raises(ValueError):
        vt.voxelize_tiled(x.double(), y, ts, pol, offs, bins=5, height=h,
                          width=w)
    with pytest.raises(ValueError):
        vt.voxelize_tiled(x, y, ts, pol, offs.cpu(), bins=5, height=h,
                          width=w)


def cell_inputs(dev, b, h, w, cx, ch, seed=0):
    g = torch.Generator().manual_seed(seed)
    cl_ = torch.channels_last
    mk = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale)
    x = mk(b, cx, h, w).to(dev, torch.bfloat16).contiguous(memory_format=cl_)
    hp = torch.tanh(mk(b, ch, h, w)).to(dev, torch.bfloat16).contiguous(
        memory_format=cl_)
    cp = mk(b, ch, h, w).to(dev, torch.bfloat16).contiguous(memory_format=cl_)
    wgt = mk(4 * ch, cx + ch, 3, 3, scale=0.05).to(dev)
    bias = mk(4 * ch, scale=0.1).to(dev)
    return x, hp, cp, wgt, bias


# cells (B, H, W, CX, CH): small ragged ones, CX != CH both ways, B = 1
# and 3, W not a multiple of the 16- or 32-pixel patch, and DSEC level 2's
# 55 rows (a ragged last patch row) at B = 1, 2 and 3
CELL_SHAPES = [(2, 10, 13, 32, 32), (1, 22, 40, 64, 64), (2, 9, 11, 256, 256),
               (1, 5, 7, 64, 32), (3, 37, 50, 32, 64), (1, 37, 50, 96, 32),
               (1, 55, 80, 256, 256), (2, 55, 80, 256, 256),
               (3, 55, 80, 256, 256)]


@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_conv_lstm_kernel_matches_plain(dev, shape):
    x, hp, cp, wgt, bias = cell_inputs(dev, *shape)
    h_ref, c_ref = cl.conv_lstm_ref(x, hp, cp, wgt, bias)
    hp0 = hp.clone()
    n0 = cl.launches
    h_new, c_new = cl.conv_lstm_cell(x, hp, cp, wgt, bias)
    torch.cuda.synchronize()
    assert cl.launches == n0 + 1
    assert c_new.data_ptr() == cp.data_ptr()          # c updated in place
    assert torch.equal(hp, hp0)                       # h_prev untouched
    torch.testing.assert_close(h_new.float(), h_ref.float(), atol=2e-2,
                               rtol=0)
    torch.testing.assert_close(c_new.float(), c_ref.float(), atol=3e-2,
                               rtol=0)


def test_conv_lstm_wrapper_rejects(dev):
    x, hp, cp, wgt, bias = cell_inputs(dev, 1, 4, 4, 32, 32)
    with pytest.raises(ValueError):
        cl.conv_lstm_cell(x.float(), hp, cp, wgt, bias)
    with pytest.raises(ValueError):
        cl.conv_lstm_cell(x.contiguous(), hp.contiguous(), cp, wgt, bias)
    with pytest.raises(ValueError):
        cl.conv_lstm_cell(x, hp, hp, wgt, bias)
    x16, h16, c16, w16, b16 = cell_inputs(dev, 1, 4, 4, 16, 16)
    with pytest.raises(ValueError):
        cl.conv_lstm_cell(x16, h16, c16, w16, b16)


def test_conv_lstm_wrapper_refuses_the_gate_matrix(dev):
    """The exact kernel reads its weight image
    (``prepare_cell_weights(w, 'pallas')``); the prepared 2-D gate matrix
    (``prepare_gate_weights(w)``), which the earlier kernel read, is refused
    before any launch. The image itself runs."""
    x, hp, cp, wgt, bias = cell_inputs(dev, 1, 12, 14, 32, 64)
    n0 = cl.launches
    with pytest.raises(ValueError):
        cl.conv_lstm_cell(x, hp, cp, wgt, bias,
                          prepared=cl.prepare_gate_weights(wgt))
    assert cl.launches == n0
    img = cl.prepare_cell_weights(wgt, "pallas")
    assert img.dim() == 5
    h_img, c_img = cl.conv_lstm_cell(x, hp, cp.clone(), wgt, bias,
                                     prepared=img)
    h_own, c_own = cl.conv_lstm_cell(x, hp, cp.clone(), wgt, bias)
    torch.cuda.synchronize()
    assert torch.equal(h_img, h_own) and torch.equal(c_img, c_own)


def bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at max(|a|, |b|): 2^(e - 8) for values in [2^(e-1), 2^e)."""
    _, e = torch.frexp(torch.maximum(a.float().abs(), b.float().abs()))
    return torch.ldexp(torch.ones_like(a, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("shape", CELL_SHAPES + [
    (1, 9, 11, 256, 256), (2, 220, 320, 64, 64), (2, 110, 160, 128, 128)])
def test_conv_lstm_int8_kernel_matches_plain(dev, shape):
    b, h, w, cx, ch = shape
    x, hp, cp, wgt, bias = cell_inputs(dev, *shape)
    x = torch.relu(x) * 2
    wgt = wgt * (0.05 * (9 * (cx + ch)) ** 0.5) ** -1
    h_ref, c_ref = cl.conv_lstm_int8_ref(x, hp, cp, wgt, bias)
    hp0 = hp.clone()
    n0, e0, p0 = cl.launches_int8, cl.launches, cl.launches_int8_prep
    if cl.pick_row_tile(h) is not None:
        h_new, c_new = cl.conv_lstm_cell(x, hp, cp, wgt, bias, impl=INT8)
    else:   # the name runs the exact cell here, as in the JAX package
        h_new, c_new = cl._launch_int8(x, hp, cp, wgt, bias, None)
    torch.cuda.synchronize()
    assert cl.launches_int8 == n0 + 1 and cl.launches == e0
    assert cl.launches_int8_prep == p0 + 2
    assert c_new.data_ptr() == cp.data_ptr()          # c updated in place
    assert torch.equal(hp, hp0)                       # h_prev untouched
    for got, want in ((h_new, h_ref), (c_new, c_ref)):
        d = (got.float() - want.float()).abs()
        assert (d <= bf16_ulp(got, want) + 1e-6).all(), d.max()


# the six DDD17 cells at B=16 (B, H, W, CX, CH): the 200x352 rollout's
# three levels and the 120x216 UDA crop's (partial pixel tiles in both axes
# at 25x44 and 15x27)
DDD17_CELLS = [(16, 100, 176, 64, 64), (16, 50, 88, 128, 128),
               (16, 25, 44, 256, 256), (16, 60, 108, 64, 64),
               (16, 30, 54, 128, 128), (16, 15, 27, 256, 256)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", DDD17_CELLS)
def test_cells_at_ddd17_shapes(dev, shape, int8):
    """B2 and B2-int8 (the int8 cell at every shape) at the DDD17 level
    shapes against their plain versions, under the bounds above."""
    b, h, w, cx, ch = shape
    x, hp, cp, wgt, bias = cell_inputs(dev, *shape)
    if int8:
        x = torch.relu(x) * 2
        wgt = wgt * (0.05 * (9 * (cx + ch)) ** 0.5) ** -1
        h_ref, c_ref = cl.conv_lstm_int8_ref(x, hp, cp, wgt, bias)
    else:
        h_ref, c_ref = cl.conv_lstm_ref(x, hp, cp, wgt, bias)
    counts = (cl.launches, cl.launches_int8)
    h_new, c_new = cl.conv_lstm_cell(x, hp, cp, wgt, bias,
                                     impl=INT8 if int8 else "pallas")
    torch.cuda.synchronize()
    assert (cl.launches, cl.launches_int8) == (counts[0] + (not int8),
                                               counts[1] + int8)
    if int8:
        for got, want in ((h_new, h_ref), (c_new, c_ref)):
            d = (got.float() - want.float()).abs()
            assert (d <= bf16_ulp(got, want) + 1e-6).all(), d.max()
    else:
        torch.testing.assert_close(h_new.float(), h_ref.float(), atol=2e-2,
                                   rtol=0)
        torch.testing.assert_close(c_new.float(), c_ref.float(), atol=3e-2,
                                   rtol=0)


@pytest.mark.parametrize("shape", DDD17_CELLS)
def test_int8_rule_routes_the_cells_on_the_card(dev, shape):
    """'pallas_int8' launches B2-int8 where the JAX package's size rule
    holds and B2, with the exact weight image, where it does not (its
    result is then the exact cell's, bit for bit), through the model's
    cell as the rollout calls it."""
    b, h, w, cx, ch = shape
    x, hp, cp, _, _ = cell_inputs(dev, *shape)
    cell = layers.ConvLSTMCell(cx, ch, device=dev)
    rule = cl.int8_size_rule(tuple(x.shape))
    counts = (cl.launches, cl.launches_int8)
    with torch.no_grad():
        h8, (_, c8) = cell(x, (hp, cp.clone()), "pallas_int8")
        torch.cuda.synchronize()
        assert (cl.launches, cl.launches_int8) == (
            counts[0] + (not rule), counts[1] + rule)
        if not rule:
            he, (_, ce) = cell(x, (hp, cp.clone()), "pallas")
            assert torch.equal(h8, he) and torch.equal(c8, ce)
            assert cell._prepared["pallas"][1].dim() == 5
            assert "pallas_int8" not in cell._prepared


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8"])
def test_kernel_cells_backward(dev, impl):
    impl = EVERY_SHAPE[impl]
    x, hp, cp, wgt, bias = cell_inputs(dev, 1, 12, 14, 32, 64, seed=3)
    g = torch.Generator().manual_seed(4)
    ct_h, ct_c = (torch.randn(1, 64, 12, 14, generator=g).to(dev)
                  for _ in range(2))
    with torch.no_grad():
        h_ng, c_ng = cl.conv_lstm_cell(x, hp, cp.clone(), wgt, bias,
                                       impl=impl)

    def grads(fn):
        ins = [t.detach().clone(memory_format=torch.preserve_format)
               .requires_grad_(True) for t in (x, hp, cp, wgt, bias)]
        c_before = ins[2].detach().clone()
        hn, cn = fn(*ins)
        ((hn.float() * ct_h).sum() + (cn.float() * ct_c).sum()).backward()
        assert torch.equal(ins[2].detach(), c_before)   # c_prev intact
        return (hn, cn), [t.grad for t in ins]

    n0 = cl.launches + cl.launches_int8
    (hn, cn), g_k = grads(lambda *a: cl.conv_lstm_cell(*a, impl=impl))
    assert cl.launches + cl.launches_int8 == n0 + 1
    assert torch.equal(hn, h_ng) and torch.equal(cn, c_ng)
    _, g_r = grads(cl.conv_lstm_ref)
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.parametrize("shape", [(2, 5, 7, 32, 64), (1, 37, 50, 96, 32),
                                   (2, 55, 80, 256, 256)])
def test_int8_prep_kernels_match_plain(dev, shape):
    """The two prep kernels give the plain prep's scales, weight image,
    column scales and padded int8 copies bit for bit (no host sync)."""
    b, h, w, cx, ch = shape
    x, hp, _, wgt, _ = cell_inputs(dev, *shape, seed=8)
    x = x * 3
    prep = cl.prepare_gate_weights(wgt, torch.float32)
    got = cl.int8_prep(x, hp, prep)
    want = cl.int8_prep_ref(x, hp, prep, cx)
    for name, a, b_ in zip(("scal", "w_img", "ws", "xq", "hq"), got, want):
        assert a.shape == b_.shape and torch.equal(a, b_), name


def two_rank_absmax(monkeypatch, rows_of_other):
    """Emulate rank r of two data-parallel ranks in this process: the
    world reads 2 and ``dp.all_max`` takes the maximum with the other
    rank's |x| (``rows_of_other``, bf16, whose absmax is exact)."""
    from ess_tpu_torch.parallel import dp

    other = rows_of_other.abs().amax().float().view(1)
    monkeypatch.setattr(dp, "world", lambda: 2)
    monkeypatch.setattr(dp, "all_max", lambda t: torch.maximum(t, other))


@pytest.mark.parametrize("kind,shape", [
    ("cell", (4, 55, 80, 256, 256)), ("cell", (2, 7, 9, 32, 64)),
    ("conv", (4, 220, 320, 128, 64)), ("conv", (2, 13, 40, 24, 16))])
def test_int8_prep_global_absmax(dev, kind, shape, monkeypatch):
    """Under data parallel each rank's int8 prep takes the global batch's
    x absmax: ``ess_int8_absmax`` on its rows, the maximum over the ranks
    (``dp.all_max``; two ranks emulated in this process), then the prep
    kernel with ``n_given=1``. Each rank's scales and weights equal the
    two-launch prep's on the global batch bit for bit, and so do the
    cell's quantized x and h rows; sample 1 (rank 1's first row) has the
    largest |x| by far, so a rank-local absmax fails this test."""
    b, h, w, cin, cout = shape
    if kind == "cell":
        x, hp, _, wgt, _ = cell_inputs(dev, *shape, seed=9)
        prep = cl.prepare_gate_weights(wgt, torch.float32)
        run = lambda x_, r: cl.int8_prep(x_, hp[r], prep)
        names = ("scal", "w_img", "ws", "xq", "hq")
    else:
        x, wgt, _ = conv_inputs(dev, *shape, seed=9)
        prep = c3.prepare_conv_weights(wgt, int8=True)
        run = lambda x_, r: c3.int8_prep(x_, prep)
        names = ("scal", "wq", "ws")
    x[b // 2] *= 16
    whole = slice(0, b)
    want = run(x, whole)
    halves = [slice(0, b // 2), slice(b // 2, b)]
    for r, rows in enumerate(halves):
        alone = run(x[rows], rows)
        assert (alone[0][0] != want[0][0]) == (r == 0)
        with monkeypatch.context() as m:
            two_rank_absmax(m, x[halves[1 - r]])
            p0 = cl.launches_int8_prep + c3.launches_int8_prep
            got = run(x[rows], rows)
            assert cl.launches_int8_prep + c3.launches_int8_prep == p0 + 2
        for name, a, b_ in zip(names, got, want):
            if name in ("xq", "hq"):
                b_ = b_[rows]
            assert a.shape == b_.shape and torch.equal(a, b_), (name, r)


def test_cell_launchers_refuse_a_plan_that_disagrees(dev):
    """The cell launchers rebuild the plan's layout and refuse (an error,
    no launch) a patch of other than 256 pixels, a patch width that is not
    a multiple of 16, a shared-memory size that disagrees (among them that
    of a ring of three stages) and an empty grid; the plan's own runs, in
    both cells."""
    from ess_tpu_torch import kernels
    from ess_tpu_torch.ops import conv_halo

    lib = kernels.get_lib()
    stream = torch.cuda.current_stream().cuda_stream
    b, h, w, cx, ch = 1, 12, 14, 32, 64
    x, hp, cp, wgt, bias = cell_inputs(dev, b, h, w, cx, ch)
    bias = bias.float().contiguous()
    hn = torch.empty_like(hp, memory_format=torch.channels_last)
    smem_of = conv_halo.cell_smem
    for int8 in (False, True):
        plan = conv_halo.cell_plan(b, h, w, cx, ch, int8=int8)
        if int8:
            _, img, ws, xq, hq = cl.int8_prep(
                x, hp, cl.prepare_gate_weights(wgt, torch.float32))
            entry = lib.ess_conv_lstm_int8
            head = (xq.data_ptr(), hq.data_ptr(), cp.data_ptr(),
                    img.data_ptr(), ws.data_ptr(), bias.data_ptr(),
                    hn.data_ptr(), b, h, w, cx, ch)
        else:
            img = cl.prepare_cell_weights(wgt, "pallas")
            entry = lib.ess_conv_lstm
            head = (x.data_ptr(), hp.data_ptr(), cp.data_ptr(),
                    img.data_ptr(), bias.data_ptr(), hn.data_ptr(), b, h, w,
                    cx, ch)
        good = dict(th=plan.th, tw=plan.tw, grid=plan.grid, smem=plan.smem)
        for bad in (dict(th=2 * plan.th, smem=smem_of(2 * plan.th, plan.tw)),
                    dict(th=32, tw=8, smem=smem_of(32, 8)),
                    dict(smem=plan.smem + 16),
                    dict(smem=smem_of(plan.th, plan.tw, 3)),
                    dict(grid=0)):
            args = {**good, **bad}
            assert entry(*head, *args.values(), stream) != 0, (int8, bad)
        assert entry(*head, *good.values(), stream) == 0
        torch.cuda.synchronize()


def test_conv_lstm_int8_wrapper_rejects(dev):
    x, hp, cp, wgt, bias = cell_inputs(dev, 1, 4, 4, 32, 32)
    for args in ((x.float(), hp, cp), (x.contiguous(), hp.contiguous(), cp),
                 (x, hp, hp)):
        with pytest.raises(ValueError):
            cl.conv_lstm_cell(*args, wgt, bias, impl=INT8)
    x16, h16, c16, w16, b16 = cell_inputs(dev, 1, 4, 4, 16, 16)
    with pytest.raises(ValueError):
        cl.conv_lstm_cell(x16, h16, c16, w16, b16, impl=INT8)
    with pytest.raises(ValueError):
        cl.conv_lstm_cell(x, hp, cp, wgt, bias, impl=INT8,
                          prepared=cl.prepare_gate_weights(wgt))


def conv_inputs(dev, b, h, w, cin, cout, seed=0, bias=True):
    g = torch.Generator().manual_seed(seed)
    x = (torch.relu(torch.randn(b, cin, h, w, generator=g)) * 2).to(
        dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wgt = (torch.randn(cout, cin, 3, 3, generator=g)
           * (9 * cin) ** -0.5).to(dev)
    bia = (torch.randn(cout, generator=g) * 0.1).to(dev) if bias else None
    return x, wgt, bia


# (B, H, W, C_in, C_out). After the first seven, shapes for the 2-D pixel
# tiles of the halo core: H and W not multiples of the patch, W below its
# width, B > 1, C_in 4 / 20 / 36 / 128 against C_out 8 / 24 / 64 / 128, and
# weights too large to stay resident (C_in 512) over two N tiles.
CONV_SHAPES = [(2, 13, 40, 24, 16), (1, 9, 11, 20, 128), (2, 22, 32, 128, 64),
               (1, 7, 5, 4, 8), (1, 16, 16, 36, 40), (2, 220, 320, 20, 128),
               (2, 220, 320, 128, 64),
               (3, 17, 45, 4, 24), (2, 9, 7, 36, 128), (2, 30, 50, 128, 8),
               (2, 11, 70, 20, 64), (1, 5, 200, 36, 24),
               (2, 19, 21, 128, 128), (1, 8, 16, 512, 136)]


@pytest.mark.parametrize("relu,bias", [(True, True), (False, True),
                                       (True, False)])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(dev, shape, relu, bias):
    x, wgt, bia = conv_inputs(dev, *shape, bias=bias)
    want = c3.conv3x3_ref(x, wgt, bia, relu=relu)
    n0, i0 = c3.launches, c3.launches_int8
    got = c3.conv3x3_fused(x, wgt, bia, relu=relu, impl="pallas")
    torch.cuda.synchronize()
    assert c3.launches == n0 + 1 and c3.launches_int8 == i0
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    d = (got.float() - want.float()).abs()
    within = (d <= bf16_ulp(got, want)).float().mean().item()
    assert within >= 0.999, within
    assert d.max().item() <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.parametrize("relu,bias", [(True, True), (False, True),
                                       (True, False)])
@pytest.mark.parametrize("shape", CONV_SHAPES + [(8, 220, 320, 20, 128),
                                                 (8, 220, 320, 128, 64)])
def test_conv3x3_int8_kernel_matches_plain(dev, shape, relu, bias):
    """Bit for bit; three launches a conv: two prep kernels, the conv."""
    x, wgt, bia = conv_inputs(dev, *shape, seed=1, bias=bias)
    want = c3.conv3x3_int8_ref(x, wgt, bia, relu=relu)
    n0, i0, p0 = c3.launches, c3.launches_int8, c3.launches_int8_prep
    got = c3.conv3x3_fused(x, wgt, bia, relu=relu, impl=INT8)
    torch.cuda.synchronize()
    assert c3.launches == n0 and c3.launches_int8 == i0 + 1
    assert c3.launches_int8_prep == p0 + 2
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert int((got != want).sum()) == 0
    # within the JAX package's int8 bounds of the exact conv at its shape
    if shape == CONV_SHAPES[0]:
        ref = c3.conv3x3_ref(x, wgt, bia, relu=relu).float()
        err = (got.float() - ref).abs() / ref.abs().max()
        assert err.max().item() < 0.02 and err.mean().item() < 2e-3


# the quad-block rollout's block convs at 440x640 (B, H, W, C_in, C_out),
# at B=2: the s4d head 80 -> 512, the s4d -> s2d first encoder 512 -> 256
# and the second encoder on the s2d hidden state 256 -> 128, all 110x160
QUAD_CONVS = [(2, 110, 160, 80, 512), (2, 110, 160, 512, 256),
              (2, 110, 160, 256, 128)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", QUAD_CONVS)
def test_conv3x3_at_the_quad_shapes(dev, shape, int8):
    """B4 within its bounds of the plain conv, B4-int8 bit for bit with
    the plain int8 conv, at the quad-block shapes (weights streamed, not
    resident, at C_in 512)."""
    x, wgt, bia = conv_inputs(dev, *shape, seed=2)
    if int8:   # the int8 conv at every size (B=2's head is below the rule)
        want = c3.conv3x3_int8_ref(x, wgt, bia, relu=True)
        i0 = c3.launches_int8
        got = c3.conv3x3_fused(x, wgt, bia, relu=True, impl=INT8)
        torch.cuda.synchronize()
        assert c3.launches_int8 == i0 + 1
        assert int((got != want).sum()) == 0
        return
    want = c3.conv3x3_ref(x, wgt, bia, relu=True)
    n0 = c3.launches
    got = c3.conv3x3_fused(x, wgt, bia, relu=True, impl="pallas")
    torch.cuda.synchronize()
    assert c3.launches == n0 + 1
    d = (got.float() - want.float()).abs()
    assert (d <= bf16_ulp(got, want)).float().mean().item() >= 0.999
    assert d.max().item() <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.parametrize("int8", [False, True])
def test_s2d_cell_at_the_quad_shape(dev, int8):
    """B2 / B2-int8 at the quad-block level 0 (x, h, c at 110x160 with
    256 channels, 1024 gate columns) through ``ConvLSTMCell(state_block=
    2)``: the remapped gate weights on the kernel, against the plain cell
    on the same remapped weights (the bounds of the cell tests above)."""
    from ess_tpu_torch.models.layers import ConvLSTMCell
    from ess_tpu_torch.ops.conv_s2d import gates_bias_s2d, gates_kernel_s2d

    x, hp, cp, _, _ = cell_inputs(dev, 2, 110, 160, 256, 256, seed=3)
    cell = ConvLSTMCell(64, 64, device=dev)
    with torch.no_grad():
        cell.Gates.weight.normal_(0, 0.05)
        cell.Gates.bias.normal_(0, 0.1)
        w2 = gates_kernel_s2d(cell.Gates.weight)
        b2 = gates_bias_s2d(cell.Gates.bias)
    impl = "pallas_int8" if int8 else "pallas"
    if int8:
        x = torch.relu(x) * 2
        h_ref, c_ref = cl.conv_lstm_int8_ref(x, hp, cp, w2, b2)
    else:
        h_ref, c_ref = cl.conv_lstm_ref(x, hp, cp, w2, b2)
    n0, i0 = cl.launches, cl.launches_int8
    with torch.no_grad():
        h_new, (_, c_new) = cell(x, (hp, cp.clone(
            memory_format=torch.channels_last)), impl, state_block=2)
    torch.cuda.synchronize()
    assert (cl.launches_int8 - i0, cl.launches - n0) == (
        (1, 0) if int8 else (0, 1))
    if int8:
        for got, want in ((h_new, h_ref), (c_new, c_ref)):
            d = (got.float() - want.float()).abs()
            assert (d <= bf16_ulp(got, want) + 1e-6).all(), d.max()
    else:
        torch.testing.assert_close(h_new.float(), h_ref.float(), atol=2e-2,
                                   rtol=0)
        torch.testing.assert_close(c_new.float(), c_ref.float(), atol=3e-2,
                                   rtol=0)


@pytest.mark.parametrize("shape", [(1, 7, 5, 4, 8), (2, 13, 40, 24, 16),
                                   (2, 22, 32, 128, 64), (1, 8, 16, 512, 136),
                                   (8, 220, 320, 128, 64)])
def test_conv3x3_int8_prep_kernels_match_plain(dev, shape):
    """The two prep kernels give the plain prep's scales, s8 weights and
    column scales bit for bit, also where the element count is not a
    multiple of 8 (the absmax's tail) and where the absmax is negative."""
    b, h, w, cin, cout = shape
    x, wgt, _ = conv_inputs(dev, *shape, seed=6)
    x = (x - 0.75).contiguous(memory_format=torch.channels_last)
    prep = c3.prepare_conv_weights(wgt, int8=True)
    p0 = c3.launches_int8_prep
    got = c3.int8_prep(x, prep)
    assert c3.launches_int8_prep == p0 + 2
    want = c3.int8_prep_ref(x, prep)
    for name, a, b_ in zip(("scal", "wq", "ws"), got, want):
        assert a.shape == b_.shape and torch.equal(a, b_), name


def test_plain_int8_conv_weights_on_the_card_are_the_cpus(dev):
    """``quantize_conv_weights`` and ``input_scale`` on CUDA tensors give
    the CPU's bits: both divide by 127 (a division by a Python scalar on
    CUDA multiplies by its reciprocal)."""
    for seed in range(4):
        x, wgt, _ = conv_inputs(dev, 2, 22, 32, 128, 64, seed=seed)
        prep = c3.prepare_conv_weights(wgt, int8=True)
        s_x = input_scale(x)
        assert torch.equal(s_x.cpu(), input_scale(x.cpu()))
        wq, ws = c3.quantize_conv_weights(prep, s_x)
        wq_c, ws_c = c3.quantize_conv_weights(prep.cpu(), s_x.cpu())
        assert torch.equal(ws.cpu(), ws_c) and torch.equal(wq.cpu(), wq_c)


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8"])
def test_conv3x3_kernel_is_the_only_route_on_cuda(dev, impl, monkeypatch):
    """On a CUDA tensor the fused conv launches its kernel and never reaches
    ``F.conv2d``, ``torch.matmul`` or a plain version; it raises on what the
    kernel does not take."""
    int8, impl = impl == "pallas_int8", EVERY_SHAPE[impl]
    x, wgt, bia = conv_inputs(dev, 1, 12, 14, 20, 32)

    def refuse(*a, **k):
        raise AssertionError("the fused conv reached a library or plain conv")

    prepared = c3.prepare_conv_weights(wgt, int8=int8)
    with monkeypatch.context() as mp:
        mp.setattr(torch.nn.functional, "conv2d", refuse)
        mp.setattr(torch, "matmul", refuse)
        mp.setattr(c3, "conv3x3_ref", refuse)
        mp.setattr(c3, "conv3x3_int8_ref", refuse)
        n0 = c3.launches + c3.launches_int8
        got = c3.conv3x3_fused(x, wgt, bia, impl=impl, prepared=prepared)
        torch.cuda.synchronize()
        assert c3.launches + c3.launches_int8 == n0 + 1
    plain = c3.conv3x3_int8_ref if int8 else c3.conv3x3_ref
    torch.testing.assert_close(got.float(),
                               plain(x, wgt, bia, relu=True).float(),
                               atol=2e-2, rtol=2e-2)
    for bad_x in (x.float(), x.contiguous()):
        with pytest.raises(ValueError):
            c3.conv3x3_fused(bad_x, wgt, bia, impl=impl)
    x6, w6, b6 = conv_inputs(dev, 1, 4, 4, 6, 8)           # C_in % 4
    with pytest.raises(ValueError):
        c3.conv3x3_fused(x6, w6, b6, impl=impl)
    x8, w8, b8 = conv_inputs(dev, 1, 4, 4, 8, 12)          # C_out % 8
    with pytest.raises(ValueError):
        c3.conv3x3_fused(x8, w8, b8, impl=impl)
    with pytest.raises(ValueError):
        c3.conv3x3_fused(x, torch.zeros(32, 20, 5, 5, device=dev), bia,
                         impl=impl)
    with pytest.raises(ValueError):                        # the other kernel's
        c3.conv3x3_fused(x, wgt, bia, impl=impl,
                         prepared=c3.prepare_conv_weights(
                             wgt, int8=not int8))


def test_halo_launchers_refuse_a_plan_that_disagrees(dev):
    """B4's, B4-int8's and T1's launchers recompute the shared-memory
    layout of the plan they are given and refuse (an error, no launch) one
    that disagrees with it or with the block's warp layout; the wrappers'
    own plans run."""
    from ess_tpu_torch import kernels
    from ess_tpu_torch.ops import conv_halo

    lib = kernels.get_lib()
    stream = torch.cuda.current_stream().cuda_stream
    x, wgt, bia = conv_inputs(dev, 1, 12, 14, 20, 32)
    prep = c3.prepare_conv_weights(wgt)
    bias = bia.float().contiguous()
    out = torch.empty(1, 32, 12, 14, dtype=torch.bfloat16, device=dev,
                      memory_format=torch.channels_last)
    plan = conv_halo.conv_plan(1, 12, 14, 20, 32)
    head = (x.data_ptr(), prep.data_ptr(), bias.data_ptr(), out.data_ptr(),
            1, 12, 14, 20, 32, 1)
    for th, tw, smem in ((plan.th, plan.tw, plan.smem + 16),
                         (2 * plan.th, plan.tw, plan.smem),
                         (2 * plan.th, plan.tw // 2, plan.smem)):
        assert lib.ess_conv3x3(*head, th, tw, int(plan.resident),
                               plan.grid_x, smem, stream) != 0
    assert lib.ess_conv3x3(*head, plan.th, plan.tw, int(plan.resident),
                           plan.grid_x, plan.smem, stream) == 0
    torch.cuda.synchronize()

    # B4-int8: shared memory off by a 16-byte piece, residency flipped, one
    # s8 halo tile with the layout of two, three, a patch of other than 256
    # pixels, no scales
    scal, wq, ws = c3.int8_prep(x, c3.prepare_conv_weights(wgt, int8=True))
    plan8 = conv_halo.conv_plan(1, 12, 14, 20, 32, int8=True)
    assert plan8.q_stages == 2
    args8 = (x.data_ptr(), wq.data_ptr(), ws.data_ptr(), scal.data_ptr(),
             bias.data_ptr(), out.data_ptr(), 1, 12, 14, 20, 32, 1)
    good = (plan8.th, plan8.tw, 1, 2, plan8.grid_x, plan8.smem)
    for bad in ((plan8.th, plan8.tw, 1, 2, plan8.grid_x, plan8.smem + 16),
                (plan8.th, plan8.tw, 0, 2, plan8.grid_x, plan8.smem),
                (plan8.th, plan8.tw, 1, 1, plan8.grid_x, plan8.smem),
                (plan8.th, plan8.tw, 1, 3, plan8.grid_x, plan8.smem),
                (2 * plan8.th, plan8.tw, 1, 2, plan8.grid_x, plan8.smem)):
        assert lib.ess_conv3x3_int8(*args8, *bad, stream) != 0, bad
    assert lib.ess_conv3x3_int8(*args8[:3], None, *args8[4:], *good,
                                stream) != 0
    assert lib.ess_conv3x3_int8(*args8, *good, stream) == 0
    torch.cuda.synchronize()

    xc, w2, b4 = bench_head.make_inputs(12, (1, 20, 8, 16, 128), dev)
    prep = c3.prepare_conv_weights(w2)
    b4 = b4.float().contiguous()
    out = torch.empty(1, 128, 8, 16, dtype=torch.bfloat16, device=dev)
    plan = conv_halo.head_plan(1, 8, 16, 20, 128, nchw_out=True,
                               aligned=True)
    head = (xc.data_ptr(), prep.data_ptr(), b4.data_ptr(), out.data_ptr(),
            1, 8, 16, 20, 128, 0.0, 1.0, 1)
    for aligned, smem in ((1, plan.smem - 16), (0, plan.smem)):
        assert lib.ess_head_cmajor(*head, aligned, plan.th, plan.tw,
                                   plan.grid_x, smem, stream) != 0
    assert lib.ess_head_cmajor(*head, 1, plan.th, plan.tw, plan.grid_x,
                               plan.smem, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8"])
def test_conv3x3_kernel_backward(dev, impl):
    impl = EVERY_SHAPE[impl]
    x, wgt, bia = conv_inputs(dev, 1, 12, 14, 24, 16, seed=3)
    ct = torch.randn(1, 16, 12, 14,
                     generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.no_grad():
        out_ng = c3.conv3x3_fused(x, wgt, bia, impl=impl)

    def grads(fn):
        ins = [t.detach().clone(memory_format=torch.preserve_format)
               .requires_grad_(True) for t in (x, wgt, bia)]
        out = fn(*ins)
        (out.float() * ct).sum().backward()
        return out, [t.grad for t in ins]

    n0 = c3.launches + c3.launches_int8
    out, g_k = grads(lambda *a: c3.conv3x3_fused(*a, impl=impl))
    assert c3.launches + c3.launches_int8 == n0 + 1
    assert torch.equal(out, out_ng)
    _, g_r = grads(lambda *a: c3.conv3x3_ref(*a, relu=True))
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                   rtol=1e-2)


# (u shape, hidden channels, u_s2d): the three DSEC levels at B=2, L0 also
# from a full-resolution input at a small shape with three row tiles, a
# shape whose conv has 32 output columns and a ragged last pixel tile, and
# the three DSEC levels at the tool's B=8 (80 or 40 groups; the widest
# scratch)
LEVEL_CASES = [((2, 128, 220, 320), 64, True), ((2, 64, 220, 320), 128, False),
               ((2, 128, 110, 160), 256, False), ((1, 32, 78, 40), 64, False),
               ((2, 16, 26, 24), 32, True), ((1, 8, 14, 10), 32, False),
               *bench_level.LAYERS]


def assert_within_ulp(got, want, share=1.0, cap=None):
    d = (got.float() - want.float()).abs()
    beyond = int((d > bf16_ulp(got, want) + 1e-6).sum())
    assert beyond <= (1.0 - share) * d.numel(), (beyond, d.max().item())
    if cap is not None:
        assert d.max().item() <= cap, d.max().item()


@pytest.fixture
def no_size_rule(monkeypatch):
    """Lift the level's size rule on the card, so that the kernels run at the
    small shapes of these tests."""
    monkeypatch.setattr(lv, "FUSE_MIN_ELEMENTS", 0)


@pytest.mark.parametrize("case", LEVEL_CASES)
def test_level_kernel_matches_plain(dev, case, no_size_rule):
    ushape, ch, u_s2d = case
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(1, ushape, ch, u_s2d,
                                                        dev)
    gb = torch.randn(4 * ch, device=dev) * 0.05
    prep = lv.prepare_level_weights(ek, eb, gk, gb)
    th = cl.pick_row_tile(h0.shape[2])
    want = lv.level_int8_ref(u, h0, c0, prep, u_s2d=u_s2d, th=th)
    h_before = h0.clone()
    n0 = lv.launches
    c = c0.clone(memory_format=torch.channels_last)
    got = lv.level_int8_cuda(u, h0, c, prep, u_s2d=u_s2d, th=th)
    torch.cuda.synchronize()
    assert lv.launches == n0 + 1
    assert got[1].data_ptr() == c.data_ptr()          # c updated in place
    assert torch.equal(h0, h_before)                  # h_prev untouched
    floor = lambda a: a.clamp(min=lv.AMAX_FLOOR)
    x_ref, _ = lv.level_x_ref(u, prep, u_s2d=u_s2d, th=th)
    x_k = torch.full((x_ref.shape[0], th + 2, h0.shape[3], ch), float("nan"),
                     device=dev)
    c3_ = c0.clone(memory_format=torch.channels_last)
    got3 = lv.level_int8_cuda(u, h0, c3_, prep, u_s2d=u_s2d, th=th,
                              x_out=x_k)
    torch.cuda.synchronize()
    assert torch.equal(x_k, x_ref.permute(0, 2, 3, 1)), "x differs"
    assert torch.equal(got3[0], got[0]) and torch.equal(c3_, got[1])
    assert torch.equal(floor(got[2]), want[2]), "amax_u differs"
    assert torch.equal(floor(got[3]), want[3]), "amax_x differs"
    assert_within_ulp(got[0], want[0])
    assert_within_ulp(got[1], want[1])
    # the public entry gives the same result and leaves its inputs' c alone
    # only under autograd; here it updates c in place too
    c2 = c0.clone(memory_format=torch.channels_last)
    h2, (h2b, c2n) = lv.encoder_level_int8(u, (h0, c2), ek, eb, gk, gb,
                                           u_s2d=u_s2d)
    assert h2b is h2 and torch.equal(h2, got[0]) and torch.equal(c2n, got[1])


@pytest.mark.parametrize("case", LEVEL_CASES[:3] + LEVEL_CASES[4:5]
                         + LEVEL_CASES[6:])
def test_level_kernel_20_step_chain(dev, case, no_size_rule):
    ushape, ch, u_s2d = case
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(2, ushape, ch, u_s2d,
                                                        dev)
    prep = lv.prepare_level_weights(ek, eb, gk, gb)
    kw = dict(u_s2d=u_s2d, prepared=prep)
    hk, ck = h0, c0.clone(memory_format=torch.channels_last)
    hp, cp = h0, c0
    for _ in range(20):
        hk, ck = lv.encoder_level_int8(u, (hk, ck), ek, eb, gk, gb, **kw)[1]
        hp, cp = lv.encoder_level_int8_ref(u, hp, cp, ek, eb, gk, gb, **kw)
    assert_within_ulp(hk, hp, share=0.999, cap=0.05)
    assert_within_ulp(ck, cp, share=0.999, cap=0.05)


def test_level_kernel_is_the_only_route_on_cuda(dev, monkeypatch,
                                               no_size_rule):
    """On CUDA tensors the level launches its kernels and reaches no library
    conv, no matmul and no plain version; it raises on what they do not
    take and returns None where the geometry does not tile."""
    ushape, ch, u_s2d = LEVEL_CASES[4]
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(3, ushape, ch, u_s2d,
                                                        dev)
    prep = lv.prepare_level_weights(ek, eb, gk, gb)

    def refuse(*a, **k):
        raise AssertionError("the level reached a library or plain version")

    with monkeypatch.context() as mp:
        mp.setattr(torch.nn.functional, "conv2d", refuse)
        mp.setattr(torch, "matmul", refuse)
        mp.setattr(lv, "level_int8_ref", refuse)
        mp.setattr(lv, "encoder_level_ref", refuse)
        n0 = lv.launches
        out = lv.encoder_level_int8(u, (h0, c0.clone()), ek, eb, gk, gb,
                                    u_s2d=u_s2d, prepared=prep)
        torch.cuda.synchronize()
        assert out is not None and lv.launches == n0 + 1
    for bad in ((u.float(), h0, c0), (u.contiguous(), h0, c0), (u, h0, h0)):
        with pytest.raises(ValueError):
            lv.encoder_level_int8(bad[0], bad[1:], ek, eb, gk, gb,
                                  u_s2d=u_s2d)
    # 29 rows: no row tile
    z = torch.zeros(1, 32, 29, 8, device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert lv.encoder_level_int8(
        torch.zeros(1, 16, 29, 8, device=dev, dtype=torch.bfloat16), (z, z),
        ek, eb, gk, gb, u_s2d=True) is None
    # hidden channels not a multiple of 32
    u16, h16, c16, *w16 = bench_level.make_inputs(3, (1, 16, 8, 8), 16, True,
                                                  dev)
    with pytest.raises(ValueError):
        lv.encoder_level_int8(u16, (h16, c16), *w16, u_s2d=True)


def test_level_weight_prep_on_the_card_is_the_cpus(dev):
    """``prepare_level_weights`` and ``quant_cols`` on CUDA tensors give the
    CPU's bits, int8 weights and scales both: every scale divides by 127
    once (a division by a Python scalar on CUDA multiplies by its
    reciprocal instead)."""
    for seed, (ushape, ch, u_s2d) in enumerate(LEVEL_CASES[:6]):
        _, _, _, ek, eb, gk, gb = bench_level.make_inputs(seed, ushape, ch,
                                                          u_s2d, dev)
        got = lv.prepare_level_weights(ek, eb, gk, gb)
        want = lv.prepare_level_weights(ek.cpu(), eb.cpu(), gk.cpu(),
                                        gb.cpu())
        for name, a, b_ in zip(lv.LevelWeights._fields, got, want):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b_), name
    g = torch.Generator().manual_seed(7)
    for k, n in ((1152, 64), (2304, 512), (4608, 1024)):
        w2 = torch.randn(k, n, generator=g) * torch.rand(n, generator=g)
        wq, ws = cl.quant_cols(w2.to(dev))
        wq_c, ws_c = cl.quant_cols(w2)
        assert torch.equal(ws.cpu(), ws_c) and torch.equal(wq.cpu(), wq_c)


def test_level_launcher_refuses_a_plan_that_disagrees(dev):
    """The level's launcher recomputes the layout of its three kernels and
    refuses (an error, no launch) a plan that disagrees: another number of
    amax partials, a conv patch that is not its block's pixels, conv or
    gate shared memory off, no conv blocks, a gate patch of the wrong size,
    gate weight stages of another size, more gate blocks than items; the
    wrapper's own plan runs."""
    ushape, ch, u_s2d = LEVEL_CASES[3]
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(6, ushape, ch, u_s2d,
                                                        dev)
    prep = lv.prepare_level_weights(ek, eb, gk, gb)
    b, _, ho, wo = h0.shape
    cu = 4 * ushape[1]
    th = cl.pick_row_tile(ho)
    plan = chp.level_plan(b, ho, wo, cu, ch, th,
                          sm_count=chp.sm_count(dev))
    g = plan.groups
    scratch = torch.empty((2 + plan.amax_blocks) * g, device=dev)
    xs = torch.empty((g, th + 2, wo, ch), device=dev)
    h_new = torch.empty_like(h0)
    c = c0.clone(memory_format=torch.channels_last)
    from ess_tpu_torch import kernels

    lib = kernels.get_lib()
    head = [u.data_ptr(), h0.data_ptr(), c.data_ptr(), prep.we_k.data_ptr(),
            prep.wg_img.data_ptr(), prep.sbe.data_ptr(), prep.sbg.data_ptr(),
            scratch.data_ptr(), xs.data_ptr(), h_new.data_ptr(), b, ho, wo,
            cu, ch, th, int(u_s2d)]
    cp, gp = plan.conv, plan.gates
    good = [plan.amax_blocks, cp.th, cp.tw, int(cp.resident), cp.grid_x,
            cp.smem, gp.th, gp.tw, plan.gate_halves, gp.grid, gp.smem]
    stream = torch.cuda.current_stream().cuda_stream
    for i, v in ((0, plan.amax_blocks + 1), (1, cp.th * 2), (5, cp.smem + 16),
                 (4, 0), (6, gp.th + 1), (7, gp.tw * 2), (8, 3),
                 (8, 3 - plan.gate_halves), (10, gp.smem + 1024),
                 (9, gp.n_tiles + 1)):
        bad = list(good)
        bad[i] = v
        assert lib.ess_level_int8(*head, *bad, stream) != 0, (i, v)
    assert lib.ess_level_int8(*head, *good, stream) == 0
    torch.cuda.synchronize()
    want = lv.level_int8_ref(u, h0, c0, prep, u_s2d=u_s2d, th=th)
    assert_within_ulp(h_new, want[0])


def test_level_size_rule_on_cuda(dev):
    """On CUDA tensors the entry keeps JAX's size rule: below
    ``FUSE_MIN_ELEMENTS`` elements of h_prev it returns None and launches
    nothing (the split level runs instead); at and above it, it launches
    the kernels, and below it too with the rule's threshold lowered. The
    CPU's plain version answers below it."""
    for ushape, ch, u_s2d in (LEVEL_CASES[3], LEVEL_CASES[4]):
        u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(
            7, ushape, ch, u_s2d, dev)
        assert not lv.fuses(h0.numel())
        n0 = lv.launches
        assert lv.encoder_level_int8(u, (h0, c0.clone()), ek, eb, gk, gb,
                                     u_s2d=u_s2d) is None
        torch.cuda.synchronize()
        assert lv.launches == n0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lv, "FUSE_MIN_ELEMENTS", 0)
            assert lv.encoder_level_int8(u, (h0, c0.clone()), ek, eb, gk, gb,
                                         u_s2d=u_s2d) is not None
        assert lv.launches == n0 + 1
        assert lv.encoder_level_int8(
            u.cpu(), (h0.cpu(), c0.cpu()), ek.cpu(), eb.cpu(), gk.cpu(),
            gb.cpu(), u_s2d=u_s2d) is not None
    ushape, ch, u_s2d = LEVEL_CASES[2]
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(8, ushape, ch, u_s2d,
                                                        dev)
    assert lv.fuses(h0.numel())
    n0 = lv.launches
    out = lv.encoder_level_int8(u, (h0, c0.clone(
        memory_format=torch.channels_last)), ek, eb, gk, gb, u_s2d=u_s2d)
    torch.cuda.synchronize()
    assert out is not None and lv.launches == n0 + 1


def test_level_kernel_backward(dev, no_size_rule):
    ushape, ch, u_s2d = LEVEL_CASES[5]
    u, h0, c0, ek, eb, gk, gb = bench_level.make_inputs(4, ushape, ch, u_s2d,
                                                        dev)
    g = torch.Generator().manual_seed(5)
    ct_h, ct_c = (torch.randn(*h0.shape, generator=g).to(dev)
                  for _ in range(2))
    with torch.no_grad():
        h_ng, (_, c_ng) = lv.encoder_level_int8(u, (h0, c0.clone()), ek, eb,
                                                gk, gb, u_s2d=u_s2d)

    def grads(fn):
        ins = [t.detach().clone(memory_format=torch.preserve_format)
               .requires_grad_(True) for t in (u, h0, c0, ek, eb, gk, gb)]
        c_before = ins[2].detach().clone()
        hn, cn = fn(*ins)
        ((hn.float() * ct_h).sum() + (cn.float() * ct_c).sum()).backward()
        assert torch.equal(ins[2].detach(), c_before)   # c_prev intact
        return (hn, cn), [t.grad for t in ins]

    n0 = lv.launches
    (hn, cn), g_k = grads(lambda u_, h_, c_, *w: lv.encoder_level_int8(
        u_, (h_, c_), *w, u_s2d=u_s2d)[1])
    assert lv.launches == n0 + 1
    assert torch.equal(hn, h_ng) and torch.equal(cn, c_ng)
    _, g_r = grads(lambda *a: lv.encoder_level_ref(*a, u_s2d=u_s2d))
    for a, b in zip(g_k, g_r):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2,
                                   rtol=1e-2)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mode", bd.COMPARED)
@pytest.mark.parametrize("shape", [(2, 32, 10, 13), (1, 64, 22, 40),
                                   (2, 64, 220, 320), (2, 256, 55, 80),
                                   (1, 256, 55, 80), *bd.SHAPES])
def test_cell_variant_kernel_matches_plain(dev, shape, mode, int8):
    x, h0, c0, wgt, bias = bd.make_inputs(6, shape, dev)
    want_h, want_c = bd.cell_variant_ref(x, h0, c0, wgt, bias, mode=mode,
                                         int8=int8)
    counts = (cl.launches, cl.launches_int8, cl.launches_variant)
    c = c0.clone(memory_format=torch.channels_last)
    got_h, got_c = bd.cell_variant(x, h0, c, wgt, bias, mode=mode, int8=int8)
    torch.cuda.synchronize()
    after = (cl.launches, cl.launches_int8, cl.launches_variant)
    moved = 2 if mode != "full" else int(int8)
    assert after == tuple(n + (i == moved) for i, n in enumerate(counts))
    assert got_c.data_ptr() == c.data_ptr()
    for got, want in ((got_h, want_h), (got_c, want_c)):
        if int8 and mode != "ptw_bf16":
            assert_within_ulp(got, want)
        elif int8:
            assert_within_ulp(got, want, share=0.999, cap=2.0 ** -5)
        elif mode == "ptw_bf16":
            assert (got.float() - want.float()).abs().max() <= 2.0 ** -4
        else:
            d = (got.float() - want.float()).abs().max().item()
            assert d <= 2.0 ** -6 * want.float().abs().max().item(), d


@pytest.mark.parametrize("int8", [False, True])
def test_full_mode_is_the_cells_own_entry_point(dev, int8):
    """``full`` launches the cell's own entry point, the only one that
    holds that instantiation (it counts as the cell's launch and gives the
    cell's result); the mode entry points refuse it."""
    from ess_tpu_torch import kernels

    x, h0, c0, wgt, bias = bd.make_inputs(7, (2, 64, 22, 40), dev)
    impl = INT8 if int8 else "pallas"
    h1, c1 = cl.conv_lstm_cell(x, h0, c0.clone(), wgt, bias, impl=impl)
    counts = (cl.launches, cl.launches_int8, cl.launches_variant)
    h2, c2 = cl.launch_variant(x, h0, c0.clone(), wgt, bias, mode="full",
                               int8=int8)
    assert (cl.launches, cl.launches_int8, cl.launches_variant) == tuple(
        n + (i == int(int8)) for i, n in enumerate(counts))
    assert torch.equal(h1, h2) and torch.equal(c1, c2)
    from ess_tpu_torch.ops import conv_halo

    lib = kernels.get_lib()
    entry = lib.ess_conv_lstm_int8_mode if int8 else lib.ess_conv_lstm_mode
    n_ptr = 7 if int8 else 6
    plan = conv_halo.cell_plan(2, 22, 40, 64, 64, int8=int8)
    pa = (plan.th, plan.tw, plan.grid, plan.smem)
    for mode in (0, len(cl.MODES)):
        assert entry(*[None] * n_ptr, 2, 22, 40, 64, 64, *pa, mode,
                     None) != 0
    # no_build runs and writes finite-or-not values of the right shape
    h3, _ = cl.launch_variant(x, h0, c0.clone(), wgt, bias, mode="no_build",
                              int8=int8)
    torch.cuda.synchronize()
    assert h3.shape == h0.shape


def test_tools_run_on_the_card(dev, capsys, tmp_path, no_size_rule):
    """Both tools' ``main`` at one small level: they launch the kernels;
    ``bench_level --profile`` traces one more chain of each path (two
    warm-up calls and the traced one) and prints its device time by kernel.
    """
    n0, v0 = lv.launches, cl.launches_variant
    layers = [((2, 16, 26, 24), 32, True)]
    res = bench_level.main(["--layers=0", f"--profile={tmp_path}"],
                           layers=layers, steps=3)
    assert lv.launches == n0 + 1 + (4 + 3) * 3
    assert res[0]["fused"]["dh_max"] < 0.06 and res[0]["fused"]["dc_max"] < 0.12
    bd.main(["--layers=0", "--int8=0"], shapes=[(2, 32, 10, 13)], steps=3)
    assert cl.launches_variant == v0 + 4 * 4 * 3
    out = capsys.readouterr().out
    assert "kernels, CUDA events" in out
    for path in ("fused", "split"):
        assert f"L0_{path} profile: wall" in out
        assert (tmp_path / f"L0_{path}_trace.json").exists()
    assert "level_" in out.split("L0_fused profile")[1]


HEAD_SHAPES = [(8, 20, 220, 320, 128),    # the tool's shape (T1's path)
               (2, 20, 13, 37, 128),      # W = 37: rows not 16-byte aligned
               (1, 12, 9, 16, 24),        # C_in 12, C_out one 24-wide tile
               (3, 20, 21, 48, 128),      # ragged last patch row, B = 3
               (2, 16, 10, 40, 64),       # 8 x 32 patches, ragged column
               (1, 20, 6, 13, 136)]       # W below the patch, two N tiles


@pytest.mark.parametrize("nchw_out", [False, True])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_head_cmajor_kernel_matches_plain(dev, shape, nchw_out):
    """T1 against its plain version: at most one bf16 ulp on 99.9 % of the
    values, max |d| within 2^-7 of the plain output's absmax (the fused
    conv's bound: f32 sums of the same bf16 products in another order)."""
    x, w2, b4 = bench_head.make_inputs(11, shape, dev)
    kw = dict(shift=0.1, scale=1.5, nchw_out=nchw_out)
    want = hc.head_cmajor_ref(x, w2, b4, **kw)
    n0 = hc.launches
    got = hc.head_cmajor(x, w2, b4, **kw)
    torch.cuda.synchronize()
    assert hc.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == want.shape
    d = (got.float() - want.float()).abs()
    within = (d <= bf16_ulp(got, want)).float().mean().item()
    assert within >= 0.999, within
    assert d.max().item() <= 2.0 ** -7 * want.float().abs().max().item()


def test_head_cmajor_kernel_is_the_only_route_on_cuda(dev, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: it never
    reaches the plain version or the library conv."""
    x, w2, b4 = bench_head.make_inputs(12, (1, 20, 8, 16, 128), dev)

    def boom(*a, **k):
        raise AssertionError("plain path reached on CUDA")

    monkeypatch.setattr(hc, "head_cmajor_ref", boom)
    monkeypatch.setattr(hc.F, "conv2d", boom)
    kw = dict(shift=0.0, scale=1.0, nchw_out=True)
    hc.head_cmajor(x, w2, b4, **kw)
    with pytest.raises(ValueError):
        hc.head_cmajor(x.float(), w2, b4, **kw)                # not bf16
    with pytest.raises(ValueError):
        hc.head_cmajor(x.contiguous(memory_format=torch.channels_last),
                       w2, b4, **kw)                           # not C-major
    with pytest.raises(ValueError):
        hc.head_cmajor(x.repeat(1, 2, 1, 1), w2.repeat(1, 2, 1, 1), b4,
                       **kw)                                   # C_in 40


def legacy_inputs(rng, b, n, h, w):
    """(B, N) raw windows binned on both band wires."""
    raw, valid = raw_windows(rng, b, n, h, w, edges=True)
    wires = {}
    for x_slots in (False, True):
        r, v, o = vf.host_band_bin_folded(raw, valid, height=h, width=w,
                                          bins=5, x_slots=x_slots)
        cols = [torch.from_numpy(np.ascontiguousarray(r[..., i]))
                for i in range(4)]
        wires[x_slots] = (cols + [torch.from_numpy(v)], torch.from_numpy(o))
    return wires


@pytest.mark.parametrize("h,w,b,n", [(480, 640, 160, 100_000),
                                     (72, 384, 3, 20000), (26, 170, 2, 5000)])
def test_voxel_legacy_kernel_matches_plain(dev, h, w, b, n):
    """The full-width band wire against its plain version (raw grid and
    stats atol/rtol 1e-5, normalized grid 1e-4, the B1 bounds) and against
    the slotted wire on the same events (normalized grids 1e-4), at the
    DSEC shape the band wire runs (B=8 x T=20 windows of 100k events on
    480x640) and two small ones."""
    wires = legacy_inputs(np.random.default_rng(h + b), b, n, h, w)
    cols, offs = wires[False]
    assert offs.shape[1] == -(-h // 24) + 1
    x, y, t, p, valid = [c.to(dev) for c in cols]
    offs = offs.to(dev)
    ts = masked_time_norm(t, valid, 5).contiguous()
    pol = torch.where(valid, p, torch.zeros_like(p)).contiguous()
    hp = -(-h // 24) * 24
    wp = -(-w // 128) * 128
    kw = dict(bins=5, height=hp, width=wp)
    n0, l0 = vf.launches, vf.launches_legacy
    grid, stats = vf.voxelize_folded(x, y, ts, pol, offs, **kw)
    torch.cuda.synchronize()
    assert (vf.launches, vf.launches_legacy) == (n0, l0 + 1)
    grid_r, stats_r = vf.voxelize_folded_ref(x, y, ts, pol, offs, **kw)
    torch.testing.assert_close(grid, grid_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats, stats_r, atol=1e-3, rtol=1e-5)
    del grid_r
    kwb = dict(num_bins=5, height=h, width=w, normalize=True)
    got = voxelize_band(x, y, t, p, valid, offs, **kwb)
    scols, soffs = wires[True]
    slotted = voxelize_band(*[c.to(dev) for c in scols], soffs.to(dev),
                            **kwb)
    torch.testing.assert_close(got, slotted, atol=1e-4, rtol=0)
    torch.testing.assert_close(
        got, normalize_from_stats(grid, stats)[:, :, :h, :w], atol=1e-4,
        rtol=0)


def legacy_edge_windows(rng, case):
    """Two DSEC windows of 100k raw events on 480x640 holding one of
    B3-legacy's edge cases."""
    n = 100_000
    raw, valid = raw_windows(rng, 2, n, 480, 640)
    k = n // 8
    if case == "edges":
        # x = 127.0 .. 511.0 exactly (their x + 1 corner carries no weight),
        # just below a 128-column boundary (it crosses into the next tile),
        # on the last column and just past it
        raw[:, :k, 0] = rng.choice([127.0, 255.0, 383.0, 511.0], (2, k))
        raw[:, k:2 * k, 0] = rng.choice([128.0, 256.0, 384.0, 512.0], (
            2, k)) - rng.choice([2.0 ** -16, 2.0 ** -8, 0.25], (2, k))
        raw[:, 2 * k:3 * k, 0] = 639.0 + rng.uniform(0, 0.9, (2, k))
        raw[:, 3 * k:4 * k, 0] = np.floor(raw[:, 3 * k:4 * k, 0])
    elif case == "empty_bands":
        # window 0 in bands 0-4 only, window 1 empty
        raw[0, :, 1] = rng.uniform(0.0, 4 * 24 + 22.9, n)
        valid[1] = False
    elif case == "one_band":
        # 90 % of window 0 in band 7, some on its edge rows
        m = n * 9 // 10
        raw[0, :m, 1] = rng.uniform(168.0, 191.99, m)
        raw[0, :k, 1] = rng.choice([167.5, 191.5], k)
    return raw, valid


@pytest.mark.parametrize("case", ["edges", "empty_bands", "one_band"])
def test_voxel_legacy_kernel_edge_records(dev, case):
    """B3-legacy on the scatter core (band rule: each (window, band, tile)
    item walks its band and keeps the records whose floor(x) lies in
    [128 tx - 1, 128 tx + 127]) against its plain version at the DSEC
    shape: records on and next to the 128-column boundaries and on the last
    column, empty bands and an empty window, a band holding 90 % of a
    window (raw grid atol/rtol 1e-5, stats 1e-3 / 1e-5, normalized 1e-4;
    the B1 bounds)."""
    raw, valid = legacy_edge_windows(np.random.default_rng(31), case)
    r, v, o = vf.host_band_bin_folded(raw, valid, height=480, width=640,
                                      bins=5, x_slots=False)
    assert o.shape == (2, 21)
    x, y, t, p = (torch.from_numpy(np.ascontiguousarray(r[..., i])).to(dev)
                  for i in range(4))
    vd = torch.from_numpy(v).to(dev)
    ts = masked_time_norm(t, vd, 5).contiguous()
    pol = torch.where(vd, p, torch.zeros_like(p)).contiguous()
    offs = torch.from_numpy(o).to(dev)
    kw = dict(bins=5, height=480, width=640)
    l0 = vf.launches_legacy
    grid, stats = vf.voxelize_folded(x, y, ts, pol, offs, **kw)
    torch.cuda.synchronize()
    assert vf.launches_legacy == l0 + 1
    grid_r, stats_r = vf.voxelize_folded_ref(x, y, ts, pol, offs, **kw)
    torch.testing.assert_close(grid, grid_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats, stats_r, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(normalize_from_stats(grid, stats),
                               normalize_from_stats(grid_r, stats_r),
                               atol=1e-4, rtol=0)
    if case == "empty_bands":
        assert grid[1].abs().sum().item() == 0
        assert grid[0, :, 120:].abs().sum().item() == 0


@pytest.mark.parametrize("pin", [False, True])
def test_prefetch_to_device_onto_cuda_with_a_recycled_ring(dev, pin):
    """``prefetch_to_device`` onto the card from a recycled collate ring (the
    smallest ring the rule allows, pinned or not): every batch arrives on
    ``cuda`` equal to the loader's fresh arrays, also when the consumer
    holds the card busy before it reads each batch, so that the producer
    runs ahead and the ring is rewritten as soon as the rule allows."""
    from ess_tpu_torch.data import loader, synthetic

    ds = synthetic.SyntheticEvents(length=24, height=64, width=64,
                                   nr_events_data=4, nr_events_window=4096)
    want = [{k: np.copy(v) for k, v in b.items()}
            for b in loader.BatchLoader(ds, batch_size=2, shuffle=False)]
    dl = loader.BatchLoader(ds, batch_size=2, shuffle=False,
                            collate_buffers=4, prefetch_size=2,
                            pin_memory=pin)
    busy = torch.randn(2048, 2048, device=dev)
    n = 0
    for got, w in zip(loader.prefetch_to_device(iter(dl), size=2,
                                                device=dev), want):
        for _ in range(4):
            busy = busy @ busy / busy.norm()
        assert all(v.device.type == "cuda" for v in got.values())
        for k, v in w.items():
            assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k
        n += 1
    assert n == len(want) == 12


# The persistent scatter core (B1 and B3, csrc/voxel_scatter.cuh).

def scatter_lib_args(grid):
    """(library, plan) of a direct voxelizer launch on ``grid``'s shape."""
    from ess_tpu_torch import kernels
    from ess_tpu_torch.ops import voxel_scatter

    b, bins, h, w = grid.shape
    return kernels.get_lib(), voxel_scatter.scatter_plan(bins, h, w, b)


def tiled_inputs(rng, b, n, h, w, bins=5, edges=True):
    """Tile-sorted kernel inputs on the CPU: (x, y, ts, pol, offsets)."""
    raw, valid = raw_windows(rng, b, n, h, w, edges=edges)
    raw, valid, o = vt.host_tile_bin(raw, valid, height=h, width=w,
                                     bins=bins)
    x, y, t = (torch.from_numpy(np.ascontiguousarray(raw[..., i]))
               for i in range(3))
    vd = torch.from_numpy(valid)
    ts = masked_time_norm(t, vd, bins).contiguous()
    pol = torch.where(vd, torch.where(torch.from_numpy(raw[..., 3]) > 0,
                                      1.0, -1.0), 0.0).contiguous()
    return x, y, ts, pol, torch.from_numpy(o)


def test_voxel_folded_kernel_160_windows(dev):
    """B1 at one step's 160 windows (B=8 x T=20) of 100k events on 480x640
    against its plain version: raw grid and stats atol/rtol 1e-5 / 1e-3,
    normalized grid 1e-4; one launch."""
    _, _, (x, y, t, p, valid), offs = folded(np.random.default_rng(10), 160,
                                             100_000, 480, 640)
    x, y, t, p, valid, offs = (a.to(dev) for a in (x, y, t, p, valid, offs))
    ts = masked_time_norm(t, valid, 5).contiguous()
    pol = torch.where(valid, p, torch.zeros_like(p)).contiguous()
    kw = dict(bins=5, height=480, width=640)
    n0 = vf.launches
    grid, stats = vf.voxelize_folded(x, y, ts, pol, offs, **kw)
    torch.cuda.synchronize()
    assert vf.launches == n0 + 1
    grid_r, stats_r = vf.voxelize_folded_ref(x, y, ts, pol, offs, **kw)
    torch.testing.assert_close(grid, grid_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats, stats_r, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(normalize_from_stats(grid, stats),
                               normalize_from_stats(grid_r, stats_r),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("host", [True, False])
def test_voxel_tiled_kernel_one_window(dev, host):
    """B3 at streaming B=1 (one window of 100k events on 480x640 with
    border and tile-edge events: 100 items, one a block), on host and
    device offsets, through ``voxelize_tile``: one launch, raw grid
    atol/rtol 1e-5, normalized 1e-4 (B=8: the test above)."""
    raw, valid = raw_windows(np.random.default_rng(11), 1, 100_000, 480,
                             640, edges=True)
    offs = None
    if host:
        raw, valid, o = vt.host_tile_bin(raw, valid, height=480, width=640)
        offs = torch.from_numpy(o)
    cols = [torch.from_numpy(np.ascontiguousarray(raw[..., i]))
            for i in range(4)] + [torch.from_numpy(valid)]
    kw = dict(num_bins=5, height=480, width=640, trilinear=True)
    n0 = vt.launches
    got = voxelize_tile(*[c.to(dev) for c in cols],
                        None if offs is None else offs.to(dev), **kw)
    torch.cuda.synchronize()
    assert vt.launches == n0 + 1
    want = voxelize_tile(*cols, offs, **kw)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(normalize_nonzero(got).cpu(),
                               normalize_nonzero(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("w", [128, 256, 384])
@pytest.mark.parametrize("kernel", ["B1", "B3"])
def test_voxel_scatter_grid_widths(dev, w, kernel):
    """One, two and three tiles across (h 72): both kernels against their
    plain versions (atol/rtol 1e-5; B1's stats 1e-3 / 1e-5)."""
    rng = np.random.default_rng(w)
    if kernel == "B1":
        _, _, (x, y, t, p, valid), offs = folded(rng, 3, 20000, 72, w)
        ts = masked_time_norm(t, valid, 5)
        args = [a.contiguous() for a in
                (x, y, ts, torch.where(valid, p, torch.zeros_like(p)))]
        args.append(offs)
        grid, stats = vf.voxelize_folded(*[a.to(dev) for a in args], bins=5,
                                         height=72, width=w)
        grid_r, stats_r = vf.voxelize_folded_ref(*args, bins=5, height=72,
                                                 width=w)
        torch.testing.assert_close(stats.cpu(), stats_r, atol=1e-3,
                                   rtol=1e-5)
    else:
        args = tiled_inputs(rng, 3, 20000, 72, w)
        grid = vt.voxelize_tiled(*[a.to(dev) for a in args], bins=5,
                                 height=72, width=w)
        grid_r = vt.voxelize_tiled_ref(*args, bins=5, height=72, width=w)
    torch.testing.assert_close(grid.cpu(), grid_r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel", ["B1", "B3"])
def test_voxel_scatter_one_tile_window(dev, kernel):
    """A window whose 100k events all fall in one tile (one long range,
    heavy atomic contention) beside an ordinary one: the kernel against its
    plain version (raw grid atol 1e-4 / rtol 1e-5: tens of thousands of
    f32 deposits a cell in run-dependent order), normalized 1e-4."""
    rng = np.random.default_rng(12)
    raw, valid = raw_windows(rng, 2, 100_000, 480, 640)
    raw[0, :, 0] = rng.uniform(260.0, 380.0, 100_000)     # tile column 2
    raw[0, :, 1] = rng.uniform(50.0, 70.0, 100_000)       # tile row 2
    if kernel == "B1":
        r, v, o = vf.host_band_bin_folded(raw, valid, height=480, width=640,
                                          bins=5)
        x, y, t, p = (torch.from_numpy(np.ascontiguousarray(r[..., i]))
                      for i in range(4))
        vd = torch.from_numpy(v)
        args = [x, y, masked_time_norm(t, vd, 5).contiguous(),
                torch.where(vd, p, torch.zeros_like(p)).contiguous(),
                torch.from_numpy(o)]
        got, stats = vf.voxelize_folded(*[a.to(dev) for a in args], bins=5,
                                        height=480, width=640)
        want, stats_r = vf.voxelize_folded_ref(*args, bins=5, height=480,
                                               width=640)
        got_n = normalize_from_stats(got, stats).cpu()
        want_n = normalize_from_stats(want, stats_r)
    else:
        raw, valid, o = vt.host_tile_bin(raw, valid, height=480, width=640)
        assert np.diff(o[0]).max() == 100_000 - 100_000 // 10
        x, y, t = (torch.from_numpy(np.ascontiguousarray(raw[..., i]))
                   for i in range(3))
        vd = torch.from_numpy(valid)
        args = [x, y, masked_time_norm(t, vd, 5).contiguous(),
                torch.where(vd, torch.where(torch.from_numpy(raw[..., 3]) > 0,
                                            1.0, -1.0), 0.0).contiguous(),
                torch.from_numpy(o)]
        got = vt.voxelize_tiled(*[a.to(dev) for a in args], bins=5,
                                height=480, width=640)
        want = vt.voxelize_tiled_ref(*args, bins=5, height=480, width=640)
        got_n, want_n = normalize_nonzero(got).cpu(), normalize_nonzero(want)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got_n, want_n, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kernel", ["B1", "B3"])
def test_voxel_scatter_stores_every_element(dev, kernel):
    """Empty tiles, a tile with one event and an empty window: a direct
    launch into a grid filled with NaN leaves no NaN (every element is
    stored once, zeros where nothing lands) and equals the plain version."""
    h, w = 48, 384
    x = torch.tensor([[3.5, 200.25, 0.0], [0.0, 0.0, 0.0]])
    y = torch.tensor([[2.0, 47.5, 0.0], [0.0, 0.0, 0.0]])
    ts = torch.tensor([[0.5, 4.0, 0.0], [0.0, 0.0, 0.0]])
    pol = torch.tensor([[1.0, -1.0, 0.0], [0.0, 0.0, 0.0]])
    # tiles 0 and 4 (row 1, column 1) hold one event each; window 1 is empty
    offs = torch.tensor([[0, 1, 1, 1, 1, 2, 2], [0] * 7], dtype=torch.int32)
    args = [a.to(dev).contiguous() for a in (x, y, ts, pol, offs)]
    grid = torch.full((2, 5, h, w), float("nan"), device=dev)
    lib, plan = scatter_lib_args(grid)
    if kernel == "B1":
        partials = torch.full((2, 6, 3), float("nan"), device=dev)
        err = lib.ess_voxel_folded(
            *[a.data_ptr() for a in args], grid.data_ptr(),
            partials.data_ptr(), 2, 3, 5, 24, 2, 3, w, plan.threads,
            plan.grid, plan.smem, 0, 0,
            torch.cuda.current_stream().cuda_stream)
        want, stats_r = vf.voxelize_folded_ref(x, y, ts, pol, offs, bins=5,
                                               height=h, width=w)
        torch.cuda.synchronize()
        assert err == 0
        torch.testing.assert_close(partials.sum(1).cpu(), stats_r,
                                   atol=1e-6, rtol=1e-6)
    else:
        err = lib.ess_voxel_tiled(
            *[a.data_ptr() for a in args], grid.data_ptr(), 2, 3, 5, 24, 2,
            3, plan.threads, plan.grid, plan.smem, 0,
            torch.cuda.current_stream().cuda_stream)
        want = vt.voxelize_tiled_ref(x, y, ts, pol, offs, bins=5, height=h,
                                     width=w)
        torch.cuda.synchronize()
        assert err == 0
    assert not grid.isnan().any()
    torch.testing.assert_close(grid.cpu(), want, atol=1e-6, rtol=0)
    assert grid[1].abs().sum().item() == 0                    # empty window


def test_voxel_tiled_allocates_only_its_grid(dev):
    """B3 allocates its output and nothing else (no halo scratch): device
    memory after a call less before is the grid's bytes."""
    args = [a.to(dev) for a in tiled_inputs(np.random.default_rng(13), 8,
                                            20000, 480, 640)]
    kw = dict(bins=5, height=480, width=640)
    vt.voxelize_tiled(*args, **kw)                 # build, warm the allocator
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n0 = vt.launches
    grid = vt.voxelize_tiled(*args, **kw)
    torch.cuda.synchronize()
    assert vt.launches == n0 + 1
    grid_bytes = grid.numel() * 4
    assert torch.cuda.memory_allocated() - before == grid_bytes
    assert torch.cuda.max_memory_allocated() - before == grid_bytes


def test_voxel_scatter_launchers_refuse_a_plan_that_disagrees(dev):
    """The three launchers (B3, B1, B3-legacy) recompute the accumulator
    layout and refuse (an error, no launch) a plan that disagrees with it: shared memory off by a
    row or of two accumulators, threads the kernel is not built for, no
    blocks, more blocks than items, another tile height, a form the kernel
    does not have (B3-legacy's stack, an unknown layout); the wrappers'
    own plans run, in every form."""
    args = [a.to(dev) for a in tiled_inputs(np.random.default_rng(14), 2,
                                            2000, 48, 256)]
    grid = torch.empty((2, 5, 48, 256), device=dev)
    lib, plan = scatter_lib_args(grid)
    stream = torch.cuda.current_stream().cuda_stream
    head = [a.data_ptr() for a in args] + [grid.data_ptr(), 2, 2000, 5]
    row = 128 * 4
    good = (24, 2, 2, plan.threads, plan.grid, plan.smem)
    bads = [(24, 2, 2, plan.threads, plan.grid, plan.smem + row),
            (24, 2, 2, plan.threads, plan.grid, 2 * plan.smem),
            (24, 2, 2, 128, plan.grid, plan.smem),
            (24, 2, 2, plan.threads, 0, plan.smem),
            (24, 2, 2, plan.threads, 9, plan.smem),
            (12, 4, 2, plan.threads, plan.grid, 5 * 12 * row)]
    for bad in bads:
        assert lib.ess_voxel_tiled(*head, *bad, 0, stream) != 0, bad
    assert lib.ess_voxel_tiled(*head, *good, 0, stream) == 0
    assert lib.ess_voxel_tiled(*head, *good, 1, stream) == 0     # int8
    partials = torch.empty((2, 4, 3), device=dev)
    fhead = [a.data_ptr() for a in args] + [grid.data_ptr(),
                                            partials.data_ptr(), 2, 2000, 5]
    for bad in bads:
        t_h, n_b, n_s = bad[:3]
        assert lib.ess_voxel_folded(*fhead, t_h, n_b, n_s, 256, *bad[3:],
                                    0, 0, stream) != 0, bad
    for layout in (0, 1, 2):
        for q8 in (0, 1):
            assert lib.ess_voxel_folded(*fhead, 24, 2, 2, 256, *good[3:],
                                        layout, q8, stream) == 0
    assert lib.ess_voxel_folded(*fhead, 24, 2, 2, 256, *good[3:], 3, 0,
                                stream) != 0
    # B3-legacy: offsets of n_bands + 1 columns, the band mode's plan
    band = vs.scatter_plan(5, 48, 256, 2, mode="band")
    assert (band.threads, band.grid, band.smem) == good[3:]
    for bad in bads:
        t_h, n_b = bad[:2]
        assert lib.ess_voxel_folded_band(*fhead, t_h, n_b, 256, *bad[3:],
                                         0, 0, stream) != 0, bad
    for layout, q8 in ((0, 0), (0, 1), (1, 0), (1, 1)):
        assert lib.ess_voxel_folded_band(*fhead, 24, 2, 256, *good[3:],
                                         layout, q8, stream) == 0
    assert lib.ess_voxel_folded_band(*fhead, 24, 2, 256, *good[3:], 2, 0,
                                     stream) != 0          # no stack form
    torch.cuda.synchronize()


def repeat_inputs(kernel, pile):
    """Kernel inputs on the CPU of 8 DSEC windows of 100k events
    (``bench.make_raw``): B1's x-slot band records, B3-legacy's full-width
    band records or B3's tile-sorted events; with ``pile`` 15 % of each
    window's events on one pixel (``bench.pile_events``, as chip_smoke.py's
    data parallel phase piles them)."""
    from ess_tpu_torch import bench

    raw, valid = bench.make_raw(np.random.default_rng(15), 1, 8)
    raw, valid = raw[0], valid[0]
    if pile:
        bench.pile_events(raw[None], 0, 320.0, 240.0)
    if kernel == "B3":
        r, v, o = vt.host_tile_bin(raw, valid, height=480, width=640)
    else:
        r, v, o = vf.host_band_bin_folded(raw, valid, height=480, width=640,
                                          bins=5, x_slots=kernel == "B1")
    x, y, t, p = (torch.from_numpy(np.ascontiguousarray(r[..., i]))
                  for i in range(4))
    vd = torch.from_numpy(v)
    if kernel == "B3":
        p = torch.where(p > 0, 1.0, -1.0)
    return [x, y, masked_time_norm(t, vd, 5).contiguous(),
            torch.where(vd, p, torch.zeros_like(p)).contiguous(),
            torch.from_numpy(o)]


@pytest.mark.parametrize("pile", [False, True])
@pytest.mark.parametrize("kernel", ["B1", "B3", "B3-legacy"])
def test_voxelizer_repeats_bit_for_bit(dev, kernel, pile):
    """Two launches on one input give the same grid and stats, bit for bit:
    the scatter core adds fixed-point cells, so the order in which the
    threads' corners reach a cell does not reach its sum, also where 15k
    events pile on one pixel."""
    args = [a.to(dev) for a in repeat_inputs(kernel, pile)]
    fn = vt.voxelize_tiled if kernel == "B3" else vf.voxelize_folded
    runs = [fn(*args, bins=5, height=480, width=640) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*(r if isinstance(r, tuple) else (r,) for r in runs)):
        assert torch.isfinite(a).all()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_voxel_tiled_stats_do_not_depend_on_the_batch(dev):
    """B3's stats (the kernel's per-tile partials summed in tile order)
    against ``grid_stats`` of its grid (atol/rtol 1e-3 / 1e-5, B1's stats
    bound), and the same bits whether 8 windows come in one call or one at
    a time, so the tile wire's in-loop and batched forms normalize alike."""
    args = [a.to(dev) for a in repeat_inputs("B3", False)]
    kw = dict(bins=5, height=480, width=640, stats=True)
    grid, stats = vt.voxelize_tiled(*args, **kw)
    torch.testing.assert_close(stats, grid_stats(grid), atol=1e-3,
                               rtol=1e-5)
    one = [vt.voxelize_tiled(*[a[i:i + 1] for a in args], **kw)
           for i in range(8)]
    assert torch.equal(torch.cat([o[0] for o in one]), grid)
    assert torch.equal(torch.cat([o[1] for o in one]).view(torch.int32),
                       stats.view(torch.int32))


# The reconstruction program (cli/reconstruct.py) at the DAVIS346 sensor.
DAVIS = (260, 346)


def davis_window(rng, n: int) -> np.ndarray:
    """A reader's (n, 4) float64 [t, x, y, p] window: integer pixels, ~10 ms
    of events starting at an arbitrary stamp."""
    h, w = DAVIS
    return np.stack([3.0 + np.sort(rng.uniform(0, 0.01, n)),
                     rng.integers(0, w, n), rng.integers(0, h, n),
                     rng.integers(0, 2, n)], -1).astype(np.float64)


def cli_grid(window, device):
    return voxelize_window_soa(*reconstruct.window_tensors(window, device),
                               num_bins=5, height=DAVIS[0], width=DAVIS[1],
                               normalize=False)


@pytest.mark.parametrize("n", [10_000, 7919])
def test_voxel_tiled_kernel_reconstruct_window(dev, n):
    """B3 at B=1 on 260x346 with the program's call: one launch, the grid
    against the plain version on the CPU."""
    window = davis_window(np.random.default_rng(n), n)
    n0 = vt.launches
    got = cli_grid(window, dev)
    torch.cuda.synchronize()
    assert vt.launches == n0 + 1 and got.shape == (1, 5) + DAVIS
    want = cli_grid(window, "cpu")
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(normalize_nonzero(got).cpu(),
                               normalize_nonzero(want), atol=1e-4, rtol=1e-4)


def test_rollout_all_no_recurrent_on_the_card(dev):
    """``no_recurrent`` on B2 and B4 (bf16): every ``rollout_all`` frame
    equals one step from zero state on its window, bit for bit, and the
    initial state stays zero although the cell updates c in place; the
    options (normalize, flip, standardize) on."""
    from ess_tpu_torch.models.e2vid import RecurrentUNet

    torch.manual_seed(0)
    model = RecurrentUNet(lstm_impl="pallas", block_conv_impl="pallas",
                          dtype=torch.bfloat16, device=dev)
    model.requires_grad_(False)
    rec = Reconstructor(model=model, height=64, width=96, no_recurrent=True,
                        normalize=True, flip=True, standardize=True)
    g = torch.Generator(device=dev).manual_seed(1)
    wins = torch.randn(3, 2, 5, 64, 96, generator=g, device=dev)
    wins = wins * (torch.rand(wins.shape, generator=g, device=dev) < 0.3)
    n0 = cl.launches
    with torch.no_grad():
        imgs, state = rec.rollout_all(wins)
        assert cl.launches == n0 + 9
        assert not any(bool(t.any()) for pair in state for t in pair)
        for i in range(3):
            one = rec.step(wins[i], rec.init_state(2, dev))[0]
            assert torch.equal(one, imgs[i]), i


def test_padded_reconstructor_step_kernel_vs_plain(dev, monkeypatch):
    """Five carried windows through B3, ``normalize_nonzero`` and the
    padded step at 260x346 (-> 264x352) on the card, against the same with
    B3's plain version."""
    model = reconstruct.build_model("", dev)
    recon = Reconstructor(model=model, height=DAVIS[0], width=DAVIS[1],
                          normalize=False)
    assert recon.geometry.pads == (2, 2, 3, 3)
    rng = np.random.default_rng(5)
    windows = [davis_window(rng, n) for n in (10_000, 7919, 10_000, 4000,
                                              10_000)]

    def run():
        state, imgs = recon.init_state(1, dev), []
        with torch.no_grad():
            for window in windows:
                img, state, _ = recon.step(
                    normalize_nonzero(cli_grid(window, dev)), state)
                imgs.append(crop_output(img, recon.geometry))
        return torch.cat(imgs)

    n0 = vt.launches
    got = run()
    torch.cuda.synchronize()
    assert vt.launches == n0 + len(windows)
    with monkeypatch.context() as m:
        m.setattr(batch_voxel, "voxelize_tiled", vt.voxelize_tiled_ref)
        want = run()
    assert vt.launches == n0 + len(windows)
    assert got.shape == (len(windows), 1) + DAVIS
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    off = (reconstruct.to_frame8(got).int()
           - reconstruct.to_frame8(want).int()).abs()
    assert off.max() <= 1 and (off > 0).float().mean() <= 0.01


def assert_normalized_close(got, want):
    """Normalized grids within 1e-4 where both are nonzero; at most 16
    cells zero in one only (+ and - deposits that cancel exactly in one
    sum order leave a residue in another)."""
    both = (got != 0) & (want != 0)
    assert int(((got != 0) != (want != 0)).sum()) <= 16
    torch.testing.assert_close(got[both], want[both], atol=1e-4, rtol=1e-4)


def sensor_map(rng, h, w):
    """(h, w, 2) rectify map: sub-pixel offsets, with bands that leave the
    frame on every side."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    m = np.stack([xx + rng.uniform(-0.45, 0.45, xx.shape),
                  yy + rng.uniform(-0.45, 0.45, yy.shape)], -1)
    m[:, :3, 0] -= 1.5
    m[:2, :, 1] -= 0.8
    m[:, -3:, 0] += 1.5
    m[-3:, :, 1] += 2.0
    return torch.from_numpy(m.astype(np.float32))


def test_rectified_raw_events_on_the_card(dev):
    h, w, b, n = 480, 640, 8, 100_000
    rng = np.random.default_rng(21)
    cols = [torch.from_numpy(rng.integers(0, w, (b, n)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, h, (b, n)).astype(np.float32)),
            torch.from_numpy(np.sort(rng.uniform(0, 5e4, (b, n)), -1)
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (b, n)).astype(np.float32)),
            torch.ones(b, n, dtype=torch.bool)]
    m = sensor_map(rng, h, w)
    for normalize in (False, True):
        kw = dict(num_bins=5, height=h, width=w, normalize=normalize)
        n0 = vt.launches
        got = voxelize_window_soa(*[c.to(dev) for c in cols],
                                  rectify_map=m.to(dev), **kw)
        torch.cuda.synchronize()
        assert vt.launches == n0 + 1
        want = voxelize_window_soa(*cols, rectify_map=m, **kw)
        if normalize:
            assert_normalized_close(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="lies on"):
        voxelize_window_soa(*[c.to(dev) for c in cols], rectify_map=m,
                            num_bins=5, height=h, width=w)
    events = torch.stack(cols[:4], -1).view(2, 4, n, 4)
    valid = cols[4].view(2, 4, n)
    kw = dict(num_bins=5, height=h, width=w, normalize=True, rectify_map=m)
    dense = batch_voxel.voxelize_windows(
        events.to(dev), valid.to(dev), **{**kw, "rectify_map": m.to(dev)})
    assert dense.shape == (2, 4, h, w, 5)
    assert_normalized_close(dense.cpu(), batch_voxel.voxelize_windows(
        events, valid, **kw))


@pytest.mark.parametrize("wire", ["folded", "tile", "raw"])
def test_window_at_a_time_matches_batched_launch(dev, wire):
    """The in-loop rollout's voxelizer: one launch a window against one
    batched launch of the same 2 x 4 windows of 100k events."""
    from ess_tpu_torch.data.pipeline import (AugmentParams, EventPipeline,
                                             PipelineConfig)

    h, w, b, t_dim, n = 480, 640, 2, 4, 100_000
    rng = np.random.default_rng(22)
    if wire == "folded":
        _, _, cols, offs = folded(rng, b * t_dim, n, h, w)
        offs = offs.view(b, t_dim, -1)
    else:
        raw, valid = raw_windows(rng, b * t_dim, n, h, w)
        offs = None
        if wire == "tile":
            raw, valid, o = vt.host_tile_bin(raw, valid, height=h, width=w)
            offs = torch.from_numpy(o).view(b, t_dim, -1)
        cols = [torch.from_numpy(np.ascontiguousarray(raw[..., i]))
                for i in range(4)] + [torch.from_numpy(valid)]
    batch = {k: c.view(b, t_dim, -1).to(dev) for k, c in zip(
        ("ev_x", "ev_y", "ev_t", "ev_p", "ev_valid"), cols)}
    key = "ev_band_offsets" if wire == "folded" else "ev_tile_offsets"
    if offs is not None:
        batch[key] = offs.to(dev)
    pipe = EventPipeline(PipelineConfig(sensor_height=h, sensor_width=w,
                                        num_bins=5, trilinear=True,
                                        normalize=True, crop_bottom=40))
    counter = (vf, "launches") if wire == "folded" else (vt, "launches")
    n0 = getattr(*counter)
    batched, _ = pipe.build_all(batch)
    torch.cuda.synchronize()
    assert getattr(*counter) == n0 + 1
    fn = pipe.make_window_fn(AugmentParams(), offsets_kind=(
        "band" if wire == "folded" else "tile"))
    for i in range(t_dim):
        one = fn(*(batch[k][:, i] for k in ("ev_x", "ev_y", "ev_t", "ev_p",
                                            "ev_valid")),
                 tile_offsets=batch[key][:, i] if key in batch else None)
        assert_normalized_close(one, batched[i])
    torch.cuda.synchronize()
    assert getattr(*counter) == n0 + 1 + t_dim


# The voxelizer pins: the int8 tent planes and the raw and stack layouts.
# Bounds: the int8 forms against their plain versions bit for bit (both add
# the same integer products exactly and scale the sum by the same f32
# multiply), the stats within 1e-3 / 1e-5 (the plain version sums the grid
# in torch's order); the raw and stack forms equal the default form's grid
# relaid out bit for bit, with the same stats bits (the drain reduces in
# the same order in every layout).
PIN_SHAPES = [(480, 640, 8, 100_000), (26, 170, 3, 5000)]


@pytest.mark.parametrize("h,w,b,n", PIN_SHAPES)
@pytest.mark.parametrize("slots", [True, False], ids=["B1", "B3-legacy"])
def test_voxel_folded_pin_forms_match_plain(dev, slots, h, w, b, n):
    """B1 (x-slot wire) and B3-legacy (full-width bands) in each form: the
    int8 grid against the plain int8 version, the raw and stack layouts
    (f32 and int8) against the NCHW grid relaid out, deint's s2d grid
    against the s2d view; one launch a call, on its form's count; the stack
    on the band wire raises."""
    cols, offs = legacy_inputs(np.random.default_rng(h + b), b, n, h,
                               w)[slots]
    args, kw = band_operands(*cols, offs, num_bins=5, height=h, width=w)
    on = [a.to(dev) for a in args]
    th = vs.tile_h_for_bins(5)
    wire = "" if slots else "_legacy"

    def counted(form, oh, **k):
        name = f"launches{wire}" + ("_int8" if oh == "int8" else
                                    f"_{form}" if form else "")
        n0 = getattr(vf, name)
        out = vf.voxelize_folded(*on, **kw, oh_dtype=oh, **k)
        torch.cuda.synchronize()
        assert getattr(vf, name) == n0 + 1, name
        return out

    for oh in ("float32", "int8"):
        grid, stats = counted(None, oh)
        if oh == "int8":
            ref, ref_stats = vf.voxelize_folded_ref(*args, **kw,
                                                    oh_dtype=oh)
            assert torch.equal(grid.cpu(), ref)
            torch.testing.assert_close(stats.cpu(), ref_stats, atol=1e-3,
                                       rtol=1e-5)
        for layout in ("raw", "stack") if slots else ("raw",):
            out, out_stats = counted(layout, oh, layout=layout)
            assert torch.equal(out, vs.relayout(grid, layout, th)), layout
            assert torch.equal(out_stats, stats), layout
        s2d, s2d_stats = counted("stack" if slots else None, oh,
                                 layout="s2d", deint=True)
        assert torch.equal(s2d, vs.relayout(grid, "stack", th).permute(
            0, 2, 3, 1)) and torch.equal(s2d_stats, stats)
    if not slots:
        with pytest.raises(ValueError):
            vf.voxelize_folded(*on, **kw, layout="stack")


@pytest.mark.parametrize("b", [8, 1])
def test_voxel_tiled_int8_matches_plain(dev, b):
    """B3's int8 form at the streaming B=8 and B=1 on 480x640, events on
    tile edges and borders (rows in (-1, 0) fold their weight into the
    scales): the grid bit for bit against the plain int8 version, its
    per-tile stats within 1e-3 / 1e-5 of the grid's, one launch."""
    raw, valid = raw_windows(np.random.default_rng(30 + b), b, 100_000, 480,
                             640, edges=True)
    raw, valid, o = vt.host_tile_bin(raw, valid, height=480, width=640)
    ts = masked_time_norm(torch.from_numpy(raw[..., 2]),
                          torch.from_numpy(valid), 5)
    pol = torch.where(torch.from_numpy(valid),
                      torch.from_numpy(np.where(raw[..., 3] > 0, 1.0, -1.0)),
                      0.0).float()
    args = [torch.from_numpy(np.ascontiguousarray(raw[..., 0])),
            torch.from_numpy(np.ascontiguousarray(raw[..., 1])), ts, pol,
            torch.from_numpy(o)]
    kw = dict(bins=5, height=480, width=640, oh_dtype="int8")
    n0, n0_f32 = vt.launches_int8, vt.launches
    grid, stats = vt.voxelize_tiled(*[a.to(dev).contiguous() for a in args],
                                    stats=True, **kw)
    torch.cuda.synchronize()
    assert (vt.launches_int8, vt.launches) == (n0 + 1, n0_f32)
    ref = vt.voxelize_tiled_ref(*args, **kw)
    assert torch.equal(grid.cpu(), ref)
    torch.testing.assert_close(stats.cpu(), grid_stats(ref), atol=1e-3,
                               rtol=1e-5)
