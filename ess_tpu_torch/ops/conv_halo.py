"""Tile plans of the halo-tile 3x3 conv core (``csrc/conv_halo.cuh``).

The fused conv (B4 exact and B4-int8, :mod:`ess_tpu_torch.ops.conv3x3`;
their plan is :func:`conv_plan`), the C-major head conv (T1,
:mod:`ess_tpu_torch.ops.head_cmajor`) and the ConvLSTM cell kernels (B2,
B2-int8, :mod:`ess_tpu_torch.ops.conv_lstm`; their plan is
:func:`cell_plan`) run on one CUDA core:
a block owns a ``th x tw`` patch of output pixels of one image and ``bn``
output channels, stages the ``(th + 2) x (tw + 2)`` input halo in shared
memory one 64-byte chunk of channels a pixel at a time (32 bf16 or 64 s8
channels), and reads every tap as a shifted view of it. Blocks are
persistent: block ``(bx, nt)`` of a ``(grid_x, n_tiles_n)`` grid walks the
pixel tiles ``bx, bx + grid_x, ...`` (in
:func:`tile_origin` order) for its N tile ``nt``. The plan is computed
here, where the CPU tests reach it, and passed to the kernels as
arguments; the CUDA launchers recompute the shared-memory layout and
refuse a plan that disagrees.

Shared memory of a block, in bytes (the layout of ``conv_halo.cuh``):

- one staged halo pixel: ``PIX_BYTES`` = 64 bytes of channels + 16 of
  padding;
- one output channel of a weight chunk (nine taps of 64 bytes, held as
  wgmma's K-major core matrices): ``W_ROW_BYTES`` = 9 x 64;
- B4: every weight chunk of the N tile resident plus two halo stages where
  that fits, else two stages of (halo + one weight chunk); B4-int8 the
  same with two raw stages of the chunk's bf16 pixels (:func:`raw_pitch`
  bytes a pixel) in place of the halo stages, and the one or two s8 halo
  tiles (``q_stages``) that the raw stages are quantized into; T1: its one
  weight chunk, one halo tile and, where W is a multiple of 8, the raw
  C-major rows of the halo, ``tw + 16`` pixels wide from an 8-pixel
  boundary;
- per warp an epilogue slot: 16 pixels x 40 (NHWC) or 32 channels x 24
  (NCHW) bf16 values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

KC = 32                      # input channels per chunk (bf16)
KC_INT8 = 64                 # input channels per chunk (s8)
PIX_BYTES = KC * 2 + 16      # 80: odd multiple of 16 (no ldmatrix conflict)
W_ROW_BYTES = 9 * KC * 2     # 576: one output channel of a weight chunk
THREADS = 256
WARPS = THREADS // 32
SLOT_NHWC = 16 * (32 + 8) * 2
SLOT_NCHW = 32 * (16 + 8) * 2
MAX_SMEM = 232_448           # per block on the H100
SM_SMEM = 233_472            # per SM
BLOCK_RESERVED = 1_024       # the runtime's share per resident block
H100_SMS = 132


@dataclass(frozen=True)
class HaloPlan:
    th: int               # output patch rows
    tw: int               # output patch columns (a multiple of 16)
    bm: int               # th * tw: pixels per block tile
    bn: int               # output channels per block
    tiles_y: int
    tiles_x: int
    n_tiles: int          # B * tiles_y * tiles_x pixel tiles
    n_tiles_n: int        # N tiles: ceil(C_out / bn), grid dimension y
    chunks: int           # chunks of C_in: 32 bf16 or 64 s8 channels
    resident: bool        # every weight chunk held in shared memory
    smem: int             # dynamic shared memory per block, bytes
    grid_x: int           # persistent blocks per N tile
    q_stages: int = 0     # B4-int8: s8 halo tiles, 1 or 2 (0: none)


def block_shape(cout: int) -> Tuple[int, int]:
    """(bm, bn) of a block of two warpgroups, each issuing m64 x bn wgmma
    tiles: one m64 tile each at C_out > 64 (128 x 128), two at C_out > 32
    (256 x 64) and below (256 x 32)."""
    if cout > 64:
        return 128, 128
    if cout > 32:
        return 256, 64
    return 256, 32


def patch(bm: int, w: int) -> Tuple[int, int]:
    """(th, tw) of a ``bm``-pixel tile: 32 columns at 256 pixels where the
    image is wider than 16, else 16."""
    tw = 32 if bm == 256 and w > 16 else 16
    return bm // tw, tw


def halo_bytes(th: int, tw: int) -> int:
    return (th + 2) * (tw + 2) * PIX_BYTES


def blocks_per_sm(bn: int, smem: int) -> int:
    """Blocks an SM holds at once: by shared memory, and by registers (the
    kernels' ``__launch_bounds__``: two blocks of 128 columns, else one)."""
    by_regs = 2 if bn == 128 else 1
    return max(1, min(by_regs, SM_SMEM // (smem + BLOCK_RESERVED)))


def _grid_x(n_tiles: int, n_tiles_n: int, bn: int, smem: int,
            sm_count: int) -> int:
    per_sm = blocks_per_sm(bn, smem)
    return min(n_tiles, max(1, math.ceil(sm_count * per_sm / n_tiles_n)))


def raw_pitch(cin: int) -> int:
    """Bytes of one pixel in B4-int8's raw stage: the chunk's bf16
    channels, at most 64 (``conv_halo.cuh::conv_raw_pitch``)."""
    return min(cin, KC_INT8) * 2


def conv_smem(th: int, tw: int, bn: int, chunks: int, resident: bool,
              raw: int = 0, q_stages: int = 0) -> int:
    """B4's shared memory: every weight chunk (resident) or two weight
    stages, two halo stages, the epilogue slots. B4-int8 (``raw``: the raw
    stage's bytes a pixel): two raw stages in place of the halo stages,
    plus ``q_stages`` s8 halo tiles."""
    stage = (th + 2) * (tw + 2) * raw if raw else halo_bytes(th, tw)
    return ((chunks if resident else 2) * bn * W_ROW_BYTES + 2 * stage
            + q_stages * halo_bytes(th, tw) + WARPS * SLOT_NHWC)


def _tiles(b: int, h: int, w: int, cout: int):
    bm, bn = block_shape(cout)
    th, tw = patch(bm, w)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    return bm, bn, th, tw, tiles_y, tiles_x, b * tiles_y * tiles_x


def conv_plan(b: int, h: int, w: int, cin: int, cout: int, *,
              int8: bool = False, sm_count: int = H100_SMS) -> HaloPlan:
    """The plan of B4 (``ess_conv3x3``) or, with ``int8``, B4-int8
    (``ess_conv3x3_int8``) for an NHWC (b, h, w, cin) input: every weight
    chunk resident where that fits beside the stages, else the weights
    streamed chunk by chunk with the halo.

    The s8 weights of a chunk take the bytes of a bf16 chunk and cover
    twice the channels, so both DSEC convs hold theirs in 73.7 KB, and
    B4-int8 spends the room on its bf16 raw stages. It runs the producer
    kernel with two s8 halo tiles (``q_stages`` = 2: a producer warpgroup
    copies and quantizes while two warpgroups multiply) where they fit
    beside every weight chunk without costing a block an SM, else the
    256-thread kernel with one (quantized between two block barriers):
    encoder 0 (128 -> 64) runs one block an SM either way and takes the
    producer kernel; the head (20 -> 128) keeps two blocks an SM with one
    s8 halo, which overlap one block's epilogue with the other's
    products."""
    bm, bn, th, tw, tiles_y, tiles_x, n_tiles = _tiles(b, h, w, cout)
    chunks = -(-cin // (KC_INT8 if int8 else KC))
    n_tiles_n = -(-cout // bn)
    raw = raw_pitch(cin) if int8 else 0

    def layout(q_stages):
        # the producer kernel (two s8 halos) holds every weight chunk
        for resident in (True, False) if q_stages < 2 else (True,):
            smem = conv_smem(th, tw, bn, chunks, resident, raw, q_stages)
            if smem <= MAX_SMEM:
                return resident, smem
        return None

    q_stages = 0
    if int8:
        one, two = layout(1), layout(2)
        q_stages = 2 if two and blocks_per_sm(bn, two[1]) == blocks_per_sm(
            bn, one[1]) else 1
    resident, smem = layout(q_stages)
    return HaloPlan(th, tw, bm, bn, tiles_y, tiles_x, n_tiles, n_tiles_n,
                    chunks, resident, smem,
                    _grid_x(n_tiles, n_tiles_n, bn, smem, sm_count),
                    q_stages)


def head_plan(b: int, h: int, w: int, cin: int, cout: int, *,
              nchw_out: bool, aligned: bool,
              sm_count: int = H100_SMS) -> HaloPlan:
    """The plan of T1 (``ess_head_cmajor``) for a C-major (b, cin, h, w)
    input, cin <= 32; ``aligned``: the raw rows are staged with 16-byte
    copies (W a multiple of 8 and x 16-byte aligned)."""
    if aligned and w % 8:
        raise ValueError(f"head_plan: W={w} rows are not 16-byte aligned")
    bm, bn, th, tw, tiles_y, tiles_x, n_tiles = _tiles(b, h, w, cout)
    n_tiles_n = -(-cout // bn)
    smem = (bn * W_ROW_BYTES + halo_bytes(th, tw)
            + (cin * (th + 2) * (tw + 16) * 2 if aligned else 0)
            + WARPS * (SLOT_NCHW if nchw_out else SLOT_NHWC))
    return HaloPlan(th, tw, bm, bn, tiles_y, tiles_x, n_tiles, n_tiles_n, 1,
                    True, smem, _grid_x(n_tiles, n_tiles_n, bn, smem, sm_count))


def tile_origin(plan: HaloPlan, t: int) -> Tuple[int, int, int]:
    """(image, first row, first column) of pixel tile ``t``, as the
    kernels' ``tile_pos`` decodes it."""
    tx = t % plan.tiles_x
    r = t // plan.tiles_x
    return r // plan.tiles_y, (r % plan.tiles_y) * plan.th, tx * plan.tw


def block_tiles(plan: HaloPlan, bx: int) -> range:
    """The pixel tiles block ``bx`` walks (for each of the N tiles)."""
    return range(bx, plan.n_tiles, plan.grid_x)


_SM_COUNT = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    import torch

    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


# The ConvLSTM cell kernels (B2, ``csrc/conv_lstm.cu``; B2-int8,
# ``csrc/conv_lstm_int8.cu``) on the same core, with a producer warpgroup.
CELL_THREADS = 384           # two consumer warpgroups + one producer
CELL_CONSUMER_WARPS = 8
CELL_BM = 256                # pixels per block tile: 2 warpgroups x 2 m64
CELL_BN = 128                # gate columns per N tile: 32 channels x 4 gates
CELL_PIX_BYTES = 64          # one staged halo pixel (TMA, 64-byte swizzle)
CELL_W_STAGE = 36 * CELL_BN * 16   # 73,728: one chunk of an N tile's weights
CELL_SLOT = 2 * 16 * 40 * 2  # per consumer warp: c/c' and h' rows staged
CELL_BARRIERS = 64           # full and empty mbarriers of the ring
CELL_ALIGN = 1024            # halo stages: the 64-byte swizzle's alignment
CELL_STAGES = 2              # ring depth (conv_halo.cuh::kCellStages)
CELL_PATCHES = ((16, 16), (8, 32))


@dataclass(frozen=True)
class CellPlan:
    th: int               # output patch rows
    tw: int               # output patch columns (a multiple of 16)
    bm: int               # th * tw = 256 pixels per block tile
    bn: int               # 128 gate columns per N tile
    tiles_y: int
    tiles_x: int
    n_tiles: int          # B * tiles_y * tiles_x pixel tiles
    n_tiles_n: int        # N tiles: 4 * CH / 128
    kc: int               # channels per chunk: 32 bf16 or 64 int8 (64 bytes)
    chunks_x: int         # chunks staged from x; the rest from h
    chunks: int
    smem: int             # dynamic shared memory per block, bytes
    grid: int             # persistent blocks


def cell_halo_bytes(th: int, tw: int) -> int:
    """One halo stage: (th+2) x (tw+2) pixels of 64 bytes, padded to the
    swizzle's 1,024-byte alignment."""
    raw = (th + 2) * (tw + 2) * CELL_PIX_BYTES
    return -(-raw // CELL_ALIGN) * CELL_ALIGN


def cell_smem(th: int, tw: int, stages: int = CELL_STAGES) -> int:
    """The cell kernels' shared memory: the alignment slack of the dynamic
    base, ``stages`` x (weight chunk + halo), the consumer warps' epilogue
    slots and the barriers (``conv_halo.cuh::cell_smem``)."""
    return (CELL_ALIGN + stages * (CELL_W_STAGE + cell_halo_bytes(th, tw))
            + CELL_CONSUMER_WARPS * CELL_SLOT + CELL_BARRIERS)


def cell_patch(h: int, w: int) -> Tuple[int, int]:
    """The 256-pixel patch that pads an h x w image least: 16 x 16 or
    8 x 32 (a tie keeps 16 x 16, whose halo is smaller)."""
    def padded(p):
        th, tw = p
        return -(-h // th) * th * (-(-w // tw) * tw)
    return min(CELL_PATCHES, key=padded)


def cell_plan(b: int, h: int, w: int, cx: int, ch: int, *, int8: bool,
              sm_count: int = H100_SMS) -> CellPlan:
    """The plan of the cell kernels for x (b, h, w, cx) and h (b, h, w, ch)
    in channels-last memory.

    A block owns a 256-pixel patch (:func:`cell_patch`) of one image and
    one N tile of 128 gate columns: 32 hidden channels x the 4 gates, in
    the order of ``conv_lstm.gate_column_order``. K runs over chunks of 64
    bytes a pixel (32 bf16 or 64 int8 channels), first ``chunks_x`` from x,
    then the rest from h. One ring stage holds a chunk's halo and the N
    tile's weights of that chunk (73,728 bytes, streamed: an N tile's whole
    weights, 295 KB to 1.18 MB, never fit). The ring has ``CELL_STAGES``
    = 2 stages, which fit the budget at every shape; a third would need
    285 KB.

    Work: ``n_tiles * n_tiles_n`` items, N tile fastest (the blocks
    running at once share halos in L2), dealt round-robin to ``grid``
    persistent blocks, one block per SM (the ring takes ~211 KB).
    Ragged images: the last patch row and column run past the image; the
    tensor map zero-fills the halo there and the epilogue stores no pixel
    outside it (DSEC level 2's 55 rows: 4 patch rows of 16, 9 rows
    masked; with 8 x 32 patches it would be 7 rows of 8, but 80 columns
    then pad to 96, more than 16 x 16 pads). Few tiles (level 2 at B=1:
    20 patches x 8 N tiles = 160 block tiles on 132 SMs): the grid is the
    whole card and the last wave is partly idle; the plan accepts that
    quantisation (2 tile times where 1.21 would be ideal).
    """
    if cx <= 0 or ch <= 0 or cx % 32 or ch % 32:
        raise ValueError(f"cell_plan: CX={cx} and CH={ch} must be positive "
                         "multiples of 32")
    th, tw = cell_patch(h, w)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    n_tiles = b * tiles_y * tiles_x
    kc = 64 if int8 else 32
    chunks_x = -(-cx // kc)
    chunks = chunks_x + -(-ch // kc)
    n_tiles_n = 4 * ch // CELL_BN
    grid = max(1, min(n_tiles * n_tiles_n, sm_count))
    return CellPlan(th, tw, CELL_BM, CELL_BN, tiles_y, tiles_x, n_tiles,
                    n_tiles_n, kc, chunks_x, chunks, cell_smem(th, tw), grid)


def cell_items(plan: CellPlan, block: int):
    """The (N tile, pixel tile) pairs block ``block`` walks, in order."""
    items = plan.n_tiles * plan.n_tiles_n
    return [(wc % plan.n_tiles_n, wc // plan.n_tiles_n)
            for wc in range(block, items, plan.grid)]


# The fused encoder level (B5, ``csrc/level_int8.cu``): its conv and its
# gate kernel on the same core, over quantization groups.
AMAX_THREADS = 256           # level_int8.cu::kAmaxThreads
AMAX_BLOCKS = 64             # partials a group at most (kMaxAmaxBlocks)
LEVEL_GATE_PATCHES = ((8, 16), (4, 32))   # 128 pixels: one m64 a warpgroup
LEVEL_W_STAGE = 9 * 2 * CELL_BN * 16   # 36,864: a half chunk's weights


def level_gate_smem(th: int, tw: int, chunks: int, halves: int) -> int:
    """The gate kernel's shared memory (``level_int8.cu::level_cell_smem``):
    the alignment slack, two weight stages of ``halves`` half chunks,
    every chunk's s8 halo (each padded to 1,024 bytes), the consumer warps'
    epilogue slots and the barriers."""
    return (CELL_ALIGN + CELL_STAGES * halves * LEVEL_W_STAGE
            + chunks * cell_halo_bytes(th, tw)
            + CELL_CONSUMER_WARPS * CELL_SLOT + CELL_BARRIERS)


@dataclass(frozen=True)
class LevelPlan:
    groups: int           # G = B * NT quantization groups
    nt: int               # row tiles (groups) a sample
    th: int               # output rows a group (pick_row_tile)
    amax_blocks: int      # P: amax_u partials a group, one a block
    conv: HaloPlan        # the conv over the groups' th + 2 x rows
    gates: CellPlan       # the gate kernel over the groups' th rows
    gate_halves: int      # weight halves a gate stage: 2 (a chunk) or 1


def _group_patch(rows: int, w: int, cands) -> Tuple[int, int]:
    """The patch of ``cands`` that pads ``rows`` x ``w`` least (a tie keeps
    the first, whose halo is smaller)."""
    def padded(p):
        return -(-rows // p[0]) * p[0] * (-(-w // p[1]) * p[1])
    return min(cands, key=padded)


def level_plan(b: int, ho: int, wo: int, cu: int, ch: int, th: int, *,
               sm_count: int = H100_SMS) -> LevelPlan:
    """The plan of the fused level for a space-to-depth input of ``cu``
    channels at ``ho x wo`` and ``ch`` hidden channels, in groups of ``th``
    output rows (``ho`` a multiple of ``th``).

    - amax_u: ``amax_blocks`` blocks a group, each a share of the group's
      ``(th + 4) x wo x cu`` values (at most :data:`AMAX_BLOCKS`).
    - The conv (``level_conv_kernel``): the s8 NHWC conv's block shape
      (:func:`block_shape` of ``ch``), a group is an image of ``th + 2``
      rows, so a pixel tile (``tile_origin``: group, first x row of the
      group, first column) never straddles two groups; the patch that pads
      those rows least (8 x 32 or 16 x 16 at 256 pixels, 8 x 16 or 4 x 32
      at 128); every weight chunk resident where that fits beside two raw
      stages and one s8 halo, else two streamed stages.
    - The gate kernel (``level_cell_kernel``): 128-pixel patches
      (:data:`LEVEL_GATE_PATCHES`, the one that pads a group's ``th`` rows
      least), N tiles of 128 gate columns, ``chunks_x`` 64-channel chunks
      of x then as many of h; an item is a pixel tile with all its N tiles
      (``n_tiles`` items), whose chunks' s8 halos stay in shared memory
      (:func:`level_gate_smem`), weight stages of a whole chunk where they
      fit beside them (``gate_halves`` 2), else of half a chunk, one
      persistent block an SM. A level whose halos do not fit (CH above
      320) raises.
    """
    if ho % th or ch % 32 or cu % 16 or min(b, ho, wo, cu, ch) <= 0:
        raise ValueError(f"level_plan: th={th} must divide {ho} rows, "
                         f"CH={ch} be a multiple of 32 and CU={cu} of 16")
    nt = ho // th
    groups = b * nt
    want = -(-((th + 4) * wo * cu // 8) // AMAX_THREADS)
    amax_blocks = max(1, min(AMAX_BLOCKS, want))

    bm, bn = block_shape(ch)
    cands = ((8, 32), (16, 16)) if bm == 256 else ((8, 16), (4, 32))
    cth, ctw = _group_patch(th + 2, wo, cands)
    ty, tx = -(-(th + 2) // cth), -(-wo // ctw)
    n_tiles = groups * ty * tx
    chunks = -(-cu // KC_INT8)
    n_tiles_n = -(-ch // bn)
    raw = raw_pitch(cu)
    for resident in (True, False):
        smem = conv_smem(cth, ctw, bn, chunks, resident, raw, 1)
        if smem <= MAX_SMEM:
            break
    conv = HaloPlan(cth, ctw, bm, bn, ty, tx, n_tiles, n_tiles_n, chunks,
                    resident, smem,
                    _grid_x(n_tiles, n_tiles_n, bn, smem, sm_count), 1)

    gth, gtw = _group_patch(th, wo, LEVEL_GATE_PATCHES)
    gty, gtx = -(-th // gth), -(-wo // gtw)
    g_tiles = groups * gty * gtx
    chunks_x = -(-ch // KC_INT8)
    g_n = 4 * ch // CELL_BN
    halves = 2 if level_gate_smem(gth, gtw, 2 * chunks_x, 2) <= MAX_SMEM else 1
    g_smem = level_gate_smem(gth, gtw, 2 * chunks_x, halves)
    if g_smem > MAX_SMEM:
        raise ValueError(f"level_plan: the s8 halos of CH={ch} "
                         f"({2 * chunks_x} "
                         f"chunks) and the weight stages take {g_smem} B, "
                         f"more than a block's {MAX_SMEM}")
    gates = CellPlan(gth, gtw, gth * gtw, CELL_BN, gty, gtx, g_tiles, g_n,
                     KC_INT8, chunks_x, 2 * chunks_x, g_smem,
                     max(1, min(g_tiles, sm_count)))
    return LevelPlan(groups, nt, th, amax_blocks, conv, gates, halves)
