"""The work of a step, counted from the problem's shapes, and the H100's
peaks: the frozen yardstick of the roofline and MFU metrics.

Every count is of the problem, not of an implementation: a conv is counted
in its published form (the 5x5 head and encoder convs, not the block convs
that stand in for them), each input is read once and each output written
once at the configuration's dtype (bf16, int8 operands where the
configuration runs int8 cells), and a backward pass counts only the
gradients the step needs (no input gradient where the input needs none).
Peaks: NVIDIA's H100 SXM datasheet, dense: 989 TFLOP/s bf16, 1,979 TOP/s
int8, 3.35 TB/s HBM.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
BF16 = 2
EVENT_BYTES = 16            # x, y, t, p in f32


@dataclass
class Work:
    """Operations by peak type and bytes moved."""

    ops: Dict[str, float] = field(default_factory=dict)
    bytes: float = 0.0

    def add(self, kind: str, ops: float, nbytes: float) -> None:
        self.ops[kind] = self.ops.get(kind, 0.0) + ops
        self.bytes += nbytes

    def __iadd__(self, other: "Work") -> "Work":
        for k, v in other.ops.items():
            self.ops[k] = self.ops.get(k, 0.0) + v
        self.bytes += other.bytes
        return self

    def ops_seconds(self) -> float:
        return sum(v / PEAK_OPS_PER_S[k] for k, v in self.ops.items())

    def least_seconds(self) -> float:
        """The larger of the operations over their peaks and the bytes over
        the memory rate."""
        return max(self.ops_seconds(), self.bytes / HBM_BYTES_PER_S)


@dataclass(frozen=True)
class Conv:
    """One conv over a batch: output pixels a sample, kernel, channels;
    ``grad_in`` the share of the input channels whose gradient the step
    needs, ``wgrad`` whether it needs the kernel's."""

    hw_out: int
    k: int
    cin: int
    cout: int
    hw_in: int
    backward: bool = False
    grad_in: float = 0.0
    wgrad: bool = False

    def work(self, batch: int, kind: str = "bf16",
             operand_bytes: int = BF16) -> Work:
        w = Work()
        macs = batch * self.hw_out * self.k * self.k * self.cin * self.cout
        x = batch * self.hw_in * self.cin * operand_bytes
        y = batch * self.hw_out * self.cout * BF16
        wb = self.k * self.k * self.cin * self.cout * operand_bytes
        w.add(kind, 2 * macs, x + y + wb)
        if self.backward and self.grad_in:
            w.add(kind, 2 * macs * self.grad_in, y + wb + x * self.grad_in)
        if self.backward and self.wgrad:
            w.add(kind, 2 * macs, x + y + wb)
        return w


def _hw(conf: dict, scale: int) -> int:
    h, w = model_size(conf)
    return (h // scale) * (w // scale)


def model_size(conf: dict):
    if conf.get("resize_to"):
        return tuple(conf["resize_to"])
    return (conf["sensor_height"] - conf["crop_bottom"], conf["sensor_width"])


def rollout_convs(conf: dict) -> List[Conv]:
    """The convs of one window's encoder pass (head and encoders)."""
    base, n = conf["e2vid_base_channels"], conf["e2vid_num_encoders"]
    out = [Conv(_hw(conf, 1), 5, conf["bins"], base, _hw(conf, 1))]
    for i in range(n):
        out.append(Conv(_hw(conf, 2 ** (i + 1)), 5, base * 2 ** i,
                        base * 2 ** (i + 1), _hw(conf, 2 ** i)))
    return out


def decode_convs(conf: dict) -> List[Conv]:
    """The residual blocks, decoders and prediction of a decoded window."""
    base, n = conf["e2vid_base_channels"], conf["e2vid_num_encoders"]
    top, s = base * 2 ** n, 2 ** n
    out = [Conv(_hw(conf, s), 3, top, top, _hw(conf, s))
           for _ in range(2 * conf["e2vid_num_residual_blocks"])]
    for i in range(n):
        feats = base * 2 ** (n - i)
        scale = 2 ** (n - i - 1)
        out.append(Conv(_hw(conf, scale), 5, feats, feats // 2,
                        _hw(conf, scale)))
    out.append(Conv(_hw(conf, 1), 1, base, 1, _hw(conf, 1)))
    return out


def cell_work(conf: dict, windows: int, int8: bool) -> Work:
    """The ConvLSTM cells of ``windows`` windows: each level's 3x3 gate
    conv over [x, h] (2C -> 4C), and its state dataflow (read x, h, c;
    write h, c, in bf16)."""
    base, n = conf["e2vid_base_channels"], conf["e2vid_num_encoders"]
    w = Work()
    kind = "int8" if int8 else "bf16"
    for i in range(n):
        c, hw = base * 2 ** (i + 1), _hw(conf, 2 ** (i + 1))
        macs = hw * 9 * 2 * c * 4 * c
        wbytes = 9 * 2 * c * 4 * c * (1 if int8 else BF16)
        w.add(kind, windows * 2 * macs, windows * 5 * hw * c * BF16 + wbytes)
    return w


def head_convs(conf: dict, *, train: bool, input_grad: bool = False
               ) -> List[Conv]:
    """The segmentation head's convs; ``train`` adds the backward pass
    (kernel gradients), ``input_grad`` the gradient into the latent."""
    tch = conf["e2vid_base_channels"] * 2 ** conf["e2vid_num_encoders"]
    h8, h4, h2, h1 = (_hw(conf, s) for s in (8, 4, 2, 1))
    bw = train or input_grad
    ins = dict(backward=bw, wgrad=train)
    first = 1.0 if input_grad else 0.0
    convs = [Conv(h8, 3, tch, tch, h8, grad_in=first if i == 0 else 1.0,
                  **ins) for i in range(10)]
    skip = 1.0 if input_grad else 0.5
    convs += [Conv(h8, 3, tch, tch // 2, h8, grad_in=1.0, **ins),
              Conv(h4, 3, tch, tch // 2, h4, grad_in=skip, **ins),
              Conv(h4, 3, tch // 2, tch // 4, h4, grad_in=1.0, **ins),
              Conv(h2, 3, tch // 2, tch // 4, h2, grad_in=skip, **ins),
              Conv(h2, 3, tch // 4, tch // 4, h2, grad_in=1.0, **ins),
              Conv(h1, 3, tch // 4, tch // 8, h1, grad_in=1.0, **ins),
              Conv(h1, 1, tch // 8, conf["classes"], h1, grad_in=1.0, **ins)]
    return convs


def front_convs(conf: dict, *, train: bool) -> List[Conv]:
    """ResNet18's stem and layers 1-3 on one image batch; ``train`` adds
    the backward pass (no gradient into the image)."""
    w = conf["front_base_width"]
    h1, h2, h4, h8 = (_hw(conf, s) for s in (1, 2, 4, 8))
    kw = dict(backward=train, wgrad=train)
    out = [Conv(h2, 7, 1, w, h1, grad_in=0.0, **kw)]
    out += [Conv(h2, 3, w, w, h2, grad_in=1.0, **kw) for _ in range(4)]
    for c, hin, hout in ((2 * w, h2, h4), (4 * w, h4, h8)):
        out += [Conv(hout, 3, c // 2, c, hin, grad_in=1.0, **kw),
                Conv(hout, 1, c // 2, c, hin, grad_in=1.0, **kw)]
        out += [Conv(hout, 3, c, c, hout, grad_in=1.0, **kw)
                for _ in range(3)]
    return out


def convs_work(convs: List[Conv], batch: int) -> Work:
    """The convs' work over ``batch`` samples, in bf16."""
    w = Work()
    for c in convs:
        w += c.work(batch)
    return w


def voxel_work(conf: dict, windows: int) -> Work:
    """The voxelizer over ``windows`` windows: each window's events read
    once, its bf16 model-input grid written once."""
    h, w = model_size(conf)
    vox = Work()
    vox.add("bf16", 0.0, windows * (conf["events_per_window"] * EVENT_BYTES
                                    + conf["bins"] * h * w * BF16))
    return vox
