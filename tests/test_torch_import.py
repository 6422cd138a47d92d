"""The port never loads JAX, cv2 or PIL: importing it and every slice
module, or ``chip_smoke.py`` (which runs on a machine without them),
leaves ``jax`` (and the JAX package), ``cv2`` and ``PIL`` out of
``sys.modules``."""

import os
import subprocess
import sys

MODULES = [
    "ess_tpu_torch", "ess_tpu_torch.kernels",
    "ess_tpu_torch.core.config", "ess_tpu_torch.core.labels",
    "ess_tpu_torch.data.native", "ess_tpu_torch.data.pipeline",
    "ess_tpu_torch.data.slicer", "ess_tpu_torch.data.synthetic",
    "ess_tpu_torch.data.loader", "ess_tpu_torch.data.dsec",
    "ess_tpu_torch.data.ddd17",
    "ess_tpu_torch.ops.voxel", "ess_tpu_torch.ops.voxel_folded",
    "ess_tpu_torch.ops.voxel_tiled",
    "ess_tpu_torch.ops.batch_voxel", "ess_tpu_torch.ops.conv_lstm",
    "ess_tpu_torch.ops.conv_s2d", "ess_tpu_torch.ops.conv3x3",
    "ess_tpu_torch.ops.level", "ess_tpu_torch.ops.head_cmajor",
    "ess_tpu_torch.tools", "ess_tpu_torch.tools.bench_head",
    "ess_tpu_torch.tools.bench_level",
    "ess_tpu_torch.tools.bench_lstm_breakdown",
    "ess_tpu_torch.tools.bench_cell_host",
    "ess_tpu_torch.tools.sanity_train", "ess_tpu_torch.tools.roofline",
    "ess_tpu_torch.tools.bench_voxel", "ess_tpu_torch.tools.bench_kernel",
    "ess_tpu_torch.tools.profile_kernel", "ess_tpu_torch.tools.bench_lstm",
    "ess_tpu_torch.tools.profile_lstm",
    "ess_tpu_torch.tools.bench_increments",
    "ess_tpu_torch.tools.bench_uda_increments",
    "ess_tpu_torch.ops.voxel_scatter", "ess_tpu_torch.ops.conv_halo",
    "ess_tpu_torch.ops.pad", "ess_tpu_torch.ops.resize",
    "ess_tpu_torch.models.layers", "ess_tpu_torch.models.e2vid",
    "ess_tpu_torch.models.seghead", "ess_tpu_torch.models.resnet",
    "ess_tpu_torch.recon.reconstructor", "ess_tpu_torch.recon.color",
    "ess_tpu_torch.data.readers", "ess_tpu_torch.cli.reconstruct",
    "ess_tpu_torch.train.builder", "ess_tpu_torch.train.losses",
    "ess_tpu_torch.train.metrics", "ess_tpu_torch.train.supervised",
    "ess_tpu_torch.train.streaming", "ess_tpu_torch.train.uda",
    "ess_tpu_torch.io.convert", "ess_tpu_torch.io.checkpoint",
    "ess_tpu_torch.io.writers", "ess_tpu_torch.io.timers",
    "ess_tpu_torch.data.png", "ess_tpu_torch.data.imgproc",
    "ess_tpu_torch.data.cityscapes", "ess_tpu_torch.data.ddd17_gray",
    "ess_tpu_torch.utils",
    "ess_tpu_torch.utils.viz", "ess_tpu_torch.train.loop",
    "ess_tpu_torch.cli", "ess_tpu_torch.cli.train",
    "ess_tpu_torch.cli.evaluate",
    "ess_tpu_torch.bench",
    "ess_tpu_torch.parallel", "ess_tpu_torch.parallel.dp",
    "ess_tpu_torch.parallel.multihost", "ess_tpu_torch.parallel.launch",
    "ess_tpu_torch.parallel.steps",
]


def imports_nothing_forbidden(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'ess_tpu', 'cv2', 'PIL'))\n"
            "assert not bad, bad\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_imports_no_jax():
    imports_nothing_forbidden(MODULES)


def test_chip_smoke_imports_no_jax():
    imports_nothing_forbidden(["chip_smoke"])
