"""The one traffic generator: seeded synthetic DSEC and DDD17 event windows,
labels and sensor-A images, from a configuration and a traffic file.

The draws are those of the port's ``bench.py`` recipes (``make_raw``,
``make_ddd17_batch``, ``make_uda_batch``, ``pile_events``), frozen here:
uniform events over the sensor (rectified float coordinates on DSEC,
integer pixels on DDD17), times sorted over 50 ms, random polarity, uniform
labels, N(0, 1) images. The same seed gives the same inputs; every seed
gives the same sizes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

TIME_SPAN_US = 5e4


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one part of a run's inputs (``stream``), from the
    run's seed (any non-negative integer)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def events(rng: np.random.Generator, conf: dict, batch: int,
           windows: int) -> np.ndarray:
    """(batch, windows, N, 4) f32 raw (x, y, t, p) events."""
    h, w = conf["sensor_height"], conf["sensor_width"]
    shape = (batch, windows, conf["events_per_window"])
    raw = np.zeros(shape + (4,), np.float32)
    if conf["integer_coordinates"]:
        raw[..., 0] = rng.integers(0, w, shape)
        raw[..., 1] = rng.integers(0, h, shape)
    else:
        raw[..., 0] = rng.uniform(0, w - 1, shape)
        raw[..., 1] = rng.uniform(0, h - 1, shape)
    raw[..., 2] = np.sort(rng.uniform(0, TIME_SPAN_US, shape), axis=-1)
    raw[..., 3] = rng.integers(0, 2, shape)
    return raw


def pile(raw: np.ndarray, sample: Optional[int], x: float, y: float) -> None:
    """Move 15 % of each window's events of ``sample`` onto the pixel (x, y)
    in place (nothing where ``sample`` is None)."""
    if sample is not None:
        k = int(0.15 * raw.shape[2])
        raw[sample, :, :k, 0], raw[sample, :, :k, 1] = x, y


def labels(rng: np.random.Generator, conf: dict, batch: int) -> np.ndarray:
    """(batch, H, W) uniform class labels at the model's output size."""
    return rng.integers(0, conf["classes"], (batch,) + output_size(conf))


def output_size(conf: dict):
    if conf.get("resize_to"):
        return tuple(conf["resize_to"])
    return (conf["sensor_height"] - conf["crop_bottom"], conf["sensor_width"])


def train_batch(conf: dict, traffic: dict, seed: int, index: int,
                uda: bool = False) -> Dict[str, np.ndarray]:
    """Batch ``index`` of a run: ``events`` (B, T, N, 4) and ``label``; for
    UDA ``label_a`` and ``image_a`` (B, 1, H, W) of sensor A instead of
    the event label."""
    rng = rng_for(seed, 2, index)
    b = conf["batch"]
    raw = events(rng, conf, b, conf["windows"])
    pile(raw, traffic.get("pile"), conf["sensor_width"] / 2,
         conf["sensor_height"] / 2)
    out = {"events": raw, "label": labels(rng, conf, b)}
    if uda:
        del out["label"]
        out.update(sensor_a(rng_for(seed, 3, index), conf, b))
    return out


def sensor_a(rng: np.random.Generator, conf: dict, batch: int
             ) -> Dict[str, np.ndarray]:
    """Sensor-A labels and N(0, 1) grey images at the model's size (the
    label drawn first)."""
    shape = (batch,) + output_size(conf)
    label = rng.integers(0, conf["classes"], shape)
    image = rng.normal(size=(batch, 1) + shape[1:]).astype(np.float32)
    return {"label_a": label, "image_a": image}


def stream_segment(conf: dict, traffic: dict, seed: int, index: int
                   ) -> Dict[str, np.ndarray]:
    """Segment ``index``: ``events`` (S, W, N, 4) of S streams over W
    windows and the last window's ``label`` (S, H, W)."""
    rng = rng_for(seed, 4, index)
    s = traffic["streams"]
    raw = events(rng, conf, s, traffic["windows_per_segment"])
    return {"events": raw, "label": labels(rng, conf, s)}
