"""Faults planted under the timed path, to show that the check catches
them: each is a list of (object, attribute, replacement) patches of the
program or of the benchmark's adapter to it, applied before a driver is
built (the CPU tests through pytest's ``monkeypatch``,
``benchmark.calibrate`` on the card through :func:`planted`).

- ``unchanged`` (train and streaming): a step that returns its state
  unchanged: no optimizer update, or a streaming step that hands back the
  state it was given;
- ``half_batch`` (train): half of the batch left out, the loss and the
  gradient the mean over the rest;
- ``half_loss`` (supervised train): the whole batch rolled out, the loss
  the mean over the first half of the rows;
- ``answer_altered`` (streaming): the scored window's prediction altered
  where it is produced (each pixel's class moved to the next).
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

from benchmark import program
from ess_tpu_torch.train import streaming, supervised, uda


def _no_update(params, grads, opt) -> None:
    pass


def _half_rows(make):
    def wrapped(mods):
        step = make(mods)

        def half(state, batch, aug=None):
            rows = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()}, aug)
        return half
    return wrapped


def _half_loss(fn):
    def wrapped(logits, labels, *args, **kwargs):
        rows = logits.shape[0] // 2
        return fn(logits[:rows], labels[:rows], *args, **kwargs)
    return wrapped


def _frozen_streams(make):
    def wrapped(mods):
        encode, score = make(mods)

        def enc(state, batch):
            encode(state, batch)
            return state

        def sc(state, batch):
            _, cm = score(state, batch)
            return state, cm
        return enc, sc
    return wrapped


def _shifted_confusion(fn):
    def wrapped(pred, label, *, num_classes, ignore_label=255):
        return fn((pred + 1) % num_classes, label, num_classes=num_classes,
                  ignore_label=ignore_label)
    return wrapped


def patches(name: str) -> List[Tuple[object, str, object]]:
    if name == "unchanged":
        return [(supervised, "apply_updates", _no_update),
                (uda, "apply_updates", _no_update),
                (program, "streaming_steps",
                 _frozen_streams(program.streaming_steps))]
    if name == "half_batch":
        return [(program, "supervised_train_step",
                 _half_rows(program.supervised_train_step)),
                (program, "uda_train_step",
                 _half_rows(program.uda_train_step))]
    if name == "half_loss":
        return [(supervised, "task_loss", _half_loss(supervised.task_loss))]
    if name == "answer_altered":
        return [(streaming, "confusion_matrix",
                 _shifted_confusion(streaming.confusion_matrix))]
    raise ValueError(f"unknown fault {name!r}")


FAULTS = {"supervised_train": ("unchanged", "half_batch", "half_loss"),
          "uda_train": ("unchanged", "half_batch"),
          "streaming": ("unchanged", "answer_altered")}


@contextlib.contextmanager
def planted(name: str):
    saved = []
    try:
        for obj, attr, new in patches(name):
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
