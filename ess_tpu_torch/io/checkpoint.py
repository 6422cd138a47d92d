"""Checkpoints of the whole train state.

Counterpart of ``ess_tpu/io/checkpoint.py``: epoch checkpoints holding
every model's and optimizer's state plus epoch and step bookkeeping, resume
(the whole state), and a pretrained-weights path that loads the trainable
nets while keeping the template's frozen E2VID and optimizers.

One checkpoint is a directory ``<directory>/<key>`` with ``state.pt`` (a
``torch.save`` of CPU state dicts: ``step``, ``head``, ``opt_back`` and,
where the state has them, ``front`` with its batch-norm buffers,
``opt_front`` and the frozen ``e2vid``) and, when given, ``metadata.json``.
It is written to a temporary directory and renamed into place, so a crash
never leaves half a checkpoint under a key. Under data parallel rank 0
alone writes, the other ranks wait for it at a barrier, and every rank
restores (the replicas are equal, so rank 0's state is every rank's).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import torch

from ess_tpu_torch.parallel import dp
from ess_tpu_torch.train.state import TrainState

# Mid-epoch autosave keys live above this base so they never collide with
# epoch keys.
AUTOSAVE_BASE = 1_000_000

_MODULES = ("head", "front", "e2vid")
_OPTIMIZERS = ("opt_back", "opt_front")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Numbered checkpoints of a :class:`TrainState` in ``directory``,
    the newest ``max_to_keep`` of them kept."""

    def __init__(self, directory: str, *, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_keys(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isfile(os.path.join(self.directory, n,
                                                      "state.pt")))

    def save(self, key: int, state: TrainState, *,
             metadata: Optional[dict] = None, wait: bool = False) -> None:
        """Write ``state`` under ``key``. The copy to the host synchronizes
        with the device, so the saved state is the one after every step
        issued before the call; the save is synchronous and ``wait`` has
        nothing to wait for."""
        if dp.rank() == 0:
            self._write(key, state, metadata)
        dp.barrier()

    def _write(self, key: int, state: TrainState,
               metadata: Optional[dict]) -> None:
        blob: Dict[str, Any] = {"step": int(state.step)}
        for name in _MODULES + _OPTIMIZERS:
            part = getattr(state, name)
            if part is not None:
                blob[name] = _to_cpu(part.state_dict())
        tmp = tempfile.mkdtemp(prefix=f".{key}.", dir=self.directory)
        try:
            torch.save(blob, os.path.join(tmp, "state.pt"))
            if metadata:
                with open(os.path.join(tmp, "metadata.json"), "w") as f:
                    json.dump(metadata, f)
            final = os.path.join(self.directory, str(key))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_keys()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_epoch(self) -> Optional[int]:
        """Latest completed-epoch save (mid-epoch autosaves excluded)."""
        keys = [k for k in self.all_keys() if k < AUTOSAVE_BASE]
        return max(keys) if keys else None

    def latest(self) -> Optional[int]:
        """Latest save of any kind; keys >= AUTOSAVE_BASE are mid-epoch
        step autosaves."""
        keys = self.all_keys()
        return keys[-1] if keys else None

    def _load(self, key: Optional[int]) -> Dict[str, Any]:
        key = self.latest() if key is None else key
        if key is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(os.path.join(self.directory, str(key), "state.pt"),
                          map_location="cpu", weights_only=True)

    def restore(self, template: TrainState, key: Optional[int] = None
                ) -> TrainState:
        """Load the whole state saved under ``key`` (None: the latest)
        into ``template``'s modules and optimizers in place, and its step;
        returns ``template``."""
        blob = self._load(key)
        for name in _MODULES + _OPTIMIZERS:
            part = getattr(template, name)
            if (part is None) != (name not in blob):
                raise ValueError(f"checkpoint and template disagree on "
                                 f"{name!r}")
            if part is not None:
                part.load_state_dict(blob[name])
        template.step = int(blob["step"])
        return template

    def restore_metadata(self, key: int) -> Optional[dict]:
        """The JSON metadata saved with a checkpoint (epoch and step
        bookkeeping), or None for one saved without it."""
        path = os.path.join(self.directory, str(key), "metadata.json")
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_pretrained(self, template: TrainState,
                           key: Optional[int] = None, *,
                           skip_frozen: bool = True) -> TrainState:
        """Load the trainable nets (head, and front with its batch-norm
        buffers) saved under ``key`` into ``template`` in place, keeping
        its optimizers and step, and its frozen E2VID unless
        ``skip_frozen`` is False; returns ``template``."""
        blob = self._load(key)
        names = ["head", "front"] + ([] if skip_frozen else ["e2vid"])
        for name in names:
            part = getattr(template, name)
            if part is not None and name in blob:
                part.load_state_dict(blob[name])
        return template

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing is held open."""
