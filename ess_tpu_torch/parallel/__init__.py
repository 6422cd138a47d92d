"""Data parallel over ``torch.distributed``, one process per device
(counterpart of ``ess_tpu/parallel``: ``make_mesh`` is
:func:`make_group`, ``batch_sharding`` :func:`row_range`, ``shard_batch``
:func:`shard_batch`; ``replicate`` has none, every rank building the same
state from the seed, the same weights or the same checkpoint)."""

from ess_tpu_torch.parallel.dp import (
    Group, make_group, release, row_range, shard_batch)

__all__ = ["Group", "make_group", "release", "row_range", "shard_batch"]
