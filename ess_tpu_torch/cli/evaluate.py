"""Evaluation CLI: restore a checkpoint and run validation only.

Counterpart of ``ess_tpu/cli/evaluate.py``:
``python -m ess_tpu_torch.cli.evaluate --settings_file cfg.yaml
--checkpoint dir`` on the first CUDA device.
"""

from __future__ import annotations


def main(argv=None, *, device=None) -> None:
    """Validate the checkpoint ``--checkpoint`` (its ``--epoch`` key, else
    the latest); ``device`` as in :func:`ess_tpu_torch.cli.train.main`."""
    from ess_tpu_torch.cli.train import (
        build_loaders, load_pretrained_backbone, parse_args, print_summary)

    args = parse_args(argv, "ess-tpu evaluation (PyTorch)", **{
        "--checkpoint": dict(required=True,
                             help="checkpoint directory (a run's "
                                  "checkpoints/)"),
        "--epoch": dict(type=int, default=None)})

    from ess_tpu_torch.core.config import load_config
    from ess_tpu_torch.io.checkpoint import CheckpointManager
    from ess_tpu_torch.train.loop import Trainer

    cfg = load_config(args.settings_file)
    _, train_b, val_a, val_b, rectify_map = build_loaders(cfg)
    # restore_pretrained keeps the template's E2VID, so load the backbone
    # exactly as the train CLI does, or the rollout runs on random weights
    trainer = Trainer(cfg, train_b=train_b, val_b=val_b, val_a=val_a,
                      rectify_map=rectify_map,
                      e2vid_state=load_pretrained_backbone(cfg),
                      device=device)
    CheckpointManager(args.checkpoint).restore_pretrained(trainer.state,
                                                          args.epoch)
    print_summary(trainer.validate())


if __name__ == "__main__":
    main()
