from ess_tpu_torch.utils import viz

__all__ = ["viz"]
