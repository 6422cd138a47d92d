from ess_tpu_torch.recon.reconstructor import (Reconstructor,
                                               preprocess_event_tensor)

__all__ = ["Reconstructor", "preprocess_event_tensor"]
