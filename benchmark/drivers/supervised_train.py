"""The supervised train step (``train/supervised.py::make_train_step``).

The check splits the step in two stages. The frozen int8 rollout turns a
last-bit difference of its input into ~9 % of its latent, and the head's
gradient follows the latent, so a float32 reference that rolls out on its
own cannot follow the head's gradient closely enough to tell a sound step
from a faulty one. So the head's input latents of the checked steps are
kept: the rollout is judged by them against the reference's own rollout
(``latent_gap``), and the reference's head, loss and optimizer follow them
(``loss_gap``, ``grad_gap``, ``delta_gap``).
"""

from benchmark import work
from benchmark.drivers.train import CHECKED_STEPS, TrainDriver
from benchmark.reference import steps as ref_steps
from benchmark.reference.precision import F32, Precision


class Driver(TrainDriver):
    uda = False

    @classmethod
    def work(cls, conf, traffic):
        """The rollout of B x T windows, then the head's forward and its
        kernels' gradients on B samples."""
        out = cls.rollout_work(conf)
        out["convs"] += work.convs_work(work.head_convs(conf, train=True),
                                        conf["batch"])
        return out

    def prepare(self, seed: int) -> None:
        """As the train driver's, keeping on the host the latents that the
        head takes in the checked steps."""
        self.latents = []

        def keep(module, args):
            self.latents.append({s: args[0][s].detach().to("cpu", copy=True)
                                 for s in ref_steps.HEAD_SCALES})

        hook = self.mods.head.register_forward_pre_hook(keep)
        try:
            super().prepare(seed)
        finally:
            hook.remove()

    def reference(self, prec: Precision = F32) -> dict:
        return ref_steps.train_steps(
            self.conf, self.params, self.host[:CHECKED_STEPS], prec=prec,
            device=self.device, latents=self.latents)

    def program_outputs(self) -> dict:
        return {**super().program_outputs(), "latents": self.latents}
