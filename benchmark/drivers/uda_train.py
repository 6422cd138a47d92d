"""The ESS UDA train step (``train/uda.py::make_train_step``)."""

from benchmark import work
from benchmark.drivers.train import TrainDriver


class Driver(TrainDriver):
    uda = True

    @classmethod
    def work(cls, conf, traffic):
        """The rollout of B x T windows and the decode of B latents; the
        image front's forward on the images, then forward and backward; the
        head trained on the images' and the events' latents, and its
        forward with the gradient into the event latent."""
        out = cls.rollout_work(conf)
        b = conf["batch"]
        convs = (work.decode_convs(conf)
                 + work.front_convs(conf, train=False)
                 + work.front_convs(conf, train=True)
                 + work.head_convs(conf, train=True)
                 + work.head_convs(conf, train=False, input_grad=True)
                 + work.head_convs(conf, train=True))
        out["convs"] += work.convs_work(convs, b)
        return out
