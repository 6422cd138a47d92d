from ess_tpu_torch.models.layers import (
    ConvGRUCell,
    ConvLayer,
    ConvLSTMCell,
    INSResBlock,
    RecurrentConvLayer,
    ReLUINSConv2d,
    ResidualBlock,
    TransposedConvLayer,
    UpsampleConvLayer,
)
from ess_tpu_torch.models.e2vid import (RecurrentUNet, UNet, UNetDecoder,
                                        UNetTaskDecoder, zero_recurrent_state)
from ess_tpu_torch.models.resnet import ResNet18Encoder
from ess_tpu_torch.models.seghead import SegmentationHead

__all__ = [
    "ConvLayer",
    "ConvGRUCell",
    "ConvLSTMCell",
    "INSResBlock",
    "RecurrentConvLayer",
    "ReLUINSConv2d",
    "ResidualBlock",
    "TransposedConvLayer",
    "UpsampleConvLayer",
    "RecurrentUNet",
    "UNet",
    "UNetDecoder",
    "UNetTaskDecoder",
    "zero_recurrent_state",
    "ResNet18Encoder",
    "SegmentationHead",
]
