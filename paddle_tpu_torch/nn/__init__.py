"""``paddle_tpu_torch.nn`` — the names ``paddle_tpu.nn`` exports, with
``functional``. The reference's dygraph containers are torch's:
``Layer`` is ``torch.nn.Module``, ``LayerList`` ``torch.nn.ModuleList``,
``ParameterList`` ``torch.nn.ParameterList`` and ``Sequential``
``torch.nn.Sequential``, which every port layer already builds on."""

from torch.nn import Module as Layer
from torch.nn import ModuleList as LayerList
from torch.nn import ParameterList, Sequential

from . import functional
from .layers_common import (
    AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
    BatchNorm3D, BCEWithLogitsLoss, Conv2D, Conv2DTranspose,
    CrossEntropyLoss, Dropout, ELU, Embedding, Flatten, GELU, GroupNorm,
    Hardsigmoid, Hardswish, KLDivLoss, L1Loss, LayerNorm, LeakyReLU, Linear,
    LogSoftmax, MaxPool2D, MSELoss, NLLLoss, Pad2D, ReLU, ReLU6, Sigmoid,
    SiLU, SmoothL1Loss, Softmax, Softplus, Swish, SyncBatchNorm, Tanh,
    Upsample)
from .rnn import GRU, GRUCell, LSTM, LSTMCell, SimpleRNN
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = [
    "Layer", "LayerList", "ParameterList", "Sequential", "functional",
    "AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
    "BatchNorm2D", "BatchNorm3D", "BCEWithLogitsLoss", "Conv2D",
    "Conv2DTranspose", "CrossEntropyLoss", "Dropout", "ELU", "Embedding",
    "Flatten", "GELU", "GroupNorm", "Hardsigmoid", "Hardswish", "KLDivLoss",
    "L1Loss", "LayerNorm", "LeakyReLU", "Linear", "LogSoftmax", "MaxPool2D",
    "MSELoss", "NLLLoss", "Pad2D", "ReLU", "ReLU6", "Sigmoid", "SiLU",
    "SmoothL1Loss", "Softmax", "Softplus", "Swish", "SyncBatchNorm", "Tanh",
    "Upsample", "GRU", "GRUCell", "LSTM", "LSTMCell", "SimpleRNN",
    "MultiHeadAttention", "Transformer", "TransformerDecoder",
    "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer",
]
