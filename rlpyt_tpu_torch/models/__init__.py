from rlpyt_tpu_torch.models.mlp import MlpModel
from rlpyt_tpu_torch.models.conv import Conv2dModel, Conv2dHeadModel
from rlpyt_tpu_torch.models.resnet import ImpalaResNet
from rlpyt_tpu_torch.models.dqn import (
    DqnMlpModel,
    AtariDqnModel,
    AtariCatDqnModel,
    AtariR2d1Model,
    DuelingHead,
    DistributionalDuelingHead,
)
from rlpyt_tpu_torch.models.pg import (
    AtariFfModel,
    AtariLstmModel,
    MujocoFfModel,
    MujocoLstmModel,
)
from rlpyt_tpu_torch.models.qpg import MuMlpModel, QofMuMlpModel, PiMlpModel
from rlpyt_tpu_torch.models.running_norm import RunningMeanStd
