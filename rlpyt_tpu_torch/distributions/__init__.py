from rlpyt_tpu_torch.distributions.categorical import Categorical, DistInfo
from rlpyt_tpu_torch.distributions.gaussian import Gaussian, DistInfoStd
from rlpyt_tpu_torch.distributions.epsilon_greedy import (
    EpsilonGreedy,
    CategoricalEpsilonGreedy,
)
