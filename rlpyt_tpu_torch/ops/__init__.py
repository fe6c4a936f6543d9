from rlpyt_tpu_torch.ops.returns import (
    discount_return,
    generalized_advantage_estimation,
    discount_return_n_step,
    valid_from_done,
)
from rlpyt_tpu_torch.ops.value import (
    huber_loss,
    categorical_projection,
    value_rescale,
    value_rescale_inv,
    polyak_update,
)
