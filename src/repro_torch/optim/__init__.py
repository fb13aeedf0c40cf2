from repro_torch.optim.sgd import SGDConfig, sgd_init, sgd_update  # noqa: F401
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_lr, cosine_lr, step_decay_lr, warmup_cosine_lr,
)
from repro_torch.optim.api import Optimizer, make_optimizer  # noqa: F401
