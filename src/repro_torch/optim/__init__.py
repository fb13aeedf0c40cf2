from repro_torch.optim.sgd import SGDConfig, sgd_init, sgd_update  # noqa: F401
from repro_torch.optim.api import Optimizer, make_optimizer  # noqa: F401
