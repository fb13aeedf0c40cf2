"""The baselines the paper compares against (§5, Table 2) — LB-SGD
all-reduce, Local SGD, D-PSGD, AD-PSGD and SGP — as superstep factories
over the same node-stacked state as SwarmSGD (counterpart of
``repro/algorithms``)."""
from repro_torch.algorithms.registry import (  # noqa: F401
    ALGORITHMS, CAPABILITIES, AlgoCaps, make_algorithm, validate_run_config,
)
