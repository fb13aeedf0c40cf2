"""Discrete-event asynchronous gossip scheduler (numpy counterpart of
``repro/sched``).

Generates the paper's stochastic process — per-node Poisson clocks over a
(possibly heterogeneous, possibly failing, possibly churning) swarm — as
virtual-time event traces, prices them with a wall-clock cost model on the
H100's datasheet figures, and compiles them into masked supersteps the
engine executes. Everything here is host-side numpy, draw for draw the
reference's, except `cost_params_from_model`, which reads parameter shapes
through meta tensors.
"""
from repro_torch.sched.avail import (  # noqa: F401
    EVENT_JOIN, EVENT_LEAVE, EVENT_MIX, AvailabilityModel, parse_avail,
)
from repro_torch.sched.bridge import (  # noqa: F401
    BinnedSchedule, bin_trace, engine_inputs, pool_edges,
    stacked_engine_inputs,
)
from repro_torch.sched.clocks import (  # noqa: F401
    PoissonClocks, RateProfile, StragglerConfig, participation_rates,
)
from repro_torch.sched.cost import (  # noqa: F401
    CostParams, analytic_walltime, bsp_payload_factor, cost_params_from_model,
    predict_all_modes, predict_bsp_walltime, predict_walltime,
)
from repro_torch.sched.trace import (  # noqa: F401
    Trace, generate_trace, synchronous_trace, trace_stats,
)
