from repro_torch.core.bucket import (  # noqa: F401
    gossip_flat_matrix, gossip_flat_mean,
)
from repro_torch.core.exchange import (  # noqa: F401
    EngineStep, GossipTransport, StepInputs, make_local_steps,
    masked_mean_loss, transport_from_config,
)
from repro_torch.core.graph import (  # noqa: F401
    Graph, complete, hierarchical, hypercube, irregular_graph, make_graph,
    random_regular, ring, sample_matching, sample_weighted_matching, torus2d,
)
from repro_torch.core.hier import HierTopology, parse_topology  # noqa: F401
from repro_torch.core.potential import gamma_potential  # noqa: F401
from repro_torch.core.scan import (  # noqa: F401
    SuperstepChunk, make_superstep_scan,
)
from repro_torch.core.swarm import (  # noqa: F401
    SwarmConfig, SwarmState, codec_checkpoint_tree, make_join_step,
    make_mean_model_eval, make_swarm_step, pipeline_epilogue,
    pipeline_prologue, restore_codec_state, retire_nodes, sample_h_counts,
    swarm_init,
)
