from repro_torch.core.exchange import (  # noqa: F401
    GossipTransport, make_local_steps, masked_mean_loss,
)
from repro_torch.core.graph import complete, sample_matching  # noqa: F401
from repro_torch.core.potential import gamma_potential  # noqa: F401
from repro_torch.core.swarm import (  # noqa: F401
    SwarmConfig, SwarmState, codec_checkpoint_tree, make_mean_model_eval,
    make_swarm_step, pipeline_epilogue, pipeline_prologue,
    restore_codec_state, sample_h_counts, swarm_init,
)
