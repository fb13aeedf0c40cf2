from repro_torch.models.transformer import (  # noqa: F401
    TransformerLM, forward, init_cache, init_params, logits_head, loss_fn,
    node_losses, param_split, param_template, shard_template,
)
