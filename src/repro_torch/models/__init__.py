from repro_torch.models.transformer import (  # noqa: F401
    TransformerLM, forward, init_params, loss_fn, param_template,
)
