from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    load_checkpoint, load_metadata, mean_model_tree, save_checkpoint,
)
