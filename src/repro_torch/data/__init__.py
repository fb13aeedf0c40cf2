from repro_torch.data.synthetic import (  # noqa: F401
    DataConfig, SyntheticLMDataset, make_node_batches,
)
