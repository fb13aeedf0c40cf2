"""Serving subsystem (``repro/serve``): continuous-batching inference over
live swarm checkpoints.

* ``source``  — model sources: a checkpoint follower that polls a run
  directory and materializes the mean model (codec checkpoints decode
  through quant/codecs.py), plus an in-process live snapshot source;
* ``swap``    — double-buffered, generation-tagged hot swap of params;
* ``engine``  — slot-based continuous-batching scheduler over the
  prefill/decode/chunk modes with admission control and backpressure;
* ``paged``   — the paged KV cache (page pools, tables, allocator);
* ``metrics`` — tokens/s, per-token latency percentiles, queue depth,
  time-to-fresh-model.
"""
from repro_torch.serve.engine import (  # noqa: F401
    EngineConfig, Request, ServeEngine,
)
from repro_torch.serve.metrics import ServeMetrics  # noqa: F401
from repro_torch.serve.source import (  # noqa: F401
    CheckpointFollower, LiveSource, ModelUpdate, export_serving_checkpoint,
    load_serving_checkpoint,
)
from repro_torch.serve.swap import HotSwap  # noqa: F401
