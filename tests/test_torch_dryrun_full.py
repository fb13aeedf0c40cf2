"""The port's dry run (``repro_torch/launch/dryrun.py``) at full width and
depth on the CPU: one trace on fake tensors, which allocates nothing (a
file of its own: the trace takes about half a minute)."""
import resource

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import param_template
from repro_torch.models.layers import is_info


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread for these small steps (and the subprocesses
    they start): on a shared CPU the pool's threads cost far more than
    they bring at this size. Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


def _n_params(cfg) -> int:
    def count(t):
        if is_info(t):
            n = 1
            for d in t.shape:
                n *= d
            return n
        return sum(count(v) for v in t.values())
    return count(param_template(cfg))


def test_full_width_trace_allocates_nothing():
    """transformer-wmt train_4k on the reference's single mesh, at full
    width and depth: 16 nodes, one a GPU, 8 x 4096 tokens a local step,
    each block recomputed in the backward pass (remat, on at full size).
    The state is exact from 184,600,576 params a node (bf16 params, fp32
    momentum); the peak, which now fits one H100, is still far beyond
    what this process ever holds."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = D.run_one("transformer-wmt", "train_4k", "single", device="cpu")
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) \
        * 1024
    assert rec["n_nodes"] == rec["n_devices"] == 16
    assert rec["batch_per_node"] == 256 // (16 * 2)
    assert _n_params(get_config("transformer-wmt")) == 184_600_576
    assert rec["argument_bytes"] == 184_600_576 * (2 + 4)
    assert rec["remat"] and rec["fits"]
    assert rec["peak_bytes"] > 16 * 2**30
    assert grown < 4 * 2**30
    # the exact gossip sends the fp32 flat buffer: no padding at this width
    assert rec["coll_raw"]["send"] == rec["wire_bytes_per_node"] \
        == 4 * 184_600_576
    assert rec["device_allocated_bytes"] is None
