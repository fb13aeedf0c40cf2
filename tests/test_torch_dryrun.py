"""The port's dry run (``repro_torch/launch/dryrun.py``, ``launch/sweep.py``,
``roofline/{analysis,table}.py``) on the CPU, held to the JAX package's
``repro.roofline`` and to real CPU runs of the same steps.

Bounds, measured on this file's configs (reduced to 2 layers of d_model
64) before they were set:
* counted FLOPs (``FlopCounterMode``, matrix products only) over the
  analytic count: 0.9961 for transformer-wmt training and decode, 0.8868
  for its prefill (the port's prefill takes the logits of the last
  position only); mamba2-780m 0.8562-0.9047 (the SSD's elementwise terms
  are not matrix products); granite-moe-3b-a800m 1.9922-1.9932 (the
  reduced MoE computes every slot of its capacity factor 4.0: 4 experts
  top-2, so twice the active expert FLOPs). The port's analytic count is
  the reference's, term for term: the ratios to both are equal.
* the fake trace's peak of live bytes equals a real CPU run's, byte for
  byte, under the same counter.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as RC
from repro.configs.base import InputShape as RInputShape
from repro.configs.base import reduced as r_reduced
from repro.roofline import analysis as r_analysis
from repro.roofline import analytic as r_analytic

from repro_torch import hardware as HW
from repro_torch.configs import INPUT_SHAPES, get_config, reduced
from repro_torch.core.scan import _state_leaves
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import sweep, train
from repro_torch.launch.serve import make_generators, make_serve_fns
from repro_torch.models import init_cache, init_params, param_template
from repro_torch.models.layers import is_info
from repro_torch.roofline import analysis, table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("transformer-wmt", "mamba2-780m", "granite-moe-3b-a800m")
# counted / analytic FLOPs per (family, step kind), bounds as measured
FLOP_BOUNDS = {
    ("transformer-wmt", "train"): (0.99, 1.0),
    ("transformer-wmt", "prefill"): (0.88, 0.89),
    ("transformer-wmt", "decode"): (0.99, 1.0),
    ("mamba2-780m", "train"): (0.90, 0.91),
    ("mamba2-780m", "prefill"): (0.88, 0.89),
    ("mamba2-780m", "decode"): (0.85, 0.86),
    ("granite-moe-3b-a800m", "train"): (1.99, 2.0),
    ("granite-moe-3b-a800m", "prefill"): (1.99, 2.0),
    ("granite-moe-3b-a800m", "decode"): (1.99, 2.0),
}
SEQ = 128
PEAK_SEQ = 64          # the peak tests run the step for real too
# (layout, shape, per-node or per-GPU batch); one_card stacks 4 nodes
CASES = (("one_card", "train_4k", 2), ("node_a_gpu", "train_4k", 2),
         ("node_a_gpu", "prefill_32k", 2), ("node_a_gpu", "decode_32k", 4))


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


def _cfg(arch):
    return reduced(get_config(arch), n_layers=2, d_model=64)


_RECORDS = {}


def _run(arch, layout, shape, batch, seq=SEQ, **kw):
    """The dry run of a reduced config, once per arguments in this file."""
    key = (arch, layout, shape, batch, seq, tuple(sorted(kw.items())))
    if key not in _RECORDS:
        _RECORDS[key] = D.run_one(
            arch, shape, "single", device="cpu", cfg=_cfg(arch), batch=batch,
            seq=seq, nodes_per_gpu=4 if layout == "one_card" else None, **kw)
    return _RECORDS[key]


def _n_params(cfg) -> int:
    def count(t):
        if is_info(t):
            return int(np.prod(t.shape))
        return sum(count(v) for v in t.values())
    return count(param_template(cfg))


# -- the kernels' fake path ------------------------------------------------

def _kernel_calls(dev):
    """Each kernel wrapper at a few variants on `dev` tensors (made inside
    the caller's mode) -> list of output tuples."""
    g = torch.Generator().manual_seed(0)
    outs = []
    for bits, size, average, masked in ((8, 256 * 37 + 5, True, True),
                                        (4, 256 * 64, False, False),
                                        (16, 256 * 40, True, False)):
        x = torch.randn(size, generator=g).to(dev)
        r = x + 0.01 * torch.randn(size, generator=g).to(dev)
        u = torch.rand(size, generator=g).to(dev)
        q, s, pad = ops.quantize_mod(x, r, u, bits=bits, pack4=bits <= 4)
        mk = (torch.arange(q.shape[0]) % 3 != 0).to(dev) if masked else None
        d = ops.decode_avg(q, s, r, bits=bits, pack4=bits <= 4,
                           average=average, matched=mk)
        outs.append((q, s, d))
    for inplace in (False, True):
        p, gr, m = (torch.randn(8 * 512 * 3, generator=g).to(dev)
                    for _ in range(3))
        lr = torch.tensor(0.05).to(dev)
        outs.append(ops.sgd_fused_update(p, gr, m, lr=lr, mu=0.9, wd=1e-4,
                                         inplace=inplace))
    return outs


def test_kernel_fake_path_shapes_and_no_launch():
    """Fake tensors give the real CPU path's shapes and dtypes, add no
    launch, and the counter sees the same bytes: one op, its outputs."""
    counter_real, counter_fake = analysis.TraceCounter(), analysis.TraceCounter()
    before = dict(LAUNCHES)
    with counter_real:
        real = _kernel_calls("cpu")
    with FakeTensorMode(allow_fallback_kernels=False):
        with counter_fake:
            fake = _kernel_calls("cpu")
    assert LAUNCHES == before
    for a, b in zip(real, fake):
        for x, y in zip(a, b):
            assert (x.shape, x.dtype, x.device) == (y.shape, y.dtype,
                                                    y.device)
            assert type(y).__name__ == "FakeTensor"
    assert counter_fake.peak == counter_real.peak > 0


def test_kernels_are_one_dispatched_op():
    """Under the counter a kernel is one ``repro_torch::`` op: the plain
    version's temporaries stay inside it."""
    seen = []

    class Names(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    x = torch.randn(256 * 8)
    with Names():
        q, s, _ = ops.quantize_mod(x, x * 0.5, torch.rand(256 * 8))
        ops.decode_avg(q, s, x)
        ops.sgd_fused_update(x, x, x, lr=0.1)
    assert [n for n in seen if n.startswith("repro_torch.")] == [
        "repro_torch.quantize_mod.default", "repro_torch.decode_avg.default",
        "repro_torch.sgd_update.default"]
    assert not any("remainder" in n or "floor" in n for n in seen)


# -- counted against the analytic models and a real CPU run ----------------

@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("layout,shape,batch", CASES)
def test_counted_flops_against_analytic(arch, layout, shape, batch):
    rec = _run(arch, layout, shape, batch, quantize=True)
    kind = INPUT_SHAPES[shape].kind
    lo, hi = FLOP_BOUNDS[arch, kind]
    ratio = rec["flops_per_dev"] / rec["flops_analytic_per_dev"]
    assert lo <= ratio <= hi, ratio
    rcfg = r_reduced(RC.get_config(arch), n_layers=2, d_model=64)
    if kind == "train":
        g = RInputShape(shape, SEQ, batch * rec["n_nodes"] * 2, "train")
        ref = r_analytic.train_flops(rcfg, g, H=2, remat=False) \
            / rec["n_devices"]
        ref_mf = r_analysis.model_flops(rcfg, g, "train") / rec["n_devices"]
    else:
        g = RInputShape(shape, SEQ, batch, kind)
        ref = r_analytic.serve_flops(rcfg, g)
        ref_mf = r_analysis.model_flops(rcfg, g, kind)
    assert rec["flops_analytic_per_dev"] == ref
    assert lo <= rec["flops_per_dev"] / ref <= hi
    assert rec["model_flops_per_dev"] == ref_mf
    assert rec["useful_ratio"] == ref_mf / rec["flops_per_dev"]
    assert rec["temp_bytes"] == rec["peak_bytes"] - rec["argument_bytes"]


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_model_flops_equal_reference(arch, kind):
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    cfg, rcfg = get_config(arch), RC.get_config(arch)
    s, rs = INPUT_SHAPES[shape], RC.INPUT_SHAPES[shape]
    assert analysis.model_flops(cfg, s, kind) == \
        r_analysis.model_flops(rcfg, rs, kind)


def _real_train(cfg, argv, mesh=None):
    """The dry run's superstep on real CPU tensors, same counter."""
    tr = train.build(train.build_parser().parse_args(argv), cfg, mesh=mesh)
    counter = analysis.TraceCounter()
    args = counter.hold(_state_leaves(tr.state))
    with counter:
        tr.superstep(0)
    return args, counter.peak, dict(counter.coll)


@pytest.mark.parametrize("arch,layout,mode", [
    ("transformer-wmt", "one_card", "blocking"),
    ("transformer-wmt", "one_card", "overlap"),
    ("transformer-wmt", "node_a_gpu", "blocking"),
    ("transformer-wmt", "node_a_gpu", "overlap"),
    ("mamba2-780m", "one_card", "blocking"),
    ("mamba2-780m", "node_a_gpu", "overlap"),
    ("granite-moe-3b-a800m", "node_a_gpu", "blocking"),
    ("granite-moe-3b-a800m", "one_card", "overlap")])
def test_train_peak_equals_real_cpu_run(arch, layout, mode):
    """The fake trace's peak of live bytes equals the real run's, byte for
    byte; its arguments are the state's exact bytes from the template."""
    overlap = mode == "overlap"
    rec = _run(arch, layout, "train_4k", 1, seq=PEAK_SEQ, quantize=True,
               overlap=overlap)
    cfg = _cfg(arch)
    n = rec["n_nodes"]
    argv = D.train_argv(arch, n, 2, 1, PEAK_SEQ, "cpu", "gather", True,
                        overlap, overlap, "fixed", 8)
    if layout == "one_card":
        got = _real_train(cfg, argv)
    else:
        with D.fake_world(n, "cpu") as mesh:
            got = _real_train(cfg, argv, mesh)
    assert (rec["argument_bytes"], rec["peak_bytes"]) == got[:2]
    assert rec["coll_raw"] == got[2]
    if not overlap:
        # params, momentum and the q8 comm copy (a clone of the params)
        p, o = (torch.tensor([], dtype=getattr(torch, t)).element_size()
                for t in (cfg.dtype, cfg.opt_state_dtype))
        per_node = _n_params(cfg) * (2 * p + o)
        assert rec["argument_bytes"] == per_node * (n if layout ==
                                                    "one_card" else 1)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape,batch", (("prefill_32k", 2),
                                         ("decode_32k", 4)))
def test_serve_peak_equals_real_cpu_run(arch, shape, batch):
    rec = _run(arch, "node_a_gpu", shape, batch)
    cfg = _cfg(arch)
    prefill, decode_step = make_serve_fns(cfg)
    params = init_params(make_generators(0, "cpu")["init"], cfg, "cpu")
    counter = analysis.TraceCounter()
    if rec["kind"] == "prefill":
        toks = torch.zeros((batch, SEQ), dtype=torch.int32)
        args = counter.hold([params, toks])
        with counter:
            prefill(params, toks)
    else:
        cache = init_cache(cfg, batch, SEQ, device="cpu")
        toks = torch.zeros((batch, 1), dtype=torch.int32)
        args = counter.hold([params, cache, toks])
        with counter:
            decode_step(params, cache, toks)
    assert (rec["argument_bytes"], rec["peak_bytes"]) == (args, counter.peak)
    assert rec["argument_bytes"] >= _n_params(cfg) * 4


def test_mesh_wire_and_collectives():
    """On a node mesh rank 0 sends one payload a superstep (the
    transport's declared bytes) and all-reduces Γ's fp32 buffer; one card
    posts no collective."""
    rec = _run("transformer-wmt", "node_a_gpu", "train_4k", 2, quantize=True)
    assert rec["coll_raw"]["send"] == rec["wire_bytes_per_node"] \
        == rec["coll_raw"]["recv"]
    assert rec["coll_bytes_per_dev"] == sum(
        v for k, v in rec["coll_raw"].items() if k != "recv")
    # 16 GPUs span two hosts of 8: the slowest link is InfiniBand
    assert rec["collective_s"] == rec["coll_bytes_per_dev"] / HW.IB_NDR_BW
    one = _run("transformer-wmt", "one_card", "train_4k", 2, quantize=True)
    assert one["coll_raw"] == {} and one["collective_s"] == 0.0
    assert one["wire_bytes_per_node"] == rec["wire_bytes_per_node"]


# -- the reference's records and tools ------------------------------------

def test_long_500k_skip_equals_reference():
    code = ("import json; from repro.launch.dryrun import run_one; "
            "print(json.dumps(run_one('olmo-1b', 'long_500k', 'single')))")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=120)
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert D.run_one("olmo-1b", "long_500k", "single", device="cpu") == ref


def test_node_counts_and_batch_split():
    """The reference's node counts (specs.py n_nodes_for) and splits."""
    assert D.n_nodes_for(get_config("olmo-1b"), "single") == 16
    assert D.n_nodes_for(get_config("olmo-1b"), "multi") == 32
    big = get_config("jamba-1.5-large-398b")
    assert (D.n_nodes_for(big, "single"), D.n_nodes_for(big, "multi")) \
        == (1, 2)
    assert D.node_batch(INPUT_SHAPES["train_4k"], 32, 2) == 4
    assert D.serve_batch(INPUT_SHAPES["decode_32k"], 16) == 8
    assert D.serve_batch(INPUT_SHAPES["long_500k"], 16) == 1
    with pytest.raises(ValueError):
        D.node_batch(INPUT_SHAPES["train_4k"], 256, 2)


def test_cli_writes_one_record(tmp_path):
    D.main(["--device", "cpu", "--arch", "olmo-1b", "--shape", "long_500k",
            "--out", str(tmp_path)])
    (path,) = tmp_path.iterdir()
    assert path.name == "olmo-1b__long_500k__single.json"
    assert json.loads(path.read_text())["skipped"] == D.SKIP_LONG


def test_sweep_writes_a_record_a_pair(tmp_path):
    """Each pair its own process: a skip, and an error record naming its
    cause for an arch that does not exist."""
    sweep.main(["--device", "cpu", "--out", str(tmp_path), "--archs",
                "olmo-1b,no-such-arch", "--shapes", "long_500k", "--mesh",
                "single", "--jobs", "2", "--timeout", "300"])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert recs["olmo-1b__long_500k__single.json"]["skipped"] == D.SKIP_LONG
    err = recs["no-such-arch__long_500k__single.json"]["error"]
    assert "unknown arch 'no-such-arch'" in table.cause(err)


def test_table_formats_records(tmp_path):
    recs = [_run("transformer-wmt", "node_a_gpu", "decode_32k", 4),
            _run("transformer-wmt", "one_card", "train_4k", 2),
            D.run_one("olmo-1b", "long_500k", "single", device="cpu"),
            {"arch": "x", "shape": "train_4k", "mesh": "multi",
             "error": "Traceback ...\nValueError: boom"}]
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    tab, sk, fl, ok = table.build_tables(table.load(str(tmp_path)))
    lines = tab.splitlines()
    assert lines[0].endswith("| trace s | fits 1 GPU (peak GiB) |")
    assert len(lines) == 2 + 2 and len(ok) == 2
    for r in ok:
        assert f"| {r['t_trace_s']} | yes ({table.fmt_bytes(r['peak_bytes'])}) |" \
            in tab
    assert "pure full-attention" in sk
    assert fl == "* x × train_4k × multi: `ValueError: boom`"
    assert "197e12" not in open(table.__file__).read()
