"""The port's model-axis rules (``repro_torch/models/split.py``, the mesh's
in ``repro_torch/launch/specs.py``) against the reference's
(``repro/launch/specs.py``), host only: no device, no process group.

For every dense and MoE arch and K in {2, 4, 16} the port's split map
(``param_split``: one dimension a leaf, or None for a leaf every GPU of a
node holds whole) equals the reference's ``param_pspec`` on
``tests/test_specs_host.py``'s ``FakeMesh({"data": 16, "model": K})``
leaf by leaf, with two named deviations:

* ``kv_head_whole``: where n_kv_heads < K the reference cuts ``wk`` /
  ``wv`` inside a head; the port keeps them whole (each GPU computes the
  kv heads its own q heads read);
* ``heads_do_not_divide``: where K does not divide n_heads the reference
  cuts inside a head; the port refuses K.

The MoE archs' expert leaves take the reference's rules with no
deviation: granite-moe-3b-a800m's per-expert d_ff (``expert_ffn``) and
qwen3-moe-30b-a3b's experts (``expert``) on the model axis, the router
whole.

The rest: the node arithmetic, the shapes of a GPU's slices, the weight
carry-over (slices of the JAX package's weights and back, bitwise), a
GPU's draw bitwise the slice of the whole model's, and every refusal
naming its ROADMAP.md Queue A item.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.launch import specs as RS
from repro.models import init_params as jinit_params
from repro_torch.algorithms import validate_run_config
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import NodeMesh
from repro_torch.models import (init_params, param_split, param_template,
                                shard_template)
from repro_torch.models import split as MS
from repro_torch.models.convert import (params_from_numpy, shard_params,
                                        unshard_params)
from repro_torch.tree import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parents[1]
DENSE = [a for a in list_archs() if get_config(a).moe is None
         and get_config(a).ssm is None and not get_config(a).big_model]
MOE = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
KS = (2, 4, 16)


class FakeMesh:
    """``tests/test_specs_host.py``'s stand-in: axis names and sizes."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)
        self.size = int(np.prod(list(shape_map.values())))


def _ref_split(cfg, K):
    """The reference's param_pspec read as one model dimension a leaf."""
    spec = RS.param_pspec(jget_config(cfg.name), FakeMesh(
        {"data": 16, "model": K}), node_stacked=False)
    out = []
    for sp in jax.tree.leaves(spec, is_leaf=lambda s: isinstance(s, P)):
        dims = [i for i, part in enumerate(sp) if part == "model"]
        assert len(dims) <= 1, sp
        out.append(dims[0] if dims else None)
    return out


def test_the_dense_archs():
    assert DENSE == ["chatglm3-6b", "gemma3-27b", "gemma3-4b",
                     "musicgen-large", "olmo-1b", "paligemma-3b",
                     "transformer-wmt"]


def test_the_moe_archs():
    assert MOE == [a for a in list_archs() if get_config(a).moe is not None
                   and not get_config(a).big_model]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_split_map_equals_the_reference(arch, K):
    cfg = get_config(arch)
    ref = _ref_split(cfg, K)
    paths = tree_paths(param_template(cfg))
    if cfg.n_heads % K:
        # deviation heads_do_not_divide: gemma3-4b and paligemma-3b (8
        # heads) and granite-moe-3b-a800m (24) at 16
        assert (arch, K) in {("gemma3-4b", 16), ("paligemma-3b", 16),
                             ("granite-moe-3b-a800m", 16)}
        with pytest.raises(ValueError, match="n_heads"):
            param_split(cfg, K)
        return
    got = tree_leaves(param_split(cfg, K))
    assert len(got) == len(ref) == len(paths)
    deviated = []
    for path, g, r in zip(paths, got, ref):
        if g != r:
            deviated.append(path)
            # deviation kv_head_whole: a kv weight the reference cuts
            # inside a head
            assert MS.kv_deviation(cfg, K), (path, g, r)
            assert path.split(".")[-1] in ("wk", "wv"), path
            assert g is None and r is not None, (path, g, r)
    if MS.kv_deviation(cfg, K):
        n_attn = sum(p.endswith(".wk") for p in paths)
        assert len(deviated) == 2 * n_attn > 0
        assert (arch, K) in {("chatglm3-6b", 4), ("chatglm3-6b", 16),
                             ("paligemma-3b", 2), ("paligemma-3b", 4),
                             ("qwen3-moe-30b-a3b", 16)}
    else:
        assert not deviated
    if cfg.moe is not None:
        # the expert leaves split as the reference's: qwen3 by expert,
        # granite by the experts' d_ff; the router whole
        moe = [(p.split(".")[-1], g) for p, g in zip(paths, got)
               if ".moe." in p]
        want = {"router": None, "w_up": 0, "w_gate": 0, "w_down": 0} \
            if MS.expert_split(cfg) else \
            {"router": None, "w_up": 2, "w_gate": 2, "w_down": 1}
        assert moe and all(want[k] == g - 1 for k, g in moe
                           if g is not None)
        assert all((g is None) == (want[k] is None) for k, g in moe)


@pytest.mark.parametrize("K", (2, 4, 8, 16))
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_a_gpus_slices_tile_the_leaf(arch, K):
    """Each split leaf's slice is its dimension over K; a whole leaf keeps
    its shape; a GPU holds more than a K-th of the node and less than all
    of it."""
    cfg = get_config(arch)
    if cfg.n_heads % K:
        with pytest.raises(ValueError):
            shard_template(cfg, K)
        return
    full = tree_leaves(param_template(cfg))
    local = tree_leaves(shard_template(cfg, K))
    split = tree_leaves(param_split(cfg, K))
    n_full = n_local = 0
    for f, loc, d in zip(full, local, split):
        want = list(f.shape)
        if d is not None:
            want[d] //= K
        assert list(loc.shape) == want and loc.axes == f.axes
        n_full += int(np.prod(f.shape))
        n_local += int(np.prod(loc.shape))
    assert n_full == cfg.n_params()
    assert n_full / K <= n_local < n_full


@pytest.mark.parametrize("arch", DENSE)
def test_node_axes_and_node_count_equal_the_reference(arch):
    cfg = get_config(arch)
    for shape in ({"data": 16, "model": 16},
                  {"pod": 2, "data": 16, "model": 16},
                  {"data": 2, "model": 2}):
        mesh = FakeMesh(shape)
        assert S.node_axes_for(cfg, shape) == \
            RS.node_axes_for(jget_config(arch), mesh)
        assert S.n_nodes_for(cfg, shape) == \
            RS.n_nodes_for(jget_config(arch), mesh)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("arch", DENSE)
def test_logical_rules_equal_the_reference_on_the_dense_axes(arch, K):
    cfg = get_config(arch)
    if cfg.n_heads % K:
        with pytest.raises(ValueError):
            MS.logical_rules(cfg, {"data": 16, "model": K})
        return
    got = MS.logical_rules(cfg, {"data": 16, "model": K})
    ref = RS.logical_rules(jget_config(arch), FakeMesh(
        {"data": 16, "model": K}), "train")
    for axis in (None, "layers", "embed", "vocab", "ffn", "heads_x_dim"):
        assert got[axis] == ref[axis], axis
    assert got["kv_x_dim"] == (None if MS.kv_deviation(cfg, K)
                               else ref["kv_x_dim"])


def _restored(cfg, arch):
    """`cfg` (a reduced config of either package) with its arch's expert
    axis back: ``reduced`` sets it None, which would hide the expert
    split."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_shard_axis=get_config(arch).moe.expert_shard_axis))


@pytest.mark.parametrize("K", (2, 4))
@pytest.mark.parametrize("arch", ["transformer-wmt", "gemma3-4b",
                                  "chatglm3-6b", "paligemma-3b"] + MOE)
def test_weight_carry_over_round_trips_bitwise(arch, K):
    """The JAX package's weights (numpy, node-stacked or not) cut into K
    GPUs' slices and put back together: bitwise; the port's one-GPU
    tensors likewise. A MoE arch with its expert axis restored: qwen3's
    slices are whole experts, granite's every expert's d_ff slice."""
    from repro.configs import reduced as jreduced
    cfg = _restored(reduced(get_config(arch), n_layers=2, d_model=32), arch)
    jc = _restored(jreduced(jget_config(arch), n_layers=2, d_model=32),
                   arch)
    np_tree = jax.device_get(jinit_params(jax.random.PRNGKey(1), jc))
    shards = [shard_params(np_tree, cfg, K, i) for i in range(K)]
    back = unshard_params(shards, cfg)
    for a, b in zip(jax.tree.leaves(np_tree), tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    stacked = jax.tree.map(lambda x: np.stack([x, x + 1]), np_tree)
    sh = [shard_params(stacked, cfg, K, i, stacked=True) for i in range(K)]
    for a, b in zip(jax.tree.leaves(stacked),
                    tree_leaves(unshard_params(sh, cfg, stacked=True))):
        assert np.array_equal(a, b)
    if cfg.moe is not None:
        up = np_tree["blocks"]["layer_0"]["moe"]["w_up"]      # [1, E, d, f]
        mine = shards[1]["blocks"]["layer_0"]["moe"]["w_up"]
        E, f = cfg.moe.n_experts, cfg.moe.d_ff
        want = up[:, E // K:2 * E // K] if MS.expert_split(cfg) else \
            up[..., f // K:2 * f // K]
        assert np.array_equal(mine, want)
    t = params_from_numpy(np_tree, "cpu")
    ts = [shard_params(t, cfg, K, i) for i in range(K)]
    assert all(x.is_contiguous() for s in ts for x in tree_leaves(s))
    for a, b in zip(tree_leaves(t), tree_leaves(unshard_params(ts, cfg))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", (2, 4))
@pytest.mark.parametrize("arch", ["gemma3-4b", "paligemma-3b"])
def test_a_gpus_draw_is_the_slice_of_the_whole_models(arch, K):
    from repro_torch.launch.mesh import ModelShard
    cfg = reduced(get_config(arch), n_layers=2, d_model=32)
    whole = init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    for i in range(K):
        mine = init_params(torch.Generator().manual_seed(5), cfg, "cpu",
                           tp=ModelShard(K, i, None))
        want = shard_params(whole, cfg, K, i)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                     tree_leaves(want)))


def _roadmap_queue_a():
    text = (ROOT / "ROADMAP.md").read_text()
    qa = text[text.index("### Queue A"):text.index("### Queue B")]
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^(\d+)\. (.*?)(?=^\d+\. |\Z)", qa, re.S | re.M)}


@pytest.mark.parametrize("what,words", [
    ("ssm", ("SSM",)), ("big_model", ("big_model",)),
    ("serve", ("Serving", "decode")), ("run", ("baselines", "--scan-chunk"))])
def test_refusals_name_their_roadmap_item(what, words):
    m = re.search(r"ROADMAP\.md Queue A (\d+)", MS.NOT_ON_THE_MODEL_AXIS[what])
    item = _roadmap_queue_a()[int(m.group(1))]
    assert "done in PR" not in item.split("\n")[0], item[:200]
    for w in words:
        assert w in item, (what, w, item[:200])


def test_the_model_axis_itself_is_marked_done():
    item = next(v for v in _roadmap_queue_a().values()
                if v.startswith("**The model axis"))
    assert "done in PR" in item.split("\n")[0], item[:200]


def test_the_moe_axes_item_is_marked_done():
    assert "done in PR" in _roadmap_queue_a()[11].split("\n")[0]


@pytest.mark.parametrize("arch,what", [
    ("mamba2-780m", "Queue A 12"), ("jamba-1.5-large-398b", "Queue A 13")])
def test_non_dense_archs_are_refused(arch, what):
    with pytest.raises(ValueError, match=what):
        param_split(get_config(arch), 2)
    MS.check_model_parallel(get_config(arch), 1)


@pytest.mark.parametrize("arch,ks", [
    ("granite-moe-3b-a800m", (2, 4, 8)),
    ("qwen3-moe-30b-a3b", (2, 4, 8, 16))])
def test_the_moe_archs_are_accepted(arch, ks):
    for K in ks:
        MS.check_model_parallel(get_config(arch), K)


@pytest.mark.parametrize("arch,K,what", [
    ("qwen3-moe-30b-a3b", 3, "n_experts=128"),
    ("granite-moe-3b-a800m", 3, "d_ff=512")])
def test_a_k_that_divides_neither_expert_axis_is_refused(arch, K, what):
    """A K that does not divide the expert axis the arch cuts (qwen3's
    128 experts, granite's per-expert d_ff of 512) is refused, naming
    it; the heads are no bar here (an arch with K-divisible heads)."""
    import dataclasses
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_heads=3 * 8, n_kv_heads=3)
    with pytest.raises(ValueError, match=what):
        MS.check_model_parallel(cfg, K)


def test_k_that_does_not_divide_is_refused():
    cfg = get_config("gemma3-4b")
    with pytest.raises(ValueError, match="n_heads"):
        MS.check_model_parallel(cfg, 16)
    with pytest.raises(ValueError, match="1 or more"):
        MS.check_model_parallel(cfg, 0)
    MS.check_model_parallel(cfg, 8)
    assert MS.kv_deviation(cfg, 8) and not MS.kv_deviation(cfg, 4)


def _tp_mesh(n_nodes=2, K=2):
    return NodeMesh(0, n_nodes, torch.device("cpu"), None, K, 0, None)


@pytest.mark.parametrize("flags", [
    dict(algo="localsgd"), dict(algo="allreduce"), dict(algo="sgp"),
    dict(gossip_impl="ppermute_pool"),
    dict(gossip_impl="ppermute_pool_legacy"),
    dict(nonblocking=True, quantize=True, codec="q4"),
    dict(nonblocking=True, overlap=True, scan_chunk=4),
    dict(quantize=True, codec="q4"), dict(quantize=True, codec="bf16"),
    dict(quantize=True, compress_state=True), dict(scan_chunk=4),
    dict(rate_profile="lognormal")])
def test_runs_the_model_axis_does_not_carry_are_refused(flags):
    kw = dict(n_nodes=2, mesh=_tp_mesh())
    algo = flags.pop("algo", "swarm")
    with pytest.raises(ValueError, match="Queue A 15"):
        validate_run_config(algo, **flags, **kw)


@pytest.mark.parametrize("flags", [
    dict(), dict(quantize=True), dict(gossip_impl="ppermute"),
    dict(gossip_impl="ppermute", quantize=True, codec="q8"),
    dict(quantize=True, codec="q8"), dict(nonblocking=True),
    dict(nonblocking=True, quantize=True),
    dict(nonblocking=True, overlap=True),
    dict(nonblocking=True, overlap=True, quantize=True,
         gossip_impl="ppermute"),
    dict(gossip_impl="gather_legacy"),
    dict(gossip_impl="ppermute_legacy", quantize=True, nonblocking=True)])
def test_runs_the_model_axis_carries_pass(flags):
    assert validate_run_config("swarm", n_nodes=2, mesh=_tp_mesh(),
                               **flags) is not None


def test_the_mesh_record():
    mesh = NodeMesh(1, 2, torch.device("cpu"), None, 4, 3, None)
    assert mesh.world_rank == 7 and mesh.peer(0) == 3
    assert mesh.model_shard.size == 4 and mesh.model_shard.index == 3
    one = NodeMesh(1, 2, torch.device("cpu"))
    assert one.world_rank == 1 and one.peer(0) == 0
    assert one.model_shard is None


def test_serving_under_the_model_axis_is_refused():
    """What serving on the model axis leaves out raises, naming its item:
    a Mamba arch's decode (the SSM rules, Queue A 12) and the
    sequence-split decode (the reference's cache layout "seqshard")."""
    from repro_torch.launch.mesh import ModelShard
    from repro_torch.models import forward, init_cache
    tp = ModelShard(2, 0, None)
    mamba = reduced(get_config("mamba2-780m"), n_layers=1, d_model=32)
    with pytest.raises(ValueError, match="Queue A 12"):
        forward(mamba, {}, torch.zeros((1, 1), dtype=torch.int64),
                mode="decode", cache={}, tp=tp)
    item = re.search(r"Queue A \d+", MS.NOT_ON_THE_MODEL_AXIS["serve"])
    cfg = reduced(get_config("olmo-1b"), n_layers=1, d_model=32)
    with pytest.raises(ValueError, match=item.group(0)):
        init_cache(cfg, 1, 8, device="cpu", tp=tp, layout="seqshard")


def test_a_model_axis_mesh_that_does_not_divide_is_refused():
    from repro_torch.launch.mesh import init_node_mesh
    with pytest.raises(ValueError, match="model_parallel"):
        init_node_mesh("cpu", rank=0, world_size=6, model_parallel=4,
                       init_method="tcp://localhost:1")


def _dry(K, **kw):
    import dataclasses
    from repro_torch.launch import dryrun as D
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b"), n_layers=2,
                                      d_model=64), remat=True)
    return D.run_one("gemma3-4b", "train_4k", nodes=2, batch=2, seq=32,
                     device="cpu", cfg=cfg, model_parallel=K, quantize=True,
                     **kw)


def test_dry_run_on_the_model_axis():
    """``dryrun --model-parallel 2``: model index 0 of node 0 on 2 nodes x
    2 GPUs, its slices' state (less than the one-GPU node's), the model
    group's all-reduces counted apart and into the collective bytes."""
    one, two = _dry(1), _dry(2)
    assert (one["mesh"], one["n_devices"]) == ("2_gpus", 2)
    assert (two["mesh"], two["n_devices"]) == ("2_gpus_tp2", 4)
    assert two["layout"] == "node_over_gpus" and two["model_parallel"] == 2
    assert two["kv_heads_whole"] is False
    assert one["model_allreduce_calls"] == 0
    assert two["model_allreduce_calls"] > 0
    assert one["argument_bytes"] / 2 <= two["argument_bytes"] < \
        one["argument_bytes"]
    assert two["peak_bytes"] < one["peak_bytes"]
    assert two["coll_raw"]["all-reduce"] >= \
        two["model_allreduce_bytes_per_dev"] > 0
    assert two["coll_bytes_per_dev"] > one["coll_bytes_per_dev"] - \
        one["coll_raw"]["send"]
    assert two["wire_bytes_per_node"] < one["wire_bytes_per_node"]
    assert two["flops_per_dev"] < one["flops_per_dev"]


def test_dry_run_refuses_what_the_model_axis_does_not_carry():
    from repro_torch.launch import dryrun as D
    with pytest.raises(ValueError, match="Queue A 12"):
        D.run_one("mamba2-780m", "decode_32k", model_parallel=2,
                  device="cpu")
    with pytest.raises(ValueError, match="nodes-per-gpu"):
        D.run_one("gemma3-4b", "train_4k", nodes_per_gpu=2,
                  model_parallel=2, device="cpu")
    args = D.build_parser().parse_args(
        ["--arch", "gemma3-4b", "--shape", "train_4k", "--model-parallel",
         "8"])
    assert D.record_tag(args) == "gemma3-4b__train_4k__single__tp8"


@pytest.mark.parametrize("arch,want", [
    ("gemma3-4b", (8, [2, 4, 8])), ("paligemma-3b", (8, [2, 4, 8])),
    ("olmo-1b", (16, [2, 4, 8, 16])), ("gemma3-27b", (16, [2, 4, 8, 16])),
    ("chatglm3-6b", (16, [2, 4, 8, 16])),
    ("musicgen-large", (16, [2, 4, 8, 16])),
    ("granite-moe-3b-a800m", (16, [2, 4, 8])),
    ("qwen3-moe-30b-a3b", (16, [2, 4, 8, 16])),
    ("mamba2-780m", None), ("jamba-1.5-large-398b", None)])
def test_the_sweep_traces_dense_archs_at_the_references_k(arch, want):
    from repro_torch.launch.sweep import model_axis_ks, record_path
    assert model_axis_ks(arch) == want
    assert record_path("d", arch, "train_4k", "single", 4).endswith(
        f"{arch}__train_4k__single__tp4.json")


def test_the_model_axis_table():
    from repro_torch.roofline.table import model_axis_table
    gib = 2 ** 30

    def rec(arch, K, peak):
        return {"arch": arch, "shape": "train_4k",
                "mesh": "single" + (f"_tp{K}" if K > 1 else ""),
                "model_parallel": K, "peak_bytes": peak * gib,
                "fits": peak <= 79.18, "kv_heads_whole": K == 8}
    rows = [rec("gemma3-4b", 1, 144.5), rec("gemma3-4b", 2, 90.0),
            rec("gemma3-4b", 4, 50.0), rec("gemma3-4b", 8, 30.0),
            rec("granite-moe-3b-a800m", 1, 86.0),
            rec("granite-moe-3b-a800m", 2, 60.0),
            rec("qwen3-moe-30b-a3b", 1, 682.4),
            rec("qwen3-moe-30b-a3b", 16, 50.0),
            rec("mamba2-780m", 1, 33.9),
            {"arch": "olmo-1b", "shape": "train_4k", "mesh": "single",
             "error": "boom"}]
    table = model_axis_table(rows)
    assert "| gemma3-4b | single | 144.50 | K 8: yes (30.00) | K 4: 50.00 " \
           "| no |" in table
    assert "| granite-moe-3b-a800m | single | 86.00 | K 16: refused " \
        "(whole heads, Queue A 16) | K 2: 60.00 | no |" in table
    assert "| qwen3-moe-30b-a3b | single | 682.40 | K 16: yes (50.00) | " \
        "K 16: 50.00 | no |" in table
    assert "| mamba2-780m | single | 33.90 | waits (Queue A 12)" in table
    assert "waits (Queue A 11)" not in table
    assert "olmo-1b" not in table


def test_the_model_groups_bytes_are_priced_at_its_own_link():
    """The model group's all-reduces stay within a node's K GPUs: NVLink
    while K fits one host, InfiniBand beyond; the node group's bytes
    cross the slowest link of the whole mesh. K = 1 prices as before."""
    from repro_torch import hardware as HW
    from repro_torch.roofline.analysis import roofline_terms
    t = roofline_terms(1e12, 1e9, 5e9, "bfloat16", 64, 4e9, 2)
    assert t["collective_s"] == 1e9 / HW.IB_NDR_BW + 4e9 / HW.NVLINK_BW
    t = roofline_terms(1e12, 1e9, 5e9, "bfloat16", 512, 4e9, 16)
    assert t["collective_s"] == 1e9 / HW.IB_NDR_BW + 4e9 / HW.IB_NDR_BW
    t = roofline_terms(1e12, 1e9, 5e9, "bfloat16", 4, 4e9, 2)
    assert t["collective_s"] == 1e9 / HW.NVLINK_BW + 4e9 / HW.NVLINK_BW
    assert roofline_terms(1e12, 1e9, 5e9, "bfloat16", 64)["collective_s"] \
        == 5e9 / HW.IB_NDR_BW
    assert roofline_terms(1e12, 1e9, 0, "bfloat16", 1)["collective_s"] == 0


def test_the_table_prices_each_record_from_its_counts():
    """A record written with the model group's bytes at the mesh's
    slowest link reads, in the table, as the dry run prices it now."""
    from repro_torch import hardware as HW
    from repro_torch.roofline.table import model_axis_table, priced
    stale = {"arch": "gemma3-4b", "shape": "train_4k",
             "mesh": "single_tp2", "model_parallel": 2, "n_devices": 32,
             "flops_per_dev": 4e14, "bytes_analytic_per_dev": 1e10,
             "coll_bytes_per_dev": 60e9,
             "model_allreduce_bytes_per_dev": 50e9, "compute_s": 0.4,
             "memory_s": 0.003, "collective_s": 60e9 / HW.IB_NDR_BW,
             "bottleneck": "collective", "peak_bytes": 70 * 2 ** 30,
             "fits": True, "kv_heads_whole": False}
    now = priced(stale)
    assert now["collective_s"] == 10e9 / HW.IB_NDR_BW + \
        50e9 / HW.NVLINK_BW
    assert now["bottleneck"] == "compute"
    assert priced({"arch": "gemma3-4b", "error": "boom"}) == \
        {"arch": "gemma3-4b", "error": "boom"}
    assert "K 2: 70.00 cmp" in model_axis_table([now])


@pytest.mark.parametrize("arch", MOE)
def test_dry_run_counts_the_moe_layers_collectives(arch):
    """``dryrun --model-parallel 2`` of a reduced MoE arch (its expert
    axis restored): qwen3's expert split all-gathers the experts' outputs
    over the model group (counted apart, and in the rank's all-gather
    bytes); granite's d_ff split all-reduces them and gathers nothing.
    Both priced at the model group's own link."""
    from repro_torch import hardware as HW
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline.analysis import model_group_bytes
    cfg = _restored(reduced(get_config(arch), n_layers=2, d_model=64), arch)
    rec = D.run_one(arch, "train_4k", nodes=2, batch=2, seq=32,
                    device="cpu", cfg=cfg, model_parallel=2, quantize=True)
    assert rec["mesh"] == "2_gpus_tp2" and rec["n_layers"] == 2
    assert rec["model_allreduce_calls"] > 0
    if MS.expert_split(cfg):
        # one a layer and local step
        assert rec["model_allgather_calls"] == 2 * rec["H"]
        assert rec["coll_raw"]["all-gather"] >= \
            rec["model_allgather_bytes_per_dev"] > 0
    else:
        assert rec["model_allgather_calls"] == 0
        assert rec["model_allgather_bytes_per_dev"] == 0
    node = rec["coll_bytes_per_dev"] - model_group_bytes(rec)
    assert rec["collective_s"] == node / HW.NVLINK_BW + \
        model_group_bytes(rec) / HW.NVLINK_BW


@pytest.mark.parametrize("K,chunk", [(2, 128), (4, 64), (2, 512)])
def test_vocab_slices_stats_join_to_the_whole_cross_entropy(K, chunk):
    """Each GPU's vocab slice's online statistics (``layers.py``
    ``_xent_stats`` at the slice's offset), joined as the vocab-parallel
    cross-entropy joins them (max, rescaled sum, the target's logit from
    the slice that holds it), give the one-GPU chunked cross-entropy,
    also where a slice is not a multiple of the chunk (qwen3-moe-30b-a3b's
    151,936 rows at K 2 are 75,968 a GPU, 4.6 chunks of 16,384): a target
    in the next slice's first rows falls in the last chunk's padding and
    must count there as a 0 logit, not as the padding's -inf."""
    from repro_torch.models.layers import _xent_stats, chunked_softmax_xent
    V, D = 600, 16
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 24, D), generator=g)
    embed = torch.randn((V, D), generator=g)
    targets = torch.randint(0, V, (2, 24), generator=g)
    n = V // K
    stats = [_xent_stats(x, embed[i * n:(i + 1) * n], targets, chunk, 0.0,
                         i * n) for i in range(K)]
    M = torch.stack([m for m, _, _ in stats]).amax(0)
    S = sum(s * torch.exp(m - M) for m, s, _ in stats)
    TL = sum(tl for _, _, tl in stats)
    got = torch.mean(M + torch.log(S) - TL)
    want = chunked_softmax_xent(x, embed, targets, chunk=chunk)
    assert torch.isfinite(got)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
