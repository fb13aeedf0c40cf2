"""The port's flat-buffer layout and lattice codec against the JAX package.

* Layouts (offsets, n_padded, rows_per_node, payload bytes per codec) equal
  JAX's on the reduced transformer-wmt and olmo-1b parameter trees; this
  holds only if the port flattens dict keys in JAX's sorted order.
* pack equals JAX's pack bitwise and pack/unpack round-trips bitwise.
* ``gossip_flat_coded`` is bitwise JAX's (eager, REPRO_KERNEL_BACKEND's CPU
  default ``ref``) given the same buffer, comm copy, uniforms ``u``,
  matching and matched mask; so is ``gossip_flat_exact``.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import bucket as JB
from repro.models import init_params as jinit_params
from repro.quant import codecs as JC
from repro_torch.core import bucket as TB
from repro_torch.models.convert import params_from_numpy
from repro_torch.quant import codecs as TC
from repro_torch.tree import (
    tree_flatten, tree_map, tree_paths, tree_unflatten,
)

N_NODES = 4
ARCHS = ["transformer-wmt", "olmo-1b"]


def _stacked_np(arch, layers=2, d_model=64):
    cfg = jreduced(jget_config(arch), n_layers=layers, d_model=d_model)
    one = jax.device_get(jinit_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.stack([np.asarray(a) + np.float32(0.01 * i) *
                            rng.standard_normal(a.shape).astype(np.float32)
                            for i in range(N_NODES)]), one)


@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    np_tree = _stacked_np(request.param)
    return (request.param, jax.tree.map(jnp.asarray, np_tree),
            params_from_numpy(np_tree, "cpu"))


def test_leaf_order_is_jax_flatten_order(trees):
    _, jtree, ttree = trees
    jpaths = [".".join(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert tree_paths(ttree) == jpaths
    jleaves = jax.tree.leaves(jtree)
    tleaves, _ = tree_flatten(ttree)
    assert [tuple(x.shape) for x in tleaves] == \
        [tuple(x.shape) for x in jleaves]


@pytest.mark.parametrize("codec", [None, "q8", "q4", "q16"])
def test_layout_matches_jax(trees, codec):
    _, jtree, ttree = trees
    jl = JB.build_layout(jtree)
    tl = TB.build_layout(ttree)
    assert tl.offsets == jl.offsets and tl.sizes == jl.sizes
    assert tl.seg_sizes == jl.seg_sizes
    assert (tl.n_coords, tl.n_padded, tl.rows_per_node) == \
        (jl.n_coords, jl.n_padded, jl.rows_per_node)
    jc = None if codec is None else JC.make_codec(codec)
    tc = None if codec is None else TC.make_codec(codec)
    assert tl.payload_num_bytes(tc) == jl.payload_num_bytes(jc)


def test_flat_layout_matches_jax(trees):
    _, jtree, _ = trees
    one_j = jax.tree.map(lambda x: x[0], jtree)
    one_t = params_from_numpy(jax.tree.map(np.asarray, one_j), "cpu")
    jl = JB.build_flat_layout(one_j)
    tl = TB.build_flat_layout(one_t)
    assert (tl.offsets, tl.n_padded) == (jl.offsets, jl.n_padded)


def test_pack_bitwise_and_roundtrip(trees):
    _, jtree, ttree = trees
    jl = JB.build_layout(jtree)
    tl = TB.build_layout(ttree)
    tbuf = TB.pack(tl, ttree)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(JB.pack(jl, jtree)))
    back = TB.unpack(tl, tbuf)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(ttree)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.data_ptr() != tbuf.data_ptr()      # fresh tensors, no alias
    flat = TB.pack_flat(TB.build_flat_layout(ttree), ttree)
    back = TB.unpack_flat(TB.build_flat_layout(ttree), flat)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_flatten(back)[0], tree_flatten(ttree)[0]))


def test_bf16_tree_pack_roundtrip():
    t = {"b": torch.randn(3, 5, 7).to(torch.bfloat16),
         "a": {"w": torch.randn(3, 300)}}
    lay = TB.build_layout(t)
    back = TB.unpack(lay, TB.pack(lay, t))
    assert back["b"].dtype == torch.bfloat16
    assert torch.equal(back["b"], t["b"]) and torch.equal(back["a"]["w"],
                                                          t["a"]["w"])


def _wire_np(w):
    return w.view(torch.int16).numpy().view(np.uint16) \
        if w.dtype == torch.uint16 else w.numpy()


@pytest.mark.parametrize("spec", ["q8", "q4", "q16", "q2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gossip_flat_coded_bitwise(trees, spec, seed):
    _, jtree, ttree = trees
    jl = JB.build_layout(jtree)
    buf_j = JB.pack(jl, jtree)
    rng = np.random.default_rng(seed)
    prev_np = (np.asarray(buf_j) + 0.02 * rng.standard_normal(
        buf_j.shape)).astype(np.float32)
    perm = np.array([2, 3, 0, 1]) if seed == 0 else np.array([1, 0, 2, 3])
    matched = perm != np.arange(N_NODES)
    key = jax.random.PRNGKey(seed)
    jcodec = JC.make_codec(spec)
    out_j, _ = JB.gossip_flat_coded(jcodec, buf_j, jnp.asarray(prev_np),
                                    jnp.asarray(perm), jnp.asarray(matched),
                                    key)
    u = np.array(jax.random.uniform(key, buf_j.shape, jnp.float32))
    tcodec = TC.make_codec(spec)
    buf_t = TB.pack(TB.build_layout(ttree), ttree)
    out_t, res_t = TB.gossip_flat_coded(tcodec, buf_t,
                                        torch.from_numpy(prev_np),
                                        torch.from_numpy(perm).long(),
                                        torch.from_numpy(matched), None,
                                        u=torch.from_numpy(u))
    assert res_t is None
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    # the wire itself: codes and scales bitwise, bytes as declared
    jw = jcodec.encode(buf_j, jnp.asarray(prev_np), key)
    tw = tcodec.encode(buf_t, torch.from_numpy(prev_np), None,
                       u=torch.from_numpy(u))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(_wire_np(a), np.asarray(b))
    n_bytes = sum(w.numel() * w.element_size() for w in tw)
    assert n_bytes == N_NODES * tcodec.payload_num_bytes(buf_t.shape[1])


def test_gossip_flat_exact_bitwise(trees):
    _, jtree, ttree = trees
    jl = JB.build_layout(jtree)
    perm = np.array([3, 2, 1, 0])
    out_j = JB.gossip_flat_exact(JB.pack(jl, jtree), jnp.asarray(perm))
    out_t = TB.gossip_flat_exact(TB.pack(TB.build_layout(ttree), ttree),
                                 torch.from_numpy(perm).long())
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_permute_rows_uint16_and_groups():
    q = torch.arange(4 * 3 * 2, dtype=torch.int32).reshape(12, 2)
    q16 = q.to(torch.int16).view(torch.uint16)
    perm = torch.tensor([1, 0, 3, 2])
    out = TB.permute_rows(q16, perm, 4)
    assert out.dtype == torch.uint16
    want = q.reshape(4, 3, 2)[perm].reshape(12, 2)
    assert torch.equal(out.view(torch.int16).to(torch.int32), want)


def test_unported_codecs_refuse_by_name():
    """The bf16 and top-k codecs are ported now: make_codec builds them
    under the reference's names and families; bogus specs still raise
    ValueError with the grammar, as in the reference."""
    for spec, name, family in (("bf16", "bf16", "bf16"),
                               ("topk:0.25", "topk:0.25", "topk")):
        c, jc = TC.make_codec(spec), JC.make_codec(spec)
        assert (c.name, c.family) == (name, family) == (jc.name, jc.family)
        assert c.carries_residual == jc.carries_residual
    for bad in ("q17", "topk:2", "topk:x", "fp8"):
        with pytest.raises(ValueError):
            TC.make_codec(bad)
        with pytest.raises(ValueError):
            JC.make_codec(bad)
    assert TC.make_codec(None).name == "q8"


def test_wire_layouts_match_jax():
    for spec in ("q2", "q4", "q8", "q12", "q16"):
        jl = JC.make_codec(spec).wire_layout()
        tl = TC.make_codec(spec).wire_layout()
        assert tl.bytes_per_row == jl.bytes_per_row
        assert [(g.name, g.dtype, g.cols) for g in tl.groups] == \
            [(g.name, g.dtype, g.cols) for g in jl.groups]


@pytest.mark.parametrize("spec", ["q8", "q4", "q16"])
def test_codec_decode_without_average_bitwise(spec):
    """LatticeCodec.decode (the weight-load half, average=False) equals
    the JAX codec's on the same wire."""
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((2, 2048)).astype(np.float32)
    prev = (buf + 0.01 * rng.standard_normal(buf.shape)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jc, tc = JC.make_codec(spec), TC.make_codec(spec)
    jw = jc.encode(jnp.asarray(buf), jnp.asarray(prev), key)
    u = np.array(jax.random.uniform(key, buf.shape, jnp.float32))
    tw = tc.encode(torch.from_numpy(buf), torch.from_numpy(prev), None,
                   u=torch.from_numpy(u))
    want = jc.decode(jw, jnp.asarray(prev))
    got = tc.decode(tw, torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tree_ops_keep_no_reference_to_their_leaves():
    """tree_map / tree_flatten / tree_unflatten / tree_paths hold no
    reference to a tree's tensors once they return, with the cyclic garbage
    collector off: a nested recursive closure (a reference cycle through
    its own cell) used to pin every flattened leaf until a collection ran,
    whole-model tensors on the card."""
    gc.disable()
    try:
        x = torch.zeros(4)
        tree = {"a": {"b": x}, "c": torch.ones(2), "d": {}}
        refs = [weakref.ref(x)]
        y = tree_map(lambda v: v + 1, tree)
        refs.append(weakref.ref(y["a"]["b"]))
        leaves, treedef = tree_flatten(tree)
        z = tree_unflatten(treedef, [v * 2 for v in leaves])
        refs.append(weakref.ref(z["a"]["b"]))
        assert tree_paths(tree) == ["a.b", "c"]
        del x, tree, y, leaves, z
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
