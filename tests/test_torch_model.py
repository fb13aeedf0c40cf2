"""The port's dense model against the JAX package, on the CPU, from
identical weights (carried over with ``models/convert.py``).

Loss within rtol 1e-5 and gradients within atol 1e-5: jitted XLA sums and
FMA contraction differ from eager torch by a few ulp, so the comparison
cannot be bitwise. The building blocks (norms, RoPE, MLP, attention with
several chunks, chunked cross-entropy over a padded vocab) are held to the
same bound one by one, and the configs, templates and data stream equal
the JAX package's exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.data import make_node_batches as jmake_batches
from repro.models import attention as jattn
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jloss_fn
from repro.models import param_template as jparam_template
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro_torch.models import TransformerLM, attention, layers, loss_fn
from repro_torch.models import param_template
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.tree import tree_flatten

ARCHS = ["transformer-wmt", "olmo-1b"]


def _cfgs(arch, layers_=2, d_model=64):
    return (jreduced(jget_config(arch), n_layers=layers_, d_model=d_model),
            reduced(get_config(arch), n_layers=layers_, d_model=d_model))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch):
    jc, tc = jget_config(arch), get_config(arch)
    tfields = {f.name for f in dataclasses.fields(tc)}
    for name in tfields:
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.n_params() == jc.n_params()
    jr, tr = _cfgs(arch)
    for name in tfields:
        assert getattr(tr, name) == getattr(jr, name), name


def test_transformer_wmt_full_size():
    assert get_config("transformer-wmt").n_params() == 184_600_576


@pytest.mark.parametrize("arch", ARCHS)
def test_param_template_equals_jax(arch):
    jc, tc = _cfgs(arch)
    from repro.models.layers import is_info
    jt = jax.tree_util.tree_flatten_with_path(jparam_template(jc),
                                              is_leaf=is_info)[0]
    tleaves, _ = tree_flatten(param_template(tc))
    assert len(tleaves) == len(jt)
    for (path, ji), ti in zip(jt, tleaves):
        assert (ti.shape, ti.axes, ti.init, ti.scale) == \
            (ji.shape, ji.axes, ji.init, ji.scale), path


def test_convert_roundtrip():
    jc, _ = _cfgs("transformer-wmt", 1, 32)
    np_tree = jax.device_get(jinit_params(jax.random.PRNGKey(0), jc))
    back = params_to_numpy(params_from_numpy(np_tree, "cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), tree_flatten(back)[0]):
        np.testing.assert_array_equal(np.asarray(a), b)
    bf = {"w": jnp.arange(6, dtype=jnp.float32).astype(jnp.bfloat16)}
    t = params_from_numpy(jax.device_get(bf), "cpu")
    assert t["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["w"].float().numpy(), np.arange(6.0))


def test_synthetic_data_equals_jax():
    jds = JDataset(JDataConfig(vocab_size=512, seq_len=16, seed=3), 4)
    tds = SyntheticLMDataset(DataConfig(vocab_size=512, seq_len=16, seed=3), 4)
    for step in (0, 5):
        jb, tb = jmake_batches(jds, step, 6), make_node_batches(tds, step, 6)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(jb[k], tb[k])


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm", "nonparam_ln"])
def test_apply_norm(norm):
    jc, tc = _cfgs("transformer-wmt")
    jc, tc = (dataclasses.replace(c, norm=norm) for c in (jc, tc))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jlayers.apply_norm(jc, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x))
    got = layers.apply_norm(tc, {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("rot_frac", [1.0, 0.5])
def test_apply_rope(rot_frac):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                              theta=10_000.0, rot_frac=rot_frac)
    got = layers.apply_rope(_t(x), _t(pos), theta=10_000.0,
                            rot_frac=rot_frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_mlp(arch):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"w_up": rng.standard_normal((64, 256)).astype(np.float32) * 0.1,
         "w_down": rng.standard_normal((256, 64)).astype(np.float32) * 0.1,
         "w_gate": rng.standard_normal((64, 256)).astype(np.float32) * 0.1}
    if not jc.gated_mlp:
        del p["w_gate"]
    want = jlayers.apply_mlp(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = layers.apply_mlp(tc, {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("chunk_q,chunk_kv", [(32, 32), (8, 16), (16, 4)])
def test_attention_causal(chunk_q, chunk_kv):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 8)).astype(np.float32)
    want = jattn.attention_causal(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), chunk_q=chunk_q,
                                  chunk_kv=chunk_kv)
    got = attention.attention_causal(_t(q), _t(k), _t(v), chunk_q=chunk_q,
                                     chunk_kv=chunk_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("V,chunk", [(512, 128), (500, 128), (64, 16384)])
def test_chunked_softmax_xent(V, chunk):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    emb = rng.standard_normal((V, 16)).astype(np.float32)
    tgt = rng.integers(0, V, (2, 6)).astype(np.int32)
    want = jlayers.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(emb),
                                        jnp.asarray(tgt), chunk=chunk)
    got = layers.chunked_softmax_xent(_t(x), _t(emb), _t(tgt), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch,layers_,d_model", [("transformer-wmt", 1, 32),
                                                  ("transformer-wmt", 2, 64),
                                                  ("olmo-1b", 2, 64)])
def test_loss_and_grads_match_jax(arch, layers_, d_model):
    jc, tc = _cfgs(arch, layers_, d_model)
    np_params = jax.device_get(jinit_params(jax.random.PRNGKey(7), jc))
    ds = JDataset(JDataConfig(vocab_size=jc.vocab_size, seq_len=32, seed=1), 1)
    nb = jmake_batches(ds, 0, 4)
    batch = {k: v[0] for k, v in nb.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jc, p, b)))(jax.tree.map(jnp.asarray,
                                                       np_params),
                                          jax.tree.map(jnp.asarray, batch))
    model = TransformerLM(tc)
    tparams = params_from_numpy(np_params, "cpu")
    tbatch = {k: _t(v) for k, v in batch.items()}
    tg, tl = torch.func.grad_and_value(model.functional_loss)(tparams, tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tree_flatten(tg)[0], jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    # the functional module and the plain function are one computation
    assert float(loss_fn(tc, tparams, tbatch)) == float(tl)


def test_module_parameter_names_are_tree_paths():
    _, tc = _cfgs("transformer-wmt", 1, 32)
    model = TransformerLM(tc)
    from repro_torch.tree import tree_paths
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(tree_paths(param_template(tc)))
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_node_grads_fn_matches_jax_vmapped_grads(arch):
    """The engines' gradient path — one vmapped forward over stacked
    nodes, one reverse pass of the losses' sum — against JAX's vmapped
    value_and_grad, per node, from three nodes' own weights and batches
    (the module docstring's bound)."""
    from repro_torch.core.exchange import node_grads_fn
    jc, tc = _cfgs(arch, 2, 64)
    n = 3
    trees = [jax.device_get(jinit_params(jax.random.PRNGKey(s), jc))
             for s in range(n)]
    np_params = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    ds = JDataset(JDataConfig(vocab_size=jc.vocab_size, seq_len=32, seed=1), n)
    nb = jmake_batches(ds, 0, 4)
    batch = dict(nb)                      # [nodes, batch, seq] leaves
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: jloss_fn(jc, p, b))))(
        jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, batch))
    tparams = params_from_numpy(np_params, "cpu")
    tbatch = {k: _t(v) for k, v in batch.items()}
    tg, tl = node_grads_fn(lambda p, b: loss_fn(tc, p, b))(tparams, tbatch)
    assert tl.shape == (n,) and not tl.requires_grad
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, b in zip(tree_flatten(tg)[0], jax.tree.leaves(jg)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
