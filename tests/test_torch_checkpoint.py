"""The port's checkpoints, mean model and ``--eval-mean`` against the JAX
package, on the CPU.

* A checkpoint the port writes loads with ``repro.checkpoint`` and one JAX
  writes loads with the port's loader, both bitwise, with the same leaf
  ``names``, ``dtypes`` and ``treedef`` in the json (a bf16 params tree
  beside an fp32 comm copy, as a quantized run saves them).
* ``mean_model_tree`` is within 1e-6 of JAX's.
* The two drivers, run with the same flags (q8, overlapped, geometric h,
  non-iid, ``--eval-mean``, ``--ckpt --ckpt-every``), log records with the
  same keys and write the same checkpoint files with the same names,
  dtypes and metadata; the port's codec checkpoint restores its state.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import load_metadata as jload_metadata
from repro.checkpoint import mean_model_tree as jmean_model_tree
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import init_params as jinit_params
from repro_torch.checkpoint import (
    load_checkpoint, load_metadata, mean_model_tree, save_checkpoint,
)
from repro_torch.core import (
    SwarmConfig, pipeline_epilogue, pipeline_prologue, restore_codec_state,
)
from repro_torch.core.swarm import codec_checkpoint_tree
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_flatten

N = 4


def _stacked(dtype):
    """A node-stacked reduced transformer-wmt tree (nodes differ) in
    numpy, cast to `dtype`."""
    cfg = jreduced(jget_config("transformer-wmt"), n_layers=2, d_model=32)
    one = jax.device_get(jinit_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(np.stack(
            [a + np.float32(0.01 * i) *
             rng.standard_normal(a.shape).astype(np.float32)
             for i in range(N)])).astype(dtype)), one)


def _codec_tree():
    """{"params": bf16, "prev": fp32} in numpy, as a q8 run saves it."""
    return {"params": _stacked(jnp.bfloat16), "prev": _stacked(jnp.float32)}


def _json(path):
    with open(path + ".json") as f:
        return json.load(f)


def _same_bits(t: torch.Tensor, a) -> bool:
    return torch.equal(t, params_from_numpy({"x": a}, "cpu")["x"])


def test_port_checkpoint_loads_in_jax(tmp_path):
    np_tree = _codec_tree()
    meta = {"step": np.int64(3), "hs": np.arange(3)}
    save_checkpoint(str(tmp_path / "port"), params_from_numpy(np_tree,
                                                              "cpu"), meta)
    jsave_checkpoint(str(tmp_path / "jax"), np_tree, meta)
    pj, jj = _json(str(tmp_path / "port")), _json(str(tmp_path / "jax"))
    assert pj == jj
    assert "bfloat16" in pj["dtypes"].values()
    like = jax.tree.map(jnp.asarray, np_tree)
    got = jload_checkpoint(str(tmp_path / "port"), like)
    for g, a in zip(jax.tree.leaves(got), jax.tree.leaves(np_tree)):
        assert g.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(g).view(np.uint8),
                                      np.asarray(a).view(np.uint8))
    assert jload_metadata(str(tmp_path / "port")) == \
        {"step": 3, "hs": [0, 1, 2]}


def test_jax_checkpoint_loads_in_port(tmp_path):
    np_tree = _codec_tree()
    jsave_checkpoint(str(tmp_path / "jax"), np_tree, {"nodes": N})
    like = params_from_numpy(np_tree, "cpu")
    got = load_checkpoint(str(tmp_path / "jax"), like)
    leaves, _ = tree_flatten(got)
    for g, a in zip(leaves, jax.tree.leaves(np_tree)):
        assert _same_bits(g, a)
    assert load_metadata(str(tmp_path / "jax")) == {"nodes": N}
    bad = {"params": like["params"], "prev": dict(like["prev"])}
    bad["prev"]["embed"] = bad["prev"]["embed"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "jax"), bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mean_model_tree_matches_jax(dtype):
    np_tree = _stacked(getattr(jnp, dtype))
    mu = mean_model_tree(params_from_numpy(np_tree, "cpu"))
    jmu = jax.device_get(jmean_model_tree(jax.tree.map(jnp.asarray,
                                                       np_tree)))
    tl, _ = tree_flatten(mu)
    for t, j in zip(tl, jax.tree.leaves(jmu)):
        assert t.shape == j.shape and str(t.dtype).endswith(dtype)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=0, atol=1e-6)


FLAGS = ["--arch", "transformer-wmt", "--reduced", "--layers", "1",
         "--d-model", "16", "--nodes", str(N), "--steps", "3", "--batch",
         "1", "--seq", "16", "--H", "2", "--h-mode", "geometric",
         "--h-max", "4", "--quantize", "--overlap", "--non-iid", "0.5",
         "--eval-mean", "--log-every", "1", "--ckpt-every", "2"]


def _records(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_drivers_agree_on_eval_mean_and_checkpoints(tmp_path, capsys,
                                                    monkeypatch):
    from repro.launch.train import main as jmain
    for var in ("REPRO_AVAIL_PROFILE", "REPRO_RATE_PROFILE", "REPRO_CODEC",
                "REPRO_SCAN_CHUNK", "REPRO_TOPOLOGY"):
        monkeypatch.delenv(var, raising=False)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train"] + FLAGS + ["--ckpt",
                                                          str(jdir)])
    jmain()
    jrecs = _records(capsys.readouterr().out)
    trecs = ttrain.main(FLAGS + ["--ckpt", str(tdir), "--device", "cpu"])
    assert [set(r) for r in trecs] == [set(r) for r in jrecs]
    assert {"loss_mean_model", "loss_node_mean", "loss_node_worst"} <= \
        set(trecs[0])
    for r in trecs:
        assert r["loss_node_worst"] >= r["loss_node_mean"]
        assert all(np.isfinite(v) for v in r.values())
    files = sorted(p.name for p in jdir.iterdir())
    assert files == sorted(p.name for p in tdir.iterdir()) == [
        "step_000002.json", "step_000002.npz", "step_000003.json",
        "step_000003.npz"]
    for name in ("step_000002", "step_000003"):
        pj, jj = _json(str(tdir / name)), _json(str(jdir / name))
        assert pj == jj, name
        assert pj["metadata"]["codec"]["state"] == ["params", "prev"]
    # the port's final codec checkpoint restores the drained state
    # bitwise, and re-priming restores the packed comm copy
    tr = ttrain.build(ttrain.build_parser().parse_args(
        FLAGS + ["--device", "cpu"]))
    for t in range(3):
        tr.superstep(t)
    drained = pipeline_epilogue(tr.scfg, tr.state)
    like = codec_checkpoint_tree(drained)
    back = load_checkpoint(str(tdir / "step_000003"), like)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(like)[0]):
        assert torch.equal(a, b)
    fresh = ttrain.build(ttrain.build_parser().parse_args(
        FLAGS + ["--device", "cpu", "--steps", "1"]))
    scfg = SwarmConfig(n_nodes=N, H=2, h_mode="geometric", h_max=4,
                       quantize=True, nonblocking=True, overlap=True)
    resumed = pipeline_prologue(
        scfg, restore_codec_state(pipeline_epilogue(scfg, fresh.state),
                                  back), None,
        u=torch.zeros_like(tr.state.inflight["sbuf"]))
    assert torch.equal(resumed.inflight["prev"], tr.state.inflight["prev"])
    assert torch.equal(resumed.inflight["sbuf"], tr.state.inflight["sbuf"])
