"""The port's serving engine on the zoo's new layers against the JAX
package's engine, on the CPU, from identical weights and prompts:
gemma3-4b (sliding-window rings beside a global layer; its window cut to
8 rows so that decode wraps the rings), granite-moe-3b-a800m (MoE in
every layer) and jamba-1.5-large-398b at 8 layers (Mamba states, one
attention layer and MoE side by side in one bank), at ``reduced``
(d_model 32, fp32), in blocking, chunked and paged modes.

Step by step, the greedy tokens each lane commits are JAX's and the bank
(and the page pools) are within 1e-5 of JAX's, absolute or relative to a
leaf's largest magnitude where that exceeds 1 (jamba 2e-5: its last
Mamba state, after 8 layers, reaches 5.8, and fp32 sums in two orders
drift by 1.4e-5 of that over the run). The port's own pairs are
bitwise: paged == dense across a hot swap, chunked == blocking (reduced's
capacity factor 4.0 is dropless, so the MoE's batch does not change a
token's experts). An arch with a modality frontend is refused with JAX's
message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import init_params as jinit_params
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, Request, ServeEngine
from repro_torch.tree import tree_key_paths, tree_leaves

CPU = "cpu"
ARCHS = {"gemma3-4b": dict(n_layers=8, replace={"sliding_window": 8}),
         "granite-moe-3b-a800m": dict(n_layers=2, replace={}),
         "jamba-1.5-large-398b": dict(n_layers=8, replace={})}
MODES = {"blocking": dict(prefill_chunk=0),
         "chunked": dict(prefill_chunk=4),
         "paged": dict(prefill_chunk=4, paged=True, page_size=4)}
LENS = [3, 8, 5, 1, 7, 6]
ATOL = {"jamba-1.5-large-398b": 2e-5}


def _cfgs(arch):
    a = ARCHS[arch]
    jc = jreduced(jget_config(arch), n_layers=a["n_layers"], d_model=32)
    tc = reduced(get_config(arch), n_layers=a["n_layers"], d_model=32)
    return (dataclasses.replace(jc, **a["replace"]),
            dataclasses.replace(tc, **a["replace"]))


_NP = {}


def _np_params(arch, seed=0):
    if (arch, seed) not in _NP:
        _NP[arch, seed] = jax.device_get(
            jinit_params(jax.random.PRNGKey(seed), _cfgs(arch)[0]))
    return _NP[arch, seed]


def _ragged(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            for L in lens]


def _jax_leaves(tree):
    """JAX's bank stacks batch-1 caches ([slots, n_blocks, 1, ...],
    [slots, 1, ...]); -> (path, leaf) in the port's layout ([n_blocks,
    slots, ...], [slots, ...])."""
    out = []
    for p, x in jax.tree_util.tree_leaves_with_path(tree):
        path = tuple(k.key for k in p)
        x = np.asarray(x)
        if path[0] == "blocks" and x.ndim > 2:
            x = x[:, :, 0].swapaxes(0, 1)
        elif path[0] == "tail" and x.ndim > 1:
            x = x[:, 0]
        out.append((path, x))
    return out


def _banks_close(jtree, ttree, atol):
    jl = _jax_leaves(jtree)
    tl = list(zip(tree_key_paths(ttree), tree_leaves(ttree)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        b = b.float().numpy() if b.is_floating_point() else b.numpy()
        assert a.shape == b.shape, (path, a.shape, b.shape)
        scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
        np.testing.assert_allclose(b, a, rtol=0, atol=atol * scale,
                                   err_msg=str(path))


def _pools_close(jpools, tpools, atol):
    if jpools is None:
        assert tpools is None
        return
    for (path, a), b in zip(
            [(tuple(k.key for k in p), np.asarray(x)) for p, x in
             jax.tree_util.tree_leaves_with_path(jpools)],
            tree_leaves(tpools)):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=atol,
                                   err_msg=str(path))


def _lane_tokens(eng):
    return [list(ln.tokens) if ln.active else None for ln in eng.lanes]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_follows_jax_step_by_step(arch, mode):
    jc, tc = _cfgs(arch)
    npp = _np_params(arch)
    kw = dict(max_slots=2, prompt_len=8, max_new_tokens=8, queue_depth=16,
              **MODES[mode])
    je = JServeEngine(jc, JEngineConfig(**{"paged": False, **kw}),
                      params=jax.tree.map(jnp.asarray, npp))
    te = ServeEngine(tc, EngineConfig(**kw), params=params_from_numpy(npp,
                                                                      CPU),
                     device=CPU)
    for i, p in enumerate(_ragged(tc, LENS)):
        assert je.submit(JRequest(i, p)) and te.submit(Request(i, p))
    steps = 0
    while je.queue or any(ln.active for ln in je.lanes):
        je.step()
        te.step()
        steps += 1
        assert _lane_tokens(te) == _lane_tokens(je), steps
        atol = ATOL.get(arch, 1e-5)
        _banks_close(je._caches, te._caches, atol)
        _pools_close(je._pools, te._pools, atol)
        assert steps < 100
    assert not te.queue and not any(ln.active for ln in te.lanes)
    want = {c.rid: c.tokens.tolist() for c in je.completions}
    assert {c.rid: c.tokens.tolist() for c in te.completions} == want
    assert len(want) == len(LENS)
    js, ts = je.metrics.summary(), te.metrics.summary()
    for k in ("decode_cache_misses", "prefill_cache_misses", "completed",
              "kv_bytes", "kv_dense_bytes"):
        assert ts[k] == js[k], (k, ts[k], js[k])


def _run(arch, *, seed=0, swap=True, **kw):
    _, tc = _cfgs(arch)
    pA = params_from_numpy(_np_params(arch, 0), CPU)
    pB = params_from_numpy(_np_params(arch, 1), CPU)
    eng = ServeEngine(tc, EngineConfig(max_slots=2, prompt_len=8,
                                       max_new_tokens=8, queue_depth=16,
                                       seed=seed, **kw),
                      params=pA, device=CPU)
    prompts = _ragged(tc, LENS, 1)
    for i in range(4):
        eng.submit(Request(i, prompts[i]))
    eng.step()
    eng.step()
    if swap:
        eng.swap.publish(pB, tag="B")
    eng.submit(Request(4, prompts[4]))
    eng.submit(Request(5, prompts[5]))
    eng.drain()
    return eng


def _done(eng):
    return {c.rid: (c.tokens.tolist(), c.gen) for c in eng.completions}


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_paged_bitwise_dense_across_hot_swap(arch, chunk):
    """Sampled streams (temperature 0.7, seeded): paged == dense bit for
    bit across admissions, retirements and a hot swap, with no new shape
    signature and every page freed; greedy, the lanes admitted before the
    swap finish as in a run that never swaps."""
    kw = dict(temperature=0.7, prefill_chunk=chunk)
    dense = _run(arch, **kw)
    paged = _run(arch, paged=True, page_size=4, **kw)
    assert _done(paged) == _done(dense) and len(_done(dense)) == 6
    assert {g for _, g in _done(dense).values()} == {1, 2}
    greedy = _run(arch, prefill_chunk=chunk)
    still = _run(arch, swap=False, prefill_chunk=chunk)
    for rid, (toks, gen) in _done(greedy).items():
        if gen == 1:
            assert _done(still)[rid] == (toks, 1)
    for eng in (dense, paged):
        s = eng.metrics.summary()
        assert s["decode_cache_misses"] == 0
        assert s["prefill_cache_misses"] == 0
        assert s["dropped_in_flight"] == 0 and s["swaps_adopted"] == 2
    assert paged.allocator.in_use == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chunked_equals_blocking_greedy(arch):
    blocking = _run(arch, swap=False)
    chunked = _run(arch, swap=False, prefill_chunk=4)
    assert _done(chunked) == _done(blocking)
    assert chunked.metrics.summary()["prefill_cache_misses"] == 0


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_engine_refuses_a_frontend_with_jax_message(arch):
    jc = jreduced(jget_config(arch), n_layers=1, d_model=32)
    tc = reduced(get_config(arch), n_layers=1, d_model=32)
    with pytest.raises(ValueError) as jerr:
        JServeEngine(jc, JEngineConfig(paged=False))
    with pytest.raises(ValueError) as terr:
        ServeEngine(tc, EngineConfig(), device=CPU)
    assert str(terr.value) == str(jerr.value)
    assert "one-shot path" in str(terr.value)


def test_swa_bank_holds_rings_and_paged_pools_hold_global_layers():
    """gemma3-4b's bank: rings of min(window, capacity) rows stay per lane
    in both layouts; only the global layer's KV moves to the pools."""
    _, tc = _cfgs("gemma3-4b")
    npp = _np_params("gemma3-4b")
    for paged in (False, True):
        eng = ServeEngine(tc, EngineConfig(max_slots=2, prompt_len=8,
                                           max_new_tokens=8, paged=paged,
                                           page_size=4),
                          params=params_from_numpy(npp, CPU), device=CPU)
        bank = eng._caches
        assert bank["blocks"]["layer_0"]["k"].shape == (1, 2, 8, 4, 8)
        assert bank["tail"]["layer_1"]["k"].shape == (2, 8, 4, 8)
        glob = bank["blocks"]["layer_5"]
        if paged:
            assert glob == {}
            assert eng._pools["blocks"]["layer_5"]["k"].shape == \
                (1, 8, 4, 4, 8)
            assert set(eng._pools["blocks"]) == {"layer_5"}
        else:
            assert glob["k"].shape == (1, 2, 16, 4, 8)


def test_oneshot_cli_serves_a_frontend_arch(capsys):
    from repro_torch.launch import serve as tserve
    res = tserve.main(["--arch", "paligemma-3b", "--reduced", "--layers",
                       "1", "--d-model", "32", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert res["tokens"].shape == (2, 4) and res["finite"]
    assert "generated tokens" in capsys.readouterr().out
