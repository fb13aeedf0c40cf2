"""The serving engine's MoE capacity is each lane's, as the reference's.

The JAX package's engine vmaps a batch-1 ``forward`` over its slots, so a
mixture-of-experts layer routes and dispatches each lane's tokens on their
own: capacity ``moe.capacity(cfg, S)`` of the lane's S tokens (1 at
decode, the chunk in a chunk step), positions by a cumsum over that lane
only. The port's engine runs its slots as one batch and dispatches each
lane into its own expert buffers (``forward(moe_per_lane=True)``).

granite-moe-3b-a800m at ``reduced`` (4 experts, top-2, d_model 32, fp32)
with its capacity factor lowered from 4.0 (dropless) to 1.0, so that the
experts overflow: at chunk 8 over 4 slots the batch's 32 tokens share 16
slots an expert where each lane has 8 of its own; at chunk 16 a lane's own
16 tokens overflow its 8 slots too. On the CPU, against JAX eagerly from
the same weights and tokens: logits within 1e-5 (fp32; relative to the
largest magnitude where that exceeds 1) and greedy tokens equal, for a
chunk step and for the engines step by step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import transformer as jtf
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models import forward, init_cache, logits_head
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import EngineConfig, Request, ServeEngine
from repro_torch.tree import tree_key_paths, tree_leaves

ARCH = "granite-moe-3b-a800m"
ATOL = 1e-5
SLOTS = 4


def _cfgs():
    jc = jreduced(jget_config(ARCH), n_layers=2, d_model=32)
    tc = reduced(get_config(ARCH), n_layers=2, d_model=32)
    return (dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=1.0)),
        dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=1.0)))


_NP = {}


def _np_params():
    if not _NP:
        _NP["p"] = jax.device_get(jinit_params(jax.random.PRNGKey(0),
                                               _cfgs()[0]))
    return _NP["p"]


def _close(j, t):
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy()
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunk_step_routes_each_lane_on_its_own(chunk):
    """One [4, chunk] chunk step from empty caches, lanes with n_valid
    chunk, 5, 0 (an idle lane) and chunk: each valid lane's hidden states
    and last-position logits are those of JAX's batch-1 chunk on that
    lane, its greedy token JAX's; dispatched as one batch with the
    call's capacity (the engine's former behaviour) they are not."""
    jc, tc = _cfgs()
    npp = _np_params()
    jp, tp = jax.tree.map(jnp.asarray, npp), params_from_numpy(npp, "cpu")
    rng = np.random.default_rng(chunk)
    toks = rng.integers(0, tc.vocab_size, (SLOTS, chunk)).astype(np.int32)
    nv = np.asarray([chunk, 5, 0, chunk], np.int32)
    cache = init_cache(tc, SLOTS, 2 * chunk, device="cpu")
    cache["len"] = torch.zeros((SLOTS,), dtype=torch.int32)
    th, _, _ = forward(tc, tp, torch.from_numpy(toks), mode="chunk",
                       cache=cache, n_valid=torch.from_numpy(nv),
                       moe_per_lane=True)
    shared, _, _ = forward(tc, tp, torch.from_numpy(toks), mode="chunk",
                           cache=cache, n_valid=torch.from_numpy(nv))
    differs = False
    for i in range(SLOTS):
        n = int(nv[i])
        if n == 0:
            continue
        jh, _, _ = jforward(jc, jp, jnp.asarray(toks[i:i + 1]),
                            mode="chunk", cache=jinit_cache(jc, 1, 2 * chunk),
                            n_valid=jnp.int32(n))
        _close(jh[0, :n], th[i, :n])
        jl = jtf.logits_head(jc, jp, jh[:, n - 1:n])[0, -1]
        tl = logits_head(tc, tp, th[i:i + 1, n - 1:n])[0, -1]
        _close(jl, tl)
        assert int(jnp.argmax(jl)) == int(torch.argmax(tl))
        differs |= not np.allclose(shared[i, :n].numpy(),
                                   np.asarray(jh[0, :n]), rtol=0,
                                   atol=1e-3)
    assert differs, "no expert overflowed: the test would not see the fault"


def _banks_close(jtree, ttree):
    """JAX's bank stacks batch-1 caches ([slots, n_blocks, 1, ...],
    [slots, 1, ...]); compared in the port's layout ([n_blocks, slots,
    ...], [slots, ...])."""
    jl = []
    for p, x in jax.tree_util.tree_leaves_with_path(jtree):
        path = tuple(k.key for k in p)
        x = np.asarray(x)
        if path[0] == "blocks" and x.ndim > 2:
            x = x[:, :, 0].swapaxes(0, 1)
        elif path[0] == "tail" and x.ndim > 1:
            x = x[:, 0]
        jl.append((path, x))
    tl = list(zip(tree_key_paths(ttree), tree_leaves(ttree)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        b = b.float().numpy() if b.is_floating_point() else b.numpy()
        assert a.shape == b.shape, (path, a.shape, b.shape)
        scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL * scale,
                                   err_msg=str(path))


def _lane_tokens(eng):
    return [list(ln.tokens) if ln.active else None for ln in eng.lanes]


@pytest.mark.parametrize("chunk", [8, 16])
def test_engine_follows_jax_when_experts_overflow(chunk):
    """The chunked engine (4 slots) against JAX's, step by step: every
    lane's committed greedy tokens are JAX's and the bank within 1e-5 of
    JAX's; at the end, the same completions."""
    jc, tc = _cfgs()
    npp = _np_params()
    kw = dict(max_slots=SLOTS, prompt_len=16, max_new_tokens=6,
              queue_depth=16, prefill_chunk=chunk)
    je = JServeEngine(jc, JEngineConfig(**kw),
                      params=jax.tree.map(jnp.asarray, npp))
    te = ServeEngine(tc, EngineConfig(**kw),
                     params=params_from_numpy(npp, "cpu"), device="cpu")
    rng = np.random.default_rng(3)
    for i, L in enumerate([16, 9, 16, 12, 5, 16, 14]):
        p = rng.integers(0, tc.vocab_size, L).astype(np.int32)
        assert je.submit(JRequest(i, p)) and te.submit(Request(i, p))
    steps = 0
    while je.queue or any(ln.active for ln in je.lanes):
        je.step()
        te.step()
        steps += 1
        assert _lane_tokens(te) == _lane_tokens(je), steps
        _banks_close(je._caches, te._caches)
        assert steps < 100
    want = {c.rid: c.tokens.tolist() for c in je.completions}
    got = {c.rid: c.tokens.tolist() for c in te.completions}
    assert got == want
