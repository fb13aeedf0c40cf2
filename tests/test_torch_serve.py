"""The port's serving subsystem (``repro_torch/serve``,
``repro_torch/launch/serve.py``) on the CPU: every contract of the JAX
package's ``tests/test_serve.py`` and ``tests/test_paged_kv.py``, on an SSM
arch (mamba2-780m) and an attention arch (olmo-1b) where those tests
parametrize, held to the port's own bitwise pairs and to JAX's engine.

Tolerances: the engine pairs (hot swap vs no swap, paged vs dense,
chunked ragged admission vs blocking at fp32) are bitwise on tokens and
the serving checkpoints bitwise on weights; against JAX's engine, greedy
tokens equal from the same weights and prompts (the logits agree to 1e-5,
tests/test_torch_serve_model.py). A mean model materialized by each
package from the same checkpoint agrees within 1e-6 (fp32 means summed in
each library's order). At bf16, the chunked mamba engine is held to
JAX's step by step: SSM states within 5% of their largest magnitude, the
same dtypes, shape-signature counts and greedy tokens.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import init_params as jinit_params
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import export_serving_checkpoint as jexport
from repro.serve import load_serving_checkpoint as jload
from repro_torch.checkpoint import mean_model_tree, save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core import bucket as B
from repro_torch.core.exchange import GossipTransport
from repro_torch.models import init_cache
from repro_torch.models.attention import gather_pages
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.quant.codecs import make_codec
from repro_torch.serve import (CheckpointFollower, EngineConfig, LiveSource,
                               Request, ServeEngine,
                               export_serving_checkpoint,
                               load_serving_checkpoint)
from repro_torch.serve import paged as P
from repro_torch.serve.engine import grow_cache
from repro_torch.tree import (tree_flatten, tree_key_paths, tree_leaves,
                              tree_map)

try:                                   # property tests: hypothesis when
    from hypothesis import given, strategies as st      # available,
    _HYP = True                        # a deterministic grid otherwise
except ImportError:
    _HYP = False

SPECS = ["q8", "q4", "topk:0.25", "bf16"]
N_NODES = 4
CPU = "cpu"


def _cases(*pairs):
    """@given over the strategies, or a parametrized fallback grid."""
    names = [p[0] for p in pairs]
    if _HYP:
        return given(**{n: st.integers(lo, hi) for n, lo, hi in pairs})
    rng = np.random.default_rng(0)
    grid = [tuple(int(rng.integers(lo, hi + 1)) for _, lo, hi in pairs)
            for _ in range(8)]
    grid += [tuple(lo for _, lo, _hi in pairs)]
    if len(names) == 1:
        grid = [g[0] for g in grid]
    return pytest.mark.parametrize(",".join(names), grid)


def _cfg(arch="mamba2-780m", d_model=32, layers=2):
    return reduced(get_config(arch), n_layers=layers, d_model=d_model)


def _jcfg(arch="mamba2-780m", d_model=32, layers=2):
    return jreduced(jget_config(arch), n_layers=layers, d_model=d_model)


_NP_PARAMS = {}


def _np_params(arch="mamba2-780m", seed=0, d_model=32, layers=2):
    """JAX's init, drawn once per (arch, seed, width, depth) in this
    module; callers get copies (params_from_numpy copies)."""
    key = (arch, seed, d_model, layers)
    if key not in _NP_PARAMS:
        _NP_PARAMS[key] = jax.device_get(jinit_params(
            jax.random.PRNGKey(seed), _jcfg(arch, d_model, layers)))
    return _NP_PARAMS[key]


def _params(arch="mamba2-780m", seed=0, d_model=32, layers=2):
    """The JAX package's init, carried over: both packages serve the same
    weights."""
    return params_from_numpy(_np_params(arch, seed, d_model, layers), CPU)


def _stacked(params, n=N_NODES):
    return tree_map(lambda x: torch.stack([x + 0.01 * i for i in range(n)]),
                    params)


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _prompts(cfg, n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).astype(np.int32)
            for _ in range(n)]


def _ragged(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            for L in lens]


def _tokens(engine):
    return {c.rid: c.tokens.tolist() for c in engine.completions}


# ---------------------------------------------------------------------------
# Codec serving checkpoints: weight load == training-side decode, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_serving_checkpoint_bitwise_vs_training_decode(spec, tmp_path):
    """The persisted wire decodes to EXACTLY the buffer the training-side
    decode reconstructs from the same wire (WireCodec.decode, the plain
    decode_avg with its average off on the CPU), and the declared wire
    bytes are the arrays' bytes."""
    params = _params()
    path = str(tmp_path / "serving")
    n_bytes = export_serving_checkpoint(path, params, spec)
    loaded = load_serving_checkpoint(path, params)

    codec = make_codec(spec)
    flat = B.build_flat_layout(params, block=codec.block)
    buf = B.pack_flat(flat, params)
    gen = torch.Generator().manual_seed(0)
    wire = codec.encode(buf, torch.zeros_like(buf), gen)
    want = B.unpack_flat(flat, codec.decode(wire, torch.zeros_like(buf)))
    assert _trees_equal(loaded, want)
    assert n_bytes == codec.payload_num_bytes(flat.n_padded)


def test_serving_checkpoint_q_lattice_zero_reference_is_tight(tmp_path):
    params = _params()
    path = str(tmp_path / "s_q8")
    export_serving_checkpoint(path, params, "q8")
    loaded = load_serving_checkpoint(path, params)
    err = max(float(torch.max(torch.abs(a.float() - b.float())))
              for a, b in zip(tree_leaves(loaded), tree_leaves(params)))
    assert err < 0.25, err


def test_serving_checkpoint_rejects_wrong_model(tmp_path):
    path = str(tmp_path / "serving")
    export_serving_checkpoint(path, _params(), "q8")
    with pytest.raises(ValueError, match="n_padded"):
        load_serving_checkpoint(path, _params(d_model=64))


@pytest.mark.parametrize("spec", ["q8", "q4"])
def test_serving_checkpoint_crosses_packages_bitwise(spec, tmp_path):
    """A serving checkpoint written by JAX loads in the port bitwise equal
    to JAX's own load, and one written by the port loads in JAX bitwise
    equal to the port's load."""
    np_params = _np_params()
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, CPU)
    pj, pt = str(tmp_path / "by_jax"), str(tmp_path / "by_port")
    jexport(pj, jparams, spec)
    export_serving_checkpoint(pt, tparams, spec)
    for path in (pj, pt):
        want = jax.device_get(jload(path, jparams))
        got = params_to_numpy(load_serving_checkpoint(path, tparams))
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            assert np.array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# Live source and checkpoint follower
# ---------------------------------------------------------------------------


def test_live_source_bitwise_vs_mean_model_tree():
    stacked = _stacked(_params())
    src = LiveSource(GossipTransport(N_NODES))
    src.publish(stacked, t_landed=1.0)
    upd = src.poll()
    assert upd.t_landed == 1.0 and upd.version == 1
    assert _trees_equal(upd.params, mean_model_tree(stacked))
    assert src.poll() is None          # consumed
    src.publish(stacked)
    src.publish(stacked)               # newest wins between polls
    assert src.poll().version == 3


def test_follower_plain_and_codec_state_checkpoints(tmp_path):
    params = _params()
    stacked = _stacked(params)
    mu = mean_model_tree(stacked)
    save_checkpoint(str(tmp_path / "step_000002"), stacked,
                    {"arch": "mamba2-780m", "nodes": N_NODES})
    fol = CheckpointFollower(str(tmp_path), params, N_NODES, device=CPU)
    upd = fol.poll()
    assert upd is not None and _trees_equal(upd.params, mu)
    assert fol.poll() is None

    save_checkpoint(str(tmp_path / "step_000004"),
                    {"params": stacked, "prev": stacked},
                    {"arch": "mamba2-780m", "nodes": N_NODES,
                     "codec": {"spec": "q8", "state": ["params", "prev"]}})
    upd = fol.poll()
    assert upd is not None and upd.version == 2
    assert _trees_equal(upd.params, mu)


def test_follower_compress_state_and_residual_checkpoints(tmp_path):
    """A --compress-state checkpoint stores `prev` as the codec WIRE
    tuple; an error-feedback one adds a residual: the follower builds the
    matching template from the metadata and serves the params' mean."""
    params = _params()
    stacked = _stacked(params)
    codec = make_codec("q8")
    layout = B.build_layout(stacked, block=codec.block)
    prev = codec.encode_state(B.pack(layout, stacked),
                              torch.Generator().manual_seed(3))
    save_checkpoint(str(tmp_path / "step_000002"),
                    {"params": stacked, "prev": prev},
                    {"nodes": N_NODES,
                     "codec": {"spec": "q8", "state": ["params", "prev"],
                               "compress_state": True}})
    fol = CheckpointFollower(str(tmp_path), params, N_NODES, device=CPU)
    upd = fol.poll()
    assert upd is not None
    assert _trees_equal(upd.params, mean_model_tree(stacked))
    save_checkpoint(str(tmp_path / "step_000004"),
                    {"params": stacked, "prev": stacked,
                     "residual": torch.zeros((N_NODES, layout.n_padded))},
                    {"nodes": N_NODES,
                     "codec": {"spec": "topk:0.25",
                               "state": ["params", "prev", "residual"]}})
    assert _trees_equal(fol.poll().params, mean_model_tree(stacked))


def test_follower_newest_wins_and_skips_half_written(tmp_path):
    params = _params()
    fol = CheckpointFollower(str(tmp_path), params, N_NODES, device=CPU)
    assert fol.poll() is None          # empty dir
    s1 = _stacked(params)
    s2 = tree_map(lambda x: x * 2.0, s1)
    save_checkpoint(str(tmp_path / "step_000001"), s1, {"nodes": N_NODES})
    save_checkpoint(str(tmp_path / "step_000002"), s2, {"nodes": N_NODES})
    upd = fol.poll()                   # both fresh: newest only
    assert upd.tag.endswith("step_000002")
    assert _trees_equal(upd.params, mean_model_tree(s2))
    assert fol.poll() is None          # step_000001 is stale, not pending
    # json without npz: skipped; an npz cut short mid-write: retried
    (tmp_path / "step_000003.json").write_text(json.dumps({"nodes": 4}))
    assert fol.poll() is None
    (tmp_path / "step_000004.npz").write_bytes(b"PK\x03\x04 truncated")
    (tmp_path / "step_000004.json").write_text(
        json.dumps({"metadata": {"nodes": 4}}))
    assert fol.poll() is None


def test_follower_rejects_node_mismatch(tmp_path):
    params = _params()
    save_checkpoint(str(tmp_path / "step_000001"), _stacked(params),
                    {"nodes": N_NODES})
    fol = CheckpointFollower(str(tmp_path), params, N_NODES + 1, device=CPU)
    with pytest.raises(ValueError, match="nodes"):
        fol.poll()


def test_follower_follows_a_jax_run_dir(tmp_path, capsys, monkeypatch):
    """The port's follower materializes the mean model of every
    checkpoint JAX's training driver lands (a quantized run: codec-state
    checkpoints), as JAX's follower does, within 1e-6."""
    from repro.launch.train import main as jtrain_main
    from repro.serve import CheckpointFollower as JFollower
    run_dir = str(tmp_path / "run")
    for var in ("REPRO_AVAIL_PROFILE", "REPRO_SCAN_CHUNK", "REPRO_TOPOLOGY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "mamba2-780m", "--reduced", "--layers", "1",
        "--d-model", "32", "--nodes", "4", "--steps", "4", "--batch", "1",
        "--seq", "16", "--quantize", "--ckpt", run_dir, "--ckpt-every", "2",
        "--log-every", "2"])
    jtrain_main()
    capsys.readouterr()
    like_np = _np_params(layers=1)
    jfol = JFollower(run_dir, jax.tree.map(jnp.asarray, like_np), 4)
    tfol = CheckpointFollower(run_dir, params_from_numpy(like_np, CPU), 4,
                              device=CPU)
    want, got = jfol.poll(), tfol.poll()
    assert got.tag.endswith("step_000004") and want.tag == got.tag
    for a, b in zip(jax.tree.leaves(want.params), tree_leaves(got.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# grow_cache: structural mismatch raises with the leaf path
# ---------------------------------------------------------------------------


def test_grow_cache_raises_on_rank_mismatch():
    cfg = _cfg()
    small = init_cache(cfg, 1, 8, device="cpu")
    full = init_cache(cfg, 1, 16, device="cpu")
    grown = grow_cache(full, small)
    assert tree_flatten(grown)[1] == tree_flatten(full)[1]
    broken = tree_map(lambda x: x[None] if x.ndim > 2 else x, small)
    with pytest.raises(ValueError, match="rank mismatch") as ei:
        grow_cache(full, broken)
    assert "[" in str(ei.value), str(ei.value)


# ---------------------------------------------------------------------------
# Hot swap: atomic, monotone, in-flight finishes bitwise on its generation
# ---------------------------------------------------------------------------


def _jax_engine_tokens(arch, ecfg_kw, params_np, prompts, *, swap=None):
    """JAX's engine on the same weights and prompts (greedy); `swap`
    = (params_np, steps before the publish, prompts submitted after)."""
    jc = _jcfg(arch)
    eng = JServeEngine(jc, JEngineConfig(**ecfg_kw),
                       params=jax.tree.map(jnp.asarray, params_np))
    for i, p in enumerate(prompts):
        eng.submit(JRequest(i, p))
    if swap is not None:
        new, steps, later = swap
        for _ in range(steps):
            eng.step()
        eng.swap.publish(jax.tree.map(jnp.asarray, new), tag="B")
        for i, p in enumerate(later, start=len(prompts)):
            eng.submit(JRequest(i, p))
    eng.drain()
    return {c.rid: (c.tokens.tolist(), c.gen) for c in eng.completions}


@pytest.mark.parametrize("arch", ["mamba2-780m", "olmo-1b"])
def test_hot_swap_in_flight_bitwise(arch):
    """Swap mid-generation: lanes admitted before the swap finish on the
    OLD params bitwise (vs a run that never swaps); lanes admitted after
    run on the new generation; tags are monotone; no new shape signature;
    nothing dropped — and JAX's engine gives the same tokens."""
    cfg = _cfg(arch)
    npA, npB = _np_params(arch, 0), _np_params(arch, 1)
    pA, pB = params_from_numpy(npA, CPU), params_from_numpy(npB, CPU)
    prompts = _prompts(cfg, 4, 8)
    kw = dict(max_slots=2, prompt_len=8, max_new_tokens=6)

    e1 = ServeEngine(cfg, EngineConfig(**kw), params=pA, device=CPU)
    e1.submit(Request(0, prompts[0]))
    e1.submit(Request(1, prompts[1]))
    e1.drain()
    base = _tokens(e1)

    e2 = ServeEngine(cfg, EngineConfig(**kw), params=pA, device=CPU)
    e2.submit(Request(0, prompts[0]))
    e2.submit(Request(1, prompts[1]))
    e2.step()
    e2.step()                                     # 0,1 mid-flight
    assert e2.swap.publish(pB, tag="B") == 2      # monotone tag
    e2.submit(Request(2, prompts[2]))
    e2.submit(Request(3, prompts[3]))
    e2.drain()
    got = {c.rid: (c.tokens.tolist(), c.gen) for c in e2.completions}
    assert got[0] == (base[0], 1) and got[1] == (base[1], 1)
    assert got[2][1] == 2 and got[3][1] == 2
    s = e2.metrics.summary()
    assert s["dropped_in_flight"] == 0
    assert s["decode_cache_misses"] == 0
    assert s["completed"] == 4 and s["swaps_adopted"] == 2
    assert got == _jax_engine_tokens(arch, kw, npA, prompts[:2],
                                     swap=(npB, 2, prompts[2:]))


def test_swap_generations_monotone_and_newest_wins():
    cfg = _cfg()
    eng = ServeEngine(cfg, EngineConfig(max_slots=1, prompt_len=4),
                      params=_params(seed=0), device=CPU)
    assert eng.swap.generation == 1
    eng.swap.publish(_params(seed=1))
    eng.swap.publish(_params(seed=2))    # replaces unadopted gen 2
    gen, _ = eng.swap.latest()
    assert gen == 3
    eng.step()
    assert eng.adopted_gen == 3          # never adopted the skipped gen


# ---------------------------------------------------------------------------
# Admission control: bounded queue, rejects counted, nothing lost
# ---------------------------------------------------------------------------


def test_admission_bounds_and_backpressure():
    cfg = _cfg()
    ecfg = EngineConfig(max_slots=2, prompt_len=4, max_new_tokens=3,
                        queue_depth=3)
    eng = ServeEngine(cfg, ecfg, params=_params(), device=CPU)
    prompts = _prompts(cfg, 8, 4)
    accepted = [eng.submit(Request(i, prompts[i])) for i in range(8)]
    assert accepted == [True] * 3 + [False] * 5
    s = eng.metrics.summary()
    assert s["rejected"] == 5 and s["submitted"] == 3
    assert s["queue_depth_max"] <= ecfg.queue_depth
    eng.drain()
    s = eng.metrics.summary()
    assert s["completed"] == 3 and s["dropped_in_flight"] == 0
    assert len(eng.completions) == 3
    assert eng.submit(Request(99, prompts[0]))    # backpressure clears
    eng.drain()
    assert eng.metrics.completed == 4


# ---------------------------------------------------------------------------
# Paged KV + chunked prefill
# ---------------------------------------------------------------------------


@_cases(("n_pages", 1, 64), ("seed", 0, 10_000))
def test_allocator_roundtrip_and_no_aliasing(n_pages, seed):
    rng = np.random.default_rng(seed)
    alloc = P.PageAllocator(n_pages)
    grants = []
    for _ in range(50):
        if grants and rng.random() < 0.4:
            alloc.free(grants.pop(rng.integers(len(grants))))
        else:
            got = alloc.alloc(int(rng.integers(1, n_pages + 2)))
            if got is not None:
                grants.append(got)
        live = [p for g in grants for p in g]
        assert len(live) == len(set(live))
        assert alloc.in_use == len(live)
        assert alloc.free_count + alloc.in_use == n_pages
    for g in grants:
        alloc.free(g)
    assert alloc.free_count == n_pages and alloc.in_use == 0


@_cases(("n_pages", 1, 16))
def test_allocator_exhaustion_is_rejection_not_corruption(n_pages):
    alloc = P.PageAllocator(n_pages)
    grant = alloc.alloc(n_pages)
    assert grant is not None and len(grant) == n_pages
    before = (alloc.free_count, alloc.in_use)
    assert alloc.alloc(1) is None
    assert (alloc.free_count, alloc.in_use) == before
    alloc.free(grant)
    assert alloc.alloc(n_pages + 1) is None
    assert alloc.free_count == n_pages


def test_allocator_double_free_asserts():
    alloc = P.PageAllocator(4)
    g = alloc.alloc(2)
    alloc.free(g)
    with pytest.raises(AssertionError, match="double free"):
        alloc.free(g)


def test_scatter_then_gather_is_contiguous_identity():
    """Rows scattered through two lanes' page tables (one mid-sequence,
    one length-masked past its table) gather back as exactly the
    contiguous prefix of each lane's cache; masked lanes commit nothing."""
    page, kvh, hd = 4, 2, 5
    pool = torch.zeros((8, page, kvh, hd))
    rng = np.random.default_rng(0)
    tables = torch.tensor([[5, 1, 7], [2, 6, 0]], dtype=torch.int32)
    lens = torch.tensor([0, 9])
    T = 6
    rows = torch.from_numpy(rng.normal(size=(2, T, kvh, hd))
                            .astype(np.float32))
    n_valid = torch.tensor([T, 3])        # lane 1: tokens 3.. beyond table
    pool = P.scatter_rows(pool, rows, tables, lens, n_valid,
                          torch.tensor([True, True]), page)
    for b, (ln, nv) in enumerate([(0, T), (9, 3)]):
        got = gather_pages(pool, tables[b])[0]
        assert torch.equal(got[ln:ln + nv], rows[b, :nv])
    before = pool.clone()
    pool = P.scatter_rows(pool, rows, tables, lens, n_valid,
                          torch.tensor([False, False]), page)
    assert torch.equal(pool, before)


def _run(arch, lens, seed=0, params=None, **kw):
    cfg = _cfg(arch)
    ecfg = EngineConfig(max_slots=2, prompt_len=8, max_new_tokens=8,
                        queue_depth=16, seed=seed, **kw)
    eng = ServeEngine(cfg, ecfg, params=params or _params(arch), device=CPU)
    for i, p in enumerate(_ragged(cfg, lens)):
        assert eng.submit(Request(i, p))
    eng.drain()
    return eng


@pytest.mark.parametrize("arch", ["mamba2-780m", "olmo-1b"])
def test_ragged_admission_chunked_matches_blocking(arch):
    """Ragged prompts complete under every engine mode; greedy chunked
    output matches the blocking oracle (and JAX's engine), chunked
    admission adds no shape signature, and paged == dense bitwise."""
    lens = [3, 8, 5, 1, 7]
    base = _tokens(_run(arch, lens))                 # dense blocking oracle
    chunked = _run(arch, lens, prefill_chunk=4)
    assert _tokens(chunked) == base
    s = chunked.metrics.summary()
    assert s["completed"] == len(lens)
    assert s["prefill_cache_misses"] == 0
    assert s["decode_cache_misses"] == 0
    paged = _run(arch, lens, prefill_chunk=4, paged=True, page_size=4)
    assert _tokens(paged) == _tokens(chunked)
    want = _jax_engine_tokens(
        arch, dict(max_slots=2, prompt_len=8, max_new_tokens=8,
                   queue_depth=16, prefill_chunk=4, paged=False),
        _np_params(arch), _ragged(_cfg(arch), lens))
    assert {r: t for r, (t, _) in want.items()} == base


def _ssm_banks(eng, jax_engine: bool):
    """The engine bank's SSM leaves, in the port's [n_blocks, slots, ...]
    layout (JAX's bank stacks batch-1 caches: [slots, n_blocks, 1, ...])."""
    if jax_engine:
        return [x[:, :, 0].swapaxes(0, 1) for p, x in
                jax.tree_util.tree_leaves_with_path(eng._caches)
                if "ssm" in jax.tree_util.keystr(p)]
    return [x for p, x in zip(tree_key_paths(eng._caches),
                              tree_leaves(eng._caches)) if "ssm" in p]


def test_bf16_chunked_mamba_bank_follows_jax():
    """At bf16 the bank's SSM state starts in bf16 and widens to fp32 at
    the first decode, as JAX's does, so chunked prefill before it rounds
    the state to bf16 between chunks as JAX's does. Held to JAX's engine
    step by step on ragged prompts: the SSM leaves' dtypes equal before
    and after every step, the states within 5% of their largest magnitude
    (bf16 activations in two libraries), the same shape-signature counts
    (1 and 1: the widening) and the same greedy tokens."""
    import dataclasses
    jc = dataclasses.replace(_jcfg(), dtype="bfloat16")
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    npp = jax.device_get(jinit_params(jax.random.PRNGKey(0), jc))
    kw = dict(max_slots=2, prompt_len=8, max_new_tokens=8, queue_depth=16,
              prefill_chunk=4)
    je = JServeEngine(jc, JEngineConfig(paged=False, **kw),
                      params=jax.tree.map(jnp.asarray, npp))
    te = ServeEngine(cfg, EngineConfig(**kw),
                     params=params_from_numpy(npp, CPU), device=CPU)
    for i, p in enumerate(_ragged(cfg, [3, 8, 5, 1, 7])):
        je.submit(JRequest(i, p))
        te.submit(Request(i, p))
    assert [str(x.dtype) for x in _ssm_banks(je, True)] == \
        [str(x.dtype).removeprefix("torch.") for x in _ssm_banks(te, False)] \
        == ["bfloat16"]
    for _ in range(100):
        if not je.queue and not any(ln.active for ln in je.lanes):
            break
        je.step()
        te.step()
        for a, b in zip(_ssm_banks(je, True), _ssm_banks(te, False)):
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
            a = np.asarray(a.astype(jnp.float32))
            err = np.abs(a - b.float().numpy()).max()
            assert err <= 0.05 * np.abs(a).max(), (err, np.abs(a).max())
    assert not te.queue and not any(ln.active for ln in te.lanes)
    js, ts = je.metrics.summary(), te.metrics.summary()
    for k in ("decode_cache_misses", "prefill_cache_misses"):
        assert js[k] == ts[k] == 1, (k, js[k], ts[k])
    assert _tokens(te) == {c.rid: c.tokens.tolist() for c in je.completions}


@pytest.mark.parametrize("arch", ["mamba2-780m", "olmo-1b"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_paged_engine_bitwise_vs_dense_across_hot_swap(arch, chunk):
    """The paged engine's SAMPLED token stream (temperature 0.7, the
    engine's seeded generator) is bit for bit the dense engine's across
    admissions, retirements and a mid-run hot swap, under the same
    prefill schedule, with no new shape signature; every retire frees its
    pages."""
    cfg = _cfg(arch)
    pA, pB = _params(arch, 0), _params(arch, 1)
    prompts = _prompts(cfg, 6, 8)
    kw = dict(max_slots=2, prompt_len=8, max_new_tokens=8,
              temperature=0.7, prefill_chunk=chunk)

    def run(**extra):
        eng = ServeEngine(cfg, EngineConfig(**kw, **extra), params=pA,
                          device=CPU)
        for i in range(4):
            eng.submit(Request(i, prompts[i]))
        eng.step()
        eng.step()
        eng.swap.publish(pB, tag="B")
        eng.submit(Request(4, prompts[4]))
        eng.submit(Request(5, prompts[5]))
        eng.drain()
        return eng

    dense = run(paged=False)
    paged = run(paged=True, page_size=4)     # 4 divides kv_capacity 16
    got_d = {c.rid: (c.tokens.tolist(), c.gen) for c in dense.completions}
    got_p = {c.rid: (c.tokens.tolist(), c.gen) for c in paged.completions}
    assert got_p == got_d and len(got_p) == 6
    assert got_d == {c.rid: (c.tokens.tolist(), c.gen)
                     for c in run(paged=False).completions}  # seeded
    for eng in (dense, paged):
        s = eng.metrics.summary()
        assert s["decode_cache_misses"] == 0
        assert s["prefill_cache_misses"] == 0
        assert s["dropped_in_flight"] == 0 and s["swaps_adopted"] == 2
    if paged.allocator is not None:          # pure-SSM archs run dense
        assert paged.allocator.in_use == 0
    assert len(dense.metrics.ttft_s) == 6
    assert len(dense.metrics.queue_wait_s) == 6


def test_pool_exhaustion_defers_then_completes():
    cfg = _cfg("olmo-1b")
    params = _params("olmo-1b")
    ecfg = EngineConfig(max_slots=2, prompt_len=8, max_new_tokens=8,
                        queue_depth=16, paged=True, page_size=4, n_pages=4)
    assert ecfg.pages_per_lane == 4                  # = the whole pool
    eng = ServeEngine(cfg, ecfg, params=params, device=CPU)
    for i, p in enumerate(_ragged(cfg, [8, 8, 8])):
        assert eng.submit(Request(i, p))
    eng.drain()
    s = eng.metrics.summary()
    assert s["completed"] == 3 and s["rejected"] == 0
    assert s["pool_deferrals"] > 0
    assert s["dropped_in_flight"] == 0
    assert eng.allocator.in_use == 0
    free = _run("olmo-1b", [8, 8, 8], params=params, paged=True,
                page_size=4)
    assert _tokens(eng) == _tokens(free)


def test_oversize_prompt_raises():
    cfg = _cfg()
    ecfg = EngineConfig(max_slots=1, prompt_len=8, max_new_tokens=8)
    eng = ServeEngine(cfg, ecfg, params=_params(), device=CPU)
    eng.submit(Request(0, np.zeros(12, np.int32)))   # 12 + 8 > 16
    with pytest.raises(ValueError, match="kv_capacity"):
        eng.step()


def test_paged_pool_smaller_than_dense_bank_at_half_occupancy():
    cfg = _cfg("olmo-1b")
    ecfg = EngineConfig(max_slots=4, prompt_len=8, max_new_tokens=8,
                        paged=True, page_size=4, n_pages=2 * (16 // 4))
    eng = ServeEngine(cfg, ecfg, params=_params("olmo-1b"), device=CPU)
    s = eng.metrics.summary()
    assert 0 < s["kv_bytes"] < s["kv_dense_bytes"]
    assert s["kv_bytes"] * 2 == s["kv_dense_bytes"]


# ---------------------------------------------------------------------------
# CLI: one-shot oracle, train -> follow, compress_state follow, --weights
# ---------------------------------------------------------------------------


def _serve_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{\"serve\"")][0])["serve"]


@pytest.mark.parametrize("arch", ["mamba2-780m", "olmo-1b"])
def test_serve_cli_oneshot(arch, capsys):
    from repro_torch.launch.serve import main
    res = main(["--device", "cpu", "--arch", arch, "--reduced", "--layers",
                "1", "--d-model", "32", "--batch", "2", "--prompt-len", "8",
                "--gen", "4"])
    out = capsys.readouterr().out
    assert "generated tokens" in out and f"arch={arch}" in out
    assert res["tokens"].shape == (2, 4)


def test_serve_cli_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        main(["--arch", "mamba2-780m", "--reduced"])
    assert "--device cpu" in str(ei.value.code)


def test_train_ckpt_every_then_serve_follow_cli(tmp_path, capsys):
    """End to end: the port's scan-chunked training run lands step-stamped
    checkpoints in a dir; the serve CLI follows it, adopts the swarm mean
    and answers requests with the serving contract intact."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    run_dir = str(tmp_path / "run")
    train_main(["--device", "cpu", "--arch", "mamba2-780m", "--reduced",
                "--layers", "1", "--d-model", "32", "--nodes", "4",
                "--steps", "4", "--batch", "1", "--seq", "16",
                "--scan-chunk", "2", "--ckpt", run_dir, "--ckpt-every", "2",
                "--log-every", "2"])
    capsys.readouterr()
    names = sorted(os.listdir(run_dir))
    assert "step_000002.json" in names and "step_000004.npz" in names
    serve_main(["--device", "cpu", "--arch", "mamba2-780m", "--reduced",
                "--layers", "1", "--d-model", "32", "--source", "follow",
                "--follow", run_dir, "--nodes", "4", "--prompt-len", "8",
                "--gen", "4", "--requests", "2", "--slots", "2",
                "--wait-s", "10"])
    rec = _serve_line(capsys.readouterr().out)
    assert rec["completed"] == 2 and rec["dropped_in_flight"] == 0
    assert rec["decode_cache_misses"] == 0
    assert rec["swaps_adopted"] >= 1


def test_train_compress_state_then_serve_follow_cli(tmp_path, capsys):
    """A hierarchical --compress-state run checkpoints its wire-tuple
    codec state; serve --follow (paged, chunked prefill on an attention
    arch) materializes the mean and serves."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    run_dir = str(tmp_path / "run")
    common = ["--device", "cpu", "--arch", "olmo-1b", "--reduced",
              "--layers", "1", "--d-model", "32", "--nodes", "4"]
    train_main(common + ["--steps", "4", "--batch", "1", "--seq", "16",
                         "--quantize", "--codec", "q8", "--compress-state",
                         "--rate-profile", "uniform_async", "--topology",
                         "hier:2", "--ckpt", run_dir, "--ckpt-every", "2",
                         "--log-every", "2"])
    capsys.readouterr()
    meta = json.loads((tmp_path / "run" / "step_000004.json").read_text()
                      )["metadata"]
    assert meta["codec"]["compress_state"] is True
    assert "prev" in meta["codec"]["state"]
    serve_main(common + ["--source", "follow", "--follow", run_dir,
                         "--prompt-len", "8", "--gen", "4", "--requests",
                         "3", "--slots", "2", "--wait-s", "10", "--paged",
                         "--page-size", "4", "--prefill-chunk", "4"])
    rec = _serve_line(capsys.readouterr().out)
    assert rec["completed"] == 3 and rec["dropped_in_flight"] == 0
    assert rec["swaps_adopted"] >= 1 and rec["prefill_cache_misses"] == 0
    assert rec["kv_bytes"] > 0


def test_serve_cli_weights_roundtrip(tmp_path, capsys):
    """--weights feeds a codec serving checkpoint into the one-shot path;
    greedy generation under the decoded weights is deterministic."""
    from repro_torch.launch.serve import main as serve_main
    path = str(tmp_path / "weights")
    export_serving_checkpoint(path, _params(seed=7, layers=1), "q4")
    argv = ["--device", "cpu", "--arch", "mamba2-780m", "--reduced",
            "--layers", "1", "--d-model", "32", "--batch", "1",
            "--prompt-len", "8", "--gen", "4", "--weights", path]
    r1, r2 = serve_main(argv), serve_main(argv)
    out = capsys.readouterr().out
    assert np.array_equal(r1["tokens"], r2["tokens"])
    assert out.count("generated tokens") == 2


def test_serve_cli_live(capsys):
    """--source live: the port's trainer publishes its mean every
    superstep; requests are served across more than one generation."""
    from repro_torch.launch.serve import main as serve_main
    done, rec = serve_main(["--device", "cpu", "--arch", "olmo-1b",
                            "--reduced", "--layers", "1", "--d-model", "32",
                            "--source", "live", "--nodes", "4",
                            "--live-steps", "4", "--requests", "4",
                            "--prompt-len", "8", "--gen", "4"])
    assert rec["completed"] == 4 and rec["dropped_in_flight"] == 0
    assert len({c.gen for c in done}) > 1
    assert "across model generations" in capsys.readouterr().out
