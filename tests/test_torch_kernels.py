"""The port's kernel modules against the JAX package, on the CPU.

* ``repro_torch.kernels.ref`` (the plain versions the CUDA kernels are held
  against on the card) equals ``repro.kernels.ref`` run eagerly BITWISE:
  codes, scales and floats, over ragged sizes, bits 2/4/8/12/16, nibble
  packing, matched masks, ``average=False``, bf16 receivers, and SGD with
  momentum / weight decay / Nesterov.
* The ``ops`` wrappers (padding, dispatch) equal the JAX wrappers, whose
  Pallas kernels run in interpret mode.
* Dispatch is by device only: a CPU tensor launches nothing; a tensor on
  any other device raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SIZES = [256 * 8, 1000, 256 * 3 + 17, 5]


def _inputs(seed, rows, spread=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    ref = (x + spread * rng.standard_normal((rows, 256))).astype(np.float32)
    u = rng.random((rows, 256), dtype=np.float32)
    return x, ref, u


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp_np(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("bits,pack4", [(2, False), (2, True), (4, False),
                                        (4, True), (8, False), (12, False),
                                        (16, False)])
def test_quantize_plain_bitwise(bits, pack4):
    x, ref, u = _inputs(bits, 24)
    jq, js = jref.quantize_mod_ref(jnp.asarray(x), jnp.asarray(ref),
                                   jnp.asarray(u), bits=bits, pack4=pack4)
    tq, ts = tref.quantize_mod(_t(x), _t(ref), _t(u), bits=bits, pack4=pack4)
    assert _np(tq).dtype == np.asarray(jq).dtype
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


@pytest.mark.parametrize("bits", [2, 4, 8, 12, 16])
@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("y_dtype", ["float32", "bfloat16"])
def test_decode_plain_bitwise(bits, average, masked, y_dtype):
    pack4 = bits <= 4
    x, ref, u = _inputs(100 + bits, 16, spread=0.02)
    jq, js = jref.quantize_mod_ref(jnp.asarray(x), jnp.asarray(ref),
                                   jnp.asarray(u), bits=bits, pack4=pack4)
    tq, ts = tref.quantize_mod(_t(x), _t(ref), _t(u), bits=bits, pack4=pack4)
    # the receiver holds the sender's reference model
    jy = jnp.asarray(ref).astype(y_dtype)
    ty = _t(ref).to(getattr(torch, y_dtype))
    matched = np.arange(16) % 3 != 0 if masked else None
    jout = jref.decode_avg_ref(jq, js, jy, bits=bits, average=average,
                               matched=None if matched is None
                               else jnp.asarray(matched), pack4=pack4)
    tout = tref.decode_avg(tq, ts, ty, bits=bits, average=average,
                           matched=None if matched is None else _t(matched),
                           pack4=pack4)
    assert tout.dtype == ty.dtype
    np.testing.assert_array_equal(_np(tout), _jnp_np(jout))


def test_decode_plain_extreme_values_bitwise():
    """Large |y/s| (codes far beyond 2^24) and exact .5 ties of y/s: the
    floor-mod and half-to-even rounding must agree exactly."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 256, (8, 256)).astype(np.uint8)
    s = np.full((8, 1), 1e-6, np.float32)
    s[4:] = 0.5
    y = (rng.standard_normal((8, 256)) * 50).astype(np.float32)
    y[4:, :64] = np.arange(64, dtype=np.float32) * 0.25   # y/s = k/2 ties
    jout = jref.decode_avg_ref(jnp.asarray(q), jnp.asarray(s), jnp.asarray(y))
    tout = tref.decode_avg(_t(q), _t(s), _t(y))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("mu,wd,nesterov", [(0.9, 0.0, False),
                                            (0.9, 1e-4, False),
                                            (0.9, 5e-4, True),
                                            (0.0, 0.0, False)])
@pytest.mark.parametrize("lr_tensor", [False, True])
def test_sgd_plain_bitwise(mu, wd, nesterov, lr_tensor):
    rng = np.random.default_rng(3)
    p, g, m = (rng.standard_normal((16, 512)).astype(np.float32)
               for _ in range(3))
    lr = 0.05
    jp, jm = jref.sgd_update_ref(jnp.asarray(p), jnp.asarray(g),
                                 jnp.asarray(m), lr=lr, mu=mu, wd=wd,
                                 nesterov=nesterov)
    tlr = torch.tensor(lr, dtype=torch.float32) if lr_tensor else lr
    tp, tm = tref.sgd_update(_t(p), _t(g), _t(m), lr=tlr, mu=mu, wd=wd,
                             nesterov=nesterov)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_nibble_pack_roundtrip():
    q = torch.from_numpy(np.random.default_rng(0).integers(
        0, 16, (4, 256)).astype(np.uint8))
    packed = tref.pack_nibbles(q)
    assert packed.shape == (4, 128)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jref.pack_nibbles_ref(
                                      jnp.asarray(q.numpy()))))
    assert torch.equal(tref.unpack_nibbles(packed), q)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_ops_wrappers_match_jax_interpret(size, bits):
    """The wrappers' padding and un-padding, against the JAX wrappers with
    their Pallas kernels in interpret mode."""
    rng = np.random.default_rng(size + bits)
    x = rng.standard_normal(size).astype(np.float32)
    ref = (x + 0.05 * rng.standard_normal(size)).astype(np.float32)
    n_rows = -(-(-(-size // 256)) // 8) * 8
    u = rng.random(n_rows * 256, dtype=np.float32)[:size]
    pack4 = bits <= 4
    jq, js, jpad = jops.quantize_mod(jnp.asarray(x), jnp.asarray(ref),
                                     jnp.asarray(u), bits=bits, pack4=pack4,
                                     backend="interpret")
    tq, ts, tpad = tops.quantize_mod(_t(x), _t(ref), _t(u), bits=bits,
                                     pack4=pack4)
    assert tpad == jpad
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    y = ref
    matched = (np.arange(tq.shape[0]) % 2).astype(np.float32)
    jout = jops.decode_avg(jq, js, jnp.asarray(y), bits=bits, pack4=pack4,
                           matched=jnp.asarray(matched), backend="interpret")
    tout = tops.decode_avg(tq, ts, _t(y), bits=bits, pack4=pack4,
                           matched=_t(matched))
    assert tout.shape == (size,)
    # interpret mode compiles the kernel body, and XLA contracts its
    # (qy + d) * s + y into FMAs: ~1 ulp apart from eager arithmetic
    # (a few ulp of the operands, which are O(1) here)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)
    # the plain path itself is the eager reference, bitwise
    rout = jops.decode_avg(jq, js, jnp.asarray(y), bits=bits, pack4=pack4,
                           matched=jnp.asarray(matched), backend="ref")
    np.testing.assert_array_equal(tout.numpy(), np.asarray(rout))


@pytest.mark.parametrize("size", SIZES)
def test_sgd_wrapper_matches_jax_interpret(size):
    rng = np.random.default_rng(size)
    p, g, m = (rng.standard_normal(size).astype(np.float32) for _ in range(3))
    jp, jm = jops.sgd_fused_update(jnp.asarray(p), jnp.asarray(g),
                                   jnp.asarray(m), lr=0.1, mu=0.9, wd=1e-4,
                                   backend="interpret")
    tp, tm = tops.sgd_fused_update(_t(p), _t(g), _t(m),
                                   lr=torch.tensor(0.1), mu=0.9, wd=1e-4)
    # interpret mode contracts mu*m + g and p - lr*step into FMAs: a few
    # ulp of the O(1) operands
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    # the plain path itself is the eager reference, bitwise
    rp, rm = jops.sgd_fused_update(jnp.asarray(p), jnp.asarray(g),
                                   jnp.asarray(m), lr=0.1, mu=0.9, wd=1e-4,
                                   backend="ref")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_inplace_equals_out_of_place(nesterov):
    """inplace=True writes p' into p and m' into m, returns those tensors,
    and is bitwise the out-of-place update; a size that needs a padded
    copy is refused."""
    rng = np.random.default_rng(7)
    p, g, m = (_t(rng.standard_normal(4096 * 3).astype(np.float32))
               for _ in range(3))
    lr = torch.tensor(0.1)
    want_p, want_m = tops.sgd_fused_update(p, g, m, lr=lr, mu=0.9, wd=1e-4,
                                           nesterov=nesterov)
    p2, m2 = p.clone(), m.clone()
    got_p, got_m = tops.sgd_fused_update(p2, g, m2, lr=lr, mu=0.9, wd=1e-4,
                                         nesterov=nesterov, inplace=True)
    assert got_p.data_ptr() == p2.data_ptr()
    assert got_m.data_ptr() == m2.data_ptr()
    np.testing.assert_array_equal(p2.numpy(), want_p.numpy())
    np.testing.assert_array_equal(m2.numpy(), want_m.numpy())
    with pytest.raises(ValueError, match="whole number"):
        tops.sgd_fused_update(p[:1000], g[:1000], m[:1000], lr=lr,
                              inplace=True)


def test_cpu_tensors_launch_nothing():
    tops.reset_launch_counts()
    x = torch.randn(1000)
    q, s, _ = tops.quantize_mod(x, x * 0.9, torch.rand(1000))
    tops.decode_avg(q, s, x)
    tops.sgd_fused_update(x, x, x, lr=0.1)
    assert tops.LAUNCHES == {"sgd_update": 0, "quantize_mod": 0,
                             "decode_avg": 0}


def test_other_devices_raise():
    x = torch.empty(512, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tops.quantize_mod(x, x, x)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tops.sgd_fused_update(x, x, x, lr=0.1)


def test_build_plan_is_keyed_by_source_and_flags(tmp_path):
    """The libraries are named by a hash of source + flags, one per kernel,
    compiled for sm_90a with contraction off and never fast math."""
    names = set(tbuild.KERNELS)
    assert names == {"sgd_update", "quantize_mod", "decode_avg"}
    paths = {tbuild.library_path(n) for n in names}
    assert len(paths) == 3
    assert all(p.parent == tbuild.BUILD_DIR for p in paths)
    assert tbuild.library_path("decode_avg") == \
        tbuild.library_path("decode_avg")
    cmd = tbuild.nvcc_command("nvcc", "sgd_update", tmp_path / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd
    assert not any("fast_math" in c for c in cmd)
    for n in names:
        assert (tbuild.CSRC / tbuild.KERNELS[n][0]).exists()


@pytest.mark.parametrize("nesterov,wd", [(False, 0.0), (True, 1e-4)])
def test_fused_optimizer_path_equals_per_leaf(nesterov, wd):
    """optim/sgd.py: one flat sweep over a node-stacked tree (mixed
    dtypes, ragged leaves) equals the per-leaf oracle bitwise."""
    from repro_torch.optim import SGDConfig, sgd_init, sgd_update
    rng = np.random.default_rng(11)
    params = {"b": _t(rng.standard_normal((3, 7, 5)).astype(np.float32)),
              "a": {"w": _t(rng.standard_normal((3, 300)).astype(
                  np.float32)).to(torch.bfloat16)}}
    grads = {"b": _t(rng.standard_normal((3, 7, 5)).astype(np.float32)),
             "a": {"w": _t(rng.standard_normal((3, 300)).astype(
                 np.float32)).to(torch.bfloat16)}}
    out = {}
    for fused in (True, False):
        cfg = SGDConfig(lr=0.1, nesterov=nesterov, weight_decay=wd,
                        fused=fused)
        state = sgd_init(cfg, params)
        p, s = params, state
        for _ in range(2):
            p, s = sgd_update(cfg, p, grads, s, torch.tensor(0.1))
        out[fused] = (p, s)
    for a, b in zip(jax.tree.leaves(out[True]), jax.tree.leaves(out[False])):
        assert a.dtype == b.dtype and torch.equal(a, b)
