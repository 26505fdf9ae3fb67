"""PyTorch port: K5 (the stats-level flash entry points) and ring attention
over ``torch.distributed`` against the JAX package.

* ``flash_fwd_stats`` / ``flash_bwd_stats`` on a KV shard, the backward with
  the global (out, lse), at head_dim 64 and 128: the port's plain versions
  (the CPU path) against the JAX entry points (Pallas in interpret mode).
* The ring on 2 and 4 gloo ranks (fresh interpreters without JAX, see
  ``tests/test_torch_port_ranks.py``) against JAX ``ring_flash_attention``
  under ``shard_map`` on the first 2 or 4 of the 8 virtual CPU devices:
  forward and dq/dk/dv.
* A TINY DiT with SP=2 (Full remat, so each block's recompute runs the ring
  again) against the JAX single-device ``dit_forward``: output and every
  parameter gradient, as ``tests/test_ring_attention.py`` holds the JAX
  ring DiT.

Tolerances (all fp32): outputs 2e-4 (relative and absolute), the ring's
gradients rtol 1e-3 and atol 2e-4, as the JAX ring test; the DiT's
gradients 1e-3 of each tensor's largest (sums over ranks and hops in
another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from aozora_sdxl_training_tpu.models.anima import dit as jax_dit
from aozora_sdxl_training_tpu.ops import flash_attention as jax_fa
from aozora_sdxl_training_tpu.ops.ring_attention import ring_flash_attention
from aozora_sdxl_training_tpu_torch.models.anima import dit as port_dit
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port_fa
from aozora_sdxl_training_tpu_torch.ops import ring_attention as port_ring

from tests.test_torch_port_anima_dit import numpy_params
from tests.test_torch_port_ranks import run_task
from tests.test_torch_port_trainer import one_thread


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# --------------------------------------------------------------------------
# K5 entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
def test_stats_entry_points_match_jax_on_a_kv_shard(d):
    """The forward on the second of three KV shards; the backward on it
    with the global (out, lse) of all the keys, which the dQ side turns
    into the global delta."""
    rng = np.random.default_rng(d)
    b, sq, skv, h = 1, 48, 96, 2
    q, do = _rand(rng, b, sq, h, d), _rand(rng, b, sq, h, d)
    k, v = _rand(rng, b, skv, h, d), _rand(rng, b, skv, h, d)
    ks, vs = k[:, 32:64], v[:, 32:64]
    want_out, want_lse = jax_fa.flash_fwd_stats(*map(jnp.asarray, (q, ks, vs)))
    before = dict(port_fa.STATS_LAUNCHES)
    out, lse = port_fa.flash_fwd_stats(*map(torch.from_numpy, (q, ks, vs)))
    assert out.shape == (b, sq, h, d) and lse.shape == (b, sq, h)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-4, atol=2e-4)

    g_out, g_lse = (np.array(x) for x in jax_fa.flash_fwd_stats(
        *map(jnp.asarray, (q, k, v))))
    want = jax_fa.flash_bwd_stats(*map(jnp.asarray, (q, ks, vs, g_out, g_lse, do)))
    got = port_fa.flash_bwd_stats(*map(torch.from_numpy, (q, ks, vs, g_out, g_lse, do)))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-3, atol=2e-4,
                                   err_msg=name)
    # on the CPU the plain versions run: no kernel launch is counted
    assert port_fa.STATS_LAUNCHES == before


# --------------------------------------------------------------------------
# the ring on gloo ranks
# --------------------------------------------------------------------------

def _ring_inputs(n):
    """(q, k, v, g): (1, 128, 2, 64) fp32 from a seed per ring size."""
    rng = np.random.default_rng(n)
    return tuple(_rand(rng, 1, 128, 2, 64) for _ in range(4))


@functools.lru_cache(maxsize=None)
def _jax_ring_of(n):
    """JAX ring_flash_attention's (out, dq, dk, dv) on ``_ring_inputs(n)``,
    computed once for the tests that share it."""
    return _jax_ring(n, *_ring_inputs(n))


def _jax_ring(n, q, k, v, g):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    spec = P(None, "sp")
    ring = shard_map(functools.partial(ring_flash_attention, axis_name="sp",
                                       axis_size=n),
                     mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                     check_vma=False)
    out, vjp = jax.vjp(jax.jit(ring), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_ring_matches_jax_ring(tmp_path, n):
    """Every rank returns the whole output and the whole q/k/v gradients
    (the token shard's backward all-gathers them), equal across ranks and
    to the JAX ring's."""
    np.savez(tmp_path / "inputs.npz", **dict(zip("qkvg", _ring_inputs(n))))
    ranks = run_task("ring", n, tmp_path / "inputs.npz", tmp_path)
    want = dict(zip(("out", "dq", "dk", "dv"), _jax_ring_of(n)))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["out"], want["out"], rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {r} out")
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=2e-4,
                                       err_msg=f"rank {r} {name}")
        for name in want:
            np.testing.assert_array_equal(got[name], ranks[0][name])


def test_sp_ring_attention_refuses_tokens_that_do_not_split():
    x = torch.zeros(1, 10, 1, 64)
    with pytest.raises(ValueError, match="do not split over sp=3"):
        port_ring.sp_ring_attention(x, x, x, port_ring.SPRingConfig(None, 3, "xla"))


def test_merge_of_two_partials_is_attention_over_their_union():
    """``_merge`` of the stats of two KV halves gives the stats of all the
    keys (fp32, 1e-5)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 16, 2, 64)) for _ in range(3))
    o1, l1 = port_fa.flash_fwd_stats(q, k[:, :8], v[:, :8])
    o2, l2 = port_fa.flash_fwd_stats(q, k[:, 8:], v[:, 8:])
    o, lse = port_ring._merge(o1.float(), l1, o2, l2)
    want_o, want_l = port_fa.flash_fwd_stats(q, k, v)
    torch.testing.assert_close(o, want_o, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_l, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_on_one_device_matches_jax_ring(n):
    """The lockstep composition (what chip_smoke.py runs on one card)
    gives the JAX ring's output and gradients, and the global lse."""
    q, k, v, g = _ring_inputs(n)
    out, lse, dq, dk, dv = port_ring.ring_on_one_device(
        *map(torch.from_numpy, (q, k, v, g)), n)
    want = _jax_ring_of(n)
    np.testing.assert_allclose(out.numpy(), want[0], rtol=2e-4, atol=2e-4)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want[1:]):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-3, atol=2e-4, err_msg=name)
    _, want_lse = jax_fa.flash_fwd_stats(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# TINY DiT with SP=2
# --------------------------------------------------------------------------

def test_tiny_dit_sp2_matches_jax_single_device(tmp_path):
    """16 x 16 latents, patch 2: 64 self-attention tokens, 32 per rank."""
    cfg = jax_dit.TINY_ANIMA
    rng = np.random.default_rng(41)
    np_params = numpy_params(cfg, rng)
    lat = _rand(rng, 1, 1, 16, 16, cfg.in_channels)
    t = np.asarray([0.4], np.float32)
    ctx = _rand(rng, 1, 12, cfg.adapter_source_dim)
    ids = rng.integers(1, cfg.adapter_vocab, size=(1, 12)).astype(np.int32)
    tangent = _rand(rng, 1, 1, 16, 16, cfg.out_channels)
    np.savez(tmp_path / "inputs.npz", latents=lat, t=t, ctx=ctx, ids=ids,
             tangent=tangent, **{f"p.{k}": v for k, v in np_params.items()})

    def loss(p):
        out = jax_dit.dit_forward(p, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
                                  cfg=cfg, t5_ids=jnp.asarray(ids), attn_impl="xla",
                                  compute_dtype=jnp.float32, remat=False)
        return jnp.sum(out * tangent), out

    grads, want_out = jax.jit(jax.grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in np_params.items()})
    want_g = {k: v.numpy() for k, v in port_dit.params_from_jax(
        {k: np.asarray(g) for k, g in grads.items()}).items()}

    ranks = run_task("dit", 2, tmp_path / "inputs.npz", tmp_path)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["out"], np.asarray(want_out), rtol=2e-4,
                                   atol=2e-4, err_msg=f"rank {r}")
        got_g = {k[2:]: v for k, v in got.items() if k.startswith("g.")}
        assert got_g.keys() == want_g.keys()
        worst = max(np.abs(got_g[k] - want_g[k]).max() / max(np.abs(want_g[k]).max(), 1e-6)
                    for k in want_g)
        assert worst < 1e-3, f"rank {r}: worst relative gradient error {worst}"
    assert np.abs(want_g["blocks.0.self_attn.q_proj.weight"]).max() > 0


def test_dit_dispatch_under_sp_config(monkeypatch):
    """Under an SPRingConfig the self-attention goes through
    sp_ring_attention at any length; cross-attention and the adapter take
    its base_impl locally."""
    cfg = port_dit.TINY_ANIMA
    rng = np.random.default_rng(5)
    params = port_dit.params_from_jax(numpy_params(jax_dit.TINY_ANIMA, rng))
    ring_calls, local = [], []

    def fake_ring(q, k, v, sp):
        ring_calls.append((tuple(q.shape), sp.axis_size))
        return port_fa.flash_forward_reference(q, k, v, q.shape[-1] ** -0.5)[0]

    real_attention = port_dit.attention

    def spy(q, k, v, impl):
        local.append((tuple(k.shape), impl))
        return real_attention(q, k, v, impl=impl)

    monkeypatch.setattr(port_dit, "sp_ring_attention", fake_ring)
    monkeypatch.setattr(port_dit, "attention", spy)
    sp = port_ring.SPRingConfig(None, 2, "xla")
    out = port_dit.dit_forward(
        params, torch.from_numpy(_rand(rng, 1, 1, 8, 8, cfg.in_channels)),
        torch.tensor([0.3]), torch.from_numpy(_rand(rng, 1, 12, cfg.adapter_source_dim)),
        cfg=cfg, t5_ids=torch.from_numpy(rng.integers(1, cfg.adapter_vocab, (1, 12))),
        attn_impl=sp, compute_dtype=torch.float32, remat=False)
    assert torch.isfinite(out).all()
    assert ring_calls == [((1, 16, cfg.num_heads, cfg.head_dim), 2)] * cfg.num_blocks
    assert local and all(impl == "xla" for _, impl in local)
