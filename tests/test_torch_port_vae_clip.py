"""PyTorch port: the caching encoders (CLIP-L, bigG, SD-VAE) and the flash
forward at head_dim 512 against the JAX package.

Same numpy weights (SD tensor dicts loaded through both packages' loaders,
or the JAX package's random init carried over with ``params_from_jax``)
and same numpy inputs into both, fp32 on the CPU. Tolerances, each with
its reason:

* CLIP towers and VAE: 1e-4 relative to the output's largest magnitude:
  the same fp32 function computed by XLA and by PyTorch's CPU kernels,
  which sum in different orders over a few layers; the preview's
  ``latents_to_pixels`` 1e-5 absolute on pixels in [0, 1];
* flash forward at head_dim 512: 2e-4, the JAX package's own bar for its
  kernel against its XLA reference (tests/test_flash_attention.py); here
  the port's plain version (the CPU path and the CUDA kernel's oracle)
  against the folded Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from aozora_sdxl_training_tpu.models.sdxl import clip as jax_clip
from aozora_sdxl_training_tpu.models.sdxl import vae as jax_vae
from aozora_sdxl_training_tpu.ops.flash_attention import flash_attention as jax_flash
from aozora_sdxl_training_tpu.train import sampler as jax_sampler
from aozora_sdxl_training_tpu_torch.models.sdxl import clip as port_clip
from aozora_sdxl_training_tpu_torch.models.sdxl import vae as port_vae
from aozora_sdxl_training_tpu_torch.ops import flash_attention as port_flash
from aozora_sdxl_training_tpu_torch.train import sampler as port_sampler

from tests.test_clip_vae import _openclip_like_sd_tensors, _tiny_vae_sd_tensors
from tests.test_torch_port_trainer import one_thread


@pytest.fixture(autouse=True, scope="module")
def _port_on_one_thread():
    """The port's side of every test, module fixtures included, runs torch
    on one CPU thread (``one_thread``: several workers at a thread a core
    each oversubscribe the cores); the JAX side's threads are XLA's own."""
    with one_thread():
        yield


def _close(got, want, rel=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _hf_clip_l_sd_tensors(width=64, layers=2, vocab=100, length=16, seed=2):
    """An HF-layout CLIP-L tensor dict under the SD prefix."""
    rng = np.random.default_rng(seed)
    p = port_clip.CLIP_L_PREFIX

    def nrm(*shape, s=0.05):
        return (rng.normal(size=shape) * s).astype(np.float32)

    t = {f"{p}embeddings.token_embedding.weight": nrm(vocab, width, s=0.5),
         f"{p}embeddings.position_embedding.weight": nrm(length, width, s=0.5),
         f"{p}final_layer_norm.weight": 1 + nrm(width),
         f"{p}final_layer_norm.bias": nrm(width)}
    for i in range(layers):
        src = f"{p}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            t[f"{src}{ln}.weight"] = 1 + nrm(width)
            t[f"{src}{ln}.bias"] = nrm(width)
        for proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.out_proj"):
            t[f"{src}{proj}.weight"] = nrm(width, width, s=0.2)
            t[f"{src}{proj}.bias"] = nrm(width)
        t[f"{src}mlp.fc1.weight"] = nrm(4 * width, width, s=0.2)
        t[f"{src}mlp.fc1.bias"] = nrm(4 * width)
        t[f"{src}mlp.fc2.weight"] = nrm(width, 4 * width, s=0.1)
        t[f"{src}mlp.fc2.bias"] = nrm(width)
    return t


def _tokens(cfg, batch, seed):
    """Token rows with the EOS id at a different place in each row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size - 2, size=(batch, cfg.max_length))
    for i in range(batch):
        ids[i, 3 + 2 * i] = cfg.eos_token_id
    return ids.astype(np.int32)


def test_clip_towers_from_sd_tensors_match_jax():
    """CLIP-L (HF layout, 1 head of 64) and bigG (OpenCLIP layout, fused
    in_proj) loaded from one SD dict by both packages: detected configs,
    penultimate hidden states, the EOS-pooled projection and the dual-tower
    conditioning agree."""
    big_cfg = jax_clip.ClipTextConfig(vocab_size=100, width=128, num_layers=2,
                                      num_heads=2, max_length=16,
                                      projection_dim=24, eos_token_id=99)
    sd = {**_hf_clip_l_sd_tensors(), **_openclip_like_sd_tensors(big_cfg)}
    cfg_l, cfg_g = port_clip.detect_clip_l_config(sd), port_clip.detect_clip_bigg_config(sd)
    assert vars(cfg_l) == vars(jax_clip.detect_clip_l_config(sd))
    assert vars(cfg_g) == vars(jax_clip.detect_clip_bigg_config(sd))
    assert (cfg_l.num_layers, cfg_l.num_heads, cfg_g.num_heads) == (2, 1, 2)
    jl, jg = jax_clip.clip_l_params_from_sd(sd), jax_clip.clip_bigg_params_from_sd(sd)
    pl, pg = port_clip.clip_l_params_from_sd(sd), port_clip.clip_bigg_params_from_sd(sd)
    tl, tg = _tokens(cfg_l, 3, 0), _tokens(cfg_g, 3, 1)
    want_e, want_p = jax_clip.encode_dual_towers(jl, jg, jnp.asarray(tl),
                                                 jnp.asarray(tg), cfg_l=cfg_l,
                                                 cfg_g=cfg_g)
    got_e, got_p = port_clip.encode_dual_towers(pl, pg, torch.from_numpy(tl),
                                                torch.from_numpy(tg),
                                                cfg_l=cfg_l, cfg_g=cfg_g)
    assert got_e.shape == (3, 16, 64 + 128) and got_p.shape == (3, 24)
    _close(got_e, want_e)
    _close(got_p, want_p)
    hidden_l, pooled_l = port_clip.clip_text_forward(pl, torch.from_numpy(tl), cfg_l)
    assert pooled_l is None
    _close(hidden_l, jax_clip.clip_text_forward(jl, jnp.asarray(tl), cfg_l)[0])


def test_clip_sd_writers_invert_the_loaders():
    """The writers a random checkpoint is made with give back the SD dict
    the loaders read, key for key and bit for bit."""
    big_cfg = jax_clip.ClipTextConfig(vocab_size=100, width=64, num_layers=2,
                                      num_heads=1, max_length=16,
                                      projection_dim=24, eos_token_id=99)
    for sd, load, write in (
            (_hf_clip_l_sd_tensors(), port_clip.clip_l_params_from_sd,
             port_clip.clip_l_sd_from_params),
            (_openclip_like_sd_tensors(big_cfg), port_clip.clip_bigg_params_from_sd,
             port_clip.clip_bigg_sd_from_params)):
        back = write(load(sd), num_layers=2)
        assert back.keys() == sd.keys()
        for key, want in sd.items():
            np.testing.assert_array_equal(back[key].numpy(), want, err_msg=key)


def test_clip_params_from_jax_match_jax_forward():
    """The JAX package's random init carried over with ``params_from_jax``
    (TINY_CLIP: 4 heads of 8, projection 24) computes the same function;
    the port's own init has the same names and shapes."""
    cfg = jax_clip.TINY_CLIP
    jparams = jax_clip.init_clip_params(cfg, jax.random.PRNGKey(3))
    jparams = {k: np.asarray(v) for k, v in jparams.items()}
    # non-trivial norms so that the scales and shifts are exercised
    rng = np.random.default_rng(4)
    for k in jparams:
        if k.endswith(("ln1.weight", "ln2.weight", "final_ln.weight")):
            jparams[k] = (1 + 0.1 * rng.normal(size=jparams[k].shape)).astype(np.float32)
    pparams = port_clip.params_from_jax(jparams)
    ids = _tokens(port_clip.TINY_CLIP, 2, 5)
    want_h, want_p = jax_clip.clip_text_forward(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(ids), cfg)
    got_h, got_p = port_clip.clip_text_forward(pparams, torch.from_numpy(ids),
                                               port_clip.TINY_CLIP)
    _close(got_h, want_h)
    _close(got_p, want_p)
    own = port_clip.init_clip_params(port_clip.TINY_CLIP, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in pparams.items()}


@pytest.fixture(scope="module")
def tiny_vae():
    sd = _tiny_vae_sd_tensors(decoder=True)
    return (sd, jax_vae.params_from_sd_state(sd, include_decoder=True),
            port_vae.params_from_sd_state(sd, include_decoder=True))


def test_vae_encoder_and_decoder_match_jax(tiny_vae):
    """Encoder (asymmetric-pad downsamples, mid attention, mean half of
    quant_conv) and decoder (reversed up stages, nearest-2x upsamples) on a
    tiny SD-VAE dict (channels 8/8/16/16, z=4), 32x32 pixels."""
    sd, jparams, pparams = tiny_vae
    rng = np.random.default_rng(6)
    pixels = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    want = jax_vae.encoder_forward(jparams, jnp.asarray(pixels))
    got = port_vae.encoder_forward(pparams, torch.from_numpy(pixels))
    assert got.shape == (2, 4, 4, 4)
    _close(got, want)
    latents = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    want = jax_vae.decoder_forward(jparams, jnp.asarray(latents))
    got = port_vae.decoder_forward(pparams, torch.from_numpy(latents))
    assert got.shape == (2, 32, 32, 3)
    _close(got, want)
    assert port_vae.detect_latent_channels(sd) == jax_vae.detect_latent_channels(sd) == 4
    assert port_vae.detect_latent_channels({}) is None


def test_vae_params_from_jax_and_loader_errors(tiny_vae):
    sd, jparams, pparams = tiny_vae
    carried = port_vae.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})
    assert carried.keys() == pparams.keys()
    for k, v in carried.items():
        torch.testing.assert_close(v, pparams[k], rtol=0, atol=0, msg=k)
    encoder_only = port_vae.params_from_sd_state(sd)
    assert not any(k.startswith(("decoder.", "post_quant_conv")) for k in encoder_only)
    with pytest.raises(ValueError, match="decoder"):
        port_vae.params_from_sd_state(_tiny_vae_sd_tensors(), include_decoder=True)
    with pytest.raises(ValueError, match="encoder"):
        port_vae.params_from_sd_state({})


def test_latents_to_pixels_matches_jax(tiny_vae):
    """The preview's decode: denormalize, decoder, [0, 1] clamp (shapes of
    the decoder test above); 1e-5 absolute on pixels."""
    sd, jparams, pparams = tiny_vae
    latents = np.random.default_rng(8).normal(size=(2, 4, 4, 4)).astype(np.float32)
    want = np.asarray(jax_sampler.latents_to_pixels(
        jparams, jnp.asarray(latents), shift=0.1, scale=0.13025))
    got = port_sampler.latents_to_pixels(pparams, torch.from_numpy(latents),
                                         shift=0.1, scale=0.13025)
    assert got.shape == (2, 32, 32, 3) and 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_upsample_nearest_2x_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 3, 5, 4)).astype(np.float32)
    got = port_vae.upsample_nearest_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_vae.upsample_nearest_2x(jnp.asarray(x))))


@pytest.mark.parametrize("sq,skv", [(256, 256), (256, 200), (136, 256)])
def test_d512_forward_matches_jax_folded_kernel(sq, skv):
    """One 512-wide head, as in the SD-VAE mid-attention, with ragged and
    unequal lengths: the JAX package's flash_attention takes its folded
    kernel (head_dim % 128 == 0) in interpret mode."""
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(1, sq, 1, 512)).astype(np.float32)
    k, v = (rng.normal(size=(1, skv, 1, 512)).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = port_flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_d512_backward_raises_on_the_cpu_too():
    """No caller differentiates at head_dim 512, so there is no backward
    kernel and no plain backward to stand in for one: the wrappers and the
    autograd backward raise whatever the device."""
    x = torch.zeros(1, 4, 1, 512)
    lse = torch.zeros(1, 4)
    with pytest.raises(NotImplementedError, match="head_dim 512"):
        port_flash.flash_bwd_dq(x, x, x, x, lse, x, 1.0)
    with pytest.raises(NotImplementedError, match="head_dim 512"):
        port_flash.flash_bwd_dkv(x, x, x, x, lse, lse, 1.0)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="head_dim 512"):
        port_flash.flash_attention(xg, x, x).sum().backward()
