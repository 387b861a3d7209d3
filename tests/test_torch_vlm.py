"""The port's VLM backbone (Qwen2-VL, M-RoPE) on the CPU against the JAX
package.

``default_mrope_positions``; ``apply_mrope`` at head dims 16 and 128 with
three distinct position streams; ``attention_block``'s M-RoPE branch on
JAX-initialised weights with non-zero qkv biases (added before the
rotation), forward and VJP; the reduced Qwen2-VL loss and every gradient
leaf against ``jax.value_and_grad(train_loss)``, with image-layout
positions and with none, with the plain references and through
``register_kernels()``; ``init``'s layout; the config; and both CLIs,
whose loss falls.  Image-layout positions are ``chip_smoke.py``'s, in
Qwen2-VL's own ``get_rope_index`` layout: a text prefix with the three
streams equal, one image of t = 1 over an h x w grid (height = start +
row, width = start + column), then text again from start + max(h, w).
Inputs are made with numpy from a seed; ``jax_enable_x64`` is off in a
fixture.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.train as jtrain
import repro.models as jmodels
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import train_loss
from repro_torch.models import layers as TL
from repro_torch.tree import tree_flatten_with_path, tree_leaves
from test_torch_hybrid import FLASH_TOL
from test_torch_train import GRAD_TOL, LOSS_RTOL, _init_layouts, _jax_paths

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import image_positions  # noqa: E402  (the layout phase 3l trains on)

ARCH = "qwen2-vl-7b"
# the rotation's tolerance: both packages multiply the same fp32 position
# by the same fp32 frequency; cos and sin may differ in the last ulp
ROPE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(**variant):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(), **variant)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **variant)
    return jcfg, tcfg


def test_image_positions_layout():
    pos = image_positions(1, 12, (2, 3), [2])
    assert pos[:, 0].tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 5, 6, 7, 8],
                                  [0, 1, 2, 2, 2, 3, 3, 3, 5, 6, 7, 8],
                                  [0, 1, 2, 3, 4, 2, 3, 4, 5, 6, 7, 8]]


def test_default_mrope_positions_match_jax():
    got = TL.default_mrope_positions(3, 7)
    want = JL.default_mrope_positions(3, 7)
    assert got.shape == (3, 3, 7) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestApplyMrope:
    @pytest.mark.parametrize("head_dim,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))],
                             ids=["d16", "d128"])
    @pytest.mark.parametrize("theta", [1e4, 1e6])
    def test_matches_jax(self, head_dim, sections, theta):
        """Three distinct streams (image positions, and a random third),
        so each section's rotary dims take their own stream."""
        rng = np.random.default_rng(head_dim)
        x = _normal(rng, 2, 3, 40, head_dim)
        pos = image_positions(2, 40, (4, 6), [3, 9])
        pos[0, 1] = rng.integers(0, 1000, size=40)
        assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta)
        got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)

    def test_equal_streams_are_rope(self):
        rng = np.random.default_rng(1)
        x = torch.from_numpy(_normal(rng, 2, 3, 10, 16))
        got = TL.apply_mrope(x, TL.default_mrope_positions(2, 10), (2, 3, 3))
        torch.testing.assert_close(got, TL.apply_rope(x, torch.arange(10)))

    def test_bf16_keeps_its_dtype(self):
        rng = np.random.default_rng(2)
        x = _normal(rng, 1, 2, 12, 16)
        pos = image_positions(1, 12, (2, 3), [2])
        want = JL.apply_mrope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), (2, 3, 3))
        got = TL.apply_mrope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos), (2, 3, 3))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=3e-2, rtol=3e-2)

    def test_sections_must_cover_half_the_head_dim(self):
        x = torch.zeros(1, 1, 4, 16)
        with pytest.raises(ValueError, match="do not sum"):
            TL.apply_mrope(x, TL.default_mrope_positions(1, 4), (2, 3, 4))


def _biased_attn(jcfg, seed):
    """JAX attention weights with random qkv biases (JAX starts them at
    zero), so the bias is seen to come before the rotation."""
    jp = JL.init_attn(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
                      jcfg.head_dim, True, jnp.float32)
    rng = np.random.default_rng(seed)
    return {k: (jnp.asarray(_normal(rng, *v.shape, scale=0.5)) if k.startswith("b") else v)
            for k, v in jp.items()}


@pytest.mark.parametrize("positions", ["image", "default"])
@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_mrope_attention_block_matches_jax(positions, n_kv_heads):
    jcfg, tcfg = _cfgs(n_kv_heads=n_kv_heads)
    jp = _biased_attn(jcfg, 3)
    rng = np.random.default_rng(8)
    x, cot = _normal(rng, 2, 32, 64), _normal(rng, 2, 32, 64)
    pos = image_positions(2, 32, (4, 6), [3, 5]) if positions == "image" else None
    jpos = None if pos is None else jnp.asarray(pos)
    want, vjp = jax.vjp(lambda p, a: JL.attention_block(p, a, jcfg, mrope_positions=jpos)[0],
                        jp, jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(cot))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TL.attention_block(tp, xt, tcfg,
                             mrope_positions=None if pos is None else torch.from_numpy(pos))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FLASH_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **GRAD_TOL)
    want_g = _jax_paths(want_gp)
    for path, leaf in tree_flatten_with_path(tp):
        np.testing.assert_allclose(leaf.grad.numpy(), want_g[path], err_msg=str(path),
                                   **GRAD_TOL)


def _batch(cfg, positions: bool, b=2, s=32, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if positions:
        batch["mrope_positions"] = image_positions(b, s, (4, 6), [3, 5])
    return batch


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(remat: str, positions: bool):
    jcfg, _ = _cfgs(remat=remat)
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    # non-zero qkv biases, as a trained model has
    rng = np.random.default_rng(9)
    jp["layers"]["attn"] = {k: (jnp.asarray(_normal(rng, *v.shape, scale=0.5))
                                if k.startswith("b") else v)
                            for k, v in jp["layers"]["attn"].items()}
    batch = _batch(jcfg, positions)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    return jax.tree_util.tree_map(np.asarray, jp), batch, float(loss), _jax_paths(grads)


class TestReducedQwen2VL:
    @pytest.mark.parametrize("positions", [True, False], ids=["image", "default"])
    @pytest.mark.parametrize("remat", ["none", "full"])
    @pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"])
    def test_loss_and_grads_match_jax(self, positions, remat, kernels):
        """Two layers with qkv bias and M-RoPE sections (2, 3, 3), with
        image-layout positions in the batch or none (text-only defaults).
        With the kernels registered, K1 and K2 run their plain versions."""
        np_params, batch, want_loss, want = _jax_loss_and_grads(remat, positions)
        _, tcfg = _cfgs(remat=remat)
        tp = params_from_numpy(np_params, "cpu")
        for leaf in tree_leaves(tp):
            leaf.requires_grad_(True)
        if kernels:
            ops.register_kernels()
        try:
            loss = train_loss(tcfg, tp, ttrain.device_batch(batch, "cpu"))
            loss.backward()
        finally:
            ops.unregister_kernels()
        np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
        got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)

    def test_positions_change_the_loss(self):
        """Image-layout positions and the text-only defaults give different
        losses, so the batch's positions are used."""
        assert _jax_loss_and_grads("none", True)[2] != _jax_loss_and_grads("none", False)[2]

    def test_init_layout_matches_jax(self):
        jcfg, tcfg = _cfgs(dtype="bfloat16")
        got = _init_layouts(jcfg, tcfg)
        assert got[("layers", "attn", "bk")] == ((2, 64), "torch.bfloat16")
        assert ("enc_layers", "attn", "wq") not in got

    def test_config_equals_jax(self):
        tcfg, jcfg = get_config(ARCH), jconfigs.get_config(ARCH)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert tcfg.param_count() == jcfg.param_count() == 7_615_616_512
        assert dataclasses.replace(tcfg, n_layers=4).param_count() == 2_022_229_504
        assert (tcfg.head_dim, tcfg.n_heads // tcfg.n_kv_heads) == (128, 7)
        assert tcfg.reduced().mrope_sections == (2, 3, 3)


def test_both_clis_train_and_the_loss_falls(tmp_path):
    """Without positions in the batch both packages fall back to the
    text-only defaults and train."""
    args = ["--arch", ARCH, "--steps", "6", "--batch", "4", "--seq", "32", "--d-model", "64",
            "--layers", "2", "--vocab", "256"]
    assert jtrain.main([*args, "--ckpt-dir", str(tmp_path / "jax")]) == 0
    # each main asserts that its loss fell
    assert ttrain.main([*args, "--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
