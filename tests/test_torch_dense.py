"""The five dense configs of the port and K2's plain version at the head
dims they bring, on the CPU against the JAX package.

minicpm-2b, qwen2.5-32b, granite-20b (MQA), qwen3-1b and qwen3-9b at
``reduced()`` size in fp32, with JAX-initialized weights carried over by
``repro_torch.interop``: the loss and every gradient leaf against
``jax.value_and_grad(train_loss)``, with the kernels' plain versions
registered and without.  The minicpm CLI follows the JAX driver's WSD
learning rate step by step.  K2's plain version runs head dims 32 and
80 (padded on the card) against ``flash_attention_ref``.  Inputs are made
with numpy from a seed and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.train as jtrain
import repro.models as jmodels
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch import train as ttrain
from repro_torch.models import train_loss
from repro_torch.tree import tree_flatten_with_path, tree_leaves
from test_torch_kernels import TOL, _both, _close, _np
from test_torch_train import GRAD_TOL, LOSS_RTOL, _batch, _jax_paths, _port_cfg

NEW_DENSE = ["minicpm-2b", "qwen2.5-32b", "granite-20b", "qwen3-1b", "qwen3-9b"]
# the encoder-decoder and the VLM backbone, the last two configs ported
ENC_DEC_AND_VLM = ["whisper-large-v3", "qwen2-vl-7b"]


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


class TestRegistry:
    def test_every_config_equal_to_jax(self):
        """All twelve configs exist in the port and equal the JAX
        package's, at full size and reduced."""
        assert ARCHS == jconfigs.ARCHS and len(ARCHS) == 12
        for name in ARCHS:
            assert get_config(name) == _port_cfg(jconfigs.get_config(name)), name
            assert get_config(name).reduced() == _port_cfg(jconfigs.get_config(name).reduced())

    @pytest.mark.parametrize("name", ENC_DEC_AND_VLM)
    def test_enc_dec_and_vlm_configs_equal_jax(self, name):
        tcfg, jcfg = get_config(name), jconfigs.get_config(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
        with pytest.raises(KeyError, match="unknown arch"):
            get_config(name + "-x")

    def test_head_dims(self):
        """What K2 sees at full width: minicpm 64, the rest 128; granite
        is MQA and the Qwen3 models GQA 2:1 / 4:1."""
        dims = {n: (get_config(n).head_dim, get_config(n).n_heads, get_config(n).n_kv_heads)
                for n in NEW_DENSE}
        assert dims == {"minicpm-2b": (64, 36, 36), "qwen2.5-32b": (128, 40, 8),
                        "granite-20b": (128, 48, 1), "qwen3-1b": (128, 16, 8),
                        "qwen3-9b": (128, 32, 8)}
        assert get_config("qwen3-1b").param_count() == \
            jconfigs.get_config("qwen3-1b").param_count()


@pytest.fixture
def kernels_registered(request):
    if request.param:
        ops.register_kernels()
    yield request.param
    ops.unregister_kernels()


class TestLossAndGrads:
    @pytest.mark.parametrize("arch", NEW_DENSE)
    @pytest.mark.parametrize("kernels_registered", [False, True], indirect=True,
                             ids=["ref", "kernels"])
    def test_matches_jax(self, arch, kernels_registered):
        jcfg = jconfigs.get_config(arch).reduced()
        tcfg = get_config(arch).reduced()
        assert tcfg == _port_cfg(jcfg)
        jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
        batch = _batch(jcfg.vocab)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
        want = _jax_paths(want)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        for leaf in tree_leaves(tp):
            leaf.requires_grad_(True)
        loss = train_loss(tcfg, tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
        got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)


class TestMiniCPMSchedule:
    ARGS = ["--arch", "minicpm-2b", "--steps", "12", "--batch", "2", "--seq", "16",
            "--d-model", "64", "--layers", "2", "--vocab", "128", "--ckpt-every", "4"]

    def test_cli_follows_jax_wsd_step_by_step(self, tmp_path, monkeypatch):
        """Both CLIs train minicpm with WSD (warm-up 1 step, decay over the
        last 10%): the learning rate of every step is equal."""
        sups = []

        class Recording(jtrain.Supervisor):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                sups.append(self)
        monkeypatch.setattr(jtrain, "Supervisor", Recording)
        assert jtrain.main([*self.ARGS, "--ckpt-dir", str(tmp_path / "jax")]) == 0
        want = [h["lr"] for h in sups[0].history]
        sup, _ = ttrain.run([*self.ARGS, "--device", "cpu", "--ckpt-dir", str(tmp_path / "t")])
        got = [h["lr"] for h in sup.history]
        assert len(got) == len(want) == 12
        np.testing.assert_allclose(got, want, rtol=1e-6)
        # WSD, not cosine: flat at the peak between warm-up and decay
        assert got[1] == got[9] == pytest.approx(3e-3)
        assert got[11] < got[10] == got[9]


class TestFlashPlainHeadDims:
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
        (2, 4, 2, 40, 72, 32, True),      # GQA, ragged: the CLI's head_dim at --d-model 128
        (1, 8, 1, 64, 64, 32, True),      # MQA
        (1, 4, 2, 33, 57, 80, True),      # zamba2's head_dim, GQA
        (2, 6, 1, 48, 48, 80, False),     # MQA, non-causal
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fwd_matches_flash_attention_ref(self, b, hq, hkv, sq, skv, d, causal, dtype):
        qj, qt = _both(_np(0, (b, hq, sq, d)), dtype)
        kj, kt = _both(_np(1, (b, hkv, skv, d)), dtype)
        vj, vt = _both(_np(2, (b, hkv, skv, d)), dtype)
        off = skv - sq if causal else 0
        want = jax_flash_ref(qj, kj, vj, causal=causal, q_offset=off, block_kv=16)
        out, lse = flash_attention_fwd(qt, kt, vt, causal=causal, q_offset=off)
        assert out.shape == qt.shape and out.dtype == qt.dtype
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
        _close(out, want, TOL[dtype])


def test_cli_at_d_model_128_runs_head_dim_32(tmp_path):
    """``--d-model 128`` gives 4 heads of 32 (the case the card refused
    before K2 took every head dim of 8)."""
    args = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--d-model", "128", "--layers", "1", "--vocab", "64", "--ckpt-dir", str(tmp_path)]
    sup, state = ttrain.run(args)
    assert len(sup.history) == 3
    wq = state["params"]["layers"]["attn"]["wq"]
    assert tuple(wq.shape) == (1, 128, 4 * 32)


def test_reduced_configs_keep_their_attention_grouping():
    for arch in NEW_DENSE:
        cfg = get_config(arch).reduced()
        jcfg = jconfigs.get_config(arch).reduced()
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == \
            (jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim)
        assert dataclasses.replace(cfg, dtype="bfloat16").tdtype == torch.bfloat16
