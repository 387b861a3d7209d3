"""The port's training path on the CPU against the JAX package.

Reduced Qwen1.5-0.5B and Falcon-Mamba-7B in fp32 with JAX-initialized
weights carried over by ``repro_torch.interop``: loss and every gradient
leaf against
``jax.value_and_grad(train_loss)``, AdamW + cosine steps against the JAX
``build_step``, the token stream byte for byte, checkpoints, and the
CLI's checkpoint-restart.  Only numpy crosses between the packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.models as jmodels
import repro.optim as joptim
from repro.launch.train import build_step as jax_build_step
from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointManager, CorruptCheckpointError,
                                    restore_tree, save_tree)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenSource, TokenLoader
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import ArchConfig, MoECfg, SSMCfg, init, train_loss
from repro_torch.optim import adamw_init, cosine_schedule, wsd_schedule
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
STEP_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _cfgs(remat="none", arch="qwen1.5-0.5b"):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), remat=remat)
    tcfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    return jcfg, tcfg


def _jax_params(jcfg):
    p = jmodels.init(jcfg, jax.random.PRNGKey(0))
    return p, jax.tree_util.tree_map(np.asarray, p)


def _batch(vocab, b=2, s=16, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1                    # ignored positions
    labels[0, 3] = -1
    return {"tokens": tokens, "labels": labels}


def _jax_paths(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(variant: tuple, arch: str = "qwen1.5-0.5b"):
    """(numpy params, batch, loss, {path: grad}) of the JAX reference for
    one config variant; shared by the ref and kernels cases."""
    jcfg = dataclasses.replace(_cfgs(arch=arch)[0], **dict(variant))
    jp, np_params = _jax_params(jcfg)
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodels.train_loss(jcfg, p, jb)))(jp)
    return np_params, batch, float(loss), _jax_paths(grads)


@pytest.fixture
def kernels_registered(request):
    if request.param:
        ops.register_kernels()
    yield request.param
    ops.unregister_kernels()


class TestLossAndGrads:
    @pytest.mark.parametrize("variant", [
        {"remat": "none"}, {"remat": "full"},
        {"loss_chunk": 8}, {"loss_chunk": 8, "remat": "full"},
        {"act": "gelu"}, {"tie_embeddings": False, "qkv_bias": False},
        {"n_kv_heads": 2},
    ], ids=["none", "full", "chunk", "chunk-full", "gelu", "untied", "gqa"])
    @pytest.mark.parametrize("kernels_registered", [False, True], indirect=True,
                             ids=["ref", "kernels"])
    def test_matches_jax(self, variant, kernels_registered):
        self._check(variant, "qwen1.5-0.5b")

    @pytest.mark.parametrize("variant", [
        {"remat": "none"}, {"remat": "full"}, {"remat": "full", "ssm_chunk": 4},
    ], ids=["none", "full", "full-chunk4"])
    @pytest.mark.parametrize("kernels_registered", [False, True], indirect=True,
                             ids=["ref", "kernels"])
    def test_falcon_mamba_matches_jax(self, variant, kernels_registered):
        """The pure Mamba-1 stack; with kernels registered the scan runs
        K4's and K4-bwd's plain versions through the autograd wrapper."""
        self._check(variant, "falcon-mamba-7b")

    @staticmethod
    def _check(variant, arch):
        tcfg = dataclasses.replace(_cfgs(arch=arch)[1], **variant)
        np_params, batch, want_loss, want = _jax_loss_and_grads(
            tuple(sorted(variant.items())), arch)
        tp = params_from_numpy(np_params, "cpu")
        for leaf in tree_leaves(tp):
            leaf.requires_grad_(True)
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        loss = train_loss(tcfg, tp, tb)
        loss.backward()
        np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
        got = {path: leaf.grad.numpy() for path, leaf in tree_flatten_with_path(tp)}
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=str(path), **GRAD_TOL)

    def test_kernel_launch_counts_follow_remat(self):
        """The CPU path never launches a kernel; on the card the counts
        are checked by chip_smoke.py."""
        _, tcfg = _cfgs("full")
        ops.register_kernels()
        ops.reset_launch_counts()
        try:
            tp = init(tcfg, torch.Generator().manual_seed(0), "cpu")
            tb = {k: torch.from_numpy(v).long() for k, v in _batch(tcfg.vocab).items()}
            assert torch.isfinite(train_loss(tcfg, tp, tb))
        finally:
            ops.unregister_kernels()
        assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0,
                                       "mamba_scan": 0, "mamba_scan_bwd": 0}


class TestSupervisorParts:
    def test_watchdog_matches_jax(self):
        from repro.ft import StragglerWatchdog as JaxWatchdog
        from repro_torch.ft import StragglerWatchdog
        j, t = JaxWatchdog(), StragglerWatchdog()
        times = [1.0, 1.1, 0.9, 3.5, 1.0, 1.2]
        for step, dt in enumerate(times):
            assert j.observe(step, dt) == t.observe(step, dt)
            for rank in range(3):
                slow = dt * (4.0 if rank == 2 and step > 2 else 1.0)
                assert j.observe_rank(rank, step, slow) == t.observe_rank(rank, step, slow)
        assert (j.ema, j.events, j.rank_events) == (t.ema, t.events, t.rank_events)
        assert j.slowdowns() == t.slowdowns()

    def test_stream_position_checked(self):
        from repro_torch.ft import StreamPositionError, check_stream_position
        assert check_stream_position({"step": 4, "data": {"step": 4}}) == 4
        for extra in ({"step": 4}, {"step": 4, "data": {"step": 3}}):
            with pytest.raises(StreamPositionError):
                check_stream_position(extra)


class TestTrainSteps:
    def test_adamw_cosine_steps_match_jax_build_step(self):
        jcfg, tcfg = _cfgs()
        jp, np_params = _jax_params(jcfg)
        n = 3
        jstep = jax_build_step(jcfg, joptim.cosine_schedule(1e-2, n))
        jstate = {"params": jp, "opt": joptim.adamw_init(jp),
                  "step": jnp.zeros((), jnp.int32)}
        tp = params_from_numpy(np_params, "cpu")
        tstep = ttrain.build_step(tcfg, cosine_schedule(1e-2, n), "cpu")
        tstate = {"params": tp, "opt": adamw_init(tp),
                  "step": torch.zeros((), dtype=torch.int32)}
        jl = jdata.TokenLoader(jdata.SyntheticTokenSource(jcfg.vocab, seed=17), 2, 16)
        tl = TokenLoader(SyntheticTokenSource(tcfg.vocab, seed=17), 2, 16)
        for _ in range(n):
            jstate, jm = jstep(jstate, jl.next_batch())
            tstate, tm = tstep(tstate, tl.next_batch())
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=STEP_LOSS_RTOL)
            np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
            np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-4)
        want = _jax_paths(jstate["params"])
        for path, leaf in tree_flatten_with_path(tstate["params"]):
            np.testing.assert_allclose(leaf.numpy(), want[path], atol=1e-5, rtol=1e-4)
        assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == n

    @pytest.mark.parametrize("kind", ["cosine", "wsd"])
    def test_schedules_match_jax(self, kind):
        jfn = getattr(joptim, f"{kind}_schedule")(3e-3, 50)
        tfn = {"cosine": cosine_schedule, "wsd": wsd_schedule}[kind](3e-3, 50)
        for s in [0, 1, 7, 25, 44, 46, 50, 60]:
            want = float(jfn(s))
            np.testing.assert_allclose(float(tfn(s)), want, rtol=1e-6)
            np.testing.assert_allclose(float(tfn(torch.tensor(s, dtype=torch.int32))),
                                       want, rtol=1e-6)


class TestDataStream:
    def test_token_stream_byte_identical(self):
        js = jdata.SyntheticTokenSource(2048, seed=17)
        ts = SyntheticTokenSource(2048, seed=17)
        for step in (0, 1, 9, 123):
            assert js.block(step, 4, 33).tobytes() == ts.block(step, 4, 33).tobytes()
        jl = jdata.TokenLoader(js, batch=4, seq=32, host_id=1, n_hosts=2)
        tl = TokenLoader(ts, batch=4, seq=32, host_id=1, n_hosts=2)
        for _ in range(3):
            assert jl.fingerprint() == tl.fingerprint()
            jb, tb = jl.next_batch(), tl.next_batch()
            for k in ("tokens", "labels"):
                assert jb[k].dtype == tb[k].dtype
                assert jb[k].tobytes() == tb[k].tobytes()
        assert jl.state_dict() == tl.state_dict()


def _state_tree():
    g = torch.Generator().manual_seed(3)
    return {"params": {"w": torch.randn(8, 16, generator=g).to(torch.bfloat16),
                       "b": torch.randn(16, generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


class TestCheckpoint:
    def test_round_trip_bf16_bits(self, tmp_path):
        tree = _state_tree()
        ckpt = CheckpointManager(tmp_path, keep=2)
        ckpt.save(4, tree, extra={"data": {"step": 4}})
        restored, extra = ckpt.restore(tree_map(torch.zeros_like, tree))
        assert extra == {"data": {"step": 4}, "step": 4}
        for (pa, a), (pb, b) in zip(tree_flatten_with_path(tree),
                                    tree_flatten_with_path(restored)):
            assert pa == pb
            _bits_equal(a, b)
        assert ckpt.verify(4)

    def test_flipped_byte_raises(self, tmp_path):
        tree = _state_tree()
        save_tree(tree, tmp_path / "ck")
        f = tmp_path / "ck" / "params__w.npy"
        raw = bytearray(f.read_bytes())
        raw[-3] ^= 0xFF
        f.write_bytes(bytes(raw))
        with pytest.raises(CorruptCheckpointError, match="params__w"):
            restore_tree(tree, tmp_path / "ck")

    def test_tampered_manifest_raises(self, tmp_path):
        save_tree(_state_tree(), tmp_path / "ck")
        m = tmp_path / "ck" / "manifest.json"
        m.write_text(m.read_text().replace('"shape": [\n    16\n   ]', '"shape": [17]'))
        with pytest.raises(CorruptCheckpointError, match="digest"):
            restore_tree(_state_tree(), tmp_path / "ck")


def _cli(tmp, *extra):
    return ["--device", "cpu", "--steps", "12", "--batch", "2", "--seq", "16",
            "--d-model", "64", "--layers", "2", "--vocab", "128",
            "--ckpt-every", "4", "--ckpt-dir", str(tmp), *extra]


class TestCLI:
    def test_fail_at_resumes_on_the_same_stream(self, tmp_path):
        ref_sup, ref_state = ttrain.run(_cli(tmp_path / "a"))
        sup, state = ttrain.run(_cli(tmp_path / "b", "--fail-at", "6"))
        assert sup.restarts == 1 and ref_sup.restarts == 0
        # the replayed steps 5-6 overwrite the lost ones
        last = {h["step"]: h["loss"] for h in sup.history}
        assert last == {h["step"]: h["loss"] for h in ref_sup.history}
        for (pa, a), (pb, b) in zip(tree_flatten_with_path(ref_state),
                                    tree_flatten_with_path(state)):
            assert pa == pb
            assert torch.equal(a, b), pa

    def test_main_loss_falls_and_resume_continues(self, tmp_path, capsys):
        assert ttrain.main(_cli(tmp_path)) == 0
        sup, _ = ttrain.run([*_cli(tmp_path), "--steps", "14", "--resume"])
        assert "resumed from step 12" in capsys.readouterr().out
        assert [h["step"] for h in sup.history] == [13, 14]

    def test_falcon_mamba_loss_falls(self, tmp_path):
        assert ttrain.main(_cli(tmp_path, "--arch", "falcon-mamba-7b")) == 0

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.run(["--device", "cuda", "--steps", "1"])


def _port_cfg(jcfg) -> ArchConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if kw["moe"]:
        kw["moe"] = MoECfg(**dataclasses.asdict(kw["moe"]))
    if kw["ssm"]:
        kw["ssm"] = SSMCfg(**dataclasses.asdict(kw["ssm"]))
    return ArchConfig(**kw)


class TestConfigs:
    @pytest.mark.parametrize("name", jconfigs.ARCHS)
    def test_params_count_matches_jax(self, name):
        jcfg = jconfigs.get_config(name)
        tcfg = _port_cfg(jcfg)
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        assert tcfg.reduced() == _port_cfg(jcfg.reduced())

    def test_qwen_config_equals_jax(self):
        assert get_config("qwen1.5-0.5b") == _port_cfg(jconfigs.get_config("qwen1.5-0.5b"))

    def test_falcon_config_equals_jax(self):
        tcfg = get_config("falcon-mamba-7b")
        jcfg = jconfigs.get_config("falcon-mamba-7b")
        assert tcfg == _port_cfg(jcfg)
        assert tcfg.param_count() == jcfg.param_count() == 7_272_665_088

    def test_unported_configs_raise(self):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_config("dbrx-132b")
        with pytest.raises(NotImplementedError, match="not ported"):
            get_config("zamba2-2.7b")
        with pytest.raises(KeyError):
            get_config("no-such-arch")

    def test_init_layout_matches_jax(self):
        assert _init_layouts(*_cfgs())

    def test_falcon_init_layout_matches_jax(self):
        """In a bf16 Falcon-Mamba, A_log and D stay fp32, as in JAX."""
        jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                      for c in _cfgs(arch="falcon-mamba-7b"))
        got = _init_layouts(jcfg, tcfg)
        assert got[("layers", "mamba", "A_log")] == ((2, 128, 8), "torch.float32")
        assert got[("layers", "mamba", "D")] == ((2, 128), "torch.float32")
        assert got[("layers", "mamba", "in_proj")] == ((2, 64, 256), "torch.bfloat16")


def _init_layouts(jcfg, tcfg) -> dict:
    """{path: (shape, dtype)} of the port's init, asserted equal to JAX's."""
    avals = jax.eval_shape(lambda: jmodels.init(jcfg, jax.random.PRNGKey(0)))
    want = {tuple(k.key for k in path): (tuple(a.shape), "torch." + str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(avals)[0]}
    got = init(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {p: (tuple(t.shape), str(t.dtype)) for p, t in tree_flatten_with_path(got)}
    assert want == got
    return got


class TestInterop:
    def test_bf16_round_trip(self):
        a = jnp.asarray(_batch(1000)["tokens"] / 7.0, jnp.float32).astype(jnp.bfloat16)
        t = params_from_numpy({"x": {"y": np.asarray(a)}}, "cpu")["x"]["y"]
        assert t.dtype == torch.bfloat16
        assert t.view(torch.int16).numpy().tobytes() == np.asarray(a).tobytes()
        back = params_to_numpy({"x": t})["x"]
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, np.asarray(a.astype(jnp.float32)))
        f16 = params_from_numpy({"x": np.ones(3, np.float32)}, "cpu", torch.bfloat16)
        assert f16["x"].dtype == torch.bfloat16

    def test_mixed_dtype_tree_keeps_dtypes_and_bits(self, tmp_path):
        """A bf16 Falcon-Mamba tree holds fp32 A_log and D: both cross
        interop and a checkpoint save and restore with their own dtype
        and bits, and ``dtype=`` casts every leaf, A_log included."""
        jcfg = dataclasses.replace(jconfigs.get_config("falcon-mamba-7b").reduced(),
                                   dtype="bfloat16")
        jtree = jax.tree_util.tree_map(np.asarray, jmodels.init(jcfg, jax.random.PRNGKey(0)))
        want = _jax_paths(jtree)
        tp = params_from_numpy(jtree, "cpu")
        ckpt = CheckpointManager(tmp_path, keep=1)
        ckpt.save(1, tp, extra={"data": {"step": 1}})
        restored, _ = ckpt.restore(tree_map(torch.zeros_like, tp))
        back = _jax_paths(params_to_numpy(restored))
        dtypes = {}
        for path, t in tree_flatten_with_path(restored):
            w = want[path]
            dtypes[path[-1]] = str(t.dtype)
            assert str(t.dtype) == "torch." + str(w.dtype), path
            bits = np.int16 if w.dtype.name == "bfloat16" else np.int32
            assert t.view(getattr(torch, bits.__name__)).numpy().tobytes() == \
                w.view(bits).tobytes(), path
            np.testing.assert_array_equal(back[path], w.astype(np.float32))
        assert dtypes["A_log"] == dtypes["D"] == "torch.float32"
        assert dtypes["in_proj"] == "torch.bfloat16"
        cast = params_from_numpy({"A_log": want[("layers", "mamba", "A_log")]}, "cpu",
                                 torch.bfloat16)
        assert cast["A_log"].dtype == torch.bfloat16
