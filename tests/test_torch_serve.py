"""The port's serving path on the CPU against the JAX package.

``decode_attention`` (GQA, MQA, a cache length as an int and as a 0-d
tensor, windows, several queries); ``attention_block``'s KV-cache branch
with RoPE and with M-RoPE and non-zero qkv biases, including a write whose
start is clamped; ``mamba_block`` with its conv and SSM states, both
versions, equal to the JAX block's triple and, whole against split, to
itself; then, for all twelve reduced configs, ``init_cache``'s layout,
``prefill``'s logits and cache, and 8 greedy ``decode_step``s (every
step's tokens equal, its logits and every cache leaf within ``TOL``),
with the plain references and through ``register_kernels()`` (whose
wrappers take the plain versions on CPU tensors).  Besides: a pure
Mamba-2 stack (falcon-mamba-7b with a version-2 SSM), Zamba2 with a
window of 8 decoded past it (the ``wpos`` clamp), the VLM prefilled over
image-layout positions, incremental decode from an empty cache against
the training forward in both packages, and ``examples/serve_torch.py``
on the CPU for one arch of each family.  Inputs are made with numpy from
a seed and JAX-initialised weights cross through the interop module;
``jax_enable_x64`` is off in a fixture (both JAX scans refuse fp64).
"""
import dataclasses
import functools
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.models import SSMCfg, decode_step, init_cache, prefill
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "examples")]
import serve as jax_serve  # noqa: E402  (the JAX example, for its printed lines)
import serve_torch  # noqa: E402
from chip_smoke import image_positions  # noqa: E402

B, S, STEPS = 2, 16, 8
# fp32 across the two frameworks: the flash kernels' fp32 tolerance.  On
# these configs the logits (|x| <= ~0.6) differ by at most ~1e-6 and the
# cache leaves by at most ~5e-6.
TOL = dict(atol=2e-5, rtol=2e-5)
# one arch of each family for the example
EXAMPLE_ARCHS = ["qwen1.5-0.5b", "deepseek-moe-16b", "falcon-mamba-7b", "whisper-large-v3",
                 "qwen2-vl-7b", "zamba2-2.7b"]


@pytest.fixture(autouse=True)
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def kernels(request):
    """Runs the test with the kernels' wrappers registered when the param
    is true (the plain versions on CPU tensors), and unregisters them."""
    if request.param:
        ops.register_kernels()
    yield request.param
    ops.unregister_kernels()


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    """numpy leaves of a JAX or a port tree (dicts, tuples, arrays)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return params_to_numpy(tree)
    return np.asarray(tree)


def _close(got, want, msg=""):
    """Two numpy trees: the same keys, shapes and dtypes, values within TOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), msg
        for k in want:
            _close(got[k], want[k], f"{msg}/{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (msg, got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got, want, err_msg=msg, **TOL)


def _variant(name: str, variant: str | None):
    """(JAX config, port config) of a reduced arch: as it is, ``mamba2``
    (the pure Mamba stack with a version-2 SSM) or ``window8`` (the
    hybrid with a sliding window of 8)."""
    jcfg, tcfg = jconfigs.get_config(name).reduced(), get_config(name).reduced()
    if variant == "mamba2":
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, version=2))
        tcfg = dataclasses.replace(tcfg, ssm=SSMCfg(**dataclasses.asdict(jcfg.ssm)))
    elif variant == "window8":
        jcfg = dataclasses.replace(jcfg, sliding_window=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(name: str, variant: str | None = None):
    """(JAX config, port config, JAX params, the same params in the port)."""
    jcfg, tcfg = _variant(name, variant)
    jp = jmodels.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(_np(jp), "cpu")


def _batches(jcfg, s: int = S, seed: int = 0, positions=None):
    """The same prompt (and frames, and M-RoPE positions) for both packages."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab, (B, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}
    if jcfg.n_enc_layers:
        frames = _normal(rng, B, jcfg.enc_seq, jcfg.d_model)
        jb["frames"], tb["frames"] = jnp.asarray(frames), torch.from_numpy(frames)
    if positions is not None:
        jb["mrope_positions"] = jnp.asarray(positions.astype(np.int32))
        tb["mrope_positions"] = torch.from_numpy(positions)
    return jb, tb


def _image_positions(s: int):
    """Image-layout M-RoPE positions: one 2 x 3 grid after 2 and 5 tokens."""
    return image_positions(B, s, (2, 3), [2, 5])


@functools.lru_cache(maxsize=None)
def _greedy_jax(name, variant, s, steps, image=False):
    """The JAX package's prefill (over image-layout positions with
    ``image``), then ``steps`` greedy decode steps: numpy (prefill logits,
    prefill cache, [(logits, cache, tokens) per step])."""
    jcfg, _, jp, _ = _models(name, variant)
    jb, _ = _batches(jcfg, s, positions=_image_positions(s) if image else None)
    logits, cache = jmodels.prefill(jcfg, jp, jb, max_seq=s + steps)
    first = (_np(logits), _np(cache))
    step = jax.jit(functools.partial(jmodels.decode_step, jcfg))
    out = []
    for _ in range(steps):
        tok = jnp.argmax(logits[:, -1], axis=-1).reshape(B, 1).astype(jnp.int32)
        logits, cache = step(jp, tok, cache)
        out.append((_np(logits), _np(cache), np.asarray(tok)))
    return first, out


def _check_greedy(name, variant=None, s=S, steps=STEPS, image=False):
    """The port's prefill and greedy decode against the JAX package's: the
    prefill's logits and cache, then each step's input tokens (equal),
    logits and every cache leaf."""
    (want_logits, want_cache), want_steps = _greedy_jax(name, variant, s, steps, image)
    jcfg, tcfg, _, tp = _models(name, variant)
    _, tb = _batches(jcfg, s, positions=_image_positions(s) if image else None)
    with torch.no_grad():
        logits, cache = prefill(tcfg, tp, tb, max_seq=s + steps)
        _close(_np(logits), want_logits, f"{name} prefill logits")
        _close(_np(cache), want_cache, f"{name} prefill cache")
        for i, (w_logits, w_cache, w_tok) in enumerate(want_steps):
            tok = logits[:, -1].argmax(-1).reshape(B, 1)
            np.testing.assert_array_equal(tok.numpy(), w_tok, err_msg=f"{name} step {i} tokens")
            logits, cache = decode_step(tcfg, tp, tok, cache)
            _close(_np(logits), w_logits, f"{name} step {i} logits")
            _close(_np(cache), w_cache, f"{name} step {i} cache")


# ---------------------------------------------------------------------------
# decode_attention and the cache branch of attention_block
# ---------------------------------------------------------------------------

# (b, hq, hkv, sq, smax, d, cache_len, window)
DECODE_ATTN = {"gqa": (2, 4, 2, 1, 16, 8, 5, None), "mqa": (2, 4, 1, 1, 16, 8, 16, None),
               "one-key": (1, 2, 2, 1, 10, 8, 1, None), "window": (1, 4, 4, 1, 12, 8, 9, 4),
               "window-gqa": (2, 6, 2, 1, 20, 16, 20, 7),
               "three-queries": (2, 4, 2, 3, 20, 16, 7, None)}


@pytest.mark.parametrize("case", DECODE_ATTN.values(), ids=DECODE_ATTN.keys())
def test_decode_attention_matches_jax(case):
    b, hq, hkv, sq, smax, d, cache_len, window = case
    rng = np.random.default_rng(sum(case[:6]))
    q = _normal(rng, b, hq, sq, d)
    k, v = _normal(rng, b, hkv, smax, d), _normal(rng, b, hkv, smax, d)
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           cache_len, window=window))
    for length in (cache_len, torch.tensor(cache_len, dtype=torch.int32)):
        got = TA.decode_attention(*map(torch.from_numpy, (q, k, v)), length, window=window)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_attention_scale_is_fixed():
    """The flash paths' rule (``check_scale``): the default scale, given
    explicitly, is accepted; another raises where the JAX function would
    use it."""
    q, k = torch.ones(1, 2, 1, 16), torch.ones(1, 2, 4, 16)
    want = TA.decode_attention(q, k, k, 3)
    torch.testing.assert_close(TA.decode_attention(q, k, k, 3, sm_scale=16 ** -0.5), want)
    with pytest.raises(ValueError, match="fixed scale"):
        TA.decode_attention(q, k, k, 3, sm_scale=0.5)


@pytest.mark.parametrize("arch", ["qwen3-1b", "qwen2-vl-7b"], ids=["rope", "mrope-bias"])
@pytest.mark.parametrize("s,cache_len", [(1, 5), (3, 7), (3, 15)],
                         ids=["one-token", "three-tokens", "clamped-start"])
def test_attention_block_cache_matches_jax(arch, s, cache_len):
    """New keys and values written at ``cache_len`` (start clamped to Smax
    - S, as ``dynamic_update_slice`` clamps it), the rotation offset by
    ``cache_len`` (the M-RoPE streams too), the queries over the first
    ``cache_len + S`` positions; the caller's cache is left as it was."""
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(s * 100 + cache_len)
    jp = JL.init_attn(jax.random.PRNGKey(1), jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
                      jcfg.head_dim, jcfg.qkv_bias, jnp.float32)
    jp = {k: (jnp.asarray(_normal(rng, *v.shape, scale=0.5)) if k.startswith("b") else v)
          for k, v in jp.items()}
    smax = 16
    x = _normal(rng, B, s, jcfg.d_model)
    ck, cv = (_normal(rng, B, jcfg.n_kv_heads, smax, jcfg.head_dim) for _ in range(2))
    want, (wk, wv) = JL.attention_block(jp, jnp.asarray(x), jcfg,
                                        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
                                        cache_len=jnp.asarray(cache_len, jnp.int32))
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    got, (gk, gv) = TL.attention_block(params_from_numpy(_np(jp), "cpu"), torch.from_numpy(x),
                                       tcfg, kv_cache=(tk, tv),
                                       cache_len=torch.tensor(cache_len, dtype=torch.int32))
    _close(_np(got), np.asarray(want), "out")
    _close(gk.numpy(), np.asarray(wk), "k")
    _close(gv.numpy(), np.asarray(wv), "v")
    np.testing.assert_array_equal(tk.numpy(), ck)
    np.testing.assert_array_equal(tv.numpy(), cv)


# ---------------------------------------------------------------------------
# mamba_block with states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version,kernels", [(1, False), (1, True), (2, False)],
                         ids=["v1", "v1-kernels", "v2"], indirect=["kernels"])
def test_mamba_block_states(version, kernels):
    """(out, new_conv, hT) from given conv and SSM states equal the JAX
    block's triple; and in the port, a sequence run whole from zeros
    equals it run in three parts (5 tokens, 1, then 6), each part from
    the last one's states (the JAX test of the scan's continuation,
    ``tests/test_layer_numerics.py``, for the whole block)."""
    d, n, headdim, s = 32, 8, 16, 12
    jp = JL.init_mamba(jax.random.PRNGKey(version), d, n, version, jnp.float32,
                       headdim=headdim)
    tp = params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(version)
    di = 2 * d
    x = _normal(rng, B, s, d)
    conv = _normal(rng, B, 3, di, scale=0.5)
    ssm = _normal(rng, *((B, di, n) if version == 1 else (B, di // headdim, headdim, n)),
                  scale=0.5)
    kw = dict(state=n, version=version, headdim=headdim, chunk=4)
    want = JL.mamba_block(jp, jnp.asarray(x), conv_state=jnp.asarray(conv),
                          ssm_state=jnp.asarray(ssm), **kw)
    got = TL.mamba_block(tp, torch.from_numpy(x), conv_state=torch.from_numpy(conv),
                         ssm_state=torch.from_numpy(ssm), **kw)
    for name, g, w in zip(("out", "conv", "ssm"), got, want):
        _close(_np(g), np.asarray(w), name)

    xt = torch.from_numpy(x)
    whole = TL.mamba_block(tp, xt, **kw)
    ys, c, h = [], None, None
    for lo, hi in ((0, 5), (5, 6), (6, s)):
        y, c, h = TL.mamba_block(tp, xt[:, lo:hi], conv_state=c, ssm_state=h, **kw)
        ys.append(y)
    for name, g, w in zip(("out", "conv", "ssm"), (torch.cat(ys, 1), c, h), whole):
        torch.testing.assert_close(g, w, **TOL, msg=name)


# ---------------------------------------------------------------------------
# init_cache, prefill, decode_step on the twelve reduced configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout(arch):
    """Keys, shapes and dtypes of the JAX package's ``init_cache``, all
    zeros, on the device asked for."""
    jcfg, tcfg, _, _ = _models(arch)
    want = _np(jmodels.init_cache(jcfg, B, S + STEPS))
    got = init_cache(tcfg, B, S + STEPS, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in _np(got).items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert all(not v.any() for v in got.values())
    assert {v.device.type for v in got.values()} == {"cpu"}


def test_serving_defaults_to_cuda():
    """The serving entry points ask for the card unless told otherwise:
    without one they raise, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(get_config("qwen3-1b").reduced(), B, S)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_torch.main(["--arch", "qwen3-1b"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """Last-token logits, and the cache as the JAX package's prefill leaves
    it: zeros with ``len`` = S (and ``enc_out`` for Whisper)."""
    jcfg, tcfg, jp, tp = _models(arch)
    jb, tb = _batches(jcfg)
    want_logits, want_cache = jmodels.prefill(jcfg, jp, jb, max_seq=S + STEPS)
    with torch.no_grad():
        logits, cache = prefill(tcfg, tp, tb, max_seq=S + STEPS)
    assert logits.shape == (B, 1, tcfg.vocab)
    _close(_np(logits), np.asarray(want_logits), "logits")
    _close(_np(cache), _np(want_cache), "cache")
    assert int(cache["len"]) == S


@pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"], indirect=True)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_jax(arch, kernels):
    _check_greedy(arch)


@pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"], indirect=True)
def test_greedy_decode_mamba2_stack(kernels):
    """A pure Mamba-2 stack: per-layer (B, H, P, N) states through the SSD
    scan with ``h0``."""
    _check_greedy("falcon-mamba-7b", "mamba2")


@pytest.mark.parametrize("kernels", [False, True], ids=["ref", "kernels"], indirect=True)
def test_zamba2_window_clamp(kernels):
    """Zamba2 with a window of 8 from a 4-token prompt, decoded 8 tokens:
    the window cache is written at ``wpos = min(len, 7)``, so past the
    window the last slot is overwritten and RoPE rotates by 7, as in the
    JAX package."""
    jcfg, tcfg, _, _ = _models("zamba2-2.7b", "window8")
    assert init_cache(tcfg, B, 4 + STEPS, device="cpu")["k"].shape[3] == 8
    assert init_cache(tcfg, B, 6, device="cpu")["k"].shape[3] == 6
    _check_greedy("zamba2-2.7b", "window8", s=4)


def test_vlm_prefill_over_image_positions():
    """Qwen2-VL prefilled over image-layout M-RoPE positions; decode goes
    on from ``len`` on the text-only streams, as in the JAX package."""
    _check_greedy("qwen2-vl-7b", image=True)


# ---------------------------------------------------------------------------
# incremental decode from an empty cache equals the training forward
# ---------------------------------------------------------------------------

INCREMENTAL = {"dense": ("qwen3-1b", None), "mamba1": ("falcon-mamba-7b", None),
               "mamba2": ("falcon-mamba-7b", "mamba2"), "hybrid": ("zamba2-2.7b", None),
               "vlm": ("qwen2-vl-7b", None)}


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("family", INCREMENTAL.keys())
def test_incremental_decode_equals_forward(family, package):
    """``decode_step`` from ``init_cache``, teacher-forced over the prompt,
    gives at each position the training forward's logits there: the cache
    writes, the offset rotation, the masks and the carried states are
    right.  (``prefill`` cannot show it: its cache stays empty.)"""
    name, variant = INCREMENTAL[family]
    jcfg, tcfg, jp, tp = _models(name, variant)
    jb, tb = _batches(jcfg, seed=3)
    if package == "jax":
        h, _ = JM._run_decoder(jcfg, jp, jp["embed"][jb["tokens"]])
        want = np.asarray(JM._logits(jcfg, jp, h))
        cache = jmodels.init_cache(jcfg, B, S)
        step = jax.jit(functools.partial(jmodels.decode_step, jcfg))
        got = []
        for t in range(S):
            logits, cache = step(jp, jb["tokens"][:, t:t + 1], cache)
            got.append(np.asarray(logits))
    else:
        with torch.no_grad():
            h, _ = TM._run_decoder(tcfg, tp, tp["embed"][tb["tokens"]])
            want = TM._logits(tcfg, tp, h).numpy()
            cache = init_cache(tcfg, B, S, device="cpu")
            got = []
            for t in range(S):
                logits, cache = decode_step(tcfg, tp, tb["tokens"][:, t:t + 1], cache)
                got.append(logits.numpy())
    np.testing.assert_allclose(np.concatenate(got, axis=1), want, **TOL)


# ---------------------------------------------------------------------------
# examples/serve_torch.py
# ---------------------------------------------------------------------------

ARGS = ["--batch", "2", "--prompt-len", "8", "--tokens", "4"]


def _form(text: str) -> list:
    """The printed lines with every number replaced by '#'."""
    return [re.sub(r"\d+", "#", line) for line in text.strip().splitlines()]


@pytest.mark.parametrize("arch", EXAMPLE_ARCHS)
def test_serve_example_on_cpu(arch, capsys):
    """The example's four lines, and the ids it returns are the port's own
    prefill and greedy decode on the same weights and prompts."""
    gen = serve_torch.main(["--device", "cpu", "--arch", arch, *ARGS])
    lines = capsys.readouterr().out.strip().splitlines()
    cfg = get_config(arch).reduced()
    assert lines[0] == f"arch={cfg.name} ({cfg.family})  batch=2"
    assert re.fullmatch(r"prefill 8 tokens: \d+ ms", lines[1])
    assert re.fullmatch(r"decode 4 tokens: \d+ ms \(\d+ tok/s\)", lines[2])
    assert lines[3] == f"generated ids[0]: {gen[0].tolist()}"
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": prompts}
    if cfg.n_enc_layers:
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                      generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        logits, cache = prefill(cfg, params, batch, max_seq=12)
        toks = [logits[:, -1].argmax(-1).reshape(2, 1)]
        for _ in range(3):
            logits, cache = decode_step(cfg, params, toks[-1], cache)
            toks.append(logits[:, -1].argmax(-1).reshape(2, 1))
    assert torch.equal(gen, torch.cat(toks, 1))


def test_serve_example_prints_the_jax_example_lines(capsys):
    """Line for line the JAX example's output, up to the numbers."""
    jax_serve.main(["--arch", "zamba2-2.7b", *ARGS])
    want = _form(capsys.readouterr().out)
    serve_torch.main(["--device", "cpu", "--arch", "zamba2-2.7b", *ARGS])
    assert _form(capsys.readouterr().out) == want
