"""The zoo paths of ``chip_smoke.py`` (phases 3p-3t) at their published
widths, shape-only on meta tensors.

For minicpm-2b, qwen3-9b, qwen2.5-32b, granite-20b and dbrx-132b at 1
and 2 layers (every other width, head count, vocab and expert count as
published), ``train_loss`` runs forward and backward under remat "full"
with the kernels registered.  On meta tensors every wrapper takes its
plain version's shapes, so each call is recorded at the wrapper: K1
(``rmsnorm_fwd``), K2 (``flash_attention_fwd``), K3 (``moe_gmm_fwd``)
and K3-bwd (``moe_gmm_bwd``, one launch for each of dx and dw asked
for).  Each call's shape must be one the wrapper admits and one that
phase 2 holds against its plain version, and the calls must number
what ``chip_smoke.train_launches`` counts for one step: the formula the
card's launch counters are held to.  The same formula is held for the
seven earlier training paths (phases 3-3l) at one or two layers (one
group of six for Zamba2), with K4 and K4-bwd recorded too.  The JAX
package has no shapes to add here; ``tests/test_torch_dense.py`` and
``tests/test_torch_moe.py`` hold these configs' loss and gradients to it
at reduced size.  What it does add is the first loss the zoo paths are
held to, ``chip_smoke.init_loss``: both packages' inits (each from its
own seed) give it at a width of 3072 within 0.1, where ln(vocab) is
0.61 away.
"""
import collections
import contextlib
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import init, train_loss
from repro_torch.tree import tree_leaves, tree_map

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its zoo paths, launch formula and phase 2 shapes)

ZOO = {arch: layers for _, arch, layers, _ in chip_smoke.ZOO}


@contextlib.contextmanager
def recorded_calls():
    """Every call of the kernels' wrappers inside the block, as (kernel
    name, launches it stands for, shapes of its tensor arguments, keyword
    arguments), with the kernels registered."""
    calls = []
    saved = {(fa, "flash_attention_fwd"): "flash_attention", (rn, "rmsnorm_fwd"): "rmsnorm",
             (mg, "moe_gmm_fwd"): "moe_gmm", (mg, "moe_gmm_bwd"): "moe_gmm_bwd",
             (ms, "mamba_scan_fwd"): "mamba_scan", (ms, "mamba_scan_bwd"): "mamba_scan_bwd"}
    originals = {key: getattr(*key) for key in saved}

    def recording(key, name):
        fn = originals[key]

        def call(*args, **kw):
            shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            # K3-bwd launches once for each of dx and dw it is asked for
            flags = (list(args[3:5]) + [kw.get("need_dx", True), kw.get("need_dw", True)][
                len(args[3:5]):]) if name == "moe_gmm_bwd" else [True]
            calls.append((name, sum(map(bool, flags)), shapes, kw))
            return fn(*args, **kw)
        return call
    for key, name in saved.items():
        setattr(*key, recording(key, name))
    ops.register_kernels()
    try:
        yield calls
    finally:
        ops.unregister_kernels()
        for key, fn in originals.items():
            setattr(*key, fn)


def zoo_cfg(arch: str, layers: int):
    return dataclasses.replace(get_config(arch), n_layers=layers)


def step_calls(cfg) -> list:
    """One training step's forward and backward of ``cfg`` on meta
    tensors (BATCH rows of ``path_seq`` tokens, as the card's paths
    train; the encoder-decoder's frames too)."""
    params = tree_map(lambda t: t.requires_grad_(True),
                      init(cfg, torch.Generator(), "meta"))
    batch = {key: torch.zeros((chip_smoke.BATCH, chip_smoke.path_seq(cfg)), dtype=torch.long,
                              device="meta") for key in ("tokens", "labels")}
    if cfg.n_enc_layers:
        batch["frames"] = torch.zeros((chip_smoke.BATCH, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    with recorded_calls() as calls:
        loss = train_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
    assert loss.shape == () and len(grads) == len(tree_leaves(params))
    assert all(g.shape == p.shape for g, p in zip(grads, tree_leaves(params)))
    return calls


CASES = [(arch, layers) for arch in ZOO for layers in (1, 2)]
# the earlier training paths (phases 3-3l), cut to a layer or two (Zamba2
# to one group, Whisper to as many encoder layers)
EARLIER = [("qwen1.5-0.5b", 2), ("falcon-mamba-7b", 1), ("falcon-mamba-7b", 2),
           ("deepseek-moe-16b", 1), ("deepseek-moe-16b", 2), ("qwen3-1b", 2),
           ("zamba2-2.7b", 6), ("whisper-large-v3", 1), ("qwen2-vl-7b", 2)]


def assert_formula(cfg) -> None:
    got = collections.Counter()
    for name, launches, _, _ in step_calls(cfg):
        got[name] += launches
    want = chip_smoke.train_launches(cfg, steps=1)
    assert {k: got.get(k, 0) for k in want} == want
    assert set(got) <= set(want)


@pytest.mark.parametrize("arch,layers", CASES)
def test_zoo_kernel_calls_match_the_launch_formula(arch, layers):
    """The recorded calls of one step number ``train_launches(cfg, 1)``
    per kernel, the formula phase 3p-3t holds the card's counters to."""
    assert_formula(zoo_cfg(arch, layers))


@pytest.mark.parametrize("arch,layers", EARLIER)
def test_earlier_paths_match_the_launch_formula(arch, layers):
    """``train_launches`` counts the earlier paths' calls too (phases
    3-3l hold their counters to it)."""
    cfg = zoo_cfg(arch, layers)
    if cfg.n_enc_layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=layers)
    assert_formula(cfg)


@pytest.mark.parametrize("arch,layers", CASES)
def test_zoo_kernel_calls_are_admitted_and_held_in_phase_2(arch, layers):
    """Every K1, K2, K3 and K3-bwd call of the step has a shape its
    wrapper admits (K2: ``head_dim_refusal`` and ``tc_refusal``; K3:
    ``_check_shapes`` and ``tc_dims``' 16-byte rows) and one that phase 2
    holds against its plain version on the card: K1 at ``K1_SHAPES``'
    rows, K2 at a shape of ``FLASH_TIMED`` or ``FLASH_PATHS``, K3 at
    ``gmm_shapes`` of the config."""
    cfg = zoo_cfg(arch, layers)
    flash_held = {(b, hq, hkv, s, s, d, True) for b, hq, hkv, s, d in chip_smoke.FLASH_TIMED}
    flash_held |= set(chip_smoke.FLASH_PATHS)
    gmm_held = set()
    if cfg.moe:
        for e, m, k, n in chip_smoke.gmm_shapes(cfg):
            gmm_held |= {((e, m, k), (e, k, n)), ((e, m, k), (e, k, n), (e, m, n))}
    seen = collections.Counter()
    for name, _, shapes, kw in step_calls(cfg):
        seen[name] += 1
        if name == "rmsnorm":
            x, w = shapes
            assert (x[0] * x[1], x[2]) in chip_smoke.K1_SHAPES and w == (x[-1],), shapes
        elif name == "flash_attention":
            q, k, v = shapes
            assert k == v and q[3] == k[3] == cfg.head_dim
            assert fa.head_dim_refusal(q[3]) is None and fa.tc_refusal(q) is None
            assert not kw.get("window") and kw.get("q_offset", 0) == 0
            assert (*q[:2], k[1], q[2], k[2], q[3], kw.get("causal", True)) in flash_held, shapes
        else:
            x, w = (torch.empty(s, device="meta", dtype=torch.bfloat16) for s in shapes[:2])
            mg._check_shapes(x, w)
            kdim, n = shapes[0][2], shapes[1][2]
            assert mg.tc_dims(torch.bfloat16, kdim, n) == (kdim, n)    # no padding copy
            assert shapes in gmm_held, shapes
    assert seen["rmsnorm"] and seen["flash_attention"]
    assert bool(seen["moe_gmm"]) == bool(seen["moe_gmm_bwd"]) == bool(cfg.moe)


@pytest.fixture
def _x64_off():
    """Other test modules flip jax_enable_x64 process-wide."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("arch", ["granite-20b", "minicpm-2b"])
def test_first_loss_is_the_inits_expected_loss(arch, _x64_off):
    """At width 3072 (one layer, fp32, vocab 4096, 4 x 256 tokens made with
    numpy from a seed) the first loss of the JAX package's init and of the
    port's init is ``chip_smoke.init_loss`` within 0.1: the lm_head (or,
    tied, the embedding) drawn N(0, 0.02^2) makes each logit N(0, 0.02^2
    d_model) behind the final norm, 0.61 nats over ln(vocab) here."""
    kw = dict(n_layers=1, d_model=3072, d_ff=256, vocab=4096, n_heads=24, dtype="float32")
    jcfg, tcfg = jconfigs.get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab, size=(4, 256)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    want = chip_smoke.init_loss(tcfg)
    assert want - np.log(tcfg.vocab) == pytest.approx(0.6144)
    jax_loss = float(jmodels.train_loss(jcfg, jmodels.init(jcfg, jax.random.PRNGKey(0)),
                                        {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        port_loss = float(train_loss(tcfg, init(tcfg, torch.Generator().manual_seed(0), "cpu"),
                                     {k: torch.as_tensor(v).long() for k, v in batch.items()}))
    print(f"init loss {want:.4f}: JAX {jax_loss:.4f}, port {port_loss:.4f}")
    assert abs(jax_loss - want) < 0.1 and abs(port_loss - want) < 0.1, (jax_loss, port_loss, want)


# phase 3u's paths: published widths with one field changed (qwen3-1b at
# head dim 512, 2 layers; Zamba2 at 256 states, one group of 6 layers)
WIDE = {label: cfg for _, label, cfg, _ in chip_smoke.wide_paths(get_config)}


@pytest.mark.parametrize("label", list(WIDE))
def test_phase_3u_paths_match_the_launch_formula_and_phase_2(label):
    """``train_launches`` counts phase 3u's calls, and each K2 and K4 call
    has a shape its wrapper admits and phase 2 holds on the card
    (``FLASH_WIDE``, ``FLASH_WINDOWS``, and K4 at (4, 1024, 5120, 256))."""
    cfg = WIDE[label]
    assert_formula(cfg)
    flash_held = {(b, hq, hkv, s, s, d, True, 0, None)
                  for b, hq, hkv, s, d in chip_smoke.FLASH_WIDE}
    flash_held |= set(chip_smoke.FLASH_WINDOWS)
    seen = collections.Counter()
    for name, _, shapes, kw in step_calls(cfg):
        seen[name] += 1
        if name == "flash_attention":
            q, k, _ = shapes
            assert fa.head_dim_refusal(q[3]) is None and fa.tc_refusal(q) is None
            key = (*q[:2], k[1], q[2], k[2], q[3], kw.get("causal", True), kw.get("q_offset", 0),
                   kw.get("window"))
            assert key in flash_held, key
        elif name in ("mamba_scan", "mamba_scan_bwd"):
            x, _, a = shapes[:3]
            assert (*x, a[1]) == (chip_smoke.BATCH, chip_smoke.SEQ, 5120, 256)
            assert ms.groups(a[1]) == 2
    assert seen["flash_attention"]
    assert bool(seen["mamba_scan"]) == bool(cfg.ssm)
