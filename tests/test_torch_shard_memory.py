"""The production SPMD lane holds only its shards, on the CPU.

Four cut dry-run cells over the fake process group on ``pod1`` (256
ranks), run at once, each held below a bound on its counted peak a
device; the counts before this repair, from the same commands, are in
the comments:

- qwen1.5-0.5b ``prefill_32k``, 2 layers, a 2,048-token prompt: the
  prefill's cache built in its shards (8.284 GiB before, 8 GiB of them
  the global K/V zeros);
- qwen1.5-0.5b ``decode_32k``, 2 layers: decode on the sequence-sharded
  cache, written in place (4.158 GiB before: gathered and stacked caches);
- falcon-mamba-7b ``train_4k``, 2 layers at 256 tokens in scan chunks of
  16: the ZeRO-3 gradients reduce-scattered in the backward (2.342 GiB
  before: whole fp32 gradients in the optimizer);
- minicpm-2b ``train_4k``, 2 layers: the cross-entropy chunk kept on the
  rows' shards for a vocab the model axis does not divide (61.302 GiB
  before: four fp32 (16, 2048, 122753) tensors);
- dbrx-132b ``train_4k`` and ``decode_32k``, 2 layers, through the
  grouped MoE: each rank of the model axis computes its share of the
  experts (train 53.179 GiB and 1.078e15 FLOPs a device before, every
  rank computing all 16 experts; decode 10.149 GiB before, 9.97 GiB of it
  the gathered expert stacks), the train cell held to the expert-parallel
  all-to-all block's run of the same cut (6.899 GiB, 1.039e14 FLOPs).

And the mechanisms, which outlast the bounds, in a fake world of 4 or 8
ranks on reduced configs (FakeTensorMode: placements and local shapes,
no data): every zero cache leaf ``prefill`` returns under an axis map
already has its shard's local shape; every gradient reaching
``adamw_update`` has its parameter's placements, and inside it the
lane's ``CollectiveCounter`` sees only all-reduces of scalars; the
grouped MoE's expert matmuls take the E/tp experts of their rank, and no
expert stack is all-gathered over the model axis.  On plain
tensors ``decode_step(donate=True)`` gives ``decode_step``'s bits in the
argument's own buffers, and ``decode_step`` leaves its argument as it
was.  In a one-rank gloo world on a (1, 1) mesh the sharded train,
prefill and decode steps give the bits of the same functions on local
tensors (the card's phases 3n(a), with the grouped MoE, 3n(b) and 3o(a)
on the CPU).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import decode_step, init, prefill
from repro_torch.tree import tree_flatten_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
GIB = 2 ** 30
TIMEOUT = 300
# name -> (dry-run arguments, bound on the counted peak in GiB)
CELLS = {
    "prefill": (["--arch", "qwen1.5-0.5b", "--shape", "prefill_32k", "--layers", "2",
                 "--seq", "2048"], 0.5),
    "decode": (["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--layers", "2",
                "--peak-sites", "4"], 1.0),
    "train_zero3": (["--arch", "falcon-mamba-7b", "--shape", "train_4k", "--layers", "2",
                     "--seq", "256", "--ssm-chunk", "16"], 1.0),
    "train_ce": (["--arch", "minicpm-2b", "--shape", "train_4k", "--layers", "2"], 8.0),
    "moe_train": (["--arch", "dbrx-132b", "--shape", "train_4k", "--layers", "2",
                   "--moe", "grouped"], 14.0),
    "moe_train_a2a": (["--arch", "dbrx-132b", "--shape", "train_4k", "--layers", "2",
                       "--moe", "a2a"], 8.0),
    "moe_decode": (["--arch", "dbrx-132b", "--shape", "decode_32k", "--layers", "2",
                    "--moe", "grouped"], 2.0),
}


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


class _Runs:
    """Subprocesses started together, each read once by the test that
    needs it (its last line starting with ``tag``, parsed as JSON)."""

    def __init__(self):
        self.procs, self.done = {}, {}

    def start(self, key, cmd, tag):
        self.procs[key] = (tag, subprocess.Popen(cmd, env=_env(), cwd=ROOT,
                                                 stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))

    def __call__(self, key):
        if key not in self.done:
            tag, proc = self.procs[key]
            stdout, stderr = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, (stdout[-2000:], stderr[-4000:])
            line = [ln for ln in stdout.splitlines() if ln.startswith(tag)][-1]
            self.done[key] = json.loads(line[len(tag):])
        return self.done[key]

    def stop(self):
        for _, proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module, started at its first test: the
    cut cells, the fake worlds, the one-rank world."""
    out = tmp_path_factory.mktemp("cells")
    r = _Runs()
    for name, (args, _) in CELLS.items():
        r.start(name, [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--mesh",
                       "pod1", "--device", "cpu", "--out", str(out / name), "--force"],
                "DRYRUN ")
    for mesh, (shape, names) in MESHES.items():
        r.start(mesh, [sys.executable, "-c", MECHANISMS, shape, names, ",".join(TRAIN_ARCHS),
                       ",".join(PREFILL_ARCHS)], "MECH ")
    r.start("one rank", [sys.executable, "-c", ONE_RANK], "ONE_RANK ")
    yield r
    r.stop()


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cut_cell_peak_is_bounded(runs, name):
    res = runs(name)
    assert res["status"] == "ok" and res["chips"] == 256
    peak = res["memory"]["peak_bytes"] / GIB
    assert peak <= CELLS[name][1], (name, peak)
    assert res["memory"]["argument_size_in_bytes"] > 0


def test_grouped_moe_is_held_to_the_all_to_all_blocks_counts(runs):
    """The grouped block computes E/tp experts a rank, as the all-to-all
    block does: FLOPs a device within 1.25x of its, counted peak within
    2x (10.4x and 7.7x before)."""
    grouped, a2a = runs("moe_train"), runs("moe_train_a2a")
    assert grouped["flops"] <= 1.25 * a2a["flops"], (grouped["flops"], a2a["flops"])
    peaks = [r["memory"]["peak_bytes"] for r in (grouped, a2a)]
    assert peaks[0] <= 2 * peaks[1], peaks


def test_peak_sites_name_the_ports_code(runs):
    """``--peak-sites``: the call sites holding the most bytes at the
    counted peak, the placed inputs among them, at most the peak in all."""
    mem = runs("decode")["memory"]
    sites = mem["peak_sites"]
    assert 0 < len(sites) <= 4 and "inputs" in sites
    assert sum(sites.values()) <= mem["peak_bytes"]
    assert any(".py:" in site for site in sites), sites


MECHANISMS = textwrap.dedent('''
    import dataclasses, json, math, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch.hlo_stats import CollectiveCounter
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import batch_specs
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_flatten_with_path

    shape = tuple(int(s) for s in sys.argv[1].split(","))
    names = tuple(sys.argv[2].split(","))
    init_fake_world(math.prod(shape))
    mesh = make_mesh(shape, names, device_type="cpu")
    strat = steps.strategy_for(mesh, zero_stage=3)
    out = {"train": {}, "prefill": {},
           "moe": {"experts": [], "gathers": [], "x_numel": [],
                   "model_group": mesh.get_group("model").group_name}}

    # the grouped MoE block (the default impl): the experts each expert
    # matmul takes, and the inputs of the all-gathers its forward issues
    def gmm(x, w):
        out["moe"]["experts"].append([x.shape[0], w.shape[0]])
        return L.moe_gmm_ref(x, w)
    L.register_impl("moe_gmm", gmm)

    class Gathers(CollectiveCounter):
        def seen(self, func, args, kwargs, res):
            super().seen(func, args, kwargs, res)
            if func._overloadpacket.__name__ == "all_gather_into_tensor":
                out["moe"]["gathers"].append([args[2], args[0].numel()])
    block = L._moe_block_on_shards

    def on_shards(p, x, **kw):
        out["moe"]["x_numel"].append(x.to_local().numel())
        with Gathers():
            return block(p, x, **kw)
    L._moe_block_on_shards = on_shards

    def cfg_of(arch):
        cfg = dataclasses.replace(get_config(arch).reduced(), remat="full")
        if arch == "minicpm-2b":      # a vocab the model axis does not divide
            cfg = dataclasses.replace(cfg, vocab=255, loss_chunk=8)
        return cfg

    real = steps.adamw_update
    seen = {}

    def spy(params, grads, opt, lr):
        p, g = dict(tree_flatten_with_path(params)), dict(tree_flatten_with_path(grads))
        seen["misplaced"] = ["/".join(k) for k in p
                             if tuple(g[k].placements) != tuple(p[k].placements)]
        seen["leaves"] = len(p)
        counter = CollectiveCounter()
        with counter:
            res = real(params, grads, opt, lr)
        seen["collectives"] = counter.records
        return res
    steps.adamw_update = spy
    for arch in sys.argv[3].split(","):
        seen.clear()
        steps.lower_cell(cfg_of(arch), mesh, strat, "train_4k", batch=8, seq=16)
        out["train"][arch] = dict(seen)
    for arch in sys.argv[4].split(","):
        cfg = cfg_of(arch)
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, avals = steps.sharded_prefill_step(
                cfg, mesh, strat, batch_avals=batch_specs(cfg, "prefill_32k", 8, 16),
                max_seq=32)
            args = fn.place(*(steps.fake_inputs(a, "cpu") for a in avals))
            got = {}
            inner = fn.fn

            def keep(*a):
                logits, cache = inner(*a)
                got.update(cache)
                return logits, cache
            fn.fn = keep
            fn(*args)
            want = dict(tree_flatten_with_path(fn.out_shardings[1]))
            rec = {}
            for name, t in got.items():
                if name in ("len", "enc_out"):
                    continue
                sh = want[(name,)]
                local = list(t.shape)
                for i, pl in enumerate(sh.placements):
                    if pl.is_shard():
                        local[pl.dim] //= mesh.size(i)
                rec[name] = {"dtensor": isinstance(t, DTensor),
                             "placed": isinstance(t, DTensor)
                             and tuple(t.placements) == tuple(sh.placements),
                             "local": list(t.to_local().shape) if isinstance(t, DTensor)
                             else list(t.shape), "want": local, "global": list(t.shape)}
            out["prefill"][arch] = rec
    print("MECH " + json.dumps(out))
''')

TRAIN_ARCHS = ("qwen3-1b", "deepseek-moe-16b", "falcon-mamba-7b", "zamba2-2.7b",
               "whisper-large-v3", "qwen2-vl-7b", "minicpm-2b")
PREFILL_ARCHS = ("qwen3-1b", "falcon-mamba-7b", "zamba2-2.7b", "whisper-large-v3")
MESHES = {"pod1-like": ("2,2", "data,model"), "pod2-like": ("2,2,2", "pod,data,model")}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gradients_reach_the_optimizer_in_their_params_placements(runs, mesh):
    for arch, rec in runs(mesh)["train"].items():
        assert rec["leaves"] > 0, arch
        assert rec["misplaced"] == [], (arch, rec["misplaced"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_the_optimizer_all_reduces_scalars_only(runs, mesh):
    """Inside ``adamw_update``: the global norm's sums of squares, one
    vector of scalars per set of mesh dims, and nothing else."""
    for arch, rec in runs(mesh)["train"].items():
        kinds = {kind for kind, _ in rec["collectives"]}
        assert kinds <= {"all-reduce"}, (arch, rec["collectives"])
        assert all(n <= 4 * rec["leaves"] for _, n in rec["collectives"]), (arch, rec)
        assert len(rec["collectives"]) <= 2 * len(MESHES[mesh][1].split(",")), (arch, rec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_grouped_moe_computes_its_share_of_the_experts(runs, mesh):
    """The reduced DeepSeek (4 experts) on a model axis of 2: every
    expert matmul's x and w hold 2 experts, and the block's forward
    all-gathers nothing over the model axis but its input's sequence
    (an expert stack was gathered there before)."""
    moe = runs(mesh)["moe"]
    assert moe["experts"] and all(e == [2, 2] for e in moe["experts"]), moe["experts"]
    over_model = [n for group, n in moe["gathers"] if group == moe["model_group"]]
    assert over_model and set(over_model) <= set(moe["x_numel"]), (over_model, moe["x_numel"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prefill_builds_its_cache_in_shards(runs, mesh):
    for arch, rec in runs(mesh)["prefill"].items():
        assert rec, arch
        for name, leaf in rec.items():
            assert leaf["dtensor"] and leaf["placed"], (arch, name, leaf)
            assert leaf["local"] == leaf["want"], (arch, name, leaf)
        # the K/V zeros (or the SSM states) are split, not whole
        big = rec.get("k", rec.get("ssm"))
        assert big["local"] != big["global"], (arch, big)


def _serve_inputs(cfg, b=2, s=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g)}
    if cfg.n_enc_layers:
        batch["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), generator=g) * 0.5
    toks = [torch.randint(0, cfg.vocab, (b, 1), generator=g) for _ in range(4)]
    return batch, toks


def _bits(t):
    return t.detach().contiguous().view(-1).view(torch.uint8).clone()


@pytest.mark.parametrize("arch", ["qwen3-1b", "falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-large-v3", "deepseek-moe-16b"])
def test_donated_decode_gives_decode_steps_bits_in_place(arch):
    """Four steps from a prefilled cache (the hybrid's window cut to 4
    slots, so its ``wpos`` clamps): the donated step writes every leaf in
    its own buffer with ``decode_step``'s bits, and ``decode_step`` leaves
    its argument's bits as they were."""
    cfg = get_config(arch).reduced()
    if cfg.hybrid_every:
        cfg = dataclasses.replace(cfg, sliding_window=4)
    params = init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch, toks = _serve_inputs(cfg)
    _, cache = prefill(cfg, params, batch, 16)
    donated = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in donated.items()}
    with torch.no_grad():
        for tok in toks:
            before = {k: _bits(v) for k, v in cache.items()}
            logits, new = decode_step(cfg, params, tok, cache)
            for k, v in cache.items():
                assert torch.equal(_bits(v), before[k]), (arch, k)
            got, donated = decode_step(cfg, params, tok, donated, donate=True)
            assert torch.equal(_bits(got), _bits(logits)), arch
            for k in new:
                assert donated[k].data_ptr() == ptrs[k], (arch, k)
                assert torch.equal(_bits(donated[k]), _bits(new[k])), (arch, k)
            cache = new
    assert int(donated["len"]) == 5 + len(toks)


ONE_RANK = textwrap.dedent('''
    import dataclasses, json, socket
    import torch, torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import prefill_cache_specs
    from repro_torch.launch.steps import (axis_map, sharded_decode_step, sharded_prefill_step,
                                          sharded_train_step, strategy_for)
    from repro_torch.launch.train import build_step
    from repro_torch.models import decode_step, init, prefill
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_flatten_with_path, tree_map

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    torch.set_num_threads(1)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    meta = lambda t: tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"), t)
    local = lambda t: (t.to_local() if hasattr(t, "to_local") else t).detach().clone()
    bits = lambda t: t.contiguous().view(-1).view(torch.uint8)
    out = {}

    def same(a, b):
        fa, fb = dict(tree_flatten_with_path(a)), dict(tree_flatten_with_path(b))
        assert fa.keys() == fb.keys()
        return sorted("/".join(k) for k in fa if not torch.equal(bits(local(fa[k])),
                                                                bits(local(fb[k]))))

    for arch in ("qwen3-1b", "falcon-mamba-7b", "deepseek-moe-16b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), remat="full")
        strat = strategy_for(mesh, zero_stage=3)
        params = init(cfg, torch.Generator().manual_seed(0), "cpu")
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=g),
                 "labels": torch.randint(0, cfg.vocab, (4, 16), generator=g)}
        fresh = lambda: {"params": tree_map(torch.clone, params),
                         "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)}
        state = fresh()
        fn, _ = sharded_train_step(cfg, mesh, strat, lr=3e-4, state_avals=meta(state),
                                   batch_avals=meta(batch))
        new, met = fn(state, batch)
        with axis_map(mesh, strat):
            ref, rmet = build_step(cfg, lambda step: 3e-4, "cpu")(fresh(), batch)
        out["train " + arch + (" grouped" if cfg.moe else "")] = same({"loss": met["loss"], "p": new["params"], "o": new["opt"]},
                                    {"loss": rmet["loss"], "p": ref["params"], "o": ref["opt"]})

    cfg = get_config("qwen3-1b").reduced()
    strat = strategy_for(mesh, zero_stage=3)
    params = init(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 8), generator=g)}
    pfn, _ = sharded_prefill_step(cfg, mesh, strat, batch_avals=meta(batch), max_seq=16)
    dfn, _ = sharded_decode_step(cfg, mesh, strat, cache_avals=prefill_cache_specs(cfg, 4, 16),
                                 batch_avals={"token": torch.empty((4, 1), dtype=torch.int64,
                                                                   device="meta")})
    logits, cache = pfn(params, batch)
    with torch.no_grad(), axis_map(mesh, strat):
        rl, rc = prefill(cfg, params, batch, 16)
    diffs = same({"l": logits, "c": cache}, {"l": rl, "c": rc})
    for i in range(3):
        tok = local(logits)[:, -1].argmax(-1).reshape(-1, 1)
        logits, cache = dfn(params, cache, {"token": tok})
        with torch.no_grad(), axis_map(mesh, strat):
            rl, rc = decode_step(cfg, params, tok, rc)
        diffs += same({"l": logits, "c": cache}, {"l": rl, "c": rc})
    out["serve qwen3-1b"] = diffs
    dist.destroy_process_group()
    print("ONE_RANK " + json.dumps(out))
''')


def test_one_rank_sharded_steps_give_local_bits(runs):
    res = runs("one rank")
    assert set(res) == {"train qwen3-1b", "train falcon-mamba-7b",
                        "train deepseek-moe-16b grouped", "serve qwen3-1b"}
    for what, differ in res.items():
        assert differ == [], (what, differ)
