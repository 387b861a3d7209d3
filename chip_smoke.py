"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds each kernel against its plain PyTorch version at the main
path's shapes and at edge shapes, trains full-width Qwen1.5-0.5B (24
layers, bf16, remat="full", random weights from a seed) for a few steps
through the port's own entry points with the kernels installed, checks
that every kernel of that path was launched, compares one step with
the plain versions (loss and every gradient leaf), runs the training
CLI at its defaults, and profiles where a full-width step's device time
goes (``torch.profiler``), with the kernels and with their plain
versions.  It prints the card's name and power limit, one JSON line of
kernel numbers, and as its last line ``{"ok": true, "device": {...}}``.
Any failed phase ends the run with a non-zero exit code and no result.

Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
STEPS = 6
BATCH, SEQ = 4, 1024
# fp32 and bf16 tolerances of the kernel checks (tests/test_kernels.py)
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)}
# one full-width step, kernels against plain versions: (loss relative
# error, relative L2 error of each gradient leaf; layers are stacked, so
# a leaf pools every layer).  bf16 at 24 layers, and fp32 at 2 layers.
PLAIN_RTOL = {"bfloat16": (1e-3, 5e-2), "float32": (1e-5, 1e-3)}
# H100 SXM published peaks at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Mean device milliseconds per call by CUDA events, after a warm-up.
    The device first spins for ~50 ms so the host can queue every call
    before the first one starts: the events then time the device, not
    the host's launch rate (a small kernel takes less time on the card
    than its Python wrapper takes to launch it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_close(torch, name, got, want, dtype: str) -> float:
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max abs err {err.max().item():.3e}")
    return err.max().item()


def phase_kernels(torch, F, fa, rn) -> dict:
    """Each kernel against its plain version; times at the main path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(1234)

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)

    results = {}
    # K1 rmsnorm: the model's (B*S, d_model) rows, and 130 rows
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for shape in ((BATCH * SEQ, 1024), (130, 1024), (3, 5, 256)):
            x, w = randn(shape, dt), randn(shape[-1:], dt, 0.5, 1.0)
            y = rn.rmsnorm_fwd(x, w)
            torch.cuda.synchronize()
            err = check_close(torch, f"rmsnorm {dname} {shape}", y, rn.rmsnorm_plain(x, w), dname)
            print(f"  rmsnorm {dname:8s} {str(shape):16s} max_abs_err={err:.3e}", flush=True)
            if dt == torch.bfloat16 and shape == (BATCH * SEQ, 1024):
                results["rmsnorm"] = {"max_abs_err": err}
    x, w = randn((BATCH * SEQ, 1024), torch.bfloat16), randn((1024,), torch.bfloat16, 0.5, 1.0)
    n_bytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    n_ops = 5 * x.numel()      # square, sum, scale, cast, weight: fp32 CUDA-core ops
    results["rmsnorm"].update(
        ms=cuda_ms(torch, lambda: rn.rmsnorm_fwd(x, w)),
        plain_ms=cuda_ms(torch, lambda: rn.rmsnorm_plain(x, w)),
        library_ms=cuda_ms(torch, lambda: F.rms_norm(x, (1024,), w, 1e-6)),
        **bound(n_bytes, n_ops / FP32_FLOPS))

    # K2 flash attention: the model's shape, then MQA / GQA / offsets / D=128 / ragged.
    # lse is fp32 on both sides in either dtype, so it is held at the fp32 tolerance.
    cases = [(4, 16, 16, 1024, 1024, 64, True), (2, 4, 1, 64, 64, 64, True),
             (1, 8, 2, 64, 128, 64, True), (1, 8, 2, 100, 300, 64, True),
             (1, 2, 2, 32, 48, 128, False), (2, 4, 2, 40, 72, 128, True),
             (1, 4, 4, 1000, 1000, 64, True)]
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for b, hq, hkv, sq, skv, d, causal in cases:
            q = randn((b, hq, sq, d), dt)
            k, v = randn((b, hkv, skv, d), dt), randn((b, hkv, skv, d), dt)
            off = skv - sq if causal else 0
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, q_offset=off)
            tag = f"flash {dname} {(b, hq, hkv, sq, skv, d, causal)}"
            err = check_close(torch, tag, out, want, dname)
            lse_err = check_close(torch, tag + " lse", lse, want_lse, "float32")
            print(f"  {tag} max_abs_err={err:.3e} lse_err={lse_err:.3e}", flush=True)
            if dt == torch.bfloat16 and (b, hq, sq, d) == (4, 16, 1024, 64):
                results["flash_attention"] = {"max_abs_err": max(err, lse_err)}
    q = randn((BATCH, 16, SEQ, 64), torch.bfloat16)
    k, v = randn((BATCH, 16, SEQ, 64), torch.bfloat16), randn((BATCH, 16, SEQ, 64), torch.bfloat16)
    pairs = BATCH * 16 * SEQ * (SEQ + 1) // 2          # causal (query, key) pairs computed
    n_bytes = 4 * q.numel() * q.element_size() + BATCH * 16 * SEQ * 4   # q, k, v, out, lse
    results["flash_attention"].update(
        ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
        plain_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                                           is_causal=True)),
        **bound(n_bytes, 4 * 64 * pairs / BF16_FLOPS))
    return results


def bound(n_bytes: int, op_seconds: float) -> dict:
    byte_seconds = n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(byte_seconds, op_seconds) * 1e3,
            "bound_by": "bytes" if byte_seconds >= op_seconds else "operations"}


def phase_train(torch) -> dict:
    """Full-width Qwen1.5-0.5B through the port's entry points, with kernels."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    from repro_torch.ft import Supervisor
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_step
    from repro_torch.models import init
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = get_config("qwen1.5-0.5b")
    print(f"  config {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"dtype={cfg.dtype} remat={cfg.remat} params={cfg.param_count()}", flush=True)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    lr_fn = cosine_schedule(3e-4, STEPS)
    ops.register_kernels()
    step_fn = build_step(cfg, lr_fn, "cuda")

    def synced_step(state, batch):     # the supervisor times each step by the host clock
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        return out

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        loader = TokenLoader(SyntheticTokenSource(cfg.vocab, seed=17), batch=BATCH, seq=SEQ)
        sup = Supervisor(CheckpointManager(tmp, keep=1), loader, checkpoint_every=STEPS)
        ops.reset_launch_counts()
        state = sup.run(state, synced_step, STEPS, log_every=1)
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in sup.history]
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        fail(f"first loss {losses[0]} not within 1.0 of ln(vocab) = {math.log(cfg.vocab)}")
    want = {"rmsnorm": (4 * cfg.n_layers + 1) * STEPS,   # 2/layer fwd + recompute, + final
            "flash_attention": 2 * cfg.n_layers * STEPS}  # 1/layer fwd + recompute
    print(f"  launch counts {counts}, expected {want}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} != {want}")

    compare_with_plain(torch, cfg, params, losses[0])
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    compare_with_plain(torch, cfg32, init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                                          "cuda"))

    dts = [h["dt"] for h in sup.history[1:]]
    step_s = statistics.median(dts)
    print(f"  full width: {STEPS} steps, losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"  step time median {step_s * 1e3:.1f} ms over steps 2-{STEPS} "
          f"(min {min(dts) * 1e3:.1f}, max {max(dts) * 1e3:.1f}), "
          f"{BATCH * SEQ / step_s:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)", flush=True)
    return counts, {"state": state, "step_fn": step_fn, "loader": loader}


def compare_with_plain(torch, cfg, params, step_loss: float | None = None) -> None:
    """Step 1's loss and every gradient leaf on the same weights and
    batch, with the kernels and with their plain versions, held to
    ``PLAIN_RTOL`` of the config's dtype.  ``step_loss`` is the kernel
    loss the training step reported, if any.  The gradients go through
    the flash backward, which reuses K2's lse."""
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    from repro_torch.kernels import ops
    from repro_torch.models import train_loss
    from repro_torch.tree import tree_flatten_with_path, tree_map

    first = TokenLoader(SyntheticTokenSource(cfg.vocab, seed=17), batch=BATCH,
                        seq=SEQ).next_batch()
    batch = {k: torch.as_tensor(v, device="cuda").long() for k, v in first.items()}
    paths = ["/".join(path) for path, _ in tree_flatten_with_path(params)]

    def loss_and_grads():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = train_loss(cfg, p, batch)
        leaves = [leaf for _, leaf in tree_flatten_with_path(p)]
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.float() for g in grads]

    ops.register_kernels()
    k_loss, k_grads = loss_and_grads()
    ops.unregister_kernels()
    p_loss, p_grads = loss_and_grads()
    loss_rtol, grad_rtol = PLAIN_RTOL[cfg.dtype]
    first_loss = k_loss if step_loss is None else step_loss
    rel = abs(p_loss - first_loss) / abs(p_loss)
    print(f"  {cfg.dtype}, {cfg.n_layers} layers: step 1 loss: kernels {first_loss:.6f} "
          f"(outside the step: {k_loss:.6f}), plain {p_loss:.6f} (rel diff {rel:.3e}, "
          f"limit {loss_rtol})", flush=True)
    if rel > loss_rtol:
        fail("kernel and plain losses disagree")
    errs = {name: ((k - p).norm() / p.norm()).item()
            for name, k, p in zip(paths, k_grads, p_grads)}
    k_norm = torch.sqrt(sum(g.square().sum() for g in k_grads)).item()
    p_norm = torch.sqrt(sum(g.square().sum() for g in p_grads)).item()
    print(f"  step 1 grad norm: kernels {k_norm:.6f}, plain {p_norm:.6f}; relative L2 "
          f"error per leaf (limit {grad_rtol}):", flush=True)
    for name, err in errs.items():
        print(f"    {name:24s} {err:.3e}", flush=True)
    worst = max(errs, key=errs.get)
    if not all(math.isfinite(e) for e in errs.values()) or errs[worst] > grad_rtol:
        fail(f"kernel and plain gradients disagree: {worst} at {errs[worst]:.3e}")


def phase_cli(torch) -> None:
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = train.main(["--ckpt-dir", tmp])
        torch.cuda.synchronize()
        print(f"  CLI at its defaults: rc={rc} in {time.perf_counter() - t0:.1f} s, "
              f"launches {ops.launch_counts()}", flush=True)
    if rc != 0:
        fail(f"CLI returned {rc}")


# kernel-name substrings -> family, first match wins
FAMILIES = [("rmsnorm_kernel", "K1 rmsnorm"), ("flash_fwd_kernel", "K2 flash fwd"),
            ("gemm", "matmul"), ("cutlass", "matmul"), ("sm90_xmma", "matmul"),
            ("nvjet", "matmul"), ("reduce", "reductions"), ("softmax", "reductions"),
            ("elementwise", "elementwise"), ("copy", "copies/casts"),
            ("cat", "copies/casts"), ("index", "gather/scatter"),
            ("scatter", "gather/scatter"), ("gather", "gather/scatter")]
PROFILED_STEPS = 2


def _family(name: str) -> str:
    low = name.lower()
    return next((fam for key, fam in FAMILIES if key in low), "other")


def phase_profile(torch, train: dict) -> None:
    """Where a full-width step's device time goes, with the kernels and
    then with their plain versions: one warm-up step, then two steps
    under ``torch.profiler``, continuing phase 3's training state."""
    from repro_torch.kernels import ops
    state, step_fn, loader = train["state"], train["step_fn"], train["loader"]
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for mode in ("kernels", "plain"):
        if mode == "kernels":
            ops.register_kernels()
        else:
            ops.unregister_kernels()
        state, _ = step_fn(state, loader.next_batch())
        batches = [loader.next_batch() for _ in range(PROFILED_STEPS)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=act) as prof:
            start.record()
            for b in batches:
                state, _ = step_fn(state, b)
            stop.record()
            torch.cuda.synchronize()
        step_ms = start.elapsed_time(stop) / PROFILED_STEPS
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / PROFILED_STEPS / 1e3
        fam: dict[str, float] = {}
        by_name: dict[str, list] = {}
        for e in kernels:
            ms = e.time_range.elapsed_us() / PROFILED_STEPS / 1e3
            fam[_family(e.name)] = fam.get(_family(e.name), 0.0) + ms
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += ms
            rec[1] += 1
        print(f"  {mode}: step {step_ms:.2f} ms (CUDA events, profiled), device busy "
              f"{busy_ms:.2f} ms/step = {busy_ms / step_ms:.1%} of the step, "
              f"{len(kernels) // PROFILED_STEPS} kernel launches/step", flush=True)
        for f, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
            print(f"    {f:16s} {ms:8.2f} ms/step  {ms / busy_ms:6.1%}", flush=True)
        print("    top kernels (ms/step, launches/step):", flush=True)
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"    {ms:8.3f} {n // PROFILED_STEPS:5d}  {name[:100]}", flush=True)
    ops.unregister_kernels()


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {__file__}: run from a checkout of the repository")
    sys.path.insert(0, str(src))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU")
    print(gpu_line(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("allow_tf32: matmul False, cudnn False", flush=True)

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    print("[1/5] build", flush=True)
    names = [p.name for p in _build.sources()]
    print(f"  built {names} in {_build.build(verbose=True):.1f} s", flush=True)

    print("[2/5] kernels against their plain versions", flush=True)
    results = phase_kernels(torch, F, fa, rn)

    print("[3/5] full-width training", flush=True)
    counts, train = phase_train(torch)

    print("[4/5] training CLI", flush=True)
    phase_cli(torch)

    print("[5/5] where a full-width step's device time goes", flush=True)
    phase_profile(torch, train)

    meta = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:19"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:27")}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
