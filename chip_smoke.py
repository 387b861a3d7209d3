"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, checks in the library's SASS (``cuobjdump -sass``) that every
instantiation of the bf16 K2 and K3 kernels issues tensor-core ``wgmma``
(HGMMA) and TMA loads (UTMALDG) and that no instantiation of the scan
kernels K4 and K4-bwd touches local memory (LDL, STL), and holds each
kernel against its plain PyTorch version at the main paths' shapes and
at edge shapes (and K4-bwd against itself: two runs, the same bits).
Then, for each of the port's three training paths, it trains the model
at its published widths (random weights from a seed, bf16,
remat="full") for a few steps through the port's own entry points with
the kernels installed, checks that every kernel of that path was
launched exactly as often as the path calls it, compares one step with
the plain versions (loss and every gradient leaf), and profiles where a
step's device time goes (``torch.profiler``), with the kernels and with
their plain versions:

  - Qwen1.5-0.5B, all 24 layers (kernels K1 rmsnorm, K2 flash forward);
  - Falcon-Mamba-7B, 8 of its 64 layers: one stage of an 8-stage
    pipeline split, with the embedding and lm_head (K1, and K4 and
    K4-bwd, the selective scan forward and backward);
  - DeepSeek-MoE-16B, 2 of its 28 layers: one stage of a 14-stage
    split, with the embedding and lm_head (K1, K2 at head_dim 128, and
    K3, the grouped expert matmul, forward and backward).  Before its
    full-step comparison one MoE block at full width is held to its
    plain version on the same routing.

  - qwen3-1b (Qwen3-1.7B's widths, the paper's own evaluation model),
    all 28 layers (K1, and K2 at GQA 16/8 and head_dim 128).

The kernel phase runs K2 at every head dim the paths and configs give
it — 64, 128, qwen3-1b's GQA, granite-20b's MQA, and 32 and 80, which
run on a padded instantiation — each against its plain version and
timed beside SDPA.  Then the Piper IR phase traces the qwen3-1b proxy
at full width on meta tensors (no device memory may move), rewrites it
for a pp 4 x dp 2, ZeRO-3, 8-microbatch 1F1B plan with the overlap
engine and holds its chunk and comm counts and dataflow fingerprint to
the JAX package's (``IR_CASE``); and it runs the F and B chunk
functions of a region over two real qwen3-1b layers, under remat
"full" and "none", counting their K1 and K2 launches and holding their
gradients to autograd's.  Last it runs the training CLI at its defaults
for the ported archs, qwen3-1b, minicpm-2b (its WSD schedule checked
step by step) and ``--d-model 128`` (head_dim 32).  It prints the card's
name and power limit, one JSON line of kernel numbers, and as its last
line ``{"ok": true, "device": {...}}``.  Any failed phase ends the run
with a non-zero exit code and no result.

Without a CUDA device, or without the repository beside it, it fails.

    python3 chip_smoke.py --k2-against DIR

instead times the bf16 K2 at head dims 64 and 128 in this checkout and
in the one at DIR (say, the parent commit unpacked with ``git
archive``), in turns on the same card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
STEPS = 6
BATCH, SEQ = 4, 1024
FALCON_LAYERS = 8          # one stage of an 8-stage split of the 64 layers
DEEPSEEK_LAYERS = 2        # one stage of a 14-stage split of the 28 layers
# fp32 and bf16 tolerances of the kernel checks (tests/test_kernels.py)
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)}
# the selective scan's fp32 tolerance there: (atol, rtol)
SCAN_TOL = (1e-5, 1e-4)
# the bf16 K2 against the TPU kernel's formula (fp32 P; the plain version
# in fp32, its output rounded to bf16).  The kernel's bf16 P moves each
# weight by up to 2^-9, so an output by up to 2^-9 max|v| (~9e-3 for
# N(0, 1) values at these lengths), and the output's rounding to bf16 can
# then flip by one ulp (1.6e-2 in [2, 4)): ~2.4e-2 at worst, under the
# repo's bf16 tolerance.  PERF.md, section 6, records the readings.
FP32_P_TOL = TOL["bfloat16"]
# kernel against autograd through ssm_scan_ref in bf16: a relative L2
# error per output.  Both cast y to bf16 once and keep the state and every
# gradient in fp32, so they differ only in the order of fp32 sums; the
# H100 reads about 4e-5 (PERF.md, section 6), and the limit leaves 25x.
SCAN_REF_RL2 = 1e-3
# one full-width step, kernels against plain versions: (loss relative
# error, relative L2 error of each gradient leaf; layers are stacked, so
# a leaf pools every layer).  bf16 at 24 layers, and fp32 at 2 layers.
PLAIN_RTOL = {"bfloat16": (1e-3, 5e-2), "float32": (1e-5, 1e-3)}
FP32_LAYERS = 2            # depth of the fp32 comparison
# An MoE step in bf16 is compared twice.  K2 and K3 round bf16 differently
# from the plain path, and the discrete top-k routing turns a one-ulp
# difference in a router logit into a whole token moving between experts:
# on the H100, 87 and 306 of the 24,576 choices of the two DeepSeek layers
# differed, and every gradient leaf, not only the experts', then differed
# by 4.6e-2 to 1.3e-1 (PERF.md, section 6).  That measures the router's
# sensitivity, not the kernels.  So the freely routed plain run holds the
# loss and prints its routing differences and leaf errors, and a second
# plain run, routed as the kernel run (each router call takes the kernel
# run's experts, its gates renormalised from its own probabilities), holds
# every leaf to the limit.  The block-level check (the same routing by
# construction) and the fp32 comparison (freely routed, no routing
# difference allowed) hold the MoE as well.
# K3 against its plain version (tests/test_kernels.py, TestMoEGMM)
GMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}
# H100 SXM published peaks at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# exp on the special-function units: 16 per clock per SM, 132 SMs, at
# the H100 SXM's 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9


T0 = time.perf_counter()


def phase(label: str) -> None:
    print(f"[{label}] at {time.perf_counter() - T0:.1f} s", flush=True)


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


def check_close(torch, name, got, want, dtype: str, tol=None) -> float:
    atol, rtol = tol or TOL[dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max abs err {err.max().item():.3e}")
    return err.max().item()


# the IR phase's case: the qwen3-1b proxy at full width over a pp 4 x dp 2
# mesh, ZeRO-3, 8 microbatches of BATCH x SEQ tokens, 1F1B, overlap on
# (tests/test_torch_ir.py holds the port's DAG of it to the JAX package's)
IR_CASE = {"arch": "qwen3-1b", "pp": 4, "dp": 2, "zero": 3, "n_mb": 8,
           "tokens": BATCH * SEQ, "chunks": 64, "comms": 144,
           "digest": "2d88383f05210da110e6b35d"}
# the IR phase's region over real decoder layers: each leaf's chunk
# gradient against autograd through the same layers, relative L2 (the
# same kernels run the same ops in the same order; 0 is expected)
IR_GRAD_RTOL = 1e-3


def one_f_one_b(rank: int, n_ranks: int, n_mb: int) -> list:
    """(mb, pass) of one pipeline rank's 1F1B order: warm-up forwards,
    then one backward and one forward in turn."""
    warm = min(n_mb, n_ranks - rank)
    seq = [(i, "F") for i in range(warm)]
    fwd = warm
    for bwd in range(n_mb):
        seq.append((bwd, "B"))
        if fwd < n_mb:
            seq.append((fwd, "F"))
            fwd += 1
    return seq


def pipeline_directives(core, pp: int, dp: int, n_mb: int, zero: int, *,
                        split_backward: bool = False, ep_stages=()) -> list:
    """Place stage s of ``pp`` on devices [s*dp, (s+1)*dp), replicate it
    there at ZeRO stage ``zero`` (0 and 1 alike: gradients all-reduced; 2
    reduce-scattered; 3 also gathers the parameters), Shard the expert
    chunks of ``ep_stages`` over the same group, Split into ``n_mb``
    microbatches and Order each stage 1F1B (a backward is Bi then Bw when
    ``split_backward``).  ``core`` is a package's core module, so the CPU
    tests build the same list for the JAX package."""
    F = core.F
    groups = [list(range(s * dp, (s + 1) * dp)) for s in range(pp)]
    out = [core.Place(F(pp=s), devices=groups[s], stream="pp_comm") for s in range(pp)]
    for s in range(pp):
        out.append(core.Replicate(F(pp=s, ep="-"), devices=groups[s], reduce_stream="dp",
                                  gather_stream="ag", shard_grads=zero >= 2,
                                  shard_params=zero >= 3))
        if s in ep_stages:
            out.append(core.Shard(F(pp=s, ep="*"), devices=groups[s], stream="ep"))
    out.append(core.Split(F(), dim="MB", num_microbatches=n_mb))
    for s in range(pp):
        items = []
        for mb, pas in one_f_one_b(s, pp, n_mb):
            for tag in (("Bi", "Bw") if split_backward and pas == "B" else (pas,)):
                items.append(F(pp=s, MB=mb, PASS=tag))
        out.append(core.Order(items))
    return out


# K2 shapes (B, Hq, Hkv, S, D) timed in bf16, and their keys in the
# kernels line: Qwen1.5's (the row's own numbers), DeepSeek's head_dim
# 128, qwen3-1b's GQA, granite-20b's MQA, and the padded head dims
FLASH_TIMED = {(BATCH, 16, 16, SEQ, 64): None, (BATCH, 16, 16, SEQ, 128): "at_head_dim_128",
               (BATCH, 16, 8, SEQ, 128): "at_gqa_16_8_head_dim_128",
               (BATCH, 48, 1, SEQ, 128): "at_mqa_48_1_head_dim_128",
               (BATCH, 16, 16, SEQ, 32): "at_head_dim_32",
               (BATCH, 32, 32, SEQ, 80): "at_head_dim_80"}


def phase_kernels(torch, F, fa, rn) -> dict:
    """Each kernel against its plain version; times at the main path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(1234)

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)

    results, p_errs = {}, {}
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
    cases = [(4, 16, 16, 1024, 1024, 64, True), (4, 16, 16, 1024, 1024, 128, True),
             (2, 4, 1, 64, 64, 64, True),
             (1, 8, 2, 64, 128, 64, True), (1, 8, 2, 100, 300, 64, True),
             (1, 2, 2, 32, 48, 128, False), (2, 4, 2, 40, 72, 128, True),
             (1, 4, 4, 1000, 1000, 64, True),
             # qwen3-1b's GQA and granite-20b's MQA at head_dim 128; head
             # dims that run padded: 32 (the CLI at --d-model 128), 80
             # (zamba2, 2560 / 32), ragged and non-causal
             (4, 16, 8, 1024, 1024, 128, True), (4, 48, 1, 1024, 1024, 128, True),
             (4, 16, 16, 1024, 1024, 32, True), (4, 32, 32, 1024, 1024, 80, True),
             (2, 4, 2, 40, 72, 32, True), (1, 6, 2, 130, 200, 80, True),
             (1, 4, 1, 50, 90, 80, False)]
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
            extra = ""
            if dt == torch.bfloat16:
                # the plain version's bf16 path repeats the kernel's bf16 P;
                # this holds the kernel to the TPU kernel's formula, fp32 P
                fp32_p = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                      causal=causal, q_offset=off)[0]
                p_err = check_close(torch, tag + " against fp32 P", out, fp32_p.to(dt),
                                    dname, FP32_P_TOL)
                extra = f" against_fp32_P={p_err:.3e}"
            print(f"  {tag} max_abs_err={err:.3e} lse_err={lse_err:.3e}{extra}", flush=True)
            if dt == torch.bfloat16 and (b, hq, hkv, sq, d) == (4, 16, 16, 1024, 64):
                results["flash_attention"] = {"max_abs_err": max(err, lse_err),
                                              "max_abs_err_fp32_p": p_err}
            if dt == torch.bfloat16 and (b, hq, hkv, sq, d) in FLASH_TIMED:
                p_errs[(hq, hkv, d)] = p_err

    def flash_times(hq: int, hkv: int, d: int) -> dict:
        """K2, its plain version and SDPA at (BATCH, hq/hkv, SEQ, d) causal
        bf16.  The bound counts the true d: a padded d's MMA work (80 runs
        as 128) shows as distance from it."""
        q = randn((BATCH, hq, SEQ, d), torch.bfloat16)
        k, v = (randn((BATCH, hkv, SEQ, d), torch.bfloat16) for _ in range(2))
        pairs = BATCH * hq * SEQ * (SEQ + 1) // 2      # causal (query, key) pairs computed
        # q, k, v, out, lse
        n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + BATCH * hq * SEQ * 4
        timed = dict(
            ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
            plain_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True)),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=hq != hkv)),
            **bound(n_bytes, 4 * d * pairs / BF16_FLOPS))
        timed["tflops"] = 4 * d * pairs / timed["ms"] / 1e9
        timed["max_abs_err_fp32_p"] = p_errs[(hq, hkv, d)]
        print(f"  flash {(BATCH, f'{hq}/{hkv}', SEQ, d)} causal bf16: kernel "
              f"{timed['ms']:.4f} ms ({timed['tflops']:.1f} TFLOP/s), plain "
              f"{timed['plain_ms']:.4f} ms, SDPA {timed['library_ms']:.4f} ms "
              f"(kernel/SDPA {timed['ms'] / timed['library_ms']:.2f}x), bound "
              f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})", flush=True)
        return timed

    # Qwen1.5's head_dim 64 first (the row's main numbers), then the rest
    results["flash_attention"].update(flash_times(16, 16, 64))
    for (b, hq, hkv, sq, d), key in FLASH_TIMED.items():
        if key:
            results["flash_attention"][key] = flash_times(hq, hkv, d)
    return results


# the bf16 tensor-core kernels and their instantiations (head dims 64 and
# 128, each exact and padded; layouts)
TC_KERNELS = {"flash_fwd_wgmma_kernel": 4, "moe_gmm_wgmma_kernel": 3}
# the scan kernels, which must keep their state in registers and shared
# memory, and their instantiations (fp32 and bf16, N = 4, 8, 16)
SCAN_KERNELS = {"mamba_scan_fwd_kernel": 6, "mamba_scan_bwd_kernel": 6}


def cuobjdump() -> str:
    """The toolkit's cuobjdump, else the one Triton's package carries."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [pathlib.Path("/usr/local/cuda/bin/cuobjdump")]
    with contextlib.suppress(ImportError):
        import triton
        cands.append(pathlib.Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump")
    for c in cands:
        if c.exists():
            return str(c)
    fail("no cuobjdump: neither the CUDA toolkit's nor Triton's")


def sass_check(lib: pathlib.Path) -> dict:
    """Count HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    instantiation of the bf16 tensor-core kernels in the built library's
    SASS, and fail if one is missing or has none of either; count local
    memory loads and stores (LDL, STL: spills or arrays the compiler could
    not keep in registers) in each instantiation of the scan kernels, and
    fail if one is missing or has any."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    ops = ("HGMMA", "UTMALDG", "LDL", "STL")
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            words = set(line.replace(";", " ").split())
            for op in ops:
                counts[name][op] += any(w.split(".")[0] == op for w in words)
    found = {}
    for kernel, n_inst in TC_KERNELS.items():
        mine = {k: v for k, v in counts.items() if kernel in k}
        for k, v in sorted(mine.items()):
            print(f"  SASS {k}: HGMMA {v['HGMMA']}, UTMALDG {v['UTMALDG']}", flush=True)
        if len(mine) != n_inst or not all(v["HGMMA"] and v["UTMALDG"] for v in mine.values()):
            fail(f"SASS check: {kernel} has {len(mine)} of {n_inst} instantiations, "
                 f"counts {list(mine.values())}: each needs HGMMA and UTMALDG")
        found.update(mine)
    for kernel, n_inst in SCAN_KERNELS.items():
        mine = {k: v for k, v in counts.items() if kernel in k}
        local = {k: v["LDL"] + v["STL"] for k, v in mine.items()}
        print(f"  SASS {kernel}: {len(mine)} instantiations, local-memory accesses "
              f"{sorted(local.values())}", flush=True)
        if len(mine) != n_inst or any(local.values()):
            fail(f"SASS check: {kernel} has {len(mine)} of {n_inst} instantiations, local "
                 f"loads and stores {local}: the scan must not use local memory")
        found.update(mine)
    return found


def bound(n_bytes: int, op_seconds: float) -> dict:
    byte_seconds = n_bytes / HBM_BYTES_PER_S
    return {"bound_ms": max(byte_seconds, op_seconds) * 1e3,
            "bound_by": "bytes" if byte_seconds >= op_seconds else "operations"}


def gmm_shapes(cfg) -> list:
    """(E, rows, K, N) of the MoE path's grouped matmuls at BATCH x SEQ
    tokens: gate/up (d_model -> d_expert) and down (d_expert -> d_model)."""
    from repro_torch.models.layers import _dispatch_groups
    n_sc = _dispatch_groups(BATCH, SEQ)
    tg, e, k = SEQ // n_sc, cfg.moe.n_experts, cfg.moe.top_k
    rows = BATCH * n_sc * max(1, int(cfg.moe.capacity_factor * tg * k / e))
    return [(e, rows, cfg.d_model, cfg.moe.d_expert), (e, rows, cfg.moe.d_expert, cfg.d_model)]


def phase_gmm_kernels(torch, mg, cfg) -> dict:
    """K3's three layouts (forward, dx, dw) against their plain versions
    at the MoE path's shapes and the JAX test's edge shapes, in fp32 and
    bf16.  Times at the gate/up shape in bf16."""
    g = torch.Generator(device="cuda").manual_seed(2468)
    path = gmm_shapes(cfg)
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for e, m, k, n in path + [(4, 32, 64, 128), (2, 16, 32, 32), (8, 130, 64, 96)]:
            x = torch.randn((e, m, k), generator=g, device="cuda").to(dt)
            w = (torch.randn((e, k, n), generator=g, device="cuda") * k ** -0.5).to(dt)
            dy = torch.randn((e, m, n), generator=g, device="cuda").to(dt)
            y = mg.moe_gmm_fwd(x, w)
            dx, dw = mg.moe_gmm_bwd(x, w, dy)
            torch.cuda.synchronize()
            want_dx, want_dw = mg.moe_gmm_bwd_plain(x, w, dy)
            tag = f"moe_gmm {dname} {(e, m, k, n)}"
            errs = [check_close(torch, f"{tag} {name}", got, want, dname, GMM_TOL[dname])
                    for name, got, want in (("y", y, mg.moe_gmm_plain(x, w)),
                                            ("dx", dx, want_dx), ("dw", dw, want_dw))]
            print(f"  {tag} max_abs_err y={errs[0]:.3e} dx={errs[1]:.3e} dw={errs[2]:.3e}",
                  flush=True)
            if dt == torch.bfloat16 and (e, m, k, n) == path[0]:
                results["moe_gmm"] = {"max_abs_err": errs[0]}
                results["moe_gmm_bwd"] = {"max_abs_err": max(errs[1:])}
                timed = (x, w, dy)
            del x, w, dy, y, dx, dw, want_dx, want_dw
    x, w, dy = timed
    e, m, k = x.shape
    n = w.shape[2]
    flops = 2 * e * m * k * n
    io = x.element_size()
    results["moe_gmm"].update(
        ms=cuda_ms(torch, lambda: mg.moe_gmm_fwd(x, w), reps=10),
        plain_ms=cuda_ms(torch, lambda: mg.moe_gmm_plain(x, w)),
        library_ms=cuda_ms(torch, lambda: torch.bmm(x, w)),
        **bound((x.numel() + w.numel() + e * m * n) * io, flops / BF16_FLOPS))
    two_bmm_ms = cuda_ms(torch, lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                         torch.bmm(x.transpose(1, 2), dy)))
    results["moe_gmm_bwd"].update(
        ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd(x, w, dy), reps=5),
        plain_ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd_plain(x, w, dy)),
        library_ms=None,     # no single PyTorch call computes both dx and dw
        # reads x, w, dy; writes dx, dw
        **bound(2 * (x.numel() + w.numel()) * io + dy.numel() * io, 2 * flops / BF16_FLOPS))
    results["moe_gmm_bwd"]["two_bmm_ms"] = two_bmm_ms
    for name, work in (("moe_gmm", flops), ("moe_gmm_bwd", 2 * flops)):
        r = results[name]
        r["tflops"] = work / r["ms"] / 1e9
        lib_ms = r["library_ms"] or two_bmm_ms
        lib = "torch.bmm" if r["library_ms"] else "two torch.bmm calls"
        print(f"  {name} {(e, m, k, n)} bf16: kernel {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s), plain "
              f"{r['plain_ms']:.4f} ms, {lib} {lib_ms:.4f} ms (kernel/library "
              f"{r['ms'] / lib_ms:.2f}x), bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    return results


def scan_inputs(torch, g, b, s, c, n, dtype, with_h0=False):
    """The JAX scan test's distributions: x, dt = softplus(.), A < 0, B, C
    and, if asked, h0."""
    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = randn((b, s, c), 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn((b, s, c))).to(dtype)
    A = -torch.exp(randn((c, n), 0.2))
    B, C = randn((b, s, n), 0.5).to(dtype), randn((b, s, n), 0.5).to(dtype)
    return x, dt, A, B, C, (randn((b, c, n), 0.5) if with_h0 else None)


def _scan_tol(t) -> tuple:
    """bf16 outputs at the bf16 kernel tolerance, fp32 ones at the scan's."""
    return TOL["bfloat16"] if str(t.dtype) == "torch.bfloat16" else SCAN_TOL


def phase_scan_kernels(torch, ms) -> dict:
    """K4 and K4-bwd against their plain versions at the Falcon path's
    shape, the JAX test grid, a ragged S with h0 and a continuation from
    it, each with a non-zero dhT; the backward also against autograd
    through ``ssm_scan_ref``.  Times at the Falcon path's shape."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ssm_scan_ref
    g = torch.Generator(device="cuda").manual_seed(4321)
    main = (BATCH, SEQ, 8192, 16, torch.bfloat16)     # Falcon-Mamba-7B's d_inner, state
    cases = [(*main, False), (1, 16, 8, 4, torch.float32, False),
             (2, 24, 16, 8, torch.float32, False), (1, 8, 6, 4, torch.float32, False),
             (2, 1000, 256, 16, torch.float32, True), (2, 1000, 256, 16, torch.bfloat16, True),
             # the kernels' tiling edges: C ragged past a 128-channel block
             # and below a warp, S = 1 and S off the 16- and 8-step tiles
             (2, 1, 200, 16, torch.float32, True), (2, 77, 200, 16, torch.bfloat16, True),
             (2, 37, 20, 4, torch.float32, True), (1, 45, 136, 8, torch.bfloat16, True)]
    results = {}
    for b, s, c, n, dtype, with_h0 in cases:
        x, dt, A, B, C, h0 = scan_inputs(torch, g, b, s, c, n, dtype, with_h0)
        dy = torch.randn((b, s, c), generator=g, device="cuda").to(dtype)
        dhT = torch.randn((b, c, n), generator=g, device="cuda")
        tag = f"mamba_scan {str(dtype)[6:]} {(b, s, c, n)}{' h0' if with_h0 else ''}"
        y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True)
        grads = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
        torch.cuda.synchronize()
        want = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
        fwd_err = max(check_close(torch, f"{tag} {k}", got, w, "", _scan_tol(got))
                      for k, got, w in zip(("y", "hT", "hs"), (y, hT, hs), want))
        want_g = ms.mamba_scan_bwd_plain(x, dt, A, B, C, want[2], dy, dhT)
        names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
        bwd_err = max(check_close(torch, f"{tag} {k}", got, w, "", _scan_tol(got))
                      for k, got, w in zip(names, grads, want_g))
        print(f"  {tag} fwd max_abs_err={fwd_err:.3e} bwd max_abs_err={bwd_err:.3e}",
              flush=True)
        if with_h0 and s > 1:        # continue from the first half's state
            y1, h1, _ = ms.mamba_scan_fwd(x[:, :s // 2], dt[:, :s // 2], A, B[:, :s // 2],
                                          C[:, :s // 2], h0)
            y2, h2, _ = ms.mamba_scan_fwd(x[:, s // 2:], dt[:, s // 2:], A, B[:, s // 2:],
                                          C[:, s // 2:], h1)
            check_close(torch, f"{tag} continued y", torch.cat([y1, y2], 1), y, "",
                        _scan_tol(y))
            err = check_close(torch, f"{tag} continued hT", h2, hT, "", SCAN_TOL)
            print(f"  {tag} continued from step {s // 2}: hT max_abs_err={err:.3e}", flush=True)
        # autograd through K4/K4-bwd against autograd through the chunked reference
        D = 1 + 0.1 * torch.randn((c,), generator=g, device="cuda")
        ref_grads = []
        for fn in (ops.mamba_scan, ssm_scan_ref):
            leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, D)]
            h = None if h0 is None else h0.clone().requires_grad_(True)
            yy, hh = fn(*leaves, h0=h)
            torch.autograd.backward([yy, hh], [dy, dhT])
            ref_grads.append([t.grad for t in leaves + ([h] if h is not None else [])])
        worst = 0.0
        for k, got, w in zip(("x", "dt", "A", "B", "C", "D", "h0"), *ref_grads):
            if dtype == torch.float32:
                worst = max(worst, check_close(torch, f"{tag} d{k} vs ssm_scan_ref", got, w,
                                               "", SCAN_TOL))
            else:
                rl2 = ((got.float() - w.float()).norm() / w.float().norm()).item()
                if not rl2 <= SCAN_REF_RL2:
                    fail(f"{tag} d{k} vs ssm_scan_ref: relative L2 error {rl2:.3e} > "
                         f"{SCAN_REF_RL2}")
                worst = max(worst, rl2)
        kind = "max_abs_err" if dtype == torch.float32 else "worst relative L2 error"
        print(f"  {tag} grads vs autograd through ssm_scan_ref: {kind} {worst:.3e}",
              flush=True)
        if (b, s, c, n, dtype) == main:
            results["mamba_scan"] = {"max_abs_err": fwd_err}
            results["mamba_scan_bwd"] = {"max_abs_err": bwd_err}
            timed = (x, dt, A, B, C, hs, dy)

    x, dt, A, B, C, hs, dy = timed
    b, s, c, n = *x.shape, A.shape[1]
    # K4-bwd twice on the same inputs: the same bits (fixed-order sums)
    dhT = torch.randn((b, c, n), generator=g, device="cuda")
    first = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    second = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        fail("mamba_scan_bwd: two runs on the same inputs differ")
    print(f"  mamba_scan_bwd {(b, s, c, n)} bf16: two runs give the same bits", flush=True)
    del first, second
    elems, io = b * s * c * n, x.element_size()
    # exps per (b, t, c, n) of each kernel's design at this shape (the note
    # atop mamba_scan.cu)
    exps = {"mamba_scan": 1.0, "mamba_scan_bwd": 2.5}
    # forward: reads x, dt, B, C, A; writes y, hT and the chunk states
    fwd_bytes = (3 * b * s * c + 2 * b * s * n) * io + (c * n + b * c * n + hs.numel()) * 4
    # backward: reads x, dt, dy, B, C, A, the chunk states; writes dx, ddt,
    # dB, dC, dA, dh0
    bwd_bytes = ((5 * b * s * c + 4 * b * s * n) * io
                 + (2 * c * n + b * c * n + hs.numel()) * 4)
    # the chunk states' interval is the design's choice (bytes here against
    # exps in the backward): the byte time without them is printed too
    scan_bytes = {"mamba_scan": fwd_bytes - hs.numel() * 4,
                  "mamba_scan_bwd": bwd_bytes - hs.numel() * 4}
    results["mamba_scan"].update(
        ms=cuda_ms(torch, lambda: ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)),
        plain_ms=cuda_ms(torch, lambda: ms.mamba_scan_plain(x, dt, A, B, C, save_states=True),
                         reps=3),
        library_ms=None,     # no single PyTorch call computes a selective scan
        # per (b, t, c, n): dt*A, exp, h*a, u*B + that, h*C, the sum over n
        **bound(fwd_bytes, 7 * elems / FP32_FLOPS))
    results["mamba_scan_bwd"].update(
        ms=cuda_ms(torch, lambda: ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy)),
        plain_ms=cuda_ms(torch, lambda: ms.mamba_scan_bwd_plain(x, dt, A, B, C, hs, dy),
                         reps=3),
        library_ms=None,
        # per (b, t, c, n): the state's recompute (5) and its adjoint: g,
        # dC, dB, the two sums over n, dA and the carry (15)
        **bound(bwd_bytes, 20 * elems / FP32_FLOPS))
    for name in ("mamba_scan", "mamba_scan_bwd"):
        r = results[name]
        print(f"  {name} {(b, s, c, n)} bf16: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{exps[name]} exps per element, at the SFU rate "
              f"{exps[name] * elems / SFU_EXP_PER_S * 1e3:.4f} ms; bytes without the chunk "
              f"states {scan_bytes[name] / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    return results


def phase_train(torch, cfg, want: dict) -> tuple:
    """``cfg`` through the port's entry points, with kernels: STEPS
    training steps under the supervisor, launch counts held to ``want``,
    then one step against the plain versions in bf16 and, at
    FP32_LAYERS layers, in fp32."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    from repro_torch.ft import Supervisor
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_step
    from repro_torch.models import init
    from repro_torch.optim import adamw_init, cosine_schedule

    widths = (f"ssm={cfg.ssm}" if cfg.ssm else
              f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
              + (f"moe={cfg.moe}" if cfg.moe else f"d_ff={cfg.d_ff}"))
    print(f"  config {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} {widths} "
          f"vocab={cfg.vocab} dtype={cfg.dtype} remat={cfg.remat} "
          f"params={cfg.param_count()}", flush=True)
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
        t0 = time.perf_counter()
        state = sup.run(state, synced_step, STEPS, log_every=1)
        run_s = time.perf_counter() - t0
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in sup.history]
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        fail(f"first loss {losses[0]} not within 1.0 of ln(vocab) = {math.log(cfg.vocab)}")
    print(f"  launch counts {counts}, expected {want}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} != {want}")

    if cfg.moe:
        check_moe_block(torch, cfg)
    compare_with_plain(torch, cfg, params, losses[0])
    cfg32 = dataclasses.replace(cfg, n_layers=FP32_LAYERS, dtype="float32")
    compare_with_plain(torch, cfg32, init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                                          "cuda"))

    dts = [h["dt"] for h in sup.history[1:]]
    step_s = statistics.median(dts)
    print(f"  full width: {STEPS} steps, losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"  step time median {step_s * 1e3:.1f} ms over steps 2-{STEPS} "
          f"(min {min(dts) * 1e3:.1f}, max {max(dts) * 1e3:.1f}), "
          f"{BATCH * SEQ / step_s:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); the supervised run took "
          f"{run_s:.1f} s, {run_s - sum(h['dt'] for h in sup.history):.1f} s of it outside "
          "the steps (the checkpoint)", flush=True)
    return counts, {"state": state, "step_fn": step_fn, "loader": loader}


@contextlib.contextmanager
def recorded_routing(replay: list | None = None):
    """The expert ids of every MoE router call inside the block, in call
    order: the forward's layers first, then, under remat, the
    recompute's.  With ``replay`` (an earlier run's list), call i routes
    to ``replay[i]``'s experts instead, with gates renormalised from its
    own probabilities; the list still records its own choices.  Wraps
    the port's ``_router`` for the block's duration."""
    from repro_torch.models import layers as L
    calls, router = [], L._router

    def recording(p, xt, top_k):
        probs, gates, idx = router(p, xt, top_k)
        calls.append(idx.detach())
        if replay is not None:
            idx = replay[len(calls) - 1]
            vals = probs.gather(1, idx)
            gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
        return probs, gates, idx
    L._router = recording
    try:
        yield calls
    finally:
        L._router = router


def routing_diffs(a: list, b: list) -> list:
    """Per layer, the (token, k) choices of one run that the other did not make."""
    return [int((~(x[:, :, None] == y[:, None, :]).any(-1)).sum()) for x, y in zip(a, b)]


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def check_moe_block(torch, cfg) -> None:
    """One ``moe_block`` at the config's widths on one input (BATCH, SEQ,
    d_model) in its dtype, with K3 and with its plain version.  The
    router does not go through K3, so both route alike (checked).  The
    output is held elementwise to K3's tolerance; aux and the gradients
    of x and of every MoE leaf (cotangent N(0, 1) on y and 1 on aux) to
    the per-leaf relative L2 limit of ``PLAIN_RTOL``."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map
    g = torch.Generator(device="cuda").manual_seed(7)
    m = cfg.moe
    p = L.init_moe(g, cfg.d_model, m.d_expert, m.n_experts, m.n_shared, cfg.act, cfg.tdtype,
                   "cuda")
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=g, device="cuda").to(cfg.tdtype)
    dy = torch.randn((BATCH, SEQ, cfg.d_model), generator=g, device="cuda").to(cfg.tdtype)
    names = ["x"] + ["/".join(path) for path, _ in tree_flatten_with_path(p)]

    def run():
        tree = tree_map(lambda t: t.detach().requires_grad_(True), p)
        leaves = [x.detach().requires_grad_(True)] + tree_leaves(tree)
        with recorded_routing() as calls:
            y, aux = L.moe_block(tree, leaves[0], n_experts=m.n_experts, top_k=m.top_k,
                                 act=cfg.act, capacity_factor=m.capacity_factor)
        grads = torch.autograd.grad([y, aux], leaves, [dy, torch.ones_like(aux)])
        return y.detach(), aux.detach(), calls[0], grads

    ops.register_kernels()
    ops.reset_launch_counts()
    y_k, aux_k, route_k, grads_k = run()
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    ops.unregister_kernels()
    y_p, aux_p, route_p, grads_p = run()
    if launched["moe_gmm"] != 3 or launched["moe_gmm_bwd"] != 6:
        fail(f"moe block: K3 launches {launched}, expected 3 forward and 6 backward")
    if not torch.equal(route_k, route_p):
        fail("moe block: the routing differs between the K3 and plain runs")
    dname = cfg.dtype
    y_err = check_close(torch, "moe block y", y_k, y_p, dname, GMM_TOL[dname])
    grad_rtol = PLAIN_RTOL[dname][1]
    errs = {"aux": abs(aux_k.item() - aux_p.item()) / abs(aux_p.item())}
    errs.update({f"d{name}": rel_l2(gk, gp) for name, gk, gp in zip(names, grads_k, grads_p)})
    print(f"  moe block {tuple(x.shape)} {dname}, K3 against plain on the same routing: "
          f"y max_abs_err {y_err:.3e}; relative errors (limit {grad_rtol}):", flush=True)
    for name, err in errs.items():
        print(f"    {name:20s} {err:.3e}", flush=True)
    worst = max(errs, key=errs.get)
    if not all(math.isfinite(e) for e in errs.values()) or errs[worst] > grad_rtol:
        fail(f"moe block: K3 and plain disagree: {worst} at {errs[worst]:.3e}")


def compare_with_plain(torch, cfg, params, step_loss: float | None = None) -> None:
    """Step 1's loss and every gradient leaf on the same weights and
    batch, with the kernels and with their plain versions, held to
    ``PLAIN_RTOL`` of the config's dtype.  ``step_loss`` is the kernel
    loss the training step reported, if any.  The gradients go through
    the flash backward, which reuses K2's lse.  For an MoE config it
    prints how many routing choices differ per layer between the two
    runs; in fp32 any is a failure, and in bf16 the leaves are held
    against a plain run routed as the kernel run (see the note at
    ``PLAIN_RTOL``)."""
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    from repro_torch.kernels import ops
    from repro_torch.models import train_loss
    from repro_torch.tree import tree_flatten_with_path, tree_map

    first = TokenLoader(SyntheticTokenSource(cfg.vocab, seed=17), batch=BATCH,
                        seq=SEQ).next_batch()
    batch = {k: torch.as_tensor(v, device="cuda").long() for k, v in first.items()}
    paths = ["/".join(path) for path, _ in tree_flatten_with_path(params)]

    def loss_and_grads(replay=None):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with recorded_routing(replay) as calls:
            loss = train_loss(cfg, p, batch)
            leaves = [leaf for _, leaf in tree_flatten_with_path(p)]
            grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.float() for g in grads], calls

    def leaf_errors(k_grads, p_grads, held: bool) -> dict:
        errs = {name: rel_l2(k, p) for name, k, p in zip(paths, k_grads, p_grads)}
        k_norm = torch.sqrt(sum(g.square().sum() for g in k_grads)).item()
        p_norm = torch.sqrt(sum(g.square().sum() for g in p_grads)).item()
        limit = f"limit {grad_rtol}" if held else "printed, not held"
        print(f"  step 1 grad norm: kernels {k_norm:.6f}, plain {p_norm:.6f}; relative L2 "
              f"error per leaf ({limit}):", flush=True)
        for name, err in errs.items():
            print(f"    {name:24s} {err:.3e}", flush=True)
        return errs

    ops.register_kernels()
    k_loss, k_grads, k_routes = loss_and_grads()
    ops.unregister_kernels()
    p_loss, p_grads, p_routes = loss_and_grads()
    loss_rtol, grad_rtol = PLAIN_RTOL[cfg.dtype]
    first_loss = k_loss if step_loss is None else step_loss
    rel = abs(p_loss - first_loss) / abs(p_loss)
    print(f"  {cfg.dtype}, {cfg.n_layers} layers: step 1 loss: kernels {first_loss:.6f} "
          f"(outside the step: {k_loss:.6f}), plain {p_loss:.6f} (rel diff {rel:.3e}, "
          f"limit {loss_rtol})", flush=True)
    if rel > loss_rtol:
        fail("kernel and plain losses disagree")
    if cfg.moe:
        diffs = routing_diffs(k_routes[:cfg.n_layers], p_routes[:cfg.n_layers])
        print(f"  routing choices that differ between the two runs, per layer (of "
              f"{BATCH * SEQ * cfg.moe.top_k}): {diffs}", flush=True)
        if cfg.dtype == "float32" and any(diffs):
            fail(f"fp32 routing differs between kernels and plain versions: {diffs}")
        if cfg.dtype == "bfloat16":
            leaf_errors(k_grads, p_grads, held=False)
            del p_grads
            p_loss, p_grads, _ = loss_and_grads(replay=k_routes)
            rel = abs(p_loss - k_loss) / abs(p_loss)
            print(f"  plain run routed as the kernel run: loss {p_loss:.6f} (rel diff "
                  f"{rel:.3e}, limit {loss_rtol})", flush=True)
            if rel > loss_rtol:
                fail("kernel and routed plain losses disagree")
    errs = leaf_errors(k_grads, p_grads, held=True)
    worst = max(errs, key=errs.get)
    if not all(math.isfinite(e) for e in errs.values()) or errs[worst] > grad_rtol:
        fail(f"kernel and plain gradients disagree: {worst} at {errs[worst]:.3e}")


def phase_cli(torch) -> None:
    """The CLI at its defaults for the ported paths (Falcon at 50 steps),
    qwen3-1b, minicpm-2b (whose learning rate must follow WSD step by
    step) and ``--d-model 128`` (4 heads of 32: K2 on a padded head dim);
    the loss must fall in each."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import wsd_schedule
    for extra in ([], ["--arch", "falcon-mamba-7b", "--steps", "50"],
                  ["--arch", "deepseek-moe-16b"], ["--arch", "qwen3-1b"],
                  ["--arch", "minicpm-2b"], ["--d-model", "128"]):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            sup, _ = train.run(["--ckpt-dir", tmp, *extra])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            print(f"  CLI {' '.join(extra) or 'at its defaults'}: {len(sup.history)} steps in "
                  f"{time.perf_counter() - t0:.1f} s, launches {counts}", flush=True)
        losses = [h["loss"] for h in sup.history]
        if not losses[-1] < losses[0]:
            fail(f"CLI {extra}: the loss did not fall ({losses[0]} -> {losses[-1]})")
        if "--arch" not in extra or extra[1] != "falcon-mamba-7b":
            if not counts["rmsnorm"] or not counts["flash_attention"]:
                fail(f"CLI {extra}: K1 or K2 never launched: {counts}")
        if extra[-1:] == ["minicpm-2b"]:
            lr = wsd_schedule(3e-3, len(losses))
            want = [float(lr(i)) for i in range(len(losses))]
            got = [h["lr"] for h in sup.history]
            if not all(math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-12)
                       for a, b in zip(got, want)):
                fail("CLI minicpm-2b: the learning rate does not follow WSD")
            print(f"  CLI minicpm-2b: lr follows WSD step by step (peak {max(got):.1e}, "
                  f"last {got[-1]:.3e})", flush=True)


def phase_ir(torch) -> dict:
    """The Piper IR on the card.  (1) The qwen3-1b proxy at full width
    traced on meta tensors and rewritten by IR_CASE's directives and
    ``run_all`` with overlap: no byte of device memory moves, and the
    chunk and comm counts and the fingerprint are IR_CASE's (which
    tests/test_torch_ir.py holds to the JAX package's).  (2) A region
    over two real qwen3-1b decoder layers, weights on the card, under
    remat "full" and "none": its F and B chunk functions launch K1 and K2
    exactly as the layers call them, and the B chunk's gradients equal
    autograd's through the same layers (each F and B pair runs twice; the
    second is timed and counted).  Returns the launch counts."""
    from repro_torch import core
    from repro_torch.analysis import dataflow_fingerprint
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init
    from repro_torch.models.model import _dec_layer, _unstack
    from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map
    from repro_torch.tune import proxy

    c = IR_CASE
    cfg = get_config(c["arch"])
    sm = proxy.decompose(cfg, c["pp"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    act = ((c["tokens"], cfg.d_model), proxy.PROXY_DTYPE)
    dag = core.build_dag(proxy.make_proxy_forward(sm), proxy.make_proxy_params(sm),
                         {"x": act, "y": act},
                         pipeline_directives(core, c["pp"], c["dp"], c["n_mb"], c["zero"]),
                         overlap=core.OverlapConfig())
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    moved = torch.cuda.memory_allocated() - before
    stats, fp = dag.stats(), dataflow_fingerprint(dag)
    params = sum(b.param_elems for b in dag.buckets.values())
    print(f"  {c['arch']} proxy ({params} parameters in {len(dag.buckets)} stage buckets) "
          f"over pp {c['pp']} x dp {c['dp']}, ZeRO-{c['zero']}, {c['n_mb']} microbatches, "
          f"1F1B, overlap: built in {build_s:.2f} s; {stats}; fingerprint "
          f"{fp.digest()}; device memory moved {moved} bytes", flush=True)
    if moved:
        fail(f"IR: tracing the proxy moved {moved} bytes of device memory")
    if (stats["chunks"], stats["comms"], fp.digest()) != (c["chunks"], c["comms"], c["digest"]):
        fail(f"IR: {stats['chunks']} chunks, {stats['comms']} comms, digest {fp.digest()}; "
             f"expected {c['chunks']}, {c['comms']}, {c['digest']}")

    lcfg = dataclasses.replace(cfg, n_layers=2, remat="none")
    layers = init(lcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")["layers"]
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=g, device="cuda").to(lcfg.tdtype)
    cot = torch.randn(x.shape, generator=g, device="cuda").to(lcfg.tdtype)

    def two_layers(p, h):
        for lp in _unstack(p, 2):
            h, _ = _dec_layer(lcfg, lp, h)
        return h

    def forward(rec, tvs):
        with rec.annotate("pp"):
            return rec.region(two_layers, "layers", name="layers")(tvs["x"])

    ops.register_kernels()
    p = tree_map(lambda t: t.detach().requires_grad_(True), layers)
    xr = x.detach().requires_grad_(True)
    want_y = two_layers(p, xr)
    want = torch.autograd.grad(want_y, tree_leaves(p) + [xr], cot)
    names = [f"d{'/'.join(path)}" for path, _ in tree_flatten_with_path(layers)]
    counts = dict.fromkeys(("rmsnorm", "flash_attention"), 0)
    # per chunk call: each layer runs norm1, norm2 and one attention
    per_fwd = {"rmsnorm": 2 * lcfg.n_layers, "flash_attention": lcfg.n_layers}

    def chunk_call(fn, *args):
        """(outputs, device ms, launches) of one chunk call."""
        ops.reset_launch_counts()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = fn(layers, *args)
        stop.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(stop), {kk: v for kk, v in
                                               ops.launch_counts().items() if v}

    for remat in ("full", "none"):
        dag = core.build_dag(forward, {"layers": layers},
                             {"x": (tuple(x.shape), lcfg.dtype)}, remat=remat)
        f = next(n for n in dag.chunks() if n.dims["PASS"] == "F")
        b = dag.nodes[f.meta["bwd_node"]]
        k = f.n_outputs - f.meta.get("n_res", 0)
        for _ in range(2):      # the first F and B warm up; the second are read
            outs, f_ms, f_launched = chunk_call(f.fn, x)
            args = (x, cot) if remat == "full" else (*outs[k:], cot)
            (grads, dx), b_ms, b_launched = chunk_call(b.fn, *args)
        for kk in counts:
            counts[kk] += f_launched.get(kk, 0) + b_launched.get(kk, 0)
        # B re-runs the forward under "full" and reads the stash under "none"
        exp_b = per_fwd if remat == "full" else {}
        if f_launched != per_fwd or b_launched != exp_b:
            fail(f"IR remat={remat}: launches F {f_launched}, B {b_launched}; "
                 f"expected {per_fwd} and {exp_b}")
        errs = {"y": rel_l2(outs[0], want_y.detach())}
        errs.update({n: rel_l2(gg, w) for n, gg, w in
                     zip(names + ["dx"], tree_leaves(grads) + [dx], want)})
        res_bytes = sum(t.numel() * t.element_size() for t in outs[k:])
        worst = max(errs, key=errs.get)
        print(f"  region over 2 real {c['arch']} layers, remat={remat}: F {f_ms:.2f} ms "
              f"(launches {f_launched}), B {b_ms:.2f} ms (launches {b_launched}); "
              f"{f.meta.get('n_res', 0)} residual slots, {res_bytes / 2**20:.1f} MiB; worst "
              f"relative L2 error against autograd {errs[worst]:.3e} ({worst}, limit "
              f"{IR_GRAD_RTOL})", flush=True)
        if not all(math.isfinite(e) for e in errs.values()) or errs[worst] > IR_GRAD_RTOL:
            fail(f"IR remat={remat}: chunk gradients disagree with autograd: {worst} at "
                 f"{errs[worst]:.3e}")
        del outs, args, grads, dx
    ops.unregister_kernels()
    return counts


# kernel-name substrings -> family, first match wins
FAMILIES = [("moe_gmm_wgmma_kernel", "K3 grouped mm"), ("moe_gmm_kernel", "K3 grouped mm"),
            ("flash_fwd_wgmma_kernel", "K2 flash fwd"),
            ("rmsnorm_kernel", "K1 rmsnorm"), ("flash_fwd_kernel", "K2 flash fwd"),
            ("mamba_scan_fwd_kernel", "K4 scan fwd"), ("mamba_scan_bwd_kernel", "K4-bwd scan"),
            ("gemm", "matmul"), ("cutlass", "matmul"), ("sm90_xmma", "matmul"),
            ("nvjet", "matmul"), ("reduce", "reductions"), ("softmax", "reductions"),
            ("elementwise", "elementwise"), ("copy", "copies/casts"),
            ("cat", "copies/casts"), ("index", "gather/scatter"),
            ("scatter", "gather/scatter"), ("gather", "gather/scatter")]
PROFILED_STEPS = 2


def _family(name: str) -> str:
    low = name.lower()
    return next((fam for key, fam in FAMILIES if key in low), "other")


def phase_profile(torch, train: dict, plain_steps: int = PROFILED_STEPS) -> None:
    """Where a full-width step's device time goes, continuing a training
    phase's state: with the kernels, then with their plain versions, one
    warm-up step and then steps under ``torch.profiler`` (device activity
    only): PROFILED_STEPS with the kernels, ``plain_steps`` plain.  The
    plain scan launches ~445k kernels a Falcon step (~20 s), so that path
    profiles one."""
    from repro_torch.kernels import ops
    state, step_fn, loader = train["state"], train["step_fn"], train["loader"]
    act = [torch.profiler.ProfilerActivity.CUDA]
    for mode, n_steps in (("kernels", PROFILED_STEPS), ("plain", plain_steps)):
        if mode == "kernels":
            ops.register_kernels()
        else:
            ops.unregister_kernels()
        state, _ = step_fn(state, loader.next_batch())
        batches = [loader.next_batch() for _ in range(n_steps)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=act) as prof:
            start.record()
            for b in batches:
                state, _ = step_fn(state, b)
            stop.record()
            torch.cuda.synchronize()
        step_ms = start.elapsed_time(stop) / n_steps
        # the raw device events: prof.events() would build a Python event
        # tree over every one, minutes for the plain scan's launches
        kernels = [(e.name(), e.duration_ns() / n_steps / 1e6)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(ms for _, ms in kernels)
        fam: dict[str, float] = {}
        by_name: dict[str, list] = {}
        for name, ms in kernels:
            fam[_family(name)] = fam.get(_family(name), 0.0) + ms
            rec = by_name.setdefault(name, [0.0, 0])
            rec[0] += ms
            rec[1] += 1
        print(f"  {mode}: step {step_ms:.2f} ms (CUDA events, profiled), device busy "
              f"{busy_ms:.2f} ms/step = {busy_ms / step_ms:.1%} of the step, "
              f"{len(kernels) // n_steps} kernel launches/step", flush=True)
        for f, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
            print(f"    {f:16s} {ms:8.2f} ms/step  {ms / busy_ms:6.1%}", flush=True)
        print("    top kernels (ms/step, launches/step):", flush=True)
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"    {ms:8.3f} {n // n_steps:5d}  {name[:100]}", flush=True)
    ops.unregister_kernels()


# bf16 K2 shapes timed against another checkout (``--k2-against``)
K2_AB = [(BATCH, 16, SEQ, 64), (BATCH, 16, SEQ, 128)]


def k2_against(other: str) -> int:
    """Time bf16 K2 in this checkout and in ``other`` (e.g. the parent
    commit unpacked with ``git archive``) on one card, in turns: other,
    this, this, other; one process each, each building its own library
    from its own sources.  Prints the times; the smoke test itself does
    not run."""
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [sys.argv[1] + '/src', {str(ROOT)!r}]\n"
        "import chip_smoke\n"
        "from repro_torch.kernels import flash_attention as fa\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "out = {}\n"
        f"for b, h, s, d in {K2_AB!r}:\n"
        "    q, k, v = (torch.randn((b, h, s, d), generator=g, device='cuda')\n"
        "               .to(torch.bfloat16) for _ in range(3))\n"
        "    out[d] = min(chip_smoke.cuda_ms(torch, lambda: fa.flash_attention_fwd(\n"
        "        q, k, v, causal=True), reps=50) for _ in range(3)) * 1e3\n"
        "print(json.dumps(out))\n")
    print(gpu_line(), flush=True)
    for tree in (other, str(ROOT), str(ROOT), other):
        run = subprocess.run([sys.executable, "-c", code, tree], capture_output=True,
                             text=True, timeout=600)
        if run.returncode:
            fail(f"K2 timing in {tree}: {run.stderr[-2000:]}")
        print(f"  K2 bf16 causal, us by head_dim (best of 3 x 50 calls) in {tree}: "
              f"{run.stdout.strip()}", flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--k2-against"]:
        return k2_against(sys.argv[2])
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

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rmsnorm as rn
    phase("1/5 build")
    names = [p.name for p in _build.sources()]
    print(f"  built {names} in {_build.build(verbose=True):.1f} s", flush=True)
    sass_check(_build._target())

    phase("2/5 kernels against their plain versions")
    results = phase_kernels(torch, F, fa, rn)
    results.update(phase_scan_kernels(torch, ms))

    counts = {}
    qwen = get_config("qwen1.5-0.5b")
    falcon = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=FALCON_LAYERS)
    deepseek = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=DEEPSEEK_LAYERS)
    qwen3 = get_config("qwen3-1b")
    results.update(phase_gmm_kernels(torch, mg, deepseek))
    # per step with remat="full": each layer's kernels run in the forward
    # and again in its recompute; the final norm runs once.  An MoE layer
    # runs three grouped matmuls (gate, up, down), and each one's backward
    # launches K3 twice (dx and dw)
    none = dict.fromkeys(("rmsnorm", "flash_attention", "mamba_scan", "mamba_scan_bwd",
                          "moe_gmm", "moe_gmm_bwd"), 0)
    paths = [(qwen, {**none, "rmsnorm": (4 * qwen.n_layers + 1) * STEPS,
                     "flash_attention": 2 * qwen.n_layers * STEPS}),
             (falcon, {**none, "rmsnorm": (2 * falcon.n_layers + 1) * STEPS,
                       "mamba_scan": 2 * falcon.n_layers * STEPS,
                       "mamba_scan_bwd": falcon.n_layers * STEPS}),
             (deepseek, {**none, "rmsnorm": (4 * deepseek.n_layers + 1) * STEPS,
                         "flash_attention": 2 * deepseek.n_layers * STEPS,
                         "moe_gmm": 6 * deepseek.n_layers * STEPS,
                         "moe_gmm_bwd": 6 * deepseek.n_layers * STEPS}),
             (qwen3, {**none, "rmsnorm": (4 * qwen3.n_layers + 1) * STEPS,
                      "flash_attention": 2 * qwen3.n_layers * STEPS})]
    for (cfg, want), tag in zip(paths, ("3", "3b", "3c", "3d")):
        phase(f"{tag}/5 full-width training: {cfg.name}, {cfg.n_layers} layers")
        counts[cfg.name], train = phase_train(torch, cfg, want)
        phase(f"5/5 where a full-width {cfg.name} step's device time goes")
        phase_profile(torch, train, plain_steps=1 if cfg.ssm else PROFILED_STEPS)
        del train                      # free this path's state before the next one
        gc.collect()
        torch.cuda.empty_cache()

    phase("3e/5 Piper IR: the qwen3-1b proxy traced on meta tensors, chunks of real layers")
    counts["ir"] = {**none, **phase_ir(torch)}
    gc.collect()
    torch.cuda.empty_cache()

    phase("4/5 training CLI")
    phase_cli(torch)

    meta = {"rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:19"),
            "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:27"),
            "mamba_scan": ("mamba_scan.cu", "src/repro/kernels/mamba_scan.py:43"),
            "mamba_scan_bwd": ("mamba_scan.cu", "src/repro/kernels/mamba_scan.py:43"),
            "moe_gmm": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:19"),
            "moe_gmm_bwd": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:19")}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        by_path = {arch: c[name] for arch, c in counts.items() if c[name]}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **{key: r[key] for key in r if key.startswith("at_")
                           or key in ("tflops", "two_bmm_ms", "max_abs_err_fp32_p")}})
    phase("done")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
