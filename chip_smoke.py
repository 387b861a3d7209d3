"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, checks in the library's SASS (``cuobjdump -sass``) that every
instantiation of the bf16 K2 and K3 kernels issues tensor-core ``wgmma``
(HGMMA) and TMA loads (UTMALDG), that no instantiation of K1, K4,
K4-bwd and the fp32 K2 and K3 touches local memory (LDL, STL) and that the fp32
K2 issues tensor-core ``mma.sync`` (HMMA: its split TF32), and holds each
kernel against its plain PyTorch version at the main paths' shapes and
at edge shapes (and K4-bwd against itself: two runs, the same bits).
Then, for each of the port's training paths, it trains the model
at its published widths (random weights from a seed, bf16,
remat="full") for a few steps through the port's own entry points with
the kernels installed, checks that every kernel of that path was
launched exactly as often as the path calls it, compares one step with
the plain versions (loss and every gradient leaf; in bf16 a leaf the
plain step cannot resolve is held against a plain run that follows the
kernel run's forward, each K1 and K2 call checked on the same inputs),
and profiles where a
step's device time goes (``torch.profiler``), with the kernels and with
their plain versions.  Only Qwen1.5's run ends with a checkpoint save
(phase 3i holds save, restore and reshard at full width):

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
    all 28 layers (K1, and K2 at GQA 16/8 and head_dim 128);
  - Zamba2-2.7B, 12 of its 54 layers (phase 3j): two groups of six
    Mamba-2 layers, each followed by the one weight-tied shared
    attention+MLP block, whose gradients sum over both applications (K1,
    and K2 at head_dim 80 with the config's sliding window of 4096, and
    K4 and K4-bwd at N = 64 with fp32 dt: its Mamba-2 SSD scan runs
    through them, where the JAX package runs it in jnp).  The fp32
    comparison runs one group (6 layers); a kernel step is profiled, and
    one layer's SSD scan is profiled alone, plain and through K4;
  - Whisper-large-v3 whole (phase 3k): 32 encoder layers over 1500
    frames (non-causal self-attention) and 32 decoder layers over 448
    tokens, each with a cross-attention to the encoder output (K1, and K2
    at head_dim 64: non-causal 1500 x 1500, causal 448 x 448 and 448
    queries over 1500 keys).  The frames, (4, 1500, 1280) N(0, 1) in
    bf16 from a seeded generator, stand in for the stub front end and
    come from this script's loader.  The fp32 comparison runs 2 encoder
    and 2 decoder layers;
  - Qwen2-VL-7B, 4 of its 28 layers at full width (phase 3l: K1, and K2
    at GQA 28/4, head_dim 128), qkv bias and M-RoPE, each row's
    positions in Qwen2-VL's own layout: a text prefix, one image of a 16
    x 24 patch grid, then text (``image_positions``);
  - the zoo configurations the card had not run before (phases 3p-3t,
    ``ZOO``), each at its published widths and at the depth of one
    pipeline stage with the embedding and lm_head, the kernels held to
    their plain versions first (bf16 at the path's depth), then
    ``ZOO_STEPS`` steps of ``build_step`` in a loop of their own (the
    supervisor's restart snapshot would hold 10 B a parameter more than
    the card has), one profiled kernel step and the fp32 check:
    minicpm-2b whole (40 layers: K1, K2 at 36 heads of 64, its odd vocab
    of 122,753 in the cross-entropy), qwen3-9b at 6 of 36 layers (GQA
    32/8), qwen2.5-32b at 2 of 64 (GQA 40/8, qkv bias), granite-20b at 4
    of 52 (MQA 48/1) and dbrx-132b at 1 of 40, forward and backward only
    (its AdamW step, 22 B a parameter, does not fit one card: K2 at GQA
    48/8, K3 and K3-bwd at (16, 1280, 6144) @ (16, 6144, 10752), its MoE
    block held at full width); each path's step time, peak beside the
    card's memory and busy share go to a ``zoo {...}`` line near the end;
  - the TPU kernels' widest shapes on a training path (phase 3u,
    ``wide_paths``), each a published configuration with one field
    changed, as the zoo paths run: qwen3-1b with ``head_dim=512`` at 2 of
    its 28 layers (K2 on the wide kernels, K1's qk-norm at width 512) and
    Zamba2-2.7B with ``SSMCfg(state=256, version=2, ...)`` at one group
    of 6 layers (K4 and K4-bwd as two groups of 128 states),
    ``WIDE_STEPS`` AdamW steps each, the fp32 check at 1 layer (Zamba2 at
    its group); a ``3u {...}`` line near the end.

Falcon-Mamba's and Zamba2's plain profiles are skipped (the plain runs
differ only in kernels whose plain versions phase 2 times), and so are
the zoo paths' (they differ in K1, K2 and K3).

The serving phase (3m) drives ``init_cache``, ``prefill`` and
``decode_step`` under inference mode: (a) qwen3-1b, all 28 layers in
bf16, prefills 4 x 1024 prompt tokens and greedy-decodes 32 tokens in a
cache of 1056 positions with the kernels (K1 and K2 launches exact; prefill
ms, decode ms a token, tokens/s, one decode step's busy share, cache bytes
and peak memory), then with their plain versions fed the kernel run's
tokens, each step's logits held to ``SERVE_RTOL``, and then qwen3-9b
whole (36 layers, 16.4 GB of bf16 weights) the same way; (b) for each,
decode from an
empty cache, teacher-forced over 64 prompt tokens, against the training
forward's logits, in bf16 at full depth and in fp32 at 2 (the cache
writes, the offset rotation and the masks: prefill leaves its cache
empty, as the JAX package's does); (c) the other families' decode
branches at published widths and their training phases' depths, 8 steps
each, kernels against plain versions with exact launches: DeepSeek-MoE
(2 layers: K3 at 4 rows a decode step, the plain run routed as the
kernel run), Falcon-Mamba (8 layers: K4 at S = 1 from the cached state),
Zamba2 (one group of 6: the window cache and the SSD scan from a state
on K4 at N = 64),
Whisper (2 + 2 layers over 1500 frames: the cross cache) and Qwen2-VL (4
layers, prefilled over image-layout positions), with (b) for all but the
MoE (its capacity drops differ by group size) and Whisper (its cross cache
stays empty); (d) ``examples/serve_torch.py`` at its defaults.  Phase 2
holds the decode shapes too: K1 at one row a sequence, K3 at 4 rows (64 experts of
DeepSeek's widths, both matmuls, fp32 and bf16; the fp32 K3's forward,
dx and dw also at DeepSeek's training shape beside ``torch.bmm``; K3 and
K3-bwd in fp32 and bf16 at DBRX's two training shapes, each fp32 w 4.2
GB, timed in bf16 beside ``torch.bmm``) and K4
at S = 1 with h0 and no saved states (Falcon-Mamba's width, and Zamba2's at N = 64 with
fp32 dt), each timed beside its bound and library call.  Phase 2 holds
K4 and K4-bwd at Zamba2's SSD shape (4, 1024, 5120, 64) with bf16 x and
fp32 dt too, at N = 32, 40, 64 and 5 at edge shapes, and K4-bwd twice
there for the same bits.

Phase 2 also holds the rest of the TPU kernels' contract: K2 at head
dims 1, 5, 50, 68, 100, 192 and 256 (``FLASH_CONTRACT`` timed L2-warm and
L2-cold beside SDPA, fp32 at 256 too), K3 with K and N no multiple of 8
(``GMM_CONTRACT``; the gate/up shape less 4 in each timed beside the
unpadded one and ``torch.bmm``) and K4 and K4-bwd at 128 states (Zamba2's
scan shape at N = 128, timed warm and cold, K4-bwd twice for the same
bits, the bytes of the partial rows one call allocates), and 96; past
them, K2 at head dims 264, 320, 384 and 512 (``FLASH_WIDE``: GQA 16/8,
bf16 and fp32, warm and cold, beside SDPA and the backend it chose) and
1000, and K4 and K4-bwd at 129, 192 (Falcon-Mamba's channels) and 256
states (Zamba2's, and its decode step), each new kernel twice for the
same bits; and the three grids past CUDA's 65,535 blocks in y or z
(``phase_grid_limits``: K2 at 65,536 query blocks, K3 at 65,536 row
tiles, K4 at a batch of 65,536), one call each against the plain
version.  Phase 3j
reports which of its bf16 runs, the kernels' or the plain versions', is
nearer an fp32 run of the same step through the plain versions
(``nearer_fp32``).

The kernel phase runs K1 at every width the configs train at (4096
rows, and Whisper's 6000 encoder rows) and at the serving models'
decode rows, in fp32 and bf16: each case against its plain version, two
of its rows alone bit-equal to the same rows in the whole call, and
timed L2-warm and L2-cold beside PyTorch's own RMSNorm, the plain version, its
bound and the launch floor (an empty kernel by the same timer); and at
edge shapes (a D no multiple of 8, x off 16-byte alignment).
The kernel phase runs K2 at every head dim the paths and configs give
it — 64, 128, qwen3-1b's GQA, granite-20b's MQA, and 32 and 80, which
run on a padded instantiation — each against its plain version and
timed beside SDPA, and the fp32 K2 (split TF32 on the tensor cores) at
head dims 64 and 128 beside fp32 SDPA; K2 at the encoder-decoder's and
the VLM's shapes and the zoo paths' (``FLASH_PATHS``: ragged query
blocks, non-causal keys past 1,000, GQA 28/4, 36 heads of 64, GQA 32/8,
40/8 and 48/8) in fp32 and bf16 against its plain version and
timed beside SDPA; and K2 with a sliding window (``FLASH_WINDOWS``: Zamba2's own call, windows
of 1, 100 and 1000, a band at 8,192 tokens, GQA, non-causal, a query
offset) in fp32 and bf16 against its plain version with the window, timed
beside SDPA given the band as a boolean mask, its bound counted over the
visible band.
Then the Piper IR phase traces the qwen3-1b proxy at full width on meta
tensors (no device memory may move), compiles it from a Strategy
document (pp 4 x dp 2, ZeRO-3, 8-microbatch 1F1B, the overlap engine)
and holds its chunk and comm counts and dataflow fingerprint to the JAX
package's (``IR_CASE``); and it runs the F and B chunk functions of a
region over two real qwen3-1b layers, under remat "full" and "none",
counting their K1 and K2 launches and holding their gradients to
autograd's.  The Piper runtime phase (3f) runs that Strategy's program
on the ``reference`` executor with real draws for the proxy's weights,
then trains qwen3-1b's 28 layers in bf16 (and 4 layers in fp32) as a
Piper forward of four stage regions through a pp 4 x dp 2 1F1B ZeRO-3
Strategy on the interpreter, one card simulating the eight logical
devices, under remat "full" and "none": the loss and every gradient
leaf held to ``train_loss``'s autograd, exact K1 and K2 launch counts,
the replayed dispatch order equal to the run's, and a profile of one
stash forward and backward.  The scoring, tuning and verification phase
(3g) runs the training CLI's ``--autotune`` for the full qwen3-1b on a
pp 4 x dp 2 mesh (the tuner's search on the H100 constants, then the
reduced model trains and its loss must fall), replays the winner's
``strategy.json`` with ``--backend reference`` on the card (K1 and K2
launch on this path, counted from (a) to (b)), and lints the grid of the
ported configs at ``deep`` (every cell clean); then it holds
the cost model against the card: each distinct stage chunk of phase 3f's
program (F and B), counted on meta tensors (the forward's FLOPs within 1%
of the closed form) and predicted on the H100 constants, beside its
device time with the kernels (exact K1 and K2 launches); ``calibrate``
folds the ratios in, the calibrated model simulates the plan, its
memory estimate stands beside phase 3f's ledger peaks, and it scores the
tuned winner on the analytic and on the counted chunk cost.  It also checks
that the plans compile clean under the default ``analyze="quick"`` and
analyses phase 3f's program and phase 3e's proxy at ``deep``.  The
multi-rank runtimes phase (3h) holds the ``spmd`` lane (one controller,
a CUDA stream per rank) and the ``mpmd`` lane (a thread per rank over
the ``inproc`` or ``tcp`` transport) to the interpreter on the card, bit
for bit, after checking that two interpreter runs give the same bits:
(a) the CPU tests' grids of toy cases in fp64; (b) phase 3f's bf16
program at ``LANES_LAYERS`` (4) of its 28 layers under remat "full" and
"none" on both lanes, with exact K1
and K2 launches, the interpreter's order, each lane's warm step beside
the interpreter's and its busy share (remat "full"),
``max_memory_allocated`` and the bytes it moved between ranks (p2p, gathers, reductions); (c) the 4-layer
fp32 program under ZeRO-1 on ``tcp`` (``TCP_ZERO``), its bytes and seconds; (d) ``tune.measure_program``
on ``spmd`` for phase 3g's winner and 1F1B baseline beside their
predicted steps (recorded, not gated); (e) the CLI's ``--strategy`` with
``--backend`` spmd and mpmd, each loss bit-equal to reference's.  The
elastic phase (3i) runs the ``ElasticSupervisor`` through faults: (a) the
CPU tests' kill-a-rank grid on ``spmd`` and ``mpmd`` and their 24-step
chaos soak on ``spmd`` (the toy MLP in fp64), bit-equal to uninterrupted
or piecewise fault-free references; (b) phase 3f's bf16 program at
``LANES_LAYERS`` layers on ``spmd`` through a kill (world 8 -> 4, ZeRO shards 2 -> 1) and the
slot's arrival (back to 8 from the plan cache), every kept loss and final
param leaf bit-equal to the piecewise fault-free reference, with exact K1
and K2 launches over the steps each world ran, and its recovery,
recompile, checkpoint and reshard seconds, checkpoint bytes, peak memory
and step times; (c) the CLI's ``--elastic`` on ``spmd`` and ``--chaos``
with ``--chaos-report`` on ``mpmd`` for phase 3g's winner.  Last it
runs the training CLI at its defaults
for the ported archs, qwen3-1b, minicpm-2b (its WSD schedule checked
step by step), qwen2-vl-7b, ``--d-model 128`` (head_dim 32), ``--d-model
200`` (head_dim 50) and DeepSeek at ``--d-model 1020`` (head_dim 68,
experts of 1020 x 2040).

The production SPMD lane (phase 3n) runs in a one-rank NCCL world on a
(1, 1) ("data", "model") ``DeviceMesh``, destroyed at its end: (a)
DeepSeek-MoE-16B at 2 of its 28 layers through ``sharded_train_step``
(ZeRO-3, ``moe_impl="a2a"``, so ``moe_block_ep`` runs its experts on
K3), launches exact, the first step bit-equal to ``build_step`` on local
tensors under the same axis map, loss and gradients with the kernels
against their plain versions routed alike, the median step beside the
local steps' (DTensor's dispatch), busy share and peak beside phase
3c's; then the same with ``moe_impl="grouped"`` (the grouped block,
each rank of the model axis computing its share of the experts on K3),
launches exact, bit-equal to ``build_step``, its median step beside the
all-to-all block's; (b) Qwen3-1.7B whole through
``sharded_prefill_step`` and 8 ``sharded_decode_step``s, launches exact,
logits and every cache leaf bit-equal to phase 3m's functions fed the
same tokens, the cache written in place in the caller's buffers (same
``data_ptr``, new contents), and the ms a token and decode peak beside
those of a decode step that copies its cache and of the local path; (c)
``python -m repro_torch.launch.dryrun`` for (a)'s cell
on the same mesh, its ``argument_size_in_bytes`` equal to (a)'s placed
state and batch, and for qwen3-1b ``train_4k`` on ``pod1``.  It prints the card's
name and power limit, one JSON line of kernel numbers (launches by path,
the serving paths' among them), and as its last
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
import io
import json
import math
import os
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
# Zamba2-2.7B: 12 of its 54 layers, two groups of 6, so the shared block
# is applied twice and its tied gradients sum on the card
ZAMBA2_LAYERS = 12
# Whisper-large-v3 whole (32 encoder and 32 decoder layers) over its
# published decoder context (max_target_positions) and its 1500 encoder
# frames; Qwen2-VL-7B at 4 of its 28 layers (the whole model and its fp32
# AdamW moments do not fit one card), each row holding one image of a
# 16 x 24 patch grid after a text prefix of its own length
WHISPER_SEQ = 448
QWEN2_VL_LAYERS = 4
IMAGE_GRID = (16, 24)
IMAGE_PREFIXES = (16, 100, 300, 500)
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
# a leaf pools every layer).  bf16 at full depth, and fp32 at 2 layers.
# A bf16 leaf over the limit must also be over it between two plain runs
# that differ only in the order of one fp32 sum, and within it against a
# plain run that follows the kernel run's forward (``compare_with_plain``):
# at Whisper's 32 + 32 layers the plain run's own q and k leaves move by
# up to 9.3e-2 (PERF.md, section 6).
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
TF32_FLOPS = 495e12
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


def cuda_ms(torch, fn, reps: int = 20, sleep_cycles: int = 100_000_000) -> float:
    """Mean device milliseconds per call by CUDA events, after a warm-up.
    The device first spins for ``sleep_cycles`` (~50 ms by default) so
    the host can queue every call before the first one starts: the events
    then time the device, not the host's launch rate (a small kernel
    takes less time on the card than its Python wrapper takes to launch
    it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
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


def ir_strategy(core):
    """IR_CASE as a Strategy document: one stage per pipeline rank (the
    Pipeline fragment's default is two), 1F1B, ZeRO-3, the overlap engine
    at its defaults.  ``core`` is a package's core module.  It lowers to
    the plan of ``pipeline_directives``, which the CPU tests hold (the
    same fingerprint)."""
    c = IR_CASE
    return core.Strategy(core.Mesh(pp=c["pp"], dp=c["dp"]),
                         core.Pipeline("1f1b", n_mb=c["n_mb"], n_stages=c["pp"])
                         | core.ZeRO(stage=c["zero"]) | core.Overlap())


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
    """The hand-written directive list the CPU tests hold beside the
    Strategy spelling (``ir_strategy``).  Place stage s of ``pp`` on
    devices [s*dp, (s+1)*dp), replicate it there at ZeRO stage ``zero``
    (0 and 1 alike: gradients all-reduced; 2
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
# K2 at the rest of the TPU kernel's contract to D = 256, timed in
# bf16 L2-warm and L2-cold, and their keys: head dims no multiple of 8
# (50 and 68, the CLI's --d-model 200 and DeepSeek at --d-model 1020,
# padded to 56 and 72 by the wrapper and run on 64 and 128), and 192 and
# 256 on the 256-wide instantiation (fp32 at 256 too)
FLASH_CONTRACT = {(BATCH, 16, 16, SEQ, 50): "at_head_dim_50_padded",
                  (BATCH, 16, 16, SEQ, 68): "at_head_dim_68_padded",
                  (BATCH, 16, 16, SEQ, 192): "at_head_dim_192",
                  (BATCH, 16, 16, SEQ, 256): "at_head_dim_256"}
# K2 past head dim 256 (the wide kernels), GQA 16/8 as qwen3-1b's, timed
# in bf16 and fp32, L2-warm and L2-cold, beside SDPA (whose flash backend
# stops at 256: the row names the backend it chose), and their keys: 264
# (its last block 8 columns wide), 320, 384 and 512 (phase 3u's qwen3-1b)
FLASH_WIDE = {(BATCH, 16, 8, SEQ, d): f"at_head_dim_{d}_gqa_16_8" for d in (264, 320, 384, 512)}
# K2 with a sliding window, (B, Hq, Hkv, Sq, Skv, D, causal, q_offset,
# window), and its key in the kernels line: Zamba2's shared attention
# (window 4096, which masks nothing at SEQ tokens), windows that are no
# multiple of the 64-key tile, a real band at 8,192 tokens, GQA at head
# dims 128 and 256 (two blocks a query block), non-causal, and a query
# block past the keys' start
FLASH_WINDOWS = {
    (BATCH, 32, 32, SEQ, SEQ, 80, True, 0, 4096): "at_window_4096_zamba2",
    (BATCH, 32, 32, SEQ, SEQ, 80, True, 0, 1): "at_window_1",
    (BATCH, 32, 32, SEQ, SEQ, 80, True, 0, 100): "at_window_100",
    (BATCH, 32, 32, SEQ, SEQ, 80, True, 0, 1000): "at_window_1000",
    (1, 32, 32, 8192, 8192, 80, True, 0, 4096): "at_window_4096_seq_8192",
    (BATCH, 16, 8, SEQ, SEQ, 128, True, 0, 256): "at_window_256_gqa_16_8_head_dim_128",
    (BATCH, 32, 32, SEQ, SEQ, 80, False, 0, 256): "at_window_256_non_causal",
    (BATCH, 32, 32, SEQ // 2, SEQ, 80, True, SEQ // 2, 300): "at_window_300_q_offset_512",
    (BATCH, 16, 8, SEQ, SEQ, 256, True, 0, 300): "at_window_300_gqa_16_8_head_dim_256",
}


# K2 at the shapes of the encoder-decoder and VLM paths, (B, Hq, Hkv, Sq,
# Skv, D, causal), and their keys in the kernels line: Whisper's encoder
# self-attention (non-causal, 1500 rows: 11.7 blocks of 128 query rows,
# 23.4 tiles of 64 keys), its decoder self-attention (448 rows, 3.5
# blocks) and cross-attention (448 queries over 1500 keys, non-causal),
# and Qwen2-VL's GQA 28/4 (n_rep 7, no power of two); then the zoo paths'
# (``ZOO``; granite-20b's MQA 48/1 is in ``FLASH_TIMED``): minicpm-2b's 36
# heads of 64, qwen3-9b's GQA 32/8, qwen2.5-32b's 40/8 (n_rep 5) and
# DBRX's 48/8 (n_rep 6)
FLASH_PATHS = {
    (BATCH, 20, 20, 1500, 1500, 64, False): "at_whisper_encoder_1500_non_causal",
    (BATCH, 20, 20, WHISPER_SEQ, WHISPER_SEQ, 64, True): "at_whisper_decoder_448_causal",
    (BATCH, 20, 20, WHISPER_SEQ, 1500, 64, False): "at_whisper_cross_448_1500",
    (BATCH, 28, 4, SEQ, SEQ, 128, True): "at_qwen2_vl_gqa_28_4_head_dim_128",
    (BATCH, 36, 36, SEQ, SEQ, 64, True): "at_minicpm_2b_36_36_head_dim_64",
    (BATCH, 32, 8, SEQ, SEQ, 128, True): "at_qwen3_9b_gqa_32_8_head_dim_128",
    (BATCH, 40, 8, SEQ, SEQ, 128, True): "at_qwen2_5_32b_gqa_40_8_head_dim_128",
    (BATCH, 48, 8, SEQ, SEQ, 128, True): "at_dbrx_132b_gqa_48_8_head_dim_128",
}


def window_band(torch, sq: int, skv: int, causal: bool, q_offset: int, window: int) -> tuple:
    """(visible (query, key) pairs of one head, keys that any row sees):
    row i sees keys [max(0, qpos - window + 1), qpos] (causal) or up to
    Skv - 1, with qpos = i + q_offset; the rows' ranges overlap, so their
    union is one range."""
    qpos = torch.arange(sq, dtype=torch.int64) + q_offset
    lo = (qpos - window + 1).clamp(min=0)
    hi = (qpos + 1).clamp(max=skv) if causal else torch.full_like(qpos, skv)
    return int((hi - lo).clamp(min=0).sum()), int(hi.max() - lo.min())


# K1's shapes (phase 2 and ``scripts/kernel_ab.py k1``): BATCH x SEQ rows
# at each width the configs train at, Whisper's encoder rows (BATCH x 1500
# frames), and one row a sequence at the widths of phase 3m's serving
# models (Whisper 1280, qwen3-1b and DeepSeek 2048, Zamba2 2560, Qwen2-VL
# 3584, Falcon-Mamba 4096), each in fp32 and bf16
K1_WIDTHS = (1024, 1280, 2048, 2304, 2560, 3584, 4096, 5120, 6144)
K1_SHAPES = ([(BATCH * SEQ, d) for d in K1_WIDTHS] + [(BATCH * 1500, 1280)]
             + [(BATCH, d) for d in (1280, 2048, 2560, 3584, 4096)])
# an L2-cold time rotates x through copies that fill at least this many
# bytes (the H100's L2 holds 50 MB): each launch's x was last touched
# that many bytes of other copies ago
L2_COLD_BYTES = 128 << 20
# the timer's spin before K1's calls: ~10 ms, ample for the host to queue
# 20 calls of a wrapper
K1_SLEEP_CYCLES = 20_000_000
# calls timed on the host's clock
K1_HOST_CALLS = 2000


def sdpa_backend(torch, q, k, v, causal: bool, gqa: bool) -> str:
    """The backend SDPA's dispatcher picks for these inputs (its own
    choice function, ``torch._fused_sdp_choice``), by name."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal,
                                                  enable_gqa=gqa)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def cold_ms(torch, fn, args: tuple, reps: int = 20, sleep_cycles: int = 100_000_000) -> float:
    """``fn(*args)`` timed L2-cold by ``cuda_ms``: each call takes the next
    of copies of the tensors in ``args`` that together fill at least
    ``L2_COLD_BYTES`` (the H100's L2 holds 50 MB), so no input was touched
    in the last that many bytes of other calls' inputs."""
    import itertools
    n_bytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    copies = max(2, -(-L2_COLD_BYTES // n_bytes) + 1)
    pool = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                     for _ in range(copies - 1)]
    it = itertools.cycle(pool)
    return cuda_ms(torch, lambda: fn(*next(it)), reps=reps, sleep_cycles=sleep_cycles)


def k1_times(torch, rn, library, x, w) -> dict:
    """K1 on (x, w) timed L2-warm (one x, as ``cuda_ms`` times) and
    L2-cold (x rotating through copies filling ``L2_COLD_BYTES``; w, one
    vector, stays warm as in a model's layer), beside ``library(x, w)``
    (the PyTorch call computing the same function) timed both ways and
    the plain version warm; with the bound."""
    fns = {"": lambda v: rn.rmsnorm_fwd(v, w),
           "library_": lambda v: library(v, w)}
    out = {}
    for key, fn in fns.items():
        out[f"{key}ms"] = cuda_ms(torch, lambda: fn(x), sleep_cycles=K1_SLEEP_CYCLES)
        out[f"{key}ms_cold"] = cold_ms(torch, fn, (x,), sleep_cycles=K1_SLEEP_CYCLES)
    out["plain_ms"] = cuda_ms(torch, lambda: rn.rmsnorm_plain(x, w),
                              sleep_cycles=K1_SLEEP_CYCLES)
    return {**out, **bound(2 * x.numel() * x.element_size() + w.numel() * w.element_size(),
                           5 * x.numel() / FP32_FLOPS)}   # square, sum, scale, cast, weight


def k1_sweep(torch, rn, library) -> dict:
    """K1 at ``K1_SHAPES``: each case held to the plain version, two of
    its rows (the first and the last) computed alone and held bit for bit
    to the whole call's, then ``k1_times``.  The launch floor is
    ``torch.cuda._sleep(0)`` (a spin kernel of no cycles) by the same
    timer.  Returns {"launch_floor_ms": t, "<dtype>_<n>_<d>": {...}}."""
    g = torch.Generator(device="cuda").manual_seed(4321)
    out = {"launch_floor_ms": cuda_ms(torch, lambda: torch.cuda._sleep(0),
                                      sleep_cycles=K1_SLEEP_CYCLES)}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for n, d in K1_SHAPES:
            w = (torch.randn(d, generator=g, device="cuda") * 0.5 + 1.0).to(dt)
            x = torch.randn((n, d), generator=g, device="cuda").to(dt)
            name = f"rmsnorm {dname} {(n, d)}"
            y = rn.rmsnorm_fwd(x, w)
            err = check_close(torch, name, y, rn.rmsnorm_plain(x, w), dname)
            for r in (0, n - 1):
                if not torch.equal(rn.rmsnorm_fwd(x[r:r + 1], w).view(-1), y[r]):
                    fail(f"{name}: row {r} alone differs in its bits from the same row "
                         f"inside the {n}-row call")
            case = out[f"{dname}_{n}_{d}"] = {"max_abs_err": err,
                                              **k1_times(torch, rn, library, x, w)}
            print(f"  {name}: max_abs_err={err:.3e}; kernel {case['ms'] * 1e3:.2f} warm / "
                  f"{case['ms_cold'] * 1e3:.2f} cold us, library "
                  f"{case['library_ms'] * 1e3:.2f} / {case['library_ms_cold'] * 1e3:.2f}, "
                  f"plain {case['plain_ms'] * 1e3:.2f}, bound {case['bound_ms'] * 1e3:.3f} "
                  f"({case['bound_by']})", flush=True)
    print(f"  launch floor (torch.cuda._sleep(0), the same timer): "
          f"{out['launch_floor_ms'] * 1e3:.2f} us", flush=True)
    # the host's time a call at the decode shape, where the card is faster
    # than the host: wall time over many calls ending in a synchronize
    x = torch.randn((BATCH, 2048), generator=g, device="cuda").bfloat16()
    w = torch.ones(2048, device="cuda").bfloat16()
    for key, fn in (("host_us", lambda: rn.rmsnorm_fwd(x, w)),
                    ("library_host_us", lambda: library(x, w))):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(K1_HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) / K1_HOST_CALLS * 1e6
    print(f"  host time a call at ({BATCH}, 2048) bf16: kernel {out['host_us']:.2f} us, "
          f"library {out['library_host_us']:.2f} us", flush=True)
    return out


def phase_k1(torch, rn, library) -> dict:
    """K1 against its plain version at the edge shapes (rows that fill no
    block, a D that is no multiple of 8, a misaligned x), then
    ``k1_sweep``.  Returns the kernel line's entry: the main row at
    (BATCH x SEQ, 1024) bf16, and every swept case under ``at_...``."""
    g = torch.Generator(device="cuda").manual_seed(1234)
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for shape, offset in (((130, 1024), 0), ((3, 5, 256), 0), ((7, 1001), 0),
                              ((33, 2048), 1)):
            buf = torch.randn(math.prod(shape) + offset, generator=g, device="cuda").to(dt)
            x = buf[offset:].view(shape)          # offset 1: x 2 or 4 bytes off 16
            w = (torch.randn(shape[-1:], generator=g, device="cuda") * 0.5 + 1.0).to(dt)
            err = check_close(torch, f"rmsnorm {dname} {shape} offset {offset}",
                              rn.rmsnorm_fwd(x, w), rn.rmsnorm_plain(x, w), dname)
            print(f"  rmsnorm {dname:8s} {str(shape):16s} offset {offset}: max_abs_err="
                  f"{err:.3e}", flush=True)
    sweep = k1_sweep(torch, rn, library)
    main = sweep[f"bfloat16_{BATCH * SEQ}_1024"]
    return {**{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")},
            **{k: sweep.pop(k) for k in ("launch_floor_ms", "host_us", "library_host_us")},
            **{f"at_{key}": case for key, case in sweep.items()}}


def phase_kernels(torch, F, fa, rn) -> dict:
    """Each kernel against its plain version; times at the main path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(1234)

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)

    results = {"rmsnorm": phase_k1(torch, rn,
                                   lambda x, w: F.rms_norm(x, x.shape[-1:], w, 1e-6))}

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
             (1, 4, 1, 50, 90, 80, False), *FLASH_PATHS,
             # the rest of the TPU kernel's contract: FLASH_CONTRACT's
             # shapes, then 256 with GQA and an offset, 192 ragged and
             # non-causal, and head dims 5, 1 and 100 (padded to 8, 8, 104)
             *[(b, hq, hkv, s, s, d, True) for b, hq, hkv, s, d in FLASH_CONTRACT],
             (1, 8, 2, 100, 300, 256, True), (2, 4, 2, 40, 72, 192, False),
             (1, 4, 1, 50, 90, 5, True), (1, 4, 4, 130, 200, 1, True),
             (2, 6, 2, 70, 130, 100, False),
             # past 256 (the wide kernels): FLASH_WIDE's shapes, then 512
             # with an offset and ragged Skv, 320 non-causal, and 1000
             # padded to 1000 (8 blocks a query block, its last 104 wide)
             *[(b, hq, hkv, s, s, d, True) for b, hq, hkv, s, d in FLASH_WIDE],
             (1, 8, 2, 100, 300, 512, True), (2, 4, 2, 40, 72, 320, False),
             (1, 4, 2, 130, 200, 1000, True)]
    errs = {}      # (case, dtype name) -> (max abs error of out and lse, against fp32 P)
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
            extra, p_err = "", None
            if dt == torch.bfloat16:
                # the plain version's bf16 path repeats the kernel's bf16 P;
                # this holds the kernel to the TPU kernel's formula, fp32 P
                fp32_p = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                      causal=causal, q_offset=off)[0]
                p_err = check_close(torch, tag + " against fp32 P", out, fp32_p.to(dt),
                                    dname, FP32_P_TOL)
                extra = f" against_fp32_P={p_err:.3e}"
            if d > 256:           # a new kernel: the same bits on a second call
                again = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
                if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                    fail(f"{tag}: two calls on the same inputs differ")
                extra += " (the same bits twice)"
            print(f"  {tag} max_abs_err={err:.3e} lse_err={lse_err:.3e}{extra}", flush=True)
            errs[(b, hq, hkv, sq, skv, d, causal), dname] = (max(err, lse_err), p_err)

    def window_case(b, hq, hkv, sq, skv, d, causal, off, window) -> dict:
        """K2 with a window against its plain version with the window, in
        fp32 and bf16 (bf16 also against the fp32-P formula); then, in
        bf16, K2, its plain version and SDPA given the band as a boolean
        ``attn_mask``, timed.  The bound counts the visible band: its
        (query, key) pairs' FLOPs and the bytes of q, out, lse and the
        keys and values that any row sees."""
        tag = f"flash window {window} {(b, f'{hq}/{hkv}', sq, skv, d)} " \
              f"{'causal' if causal else 'non-causal'} q_offset {off}"
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            q = randn((b, hq, sq, d), dt)
            k, v = randn((b, hkv, skv, d), dt), randn((b, hkv, skv, d), dt)
            kw = dict(causal=causal, q_offset=off, window=window)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            errs[dname] = max(check_close(torch, f"{tag} {dname}", out, want, dname),
                              check_close(torch, f"{tag} {dname} lse", lse, want_lse,
                                          "float32"))
            del want, want_lse
            if dt == torch.bfloat16:
                fp32_p = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), **kw)[0]
                errs["fp32_p"] = check_close(torch, f"{tag} against fp32 P", out,
                                             fp32_p.to(dt), dname, FP32_P_TOL)
                del fp32_p
        pairs, keys = window_band(torch, sq, skv, causal, off, window)
        qpos = torch.arange(sq, device="cuda")[:, None] + off
        kpos = torch.arange(skv, device="cuda")[None, :]
        mask = (kpos > qpos - window) & ((kpos <= qpos) if causal else True)
        es = q.element_size()
        n_bytes = (2 * q.numel() + 2 * b * hkv * keys * d) * es + b * hq * sq * 4
        flops = 4 * d * b * hq * pairs
        timed = dict(
            ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **kw)),
            plain_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v, **kw),
                             reps=3),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=hq != hkv)),
            **bound(n_bytes, flops / BF16_FLOPS))
        timed.update(tflops=flops / timed["ms"] / 1e9, max_abs_err=errs["bfloat16"],
                     max_abs_err_fp32=errs["float32"], max_abs_err_fp32_p=errs["fp32_p"],
                     visible_pairs_per_head=pairs)
        print(f"  {tag}: fp32 max_abs_err={errs['float32']:.3e}, bf16 "
              f"max_abs_err={errs['bfloat16']:.3e} against_fp32_P={errs['fp32_p']:.3e}; "
              f"bf16 kernel {timed['ms']:.4f} ms ({timed['tflops']:.1f} TFLOP/s), plain "
              f"{timed['plain_ms']:.4f} ms, SDPA with the band as attn_mask "
              f"{timed['library_ms']:.4f} ms (kernel/SDPA "
              f"{timed['ms'] / timed['library_ms']:.2f}x), bound {timed['bound_ms']:.4f} ms "
              f"({timed['bound_by']}; {pairs} visible pairs a head)", flush=True)
        return timed

    def flash_times(b, hq, hkv, sq, skv, d, causal, dt=torch.bfloat16, cold=False) -> dict:
        """K2, its plain version and SDPA with q (b, hq, sq, d) and k, v
        (b, hkv, skv, d) in ``dt`` (causal calls are square), with the
        errors the checks above found there.  The bound counts the (query,
        key) pairs the mask leaves, at the true d (a padded d's MMA work, 80
        run as 128, shows as distance from it), and the bytes of q, k, v,
        out and lse; fp32 K2's bound counts the work it issues, three TF32
        products a product at the TF32 rate (its split TF32), and the
        time of the same FLOPs at the fp32 FFMA rate is printed beside it.
        With ``cold`` K2 and SDPA are also timed L2-cold (``cold_ms``)."""
        q = randn((b, hq, sq, d), dt)
        k, v = (randn((b, hkv, skv, d), dt) for _ in range(2))
        pairs = b * hq * (sq * (sq + 1) // 2 if causal else sq * skv)
        n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + b * hq * sq * 4
        op_s = 4 * d * pairs / BF16_FLOPS if dt == torch.bfloat16 else \
            3 * 4 * d * pairs / TF32_FLOPS
        timed = dict(
            ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=causal)),
            plain_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v, causal=causal)),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv)),
            **bound(n_bytes, op_s))
        if cold:
            timed["ms_cold"] = cold_ms(torch, lambda *a: fa.flash_attention_fwd(
                *a, causal=causal), (q, k, v))
            timed["library_ms_cold"] = cold_ms(torch, lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=causal, enable_gqa=hq != hkv), (q, k, v))
        if d > 256:
            timed["library_backend"] = sdpa_backend(torch, q, k, v, causal, hq != hkv)
        case = (b, hq, hkv, sq, skv, d, causal)
        tflops = 4 * d * pairs / timed["ms"] / 1e9
        if dt == torch.bfloat16:
            timed["tflops"] = tflops
            timed["max_abs_err"], timed["max_abs_err_fp32_p"] = errs[case, "bfloat16"]
            if case in FLASH_PATHS:
                timed["max_abs_err_fp32"] = errs[case, "float32"][0]
        else:       # the kernels line's fp32 rows keep measured numbers and the bound only
            timed["max_abs_err"] = errs[case, "float32"][0]
        floor = "" if dt == torch.bfloat16 else \
            f", the same FLOPs at the fp32 FFMA rate {4 * d * pairs / FP32_FLOPS * 1e3:.4f} ms"
        if "library_backend" in timed:
            floor += f"; SDPA's backend {timed['library_backend']}"
        if cold:
            floor += (f"; L2-cold: kernel {timed['ms_cold']:.4f} ms, SDPA "
                      f"{timed['library_ms_cold']:.4f} ms")
        print(f"  flash {(b, f'{hq}/{hkv}', sq, skv, d)} {'causal' if causal else 'non-causal'} "
              f"{str(dt)[6:]}: kernel {timed['ms']:.4f} ms ({tflops:.1f} TFLOP/s), "
              f"plain {timed['plain_ms']:.4f} ms, SDPA {timed['library_ms']:.4f} ms "
              f"(kernel/SDPA {timed['ms'] / timed['library_ms']:.2f}x), bound "
              f"{timed['bound_ms']:.4f} ms ({timed['bound_by']}){floor}", flush=True)
        return timed

    # Qwen1.5's head_dim 64 first (the row's main numbers, and cold beside
    # the padded 50 and 68), then the rest
    results["flash_attention"] = flash_times(BATCH, 16, 16, SEQ, SEQ, 64, True, cold=True)
    for (b, hq, hkv, sq, d), key in FLASH_TIMED.items():
        if key:
            results["flash_attention"][key] = flash_times(b, hq, hkv, sq, sq, d, True)
    for (b, hq, hkv, sq, d), key in FLASH_CONTRACT.items():
        results["flash_attention"][key] = flash_times(b, hq, hkv, sq, sq, d, True, cold=True)
        torch.cuda.empty_cache()
    # the fp32 kernel (split TF32), which the paths' fp32 checks launch, at
    # head dims 128 (qwen3-1b, DeepSeek, Qwen2-VL) and 64 (Whisper), and
    # 256 (the contract's widest)
    for d in (64, 128, 256):
        results["flash_attention"][f"at_fp32_head_dim_{d}"] = flash_times(
            BATCH, 16, 16, SEQ, SEQ, d, True, torch.float32, cold=d == 256)
    for case, key in FLASH_PATHS.items():
        results["flash_attention"][key] = flash_times(*case)
    for (b, hq, hkv, sq, d), key in FLASH_WIDE.items():
        results["flash_attention"][key] = flash_times(b, hq, hkv, sq, sq, d, True, cold=True)
        results["flash_attention"]["at_fp32_" + key[3:]] = flash_times(
            b, hq, hkv, sq, sq, d, True, torch.float32, cold=True)
        torch.cuda.empty_cache()
    for case, key in FLASH_WINDOWS.items():
        results["flash_attention"][key] = window_case(*case)
        torch.cuda.empty_cache()
    return results


# the bf16 tensor-core kernels and their instantiations (head dims 64, 128
# and 256, each exact and padded, each with and without a sliding window;
# the wide kernel past 256, with and without a window; layouts)
TC_KERNELS = {"flash_fwd_wgmma_kernel": 12, "flash_fwd_wgmma_wide_kernel": 2,
              "moe_gmm_wgmma_kernel": 3}
# the kernels that must keep their state in registers and shared memory,
# and their instantiations: the scans (x fp32 or bf16, dt fp32 or bf16,
# the built state sizes 16, 32, 64 and 128, and a group of 128 of a larger
# size), the fp32 K3 (few rows: row
# tiles 8, 16, 24, 32 x 3 layouts; tiles of 64 and 128 rows x 3 layouts x
# 16- or 4-byte copies), the fp32 K2 (head dims 64 and 128 x blocks of 64
# and 128 rows, and 256 in blocks of 64; the wide kernel past 256) and K1
# (fp32 and bf16 x 1 to 5 chunks a thread and the
# generic two-pass kernel with 16-byte accesses, and the generic one
# element by element)
SCAN_KERNELS = {"mamba_scan_fwd_kernel": 20, "mamba_scan_bwd_kernel": 20}
LOCAL_FREE_KERNELS = {**SCAN_KERNELS, "gmm_few_rows_kernel": 12, "gmm_tile_kernel": 12,
                      "flash_fwd_fp32_kernel": 5, "flash_fwd_fp32_wide_kernel": 1,
                      "rmsnorm_kernel": 14}
# the kernels whose fp32 products are split TF32 on the tensor cores
SPLIT_TF32_KERNELS = ("flash_fwd_fp32_kernel", "flash_fwd_fp32_wide_kernel")


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
    not keep in registers) in each instantiation of ``LOCAL_FREE_KERNELS``
    (K1, the scans and the fp32 K2 and K3), and fail if one is missing or has
    any; and fail if an instantiation of the fp32 K2 has no HMMA
    (``mma.sync``: its products are split TF32 on the tensor cores)."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    ops = ("HGMMA", "UTMALDG", "HMMA", "LDL", "STL")
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
    for kernel, n_inst in LOCAL_FREE_KERNELS.items():
        mine = {k: v for k, v in counts.items() if kernel in k}
        local = {k: v["LDL"] + v["STL"] for k, v in mine.items()}
        print(f"  SASS {kernel}: {len(mine)} instantiations, local-memory accesses "
              f"{sorted(local.values())}", flush=True)
        if len(mine) != n_inst or any(local.values()):
            fail(f"SASS check: {kernel} has {len(mine)} of {n_inst} instantiations, local "
                 f"loads and stores {local}: the kernel must not use local memory")
        if kernel in SPLIT_TF32_KERNELS:
            hmma = sorted(v["HMMA"] for v in mine.values())
            print(f"  SASS {kernel}: HMMA {hmma}", flush=True)
            if not all(hmma):
                fail(f"SASS check: {kernel} has an instantiation without HMMA ({hmma})")
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


def decode_gmm_shapes(cfg) -> list:
    """(E, rows, K, N) of the MoE grouped matmuls in one decode step of
    BATCH sequences: each token is its own group (``_dispatch_groups``
    gives one chunk of a 1-token row), so each expert has
    max(1, int(capacity_factor * top_k / E)) = 1 slot per group and
    BATCH rows in all, below one 128-row tile."""
    from repro_torch.models.layers import _dispatch_groups
    n_sc = _dispatch_groups(BATCH, 1)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    rows = BATCH * n_sc * max(1, int(cfg.moe.capacity_factor * k / e))
    return [(e, rows, cfg.d_model, cfg.moe.d_expert), (e, rows, cfg.moe.d_expert, cfg.d_model)]


# K3 at widths that are no multiple of 8 (bf16 runs them padded to
# the next multiple): the gate/up shape less 4 in K and N, timed beside the
# unpadded one, and the CLI's DeepSeek at --d-model 1020 (K 1020, N
# 2040), 100 x 200 and 36 x 20
GMM_PADDED = (64, 448, 2044, 1404)
GMM_CONTRACT = [GMM_PADDED, (4, 448, 1020, 2040), (8, 130, 100, 200), (8, 130, 36, 20)]


def phase_gmm_kernels(torch, mg, cfg, others: tuple = ()) -> dict:
    """K3's three layouts (forward, dx, dw) against their plain versions
    at the MoE path's shapes, the JAX test's edge shapes,
    ``GMM_CONTRACT`` and the training shapes of the MoE configs
    ``others``, in fp32 and bf16.  Times in bf16 (``gmm_times``) at the
    gate/up shape and at ``GMM_PADDED`` beside it, L2-warm and L2-cold,
    and at each of ``others``' shapes under ``at_<arch>_...`` keys.  At
    DBRX's widths each w holds 1.06 G elements: 4.2 GB in fp32, past 2^32
    bytes, so a 32-bit byte offset in either kernel would show here."""
    g = torch.Generator(device="cuda").manual_seed(2468)
    path = gmm_shapes(cfg)
    at_other = {shape: other.name for other in others for shape in gmm_shapes(other)}
    kept, errs_at = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for e, m, k, n in path + [(4, 32, 64, 128), (2, 16, 32, 32), (8, 130, 64, 96),
                                  *GMM_CONTRACT, *at_other]:
            x = torch.randn((e, m, k), generator=g, device="cuda").to(dt)
            w = (torch.randn((e, k, n), generator=g, device="cuda") * k ** -0.5).to(dt)
            dy = torch.randn((e, m, n), generator=g, device="cuda").to(dt)
            y = mg.moe_gmm_fwd(x, w)
            dx, dw = mg.moe_gmm_bwd(x, w, dy)
            torch.cuda.synchronize()
            want_dx, want_dw = mg.moe_gmm_bwd_plain(x, w, dy)
            tag = f"moe_gmm {dname} {(e, m, k, n)}"
            if (e, m, k, n) in at_other:
                tag += f", {at_other[e, m, k, n]}'s shape"
            errs = [check_close(torch, f"{tag} {name}", got, want, dname, GMM_TOL[dname])
                    for name, got, want in (("y", y, mg.moe_gmm_plain(x, w)),
                                            ("dx", dx, want_dx), ("dw", dw, want_dw))]
            print(f"  {tag} max_abs_err y={errs[0]:.3e} dx={errs[1]:.3e} dw={errs[2]:.3e}",
                  flush=True)
            errs_at[dname, (e, m, k, n)] = errs
            if dt == torch.bfloat16 and (e, m, k, n) in (path[0], GMM_PADDED, *at_other):
                kept[e, m, k, n] = (x, w, dy)
            if dt == torch.float32 and (e, m, k, n) == path[0]:
                timed32 = (x, w, dy)
            del x, w, dy, y, dx, dw, want_dx, want_dw
    torch.cuda.empty_cache()
    shape = path[0]
    fwd, bwd = gmm_times(torch, mg, *kept.pop(shape), errs_at["bfloat16", shape], cold=True)
    results = {"moe_gmm": fwd, "moe_gmm_bwd": bwd}
    print_gmm_times(results, shape, "")
    padded = gmm_times(torch, mg, *kept.pop(GMM_PADDED), errs_at["bfloat16", GMM_PADDED],
                       cold=True)
    key = "at_padded_" + "_".join(map(str, GMM_PADDED))
    results["moe_gmm"][key], results["moe_gmm_bwd"][key] = padded
    print_gmm_times(results, GMM_PADDED,
                    f", K and N padded to {mg.tc_dims(torch.bfloat16, *GMM_PADDED[2:])}", key)
    for shape, arch in at_other.items():
        fwd, bwd = gmm_times(torch, mg, *kept.pop(shape), errs_at["bfloat16", shape])
        errs32 = errs_at["float32", shape]
        fwd["max_abs_err_fp32"], bwd["max_abs_err_fp32"] = errs32[0], max(errs32[1:])
        key = "at_" + "_".join(map(str, (arch.replace("-", "_").replace(".", "_"), *shape)))
        results["moe_gmm"][key], results["moe_gmm_bwd"][key] = fwd, bwd
        print_gmm_times(results, shape, f", {arch}'s shape", key)
    torch.cuda.empty_cache()
    # the fp32 kernel (CUDA cores: tiles of 64 rows here) at the training shape,
    # the forward beside torch.bmm and dx, dw beside a torch.bmm each (TF32
    # off); the bound is the FFMAs at the fp32 rate
    x, w, dy = timed32
    errs32 = errs_at["float32", path[0]]
    e, m, k, n = path[0]
    flops, io = 2 * e * m * k * n, x.element_size()
    fwd32 = dict(max_abs_err=errs32[0], ms=cuda_ms(torch, lambda: mg.moe_gmm_fwd(x, w), reps=5),
                 plain_ms=cuda_ms(torch, lambda: mg.moe_gmm_plain(x, w), reps=5),
                 library_ms=cuda_ms(torch, lambda: torch.bmm(x, w), reps=5),
                 **bound((x.numel() + w.numel() + e * m * n) * io, flops / FP32_FLOPS))
    bwd32 = dict(
        max_abs_err=max(errs32[1:]), ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd(x, w, dy), reps=5),
        plain_ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd_plain(x, w, dy), reps=5),
        library_ms=None,     # no single PyTorch call computes both dx and dw
        two_bmm_ms=cuda_ms(torch, lambda: (torch.bmm(dy, w.transpose(1, 2)),
                                           torch.bmm(x.transpose(1, 2), dy)), reps=5),
        dx_ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd(x, w, dy, need_dw=False), reps=5),
        dw_ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd(x, w, dy, need_dx=False), reps=5),
        bmm_dx_ms=cuda_ms(torch, lambda: torch.bmm(dy, w.transpose(1, 2)), reps=5),
        bmm_dw_ms=cuda_ms(torch, lambda: torch.bmm(x.transpose(1, 2), dy), reps=5),
        **bound(2 * (x.numel() + w.numel()) * io + dy.numel() * io, 2 * flops / FP32_FLOPS))
    key = f"at_fp32_{e}_{m}_{k}_{n}"
    results["moe_gmm"][key], results["moe_gmm_bwd"][key] = fwd32, bwd32
    print(f"  moe_gmm {(e, m, k, n)} float32: kernel {fwd32['ms']:.4f} ms "
          f"({flops / fwd32['ms'] / 1e9:.1f} TFLOP/s), plain {fwd32['plain_ms']:.4f} ms, "
          f"torch.bmm {fwd32['library_ms']:.4f} ms (kernel/library "
          f"{fwd32['ms'] / fwd32['library_ms']:.2f}x), bound {fwd32['bound_ms']:.4f} ms "
          f"({fwd32['bound_by']})", flush=True)
    print(f"  moe_gmm_bwd {(e, m, k, n)} float32: kernel {bwd32['ms']:.4f} ms (dx "
          f"{bwd32['dx_ms']:.4f}, dw {bwd32['dw_ms']:.4f}), plain {bwd32['plain_ms']:.4f} ms, two "
          f"torch.bmm calls {bwd32['two_bmm_ms']:.4f} ms (dx {bwd32['bmm_dx_ms']:.4f}, dw "
          f"{bwd32['bmm_dw_ms']:.4f}; kernel/library {bwd32['ms'] / bwd32['two_bmm_ms']:.2f}x), "
          f"bound {bwd32['bound_ms']:.4f} ms ({bwd32['bound_by']})", flush=True)
    del x, w, dy, timed32
    # the decode step's shapes, forward only (serving takes no gradient),
    # each timed in both dtypes beside torch.bmm; the bound is w's bytes
    for e, m, k, n in decode_gmm_shapes(cfg):
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            x = torch.randn((e, m, k), generator=g, device="cuda").to(dt)
            w = (torch.randn((e, k, n), generator=g, device="cuda") * k ** -0.5).to(dt)
            y = mg.moe_gmm_fwd(x, w)
            torch.cuda.synchronize()
            tag = f"moe_gmm {dname} {(e, m, k, n)}, the decode shape"
            err = check_close(torch, tag, y, mg.moe_gmm_plain(x, w), dname, GMM_TOL[dname])
            io = x.element_size()
            decode = dict(
                max_abs_err=err, ms=cuda_ms(torch, lambda: mg.moe_gmm_fwd(x, w)),
                plain_ms=cuda_ms(torch, lambda: mg.moe_gmm_plain(x, w)),
                library_ms=cuda_ms(torch, lambda: torch.bmm(x, w)),
                **bound((x.numel() + w.numel() + e * m * n) * io,
                        2 * e * m * k * n / (BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS)))
            results["moe_gmm"][f"at_decode_{e}_{m}_{k}_{n}_{dname}"] = decode
            print(f"  {tag}: max_abs_err={err:.3e}; kernel {decode['ms']:.4f} ms, plain "
                  f"{decode['plain_ms']:.4f} ms, torch.bmm {decode['library_ms']:.4f} ms, bound "
                  f"{decode['bound_ms']:.4f} ms ({decode['bound_by']})", flush=True)
            del x, w, y
    return results


def gmm_times(torch, mg, x, w, dy, errs: list, cold: bool = False) -> tuple:
    """K3 and K3-bwd (bf16) on ``x``, ``w``, ``dy`` timed L2-warm (and
    L2-cold with ``cold``) beside ``torch.bmm`` (two for dx and dw), the
    plain versions and the bounds of the true shape, with ``errs``' (y,
    dx, dw) errors: (the forward's row, the backward's row)."""
    e, m, k = x.shape
    n = w.shape[2]
    flops, io = 2 * e * m * k * n, x.element_size()

    def two_bmm(x, w, dy):
        return torch.bmm(dy, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), dy)
    fwd = dict(max_abs_err=errs[0], ms=cuda_ms(torch, lambda: mg.moe_gmm_fwd(x, w), reps=10),
               plain_ms=cuda_ms(torch, lambda: mg.moe_gmm_plain(x, w), reps=5),
               library_ms=cuda_ms(torch, lambda: torch.bmm(x, w), reps=10),
               **bound((x.numel() + w.numel() + e * m * n) * io, flops / BF16_FLOPS))
    bwd = dict(max_abs_err=max(errs[1:]),
               ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd(x, w, dy), reps=5),
               plain_ms=cuda_ms(torch, lambda: mg.moe_gmm_bwd_plain(x, w, dy), reps=5),
               library_ms=None,     # no single PyTorch call computes both dx and dw
               two_bmm_ms=cuda_ms(torch, lambda: two_bmm(x, w, dy), reps=5),
               # reads x, w, dy; writes dx, dw
               **bound(2 * (x.numel() + w.numel()) * io + dy.numel() * io,
                       2 * flops / BF16_FLOPS))
    if cold:
        fwd.update(ms_cold=cold_ms(torch, mg.moe_gmm_fwd, (x, w), reps=10),
                   library_ms_cold=cold_ms(torch, torch.bmm, (x, w), reps=10))
        bwd.update(ms_cold=cold_ms(torch, mg.moe_gmm_bwd, (x, w, dy), reps=5),
                   two_bmm_ms_cold=cold_ms(torch, two_bmm, (x, w, dy), reps=5))
    fwd["tflops"], bwd["tflops"] = flops / fwd["ms"] / 1e9, 2 * flops / bwd["ms"] / 1e9
    return fwd, bwd


def print_gmm_times(results: dict, shape: tuple, what: str, key: str | None = None) -> None:
    """The K3 and K3-bwd rows of ``gmm_times`` at ``shape`` (under ``key``
    of ``results``' rows, or the rows themselves), one line each."""
    for name in ("moe_gmm", "moe_gmm_bwd"):
        r = results[name][key] if key else results[name]
        lib = r["library_ms"] or r["two_bmm_ms"]
        cold = f" warm / {r['ms_cold']:.4f} cold" if "ms_cold" in r else ""
        print(f"  {name} {shape} bf16{what}: kernel {r['ms']:.4f} ms{cold} "
              f"({r['tflops']:.1f} TFLOP/s), plain {r['plain_ms']:.4f} ms, "
              f"{'torch.bmm' if r['library_ms'] else 'two torch.bmm calls'} {lib:.4f} ms "
              f"(kernel/library {r['ms'] / lib:.2f}x), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)


def scan_inputs(torch, g, b, s, c, n, dtype, with_h0=False, dt_dtype=None, bc_dtype=None):
    """The JAX scan test's distributions: x, dt = softplus(.), A < 0, B, C
    and, if asked, h0; dt in ``dt_dtype`` and B, C in ``bc_dtype`` (x's
    dtype by default)."""
    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = randn((b, s, c), 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn((b, s, c))).to(dt_dtype or dtype)
    A = -torch.exp(randn((c, n), 0.2))
    B, C = (randn((b, s, n), 0.5).to(bc_dtype or dtype) for _ in range(2))
    return x, dt, A, B, C, (randn((b, c, n), 0.5) if with_h0 else None)


def _scan_tol(t) -> tuple:
    """bf16 outputs at the bf16 kernel tolerance, fp32 ones at the scan's."""
    return TOL["bfloat16"] if str(t.dtype) == "torch.bfloat16" else SCAN_TOL


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# exps per (b, t, c, n) of each scan kernel's design (the note atop
# mamba_scan.cuh)
SCAN_EXPS = {"mamba_scan": 1.0, "mamba_scan_bwd": 2.5}


def scan_timing(torch, ms, x, dt, A, B, C, hs, dy, reps_plain: int = 3,
                cold: bool = False) -> dict:
    """K4 (saving its chunk states, as a training step does) and K4-bwd
    timed at one shape beside their plain versions and their bounds:
    each input read once and each output written once, and per (b, t, c,
    n) 7 fp32 operations forward (dt*A, the exp, h*a, u*B plus that, h*C,
    the sum over n) and 20 backward (the state's recompute, 5, and its
    adjoint: g, dC, dB, the two sums over n, dA and the carry, 15).  The
    exps' floor at the SFU rate and the byte time without the chunk states
    (whose interval is the design's choice: bytes here against exps in
    the backward) are worked out from the design's constants and printed
    beside them, not kept: they were not measured.  With ``cold`` both
    kernels are also timed L2-cold (``cold_ms``)."""
    b, s, c, n = *x.shape, A.shape[1]
    elems = b * s * c * n
    # forward: reads x, dt, B, C, A; writes y, hT and the chunk states
    fwd_bytes = _nbytes(x, dt, B, C, A, x) + (b * c * n + hs.numel()) * 4
    # backward (timed without dhT): reads x, dt, dy, B, C, A, the chunk
    # states; writes dx, ddt, dB, dC, dA, dh0
    bwd_bytes = 2 * _nbytes(x, dt, B, C, A) + _nbytes(dy, hs) + b * c * n * 4
    out = {"mamba_scan": dict(
               ms=cuda_ms(torch, lambda: ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)),
               plain_ms=cuda_ms(torch, lambda: ms.mamba_scan_plain(x, dt, A, B, C,
                                                                   save_states=True),
                                reps=reps_plain),
               library_ms=None,     # no single PyTorch call computes a selective scan
               **bound(fwd_bytes, 7 * elems / FP32_FLOPS)),
           "mamba_scan_bwd": dict(
               ms=cuda_ms(torch, lambda: ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy)),
               plain_ms=cuda_ms(torch, lambda: ms.mamba_scan_bwd_plain(x, dt, A, B, C, hs, dy),
                                reps=reps_plain),
               library_ms=None,
               **bound(bwd_bytes, 20 * elems / FP32_FLOPS))}
    if cold:
        out["mamba_scan"]["ms_cold"] = cold_ms(
            torch, lambda *a: ms.mamba_scan_fwd(*a, save_states=True), (x, dt, A, B, C))
        out["mamba_scan_bwd"]["ms_cold"] = cold_ms(torch, ms.mamba_scan_bwd,
                                                   (x, dt, A, B, C, hs, dy))
    no_states = {"mamba_scan": fwd_bytes - hs.numel() * 4,
                 "mamba_scan_bwd": bwd_bytes - hs.numel() * 4}
    for name, r in out.items():
        exp_floor_ms = SCAN_EXPS[name] * elems / SFU_EXP_PER_S * 1e3
        print(f"  {name} {(b, s, c, n)} x {str(x.dtype)[6:]}, dt {str(dt.dtype)[6:]}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); {SCAN_EXPS[name]} exps per element, at the SFU rate "
              f"{exp_floor_ms:.4f} ms; bytes without the chunk states "
              f"{no_states[name] / HBM_BYTES_PER_S * 1e3:.4f} ms"
              + (f"; L2-cold {r['ms_cold']:.4f} ms" if cold else ""), flush=True)
    return out


def same_bits_twice(torch, ms, x, dt, A, B, C, hs, dy, tag: str) -> None:
    """K4-bwd twice on the same inputs: the same bits (fixed-order sums)."""
    b, s, c, n = *x.shape, A.shape[1]
    dhT = torch.randn((b, c, n), device="cuda")
    first = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    second = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        fail(f"mamba_scan_bwd {tag}: two runs on the same inputs differ")
    print(f"  mamba_scan_bwd {(b, s, c, n)} {tag}: two runs give the same bits", flush=True)


def scan_decode(torch, ms, g, c: int, n: int, dt_dtype) -> dict:
    """The serving path's call at a path's width: one step (S = 1) from a
    cached fp32 state, no chunk states saved, against the plain version
    and timed beside it and its bound."""
    x, dt, A, B, C, h0 = scan_inputs(torch, g, BATCH, 1, c, n, torch.bfloat16, with_h0=True,
                                     dt_dtype=dt_dtype)
    y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0)
    torch.cuda.synchronize()
    want = ms.mamba_scan_plain(x, dt, A, B, C, h0)
    tag = (f"mamba_scan bfloat16 {(BATCH, 1, c, n)} dt {str(dt.dtype)[6:]} h0, the decode "
           "step")
    if hs is not None:
        fail(f"{tag}: chunk states saved without save_states")
    err = max(check_close(torch, f"{tag} {k}", got, w, "", _scan_tol(got))
              for k, got, w in zip(("y", "hT"), (y, hT), want))
    decode = dict(
        max_abs_err=err, ms=cuda_ms(torch, lambda: ms.mamba_scan_fwd(x, dt, A, B, C, h0)),
        plain_ms=cuda_ms(torch, lambda: ms.mamba_scan_plain(x, dt, A, B, C, h0)),
        library_ms=None,
        # reads x, dt, B, C, A, h0; writes y, hT
        **bound(_nbytes(x, x, dt, B, C, A, h0, h0), 7 * x.numel() * n / FP32_FLOPS))
    print(f"  {tag}: max_abs_err={err:.3e}; kernel {decode['ms']:.4f} ms, plain "
          f"{decode['plain_ms']:.4f} ms, bound {decode['bound_ms']:.4f} ms "
          f"({decode['bound_by']})", flush=True)
    return decode


def phase_scan_kernels(torch, ms) -> dict:
    """K4 and K4-bwd against their plain versions at the Falcon path's
    shape, Zamba2's SSD scan's (its 80 heads of 64 channels over one group
    of 64 states, bf16 x, B and C with fp32 dt), the JAX test grid, state
    sizes split over lanes (32, 64) and between the built sizes (40, 5),
    ragged S with h0 and a continuation from it, fp32 B and C beside bf16
    x at 16 states, each with a non-zero
    dhT; the backward also against autograd through ``ssm_scan_ref``.
    Times at the Falcon and Zamba2 shapes and at both decode steps."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ssm_scan_ref
    g = torch.Generator(device="cuda").manual_seed(4321)
    f32, bf16 = torch.float32, torch.bfloat16
    main = (BATCH, SEQ, 8192, 16, bf16, bf16)         # Falcon-Mamba-7B's d_inner, state
    zamba2 = (BATCH, SEQ, 5120, 64, bf16, f32)        # Zamba2-2.7B's H*P, state; fp32 dt
    # Zamba2's scan shape at the public Mamba-2 models' 128 states (Mamba-2
    # 2.7B: d_model 2560, expand 2, headdim 64, d_state 128)
    wide = (BATCH, SEQ, 5120, 128, bf16, f32)
    # past 128 states, as groups of 128: Falcon-Mamba's channels at 192
    # (padded to 256) and Zamba2's SSD channels at 256 (phase 3u's)
    falcon_192 = (BATCH, SEQ, 8192, 192, bf16, bf16)
    zamba2_256 = (BATCH, SEQ, 5120, 256, bf16, f32)
    timed_shapes = {main: "main", zamba2: "zamba2", wide: "wide", falcon_192: "falcon_192",
                    zamba2_256: "zamba2_256"}
    # autograd through ssm_scan_ref's chunked (B, S, C, N) intermediates
    # would not fit the card beside them: the plain versions hold them
    no_ref = {falcon_192, zamba2_256}
    cases = [(*main, False), (*zamba2, False), (*wide, False), (1, 16, 8, 4, f32, f32, False),
             (2, 24, 16, 8, f32, f32, False), (1, 8, 6, 4, f32, f32, False),
             (2, 1000, 256, 16, f32, f32, True), (2, 1000, 256, 16, bf16, bf16, True),
             # the kernels' tiling edges: C ragged past a 128-channel block
             # and below a warp, S = 1 and S off the 16- and 8-step tiles
             (2, 1, 200, 16, f32, f32, True), (2, 77, 200, 16, bf16, bf16, True),
             (2, 37, 20, 4, f32, f32, True), (1, 45, 136, 8, bf16, bf16, True),
             # states over 2 and 4 lanes a channel and between the built
             # sizes, past the 64- and 32-channel blocks, with h0
             (2, 77, 200, 32, bf16, f32, True), (2, 45, 70, 40, bf16, f32, True),
             (1, 300, 136, 64, f32, f32, True), (2, 37, 20, 5, bf16, bf16, True),
             # fp32 B and C beside bf16 x at 16 states: the 32-state
             # kernel, padded (the 16-state forward reads B, C in x's type)
             (2, 45, 136, 16, bf16, f32, True, f32),
             # 128 states (8 lanes a channel; the backward's blocks four
             # 16-channel groups), C ragged past a block's 64 channels, and
             # 96 run on 128, with h0
             (2, 77, 200, 128, bf16, f32, True), (2, 45, 70, 96, f32, f32, True),
             # groups of 128 states (192 and 256 at the paths' widths; 129
             # and 256 with C ragged past a block, with h0)
             (*falcon_192, False), (*zamba2_256, False), (2, 77, 200, 256, bf16, f32, True),
             (2, 45, 70, 129, f32, f32, True)]
    results, timed = {}, {}
    for b, s, c, n, dtype, dt_dtype, with_h0, *bc in cases:
        bc_dtype = bc[0] if bc else dtype
        x, dt, A, B, C, h0 = scan_inputs(torch, g, b, s, c, n, dtype, with_h0, dt_dtype,
                                         bc_dtype)
        dy = torch.randn((b, s, c), generator=g, device="cuda").to(dtype)
        dhT = torch.randn((b, c, n), generator=g, device="cuda")
        tag = (f"mamba_scan {str(dtype)[6:]} {(b, s, c, n)}"
               f"{'' if dt_dtype == dtype else ' dt ' + str(dt_dtype)[6:]}"
               f"{'' if bc_dtype == dtype else ' B, C ' + str(bc_dtype)[6:]}"
               f"{' h0' if with_h0 else ''}")
        y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True)
        grads = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy, dhT)
        torch.cuda.synchronize()
        want = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
        fwd_err = max(check_close(torch, f"{tag} {k}", got, w, "", _scan_tol(got))
                      for k, got, w in zip(("y", "hT", "hs"), (y, hT, hs), want))
        want_g = ms.mamba_scan_bwd_plain(x, dt, A, B, C, want[2], dy, dhT)
        names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
        bwd_err = 0.0
        for k, got, w in zip(names, grads, want_g):
            if got.dtype != w.dtype:
                fail(f"{tag} {k}: {got.dtype}, its input's is {w.dtype}")
            bwd_err = max(bwd_err, check_close(torch, f"{tag} {k}", got, w, "", _scan_tol(got)))
        print(f"  {tag} fwd max_abs_err={fwd_err:.3e} bwd max_abs_err={bwd_err:.3e}",
              flush=True)
        del want_g, grads
        if with_h0 and s > 1:        # continue from the first half's state
            y1, h1, _ = ms.mamba_scan_fwd(x[:, :s // 2], dt[:, :s // 2], A, B[:, :s // 2],
                                          C[:, :s // 2], h0)
            y2, h2, _ = ms.mamba_scan_fwd(x[:, s // 2:], dt[:, s // 2:], A, B[:, s // 2:],
                                          C[:, s // 2:], h1)
            check_close(torch, f"{tag} continued y", torch.cat([y1, y2], 1), y, "",
                        _scan_tol(y))
            err = check_close(torch, f"{tag} continued hT", h2, hT, "", SCAN_TOL)
            print(f"  {tag} continued from step {s // 2}: hT max_abs_err={err:.3e}", flush=True)
        if (b, s, c, n, dtype, dt_dtype) in no_ref:
            print(f"  {tag} grads vs autograd through ssm_scan_ref: skipped (its chunked "
                  "intermediates would not fit the card; the plain versions hold it)",
                  flush=True)
            timed[timed_shapes[b, s, c, n, dtype, dt_dtype]] = (
                {"mamba_scan": fwd_err, "mamba_scan_bwd": bwd_err}, (x, dt, A, B, C, hs, dy))
            del x, dt, A, B, C, h0, y, hT, hs, want, dy, dhT
            continue
        # autograd through K4/K4-bwd against autograd through the chunked reference
        D = 1 + 0.1 * torch.randn((c,), generator=g, device="cuda")
        ref_grads = []
        for fn in (ops.mamba_scan, ssm_scan_ref):
            leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, D)]
            h = None if h0 is None else h0.clone().requires_grad_(True)
            yy, hh = fn(*leaves, h0=h)
            torch.autograd.backward([yy, hh], [dy, dhT])
            ref_grads.append([t.grad for t in leaves + ([h] if h is not None else [])])
            del yy, hh, leaves, h
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
        del ref_grads
        kind = "max_abs_err" if dtype == torch.float32 else "worst relative L2 error"
        print(f"  {tag} grads vs autograd through ssm_scan_ref: {kind} {worst:.3e}",
              flush=True)
        if (b, s, c, n, dtype, dt_dtype) in timed_shapes:
            timed[timed_shapes[b, s, c, n, dtype, dt_dtype]] = (
                {"mamba_scan": fwd_err, "mamba_scan_bwd": bwd_err}, (x, dt, A, B, C, hs, dy))
        del x, dt, A, B, C, h0, y, hT, hs, want, dy, dhT

    # the serving path's calls: Falcon-Mamba's, and Zamba2's (fp32 dt)
    decode = scan_decode(torch, ms, g, 8192, 16, bf16)
    decode_zamba2 = scan_decode(torch, ms, g, 5120, 64, f32)
    decode_256 = scan_decode(torch, ms, g, 5120, 256, f32)
    for key, label in (("main", "bf16"), ("zamba2", "bf16 x, fp32 dt"),
                       ("wide", "bf16 x, fp32 dt, 128 states"),
                       ("falcon_192", "bf16, 192 states"),
                       ("zamba2_256", "bf16 x, fp32 dt, 256 states")):
        errs, inputs = timed[key]
        same_bits_twice(torch, ms, *inputs, label)
        times = scan_timing(torch, ms, *inputs, cold=key not in ("main", "zamba2"))
        x, n = inputs[0], inputs[2].shape[1]
        b, s, c = x.shape
        # K4-bwd's partial rows of dB and dC, as one call allocates them (the
        # wrapper's record of its buffers), and the allocator's peak over the
        # call beside them
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms.partial_bytes = 0
        grads = ms.mamba_scan_bwd(*inputs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del grads
        times["mamba_scan_bwd"]["dB_dC_partial_bytes"] = ms.partial_bytes
        times["mamba_scan_bwd"]["call_peak_bytes"] = peak
        times["mamba_scan_bwd"]["group_partial_bytes"] = ms.group_bytes
        print(f"  mamba_scan_bwd {(b, s, c, n)}: partial rows of dB and dC "
              f"{ms.partial_bytes} bytes each ({ms.bwd_channels(n)} channels a block), "
              f"{ms.groups(n)} group(s) of states, the groups' partial sums of dx and ddt "
              f"{ms.group_bytes} bytes each; the call's peak allocation {peak} bytes",
              flush=True)
        if not 0 < 2 * ms.partial_bytes <= peak:
            fail(f"mamba_scan_bwd {(b, s, c, n)}: partial rows of {ms.partial_bytes} bytes "
                 f"do not fit the call's peak allocation of {peak}")
        for name in ("mamba_scan", "mamba_scan_bwd"):
            row = {"max_abs_err": errs[name], **times[name]}
            if key == "main":
                results[name] = row
            else:
                results[name][f"at_{key}_" + "_".join(map(str, (b, s, c, n)))] = row
        del inputs
        timed[key] = None
    results["mamba_scan"][f"at_decode_{BATCH}_1_8192_16"] = decode
    results["mamba_scan"][f"at_decode_zamba2_{BATCH}_1_5120_64"] = decode_zamba2
    results["mamba_scan"][f"at_decode_zamba2_{BATCH}_1_5120_256"] = decode_256
    return results


class NoCheckpoint:
    """The supervisor's checkpoint manager for a path that saves nothing:
    phase 3 keeps its end-of-run save, and phase 3i holds save, restore
    and reshard at full width bit for bit, so phases 3b-3d and 3j skip
    theirs (28-33 s each)."""

    def save(self, step, state, extra=None) -> None:
        pass

    def latest_step(self):
        return None

    def wait(self) -> None:
        pass


def image_positions(batch: int, seq: int, grid: tuple, prefixes):
    """(3, batch, seq) M-RoPE positions in Qwen2-VL's own layout (its
    ``get_rope_index``): row r holds ``prefixes[r]`` text tokens (the
    three streams equal), one image of t = 1 over ``grid`` = (h, w)
    patches (temporal = start, height = start + row, width = start +
    column), then text again from start + max(h, w)."""
    import numpy as np
    h, w = grid
    pos = np.zeros((3, batch, seq), np.int64)
    rows, cols = np.divmod(np.arange(h * w), w)
    for r, n_text in enumerate(prefixes):
        img = slice(n_text, n_text + h * w)
        pos[:, r, :n_text] = np.arange(n_text)
        pos[0, r, img] = n_text
        pos[1, r, img] = n_text + rows
        pos[2, r, img] = n_text + cols
        pos[:, r, img.stop:] = n_text + max(h, w) + np.arange(seq - img.stop)
    return pos


class ModalLoader:
    """A path's batches: the token loader's, plus the inputs of the stub
    front ends.  For the encoder-decoder, ``frames`` (B, enc_seq,
    d_model) in bf16, N(0, 1) from a generator on the card seeded by the
    stream position; for the VLM, ``image_positions`` in every batch.
    The stream position is the token loader's."""

    def __init__(self, torch, cfg, loader) -> None:
        self.torch, self.cfg, self.loader = torch, cfg, loader
        self.positions = (image_positions(loader.batch, loader.seq, IMAGE_GRID,
                                          IMAGE_PREFIXES) if cfg.mrope else None)

    def next_batch(self) -> dict:
        torch, cfg = self.torch, self.cfg
        step = self.loader.state.step
        batch = self.loader.next_batch()
        if cfg.n_enc_layers:
            g = torch.Generator(device="cuda").manual_seed(1000 + step)
            batch["frames"] = torch.randn((self.loader.batch, cfg.enc_seq, cfg.d_model),
                                          generator=g, device="cuda").to(torch.bfloat16)
        if self.positions is not None:
            batch["mrope_positions"] = self.positions
        return batch

    def state_dict(self) -> dict:
        return self.loader.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self.loader.load_state_dict(d)


def path_seq(cfg) -> int:
    return WHISPER_SEQ if cfg.n_enc_layers else SEQ


def path_loader(torch, cfg):
    """A training path's loader: synthetic tokens (seed 17) of BATCH rows
    of ``path_seq`` tokens, with the stub front ends' inputs where the
    family takes them."""
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    loader = TokenLoader(SyntheticTokenSource(cfg.vocab, seed=17), batch=BATCH,
                         seq=path_seq(cfg))
    return ModalLoader(torch, cfg, loader) if cfg.n_enc_layers or cfg.mrope else loader


# the launch counters, by kernel (``ops.launch_counts``)
LAUNCH_KEYS = ("rmsnorm", "flash_attention", "mamba_scan", "mamba_scan_bwd", "moe_gmm",
               "moe_gmm_bwd")


def train_launches(cfg, steps: int = STEPS) -> dict:
    """Kernel launches of ``steps`` training steps of ``cfg`` (its own
    depth), counted from the code.  Under remat "full" each layer's
    kernels run in the forward and again in its recompute; the final norm
    runs once.  A decoder layer runs two norms and one attention; an MoE
    layer three grouped matmuls (two without SwiGLU: gate, up, down),
    and each one's backward launches K3 twice (dx and dw).  A Mamba layer
    runs one norm and one scan (K4, and K4-bwd in the backward).
    Zamba2's checkpointed groups add two norms and one attention per
    application of the shared block.  Whisper runs two norms and one
    attention per encoder layer, three norms (self, cross, MLP) and two
    attentions (self, cross) per decoder layer."""
    runs = 2 if cfg.remat == "full" else 1
    n = cfg.n_layers
    if cfg.hybrid_every:
        groups = n // cfg.hybrid_every
        per = {"rmsnorm": runs * (n + 2 * groups) + 1, "flash_attention": runs * groups,
               "mamba_scan": runs * n, "mamba_scan_bwd": n}
    elif cfg.ssm:
        per = {"rmsnorm": runs * n + 1, "mamba_scan": runs * n, "mamba_scan_bwd": n}
    elif cfg.n_enc_layers:
        enc = cfg.n_enc_layers
        per = {"rmsnorm": runs * (2 * enc + 3 * n) + 1, "flash_attention": runs * (enc + 2 * n)}
    else:
        per = {"rmsnorm": runs * 2 * n + 1, "flash_attention": runs * n}
        if cfg.moe:
            mms = 3 if cfg.act == "swiglu" else 2
            per.update(moe_gmm=runs * mms * n, moe_gmm_bwd=2 * mms * n)
    return {**dict.fromkeys(LAUNCH_KEYS, 0), **{k: v * steps for k, v in per.items()}}


def config_line(cfg) -> str:
    """A training path's configuration as its phase prints it."""
    attn = (f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
            + (f"moe={cfg.moe}" if cfg.moe else f"d_ff={cfg.d_ff}"))
    widths = (f"ssm={cfg.ssm}" if cfg.ssm and not cfg.hybrid_every else
              f"ssm={cfg.ssm} hybrid_every={cfg.hybrid_every} shared block {attn} "
              f"window={cfg.sliding_window}" if cfg.hybrid_every else attn)
    if cfg.n_enc_layers:
        widths += (f" act={cfg.act}, {cfg.n_enc_layers} encoder layers over "
                   f"{cfg.enc_seq} frames, a cross-attention in every decoder layer")
    if cfg.mrope:
        widths += (f" qkv_bias={cfg.qkv_bias} M-RoPE sections={cfg.mrope_sections} "
                   f"theta={cfg.rope_theta:g}, one {IMAGE_GRID} image a row")
    return (f"  config {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} {widths} "
            f"vocab={cfg.vocab} dtype={cfg.dtype} remat={cfg.remat} "
            f"params={cfg.param_count()}, batch {BATCH} x {path_seq(cfg)} tokens")


def phase_train(torch, cfg, want: dict, steps: int = STEPS, save: bool = True,
                fp32_layers: int = FP32_LAYERS) -> tuple:
    """``cfg`` through the port's entry points, with kernels: ``steps``
    training steps under the supervisor (its end-of-run checkpoint only
    with ``save``), launch counts held to ``want``, then one step against
    the plain versions in bf16 and, at ``fp32_layers`` layers (and as many
    encoder layers), in fp32."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import Supervisor
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_step
    from repro_torch.models import init
    from repro_torch.optim import adamw_init, cosine_schedule

    seq = path_seq(cfg)
    print(config_line(cfg), flush=True)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    lr_fn = cosine_schedule(3e-4, steps)
    ops.register_kernels()
    step_fn = build_step(cfg, lr_fn, "cuda")

    def synced_step(state, batch):     # the supervisor times each step by the host clock
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        return out

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        loader = path_loader(torch, cfg)
        ckpt = CheckpointManager(tmp, keep=1) if save else NoCheckpoint()
        sup = Supervisor(ckpt, loader, checkpoint_every=steps)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state = sup.run(state, synced_step, steps, log_every=1)
        run_s = time.perf_counter() - t0
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in sup.history]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab)) > 1.0:
        fail(f"first loss {losses[0]} not within 1.0 of ln(vocab) = {math.log(cfg.vocab)}")
    print(f"  launch counts {counts}, expected {want}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} != {want}")

    if cfg.moe:
        check_moe_block(torch, cfg)
    compare_with_plain(torch, cfg, params, losses[0])
    cfg32 = dataclasses.replace(cfg, n_layers=fp32_layers, dtype="float32",
                                n_enc_layers=fp32_layers if cfg.n_enc_layers else 0)
    compare_with_plain(torch, cfg32, init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                                          "cuda"))

    dts = [h["dt"] for h in sup.history[1:]]
    step_s = statistics.median(dts)
    print(f"  full width: {steps} steps, losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"  step time median {step_s * 1e3:.1f} ms over steps 2-{steps} "
          f"(min {min(dts) * 1e3:.1f}, max {max(dts) * 1e3:.1f}), "
          f"{BATCH * seq / step_s:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); the supervised run took "
          f"{run_s:.1f} s, {run_s - sum(h['dt'] for h in sup.history):.1f} s of it outside "
          f"the steps ({'the checkpoint' if save else 'no checkpoint saved'})", flush=True)
    return counts, {"state": state, "step_fn": step_fn, "loader": loader, "step_s": step_s,
                    "peak": peak}


# The zoo configurations the card had not run before (phases 3p-3t), each
# at its published widths and at the depth of one pipeline stage, with
# the embedding and lm_head: (tag, arch, layers, AdamW step or not).  At
# the end of an AdamW step the old and new params and fp32 moments and the
# bf16 grads are alive, 22 B a parameter (``build_step`` keeps the old
# state until it returns); the supervisor's restart snapshot of the first
# state (``ft.Supervisor.run``) holds 10 B a parameter more for the whole
# run, 32 B: 87.2 GB for minicpm-2b's 2.725 B parameters.  So these paths
# step ``build_step`` in a loop of their own.  DBRX's one layer holds
# 4.492 B parameters (its 16 experts 3.17 B), 98.8 GB at 22 B: it runs
# forward and backward only (``grads_step``).
ZOO = [("3p", "minicpm-2b", 40, True),     # whole
       ("3q", "qwen3-9b", 6, True),        # one stage of a 6-stage split of 36
       ("3r", "qwen2.5-32b", 2, True),     # one stage of a 32-stage split of 64
       ("3s", "granite-20b", 4, True),     # one stage of a 13-stage split of 52
       ("3t", "dbrx-132b", 1, False)]      # one stage of a 40-stage split
ZOO_STEPS = 4
# the init's std of the embedding and lm_head (``models.init``, as the JAX
# package's); the final norm leaves each row of h at rms 1, so each
# logit at init is N(0, INIT_STD^2 d_model) and the expected first loss
# is ln(vocab) + INIT_STD^2 d_model / 2 (``init_loss``): 0.46 nats over
# ln(vocab) at minicpm-2b's 2304, 1.23 at granite-20b's and dbrx's 6144
INIT_STD = 0.02


def init_loss(cfg) -> float:
    """The expected cross-entropy of random logits at the init's scale."""
    return math.log(cfg.vocab) + INIT_STD ** 2 * cfg.d_model / 2


def grads_step(torch, cfg):
    """``build_step``'s loss and gradients without its AdamW update:
    ``step(state, batch) -> (state, metrics)``, the state unchanged, the
    gradients' global norm among the metrics."""
    from repro_torch.launch.train import device_batch
    from repro_torch.models import train_loss
    from repro_torch.optim.adamw import global_norm
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    def step(state, batch):
        batch = device_batch(batch, "cuda")
        params = tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
        loss = train_loss(cfg, params, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        return state, {"loss": loss.detach(), "gnorm": global_norm(grads)}
    return step


def phase_train_zoo(torch, cfg, optimizer: bool, steps: int = ZOO_STEPS,
                    fp32_layers: int = FP32_LAYERS) -> tuple:
    """``cfg`` at its published widths through the port's entry points:
    first the kernels against their plain versions on step 1's weights
    and batch (``compare_with_plain`` in bf16 at the path's depth), then
    ``steps`` steps of ``build_step`` with the kernels (of ``grads_step``
    without ``optimizer``), each timed by the host clock around the
    synchronised step, launches held to ``train_launches``, the first
    loss within 1.0 of ``init_loss`` and equal to the comparison's kernel
    loss, the peak (``max_memory_allocated``) beside the card's memory and
    the reckoning of ``ZOO``, and one profile of kernel steps (no plain
    profile: the plain run differs only in K1, K2 and K3, whose plain
    versions phase 2 times).  With the state freed, an MoE config's block
    is held to its plain version at its widths, and the fp32 comparison
    runs at ``fp32_layers`` layers (at most the path's).  Saves no
    checkpoint.  Returns (launches, summary)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_step
    from repro_torch.models import init
    from repro_torch.optim import adamw_init, cosine_schedule

    print(config_line(cfg), flush=True)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    k_loss = compare_with_plain(torch, cfg, params)
    ops.register_kernels()
    if optimizer:
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        step_fn = build_step(cfg, cosine_schedule(3e-4, steps), "cuda")
    else:
        state, step_fn = {"params": params}, grads_step(torch, cfg)
    del params
    loader = path_loader(torch, cfg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, dts = [], []
    for i in range(steps):
        batch = loader.next_batch()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        print(f"  step {i + 1}: loss={losses[-1]:.4f} gnorm={float(metrics['gnorm']):.4f} "
              f"({dts[-1] * 1e3:.0f} ms)", flush=True)
    counts = ops.launch_counts()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    want = train_launches(cfg, steps)
    if not all(math.isfinite(x) for x in losses):
        fail(f"losses {losses}")
    print(f"  first loss {losses[0]:.6f}: ln(vocab) {math.log(cfg.vocab):.6f}, the init's "
          f"expected loss {init_loss(cfg):.6f}", flush=True)
    if abs(losses[0] - init_loss(cfg)) > 1.0:
        fail(f"first loss {losses[0]} not within 1.0 of the init's expected loss "
             f"{init_loss(cfg)}")
    if abs(losses[0] - k_loss) > PLAIN_RTOL[cfg.dtype][0] * abs(k_loss):
        fail(f"step 1's loss {losses[0]} differs from the comparison's kernel run's {k_loss} "
             "on the same weights and batch")
    print(f"  launch counts {counts}, expected {want}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} != {want}")
    step_s = statistics.median(dts[1:])
    per_param = 22 if optimizer else 4
    print(f"  full width: {steps} steps, losses {[round(x, 4) for x in losses]} (step 1 "
          f"{losses[0]:.6f}, the comparison's kernel run {k_loss:.6f}); step time median "
          f"{step_s * 1e3:.1f} ms over steps 2-{steps} (min {min(dts[1:]) * 1e3:.1f}, max "
          f"{max(dts[1:]) * 1e3:.1f}), {BATCH * path_seq(cfg) / step_s:.0f} tokens/s; peak "
          f"{peak / 1e9:.2f} GB allocated, {reserved / 1e9:.2f} GB reserved, of the card's "
          f"{total / 1e9:.2f} GB; reckoned {per_param} B a parameter: "
          f"{per_param * cfg.param_count() / 1e9:.1f} GB", flush=True)
    train = {"state": state, "step_fn": step_fn, "loader": loader}
    del state
    prof = phase_profile(torch, train, plain_steps=0)["kernels"]
    del train, step_fn, loader
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.moe:
        check_moe_block(torch, cfg)
    cfg32 = dataclasses.replace(cfg, n_layers=min(fp32_layers, cfg.n_layers), dtype="float32")
    compare_with_plain(torch, cfg32, init(cfg32, torch.Generator(device="cuda").manual_seed(0),
                                          "cuda"))
    return counts, {"layers": cfg.n_layers, "params": cfg.param_count(),
                    "optimizer_step": optimizer, "steps": steps, "losses": losses,
                    "ln_vocab": math.log(cfg.vocab), "init_loss": init_loss(cfg),
                    "step_ms": step_s * 1e3, "step_ms_min": min(dts[1:]) * 1e3,
                    "step_ms_max": max(dts[1:]) * 1e3,
                    "tokens_per_s": BATCH * path_seq(cfg) / step_s, "peak_bytes": peak,
                    "peak_reserved_bytes": reserved, "card_bytes": total,
                    "reckoned_bytes": per_param * cfg.param_count(),
                    "profiled_step_ms": prof["step_ms"], "busy_share": prof["busy_share"],
                    "profiled_launches": prof["launches"]}


# Phase 3u: the TPU kernels' widest shapes on a training path.  No
# configuration of the zoo goes past head dim 128 or 64 states, so each
# path is a published configuration with one field changed, as a user
# would write it, at its published widths: qwen3-1b with head_dim 512
# (16/8 heads of 512, d_ff 6,144, vocab 151,936, tied embeddings) at 2 of
# its 28 layers, and Zamba2-2.7B with SSMCfg(state=256, version=2,
# d_conv=4, expand=2, headdim=64) at one group of its layers (6: a depth
# must be a multiple of hybrid_every, as in phase 3j).  Each trains
# ``WIDE_STEPS`` AdamW steps through ``phase_train_zoo``.
WIDE_STEPS = 3


def wide_paths(get_config) -> list:
    """Phase 3u's paths: (tag, label, config, layers of the fp32 check)."""
    qwen3 = dataclasses.replace(get_config("qwen3-1b"), n_layers=2, head_dim=512)
    z = get_config("zamba2-2.7b")
    zamba2 = dataclasses.replace(z, n_layers=z.hybrid_every,
                                 ssm=dataclasses.replace(z.ssm, state=256))
    return [("3u a", "qwen3-1b head_dim 512", qwen3, 1),
            ("3u b", "zamba2-2.7b ssm state 256", zamba2, z.hybrid_every)]


def dw_tol(dname: str, m: int, peak: float) -> tuple:
    """(atol, rtol) of K3-bwd's dw, a sum of m products a value, against an
    fp64 reference whose largest value is ``peak``.  fp32 (CUDA cores,
    rounding to nearest): each of the m additions rounds by at most 2^-24
    of its partial sum, independently, so the error walks: four standard
    deviations of m such roundings, sqrt(m) 2^-24 peak each.  bf16 (the
    tensor cores' fp32 accumulation, whose roundings need not cancel): at
    most 2^-24 peak at each of the m / 16 steps of the MMAs' k, all of one
    sign, and the result's rounding to bf16, 2^-8 of its value."""
    if dname == "float32":
        return 4 * m ** 0.5 * 2.0 ** -24 * peak, 0.0
    return m / 16 * 2.0 ** -24 * peak, 2.0 ** -8


def phase_grid_limits(torch, fa, mg, ms) -> dict:
    """The three shapes whose grids pass CUDA's 65,535 blocks in y or z,
    one call each at the smallest shape that crosses, against the plain
    version, each timed (``cuda_ms``): K2 with a window of 1 at 65,536
    query blocks (bf16: 128 rows a block; fp32: 64), held on slices around
    the fold (with a window of 1 a row sees only its own key, so a slice
    of q, k and v is the same problem; the plain version of the whole
    would be Sq^2); K3 at 65,536 row tiles of 128 (bf16) and 131,071 of 64
    (fp32), forward and backward (dw, summed over the M rows, held to an
    fp64 reference at ``dw_tol``); K4 and K4-bwd at a batch of 65,536 and
    S = 1.  Returns the kernels line's rows."""
    g = torch.Generator(device="cuda").manual_seed(65536)

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    rows = {}
    for dtype, per_block in ((torch.bfloat16, 128), (torch.float32, 64)):
        dname = str(dtype)[6:]
        sq = 65535 * per_block + 1
        q, k, v = (randn((1, 1, sq, 64), dtype) for _ in range(3))
        ms_ = cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True, window=1),
                      reps=3)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, window=1)
        torch.cuda.synchronize()
        err = 0.0
        for lo in (0, 65535 * per_block - 300, sq - 300):
            sl = slice(lo, lo + 300)
            want, want_lse = fa.flash_attention_fwd_plain(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                                          causal=True, window=1)
            tag = f"flash {dname} window 1 Sq {sq} rows {lo}-{lo + 299}"
            err = max(err, check_close(torch, tag, out[:, :, sl], want, dname),
                      check_close(torch, tag + " lse", lse[:, :, sl], want_lse, "float32"))
        blocks = -(-sq // per_block)
        print(f"  flash {dname} (1, 1, {sq}, 64) causal window 1: {blocks} query blocks of "
              f"{per_block} (gridDim.y 65535, gridDim.z {-(-blocks // 65535)}), max_abs_err "
              f"{err:.3e} on slices around the fold; kernel {ms_:.4f} ms", flush=True)
        # one key a row: the bytes of q, k, v, out and lse bound it; the
        # plain version of the whole would hold Sq^2 scores
        rows.setdefault("flash_attention", {})[f"at_{dname}_window_1_{blocks}_query_blocks"] = \
            {"max_abs_err": err, "ms": ms_, "plain_ms": None, "query_blocks": blocks,
             **bound(4 * q.numel() * q.element_size() + sq * 4, 4 * 64 * sq / BF16_FLOPS)}
        del q, k, v, out, lse
    m = 65535 * 128 + 1
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        x, w, dy = randn((1, m, 8), dtype), randn((1, 8, 8), dtype), randn((1, m, 8), dtype)
        y = mg.moe_gmm_fwd(x, w)
        dx, dw = mg.moe_gmm_bwd(x, w, dy)
        torch.cuda.synchronize()
        tag = f"moe_gmm {dname} (1, {m}, 8) x (1, 8, 8)"
        err = check_close(torch, tag, y, mg.moe_gmm_plain(x, w), dname, GMM_TOL[dname])
        want_dx = mg.moe_gmm_bwd_plain(x.float(), w.float(), dy.float())[0]
        want_dw = (x[0].double().T @ dy[0].double())[None]
        bwd_err = max(check_close(torch, tag + " dx", dx, want_dx.to(dtype), dname,
                                  GMM_TOL[dname]),
                      check_close(torch, tag + " dw", dw, want_dw, dname,
                                  dw_tol(dname, m, want_dw.abs().max().item())))
        tile = 128 if dtype == torch.bfloat16 else 64
        fwd_ms = cuda_ms(torch, lambda: mg.moe_gmm_fwd(x, w), reps=3)
        bwd_ms = cuda_ms(torch, lambda: mg.moe_gmm_bwd(x, w, dy), reps=3)
        print(f"  {tag}: {-(-m // tile)} row tiles of {tile}, max_abs_err {err:.3e} forward, "
              f"{bwd_err:.3e} backward; kernel {fwd_ms:.4f} ms forward, {bwd_ms:.4f} ms "
              "backward", flush=True)
        key = f"at_{dname}_{-(-m // tile)}_row_tiles"
        rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        rows.setdefault("moe_gmm", {})[key] = {
            "max_abs_err": err, "ms": fwd_ms,
            "plain_ms": cuda_ms(torch, lambda: mg.moe_gmm_plain(x, w), reps=3),
            **bound(_nbytes(x, w, y), 2 * m * 64 / rate)}
        rows.setdefault("moe_gmm_bwd", {})[key] = {
            "max_abs_err": bwd_err, "ms": bwd_ms,
            "plain_ms": cuda_ms(torch, lambda: mg.moe_gmm_bwd_plain(x, w, dy), reps=3),
            **bound(_nbytes(x, w, dy, dx, dw), 4 * m * 64 / rate)}
        del x, w, dy, y, dx, dw
    x, dt, A, B, C, h0 = scan_inputs(torch, g, 65536, 1, 64, 16, torch.float32, with_h0=True)
    dy = randn((65536, 1, 64), torch.float32)
    y, hT, hs = ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True)
    grads = ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy)
    torch.cuda.synchronize()
    want = ms.mamba_scan_plain(x, dt, A, B, C, h0, save_states=True)
    tag = "mamba_scan float32 (65536, 1, 64, 16) h0"
    err = max(check_close(torch, f"{tag} {k}", a, b_, "", SCAN_TOL)
              for k, a, b_ in zip(("y", "hT", "hs"), (y, hT, hs), want))
    bwd_err = max(check_close(torch, f"{tag} d{i}", a, b_, "", SCAN_TOL) for i, (a, b_) in
                  enumerate(zip(grads, ms.mamba_scan_bwd_plain(x, dt, A, B, C, want[2], dy))))
    fwd_ms = cuda_ms(torch, lambda: ms.mamba_scan_fwd(x, dt, A, B, C, h0, save_states=True),
                     reps=3)
    bwd_ms = cuda_ms(torch, lambda: ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy), reps=3)
    print(f"  {tag}: a batch of 65536 (two launches of at most 65535 rows), max_abs_err "
          f"{err:.3e} forward, {bwd_err:.3e} backward; kernel {fwd_ms:.4f} ms forward, "
          f"{bwd_ms:.4f} ms backward", flush=True)
    elems = x.numel() * 16
    rows["mamba_scan"] = {"at_batch_65536_1_64_16": {
        "max_abs_err": err, "ms": fwd_ms,
        "plain_ms": cuda_ms(torch, lambda: ms.mamba_scan_plain(x, dt, A, B, C, h0,
                                                               save_states=True), reps=3),
        # reads x, dt, A, B, C, h0; writes y, hT and the chunk states
        **bound(_nbytes(x, dt, A, B, C, h0, x, h0, hs), 7 * elems / FP32_FLOPS)}}
    rows["mamba_scan_bwd"] = {"at_batch_65536_1_64_16": {
        "max_abs_err": bwd_err, "ms": bwd_ms,
        "plain_ms": cuda_ms(torch, lambda: ms.mamba_scan_bwd_plain(x, dt, A, B, C, hs, dy),
                            reps=3),
        # reads x, dt, dy, A, B, C, the chunk states; writes dx, ddt, dA, dB, dC, dh0
        **bound(2 * _nbytes(x, dt, B, C, A) + _nbytes(dy, hs, h0), 20 * elems / FP32_FLOPS)}}
    return rows


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


# the impls whose outputs a plain run can follow (``followed_forward``)
FOLLOWED_IMPLS = ("rmsnorm", "attention")


@contextlib.contextmanager
def followed_forward(torch, record: list | None = None):
    """Wraps the ``FOLLOWED_IMPLS`` registered in the block (the kernels'
    wrappers, or the plain defaults).  Without ``record``, each call's
    output is appended to the yielded list, in call order: the forward's,
    then the checkpoint recomputes'.  With ``record`` (a kernel run's
    list), call i computes its own output y on its own inputs, checks it
    elementwise against ``record[i]`` (``TOL`` of its dtype) and returns
    ``record[i]`` with y's gradient: the run's forward is the kernel
    run's value for value, and its backward is the plain versions'.  The
    yielded list then holds each call's (name, max abs error, within
    TOL)."""
    from repro_torch.models import layers as L
    from repro_torch.models.attention import flash_attention_ref
    defaults = {"rmsnorm": L.rmsnorm_ref, "attention": flash_attention_ref}
    saved = {n: L._IMPLS.get(n) for n in FOLLOWED_IMPLS}
    out = []

    def wrap(name, fn):
        def call(*args, **kw):
            y = fn(*args, **kw)
            if record is None:
                out.append(y.detach())
                return y
            want = record[len(out)]
            atol, rtol = TOL[str(y.dtype).split(".")[1]]
            err = (y.detach().float() - want.float()).abs()
            out.append((name, err.max().item(),
                        bool((err <= atol + rtol * want.float().abs()).all())))
            return want + (y - y.detach())      # want's value, y's gradient
        return call
    for name in FOLLOWED_IMPLS:
        L.register_impl(name, wrap(name, saved[name] or defaults[name]))
    try:
        yield out
    finally:
        for name, fn in saved.items():
            if fn is None:
                L._IMPLS.pop(name, None)
            else:
                L.register_impl(name, fn)


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


def nearer_fp32(torch, cfg, params, batch, paths, errs, k_grads, p_grads) -> dict:
    """The hybrid's watch item (ROADMAP Queue 3): the same step in fp32
    (every weight widened from its bf16 value) through the plain versions,
    so that the reference leans toward neither run, and each bf16 run's
    relative L2 distance to it, the kernels' (K4's scan) and the plain
    versions', at the worst leaf of the bf16 comparison and over all
    leaves together.  Printed and returned, not held: a kernel run
    farther from fp32 than the plain run is a fault to record there."""
    from repro_torch.kernels import ops
    from repro_torch.models import train_loss
    from repro_torch.tree import tree_flatten_with_path, tree_map
    ops.unregister_kernels()
    before = ops.launch_counts()
    p = tree_map(lambda t: t.detach().float().requires_grad_(True), params)
    loss = train_loss(dataclasses.replace(cfg, dtype="float32"), p, batch)
    ref = [g.float() for g in torch.autograd.grad(
        loss, [leaf for _, leaf in tree_flatten_with_path(p)])]
    del p, loss
    if ops.launch_counts() != before:
        fail(f"3j watch: the fp32 reference step launched a kernel: {ops.launch_counts()}")

    def whole(grads):
        num = sum((g - r).square().sum() for g, r in zip(grads, ref))
        return torch.sqrt(num / sum(r.square().sum() for r in ref)).item()
    worst = max(errs, key=errs.get)
    i = paths.index(worst)
    out = {"worst_leaf": worst, "kernels_vs_plain": errs[worst],
           "kernels_vs_fp32": rel_l2(k_grads[i], ref[i]),
           "plain_vs_fp32": rel_l2(p_grads[i], ref[i]),
           "all_leaves_kernels_vs_fp32": whole(k_grads), "all_leaves_plain_vs_fp32": whole(p_grads)}
    out["nearer_fp32_at_worst_leaf"] = \
        "kernels" if out["kernels_vs_fp32"] <= out["plain_vs_fp32"] else "plain"
    out["nearer_fp32_all_leaves"] = ("kernels" if out["all_leaves_kernels_vs_fp32"]
                                     <= out["all_leaves_plain_vs_fp32"] else "plain")
    del ref
    print(f"  3j watch {json.dumps(out)}", flush=True)
    return out


def compare_with_plain(torch, cfg, params, step_loss: float | None = None) -> float:
    """Step 1's loss and every gradient leaf on the same weights and
    batch, with the kernels and with their plain versions, held to
    ``PLAIN_RTOL`` of the config's dtype.  ``step_loss`` is the kernel
    loss the training step reported, if any.  The gradients go through
    the flash backward, which reuses K2's lse.  For an MoE config it
    prints how many routing choices differ per layer between the two
    runs; in fp32 any is a failure, and in bf16 the leaves are held
    against a plain run routed as the kernel run (see the note at
    ``PLAIN_RTOL``).

    A bf16 leaf over the limit passes only if the plain step cannot
    resolve it and the kernels agree on it where they can be compared
    call by call: (a) a second plain run, whose attention sums its fp32
    KV blocks in another order (128 keys, not 512), differs from the
    first on that leaf by more than the limit too, and (b) a plain run
    that follows the kernel run's forward (``followed_forward``: every
    K1 and K2 call of the kernel run held elementwise to its plain
    version on the same inputs, ``TOL``) holds every leaf within the
    limit.  Deep bf16 stacks whose leaves have small gradients need this:
    Whisper's 32 + 32 layers move their attention's q and k leaves by
    ~9e-2 under (a) alone (PERF.md, section 6).  Returns the kernel run's
    loss."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import device_batch
    from repro_torch.models import layers as L
    from repro_torch.models import train_loss
    from repro_torch.models.attention import flash_attention_ref
    from repro_torch.tree import tree_flatten_with_path, tree_map

    batch = device_batch(path_loader(torch, cfg).next_batch(), "cuda")
    paths = ["/".join(path) for path, _ in tree_flatten_with_path(params)]

    def loss_and_grads(replay=None, follow=None):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with recorded_routing(replay) as calls, followed_forward(torch, follow) as outs:
            loss = train_loss(cfg, p, batch)
            leaves = [leaf for _, leaf in tree_flatten_with_path(p)]
            grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.float() for g in grads], calls, outs

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
    k_loss, k_grads, k_routes, k_outs = loss_and_grads()
    ops.unregister_kernels()
    p_loss, p_grads, p_routes, _ = loss_and_grads()
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
            p_loss, p_grads, _, _ = loss_and_grads(replay=k_routes)
            rel = abs(p_loss - k_loss) / abs(p_loss)
            print(f"  plain run routed as the kernel run: loss {p_loss:.6f} (rel diff "
                  f"{rel:.3e}, limit {loss_rtol})", flush=True)
            if rel > loss_rtol:
                fail("kernel and routed plain losses disagree")
    errs = leaf_errors(k_grads, p_grads, held=True)
    if not all(math.isfinite(e) for e in errs.values()):
        fail("non-finite gradient error")
    if cfg.hybrid_every and cfg.dtype == "bfloat16":
        nearer_fp32(torch, cfg, params, batch, paths, errs, k_grads, p_grads)
    over = [name for name, err in errs.items() if err > grad_rtol]
    if not over:
        return k_loss
    worst = max(errs, key=errs.get)
    if cfg.dtype != "bfloat16":
        fail(f"kernel and plain gradients disagree: {worst} at {errs[worst]:.3e}")
    # (a) the plain step against itself, its attention's fp32 KV blocks summed
    # in another order
    print(f"  {len(over)} leaves over the limit: {over}; (a) the plain run against "
          "itself with the attention's KV blocks of 128 keys:", flush=True)
    L.register_impl("attention", lambda *a, **kw: flash_attention_ref(*a, **kw, block_kv=128))
    try:
        _, q_grads, _, _ = loss_and_grads(replay=k_routes if cfg.moe else None)
    finally:
        ops.unregister_kernels()
    floor = {name: rel_l2(a, b) for name, a, b in zip(paths, q_grads, p_grads)}
    del q_grads, p_grads
    for name in over:
        print(f"    {name:24s} kernels {errs[name]:.3e}, plain against plain "
              f"{floor[name]:.3e}", flush=True)
    resolved = [name for name in over if floor[name] <= grad_rtol]
    if resolved:
        fail(f"kernel and plain gradients disagree where the plain run resolves them: "
             f"{resolved[0]} at {errs[resolved[0]]:.3e} (plain against plain "
             f"{floor[resolved[0]]:.3e})")
    # (b) a plain run that follows the kernel run's forward
    f_loss, f_grads, _, checks = loss_and_grads(replay=k_routes if cfg.moe else None,
                                                follow=k_outs)
    del k_outs
    n_bad = sum(not ok for _, _, ok in checks)
    by_name = {n: max(e for m, e, _ in checks if m == n) for n in FOLLOWED_IMPLS
               if any(m == n for m, _, _ in checks)}
    print(f"  (b) a plain run following the kernel run's forward: {len(checks)} K1/K2 calls "
          f"held to their plain versions on the same inputs, max abs err {by_name} "
          f"({n_bad} outside TOL); loss {f_loss:.6f} (kernels {k_loss:.6f})", flush=True)
    if n_bad or abs(f_loss - k_loss) > loss_rtol * abs(k_loss):
        fail(f"followed plain run: {n_bad} calls outside TOL, loss {f_loss} vs {k_loss}")
    errs = leaf_errors(k_grads, f_grads, held=True)
    worst = max(errs, key=errs.get)
    if not all(math.isfinite(e) for e in errs.values()) or errs[worst] > grad_rtol:
        fail(f"kernel and followed plain gradients disagree: {worst} at {errs[worst]:.3e}")
    return k_loss


# the CLI's steps in phase 4 (its default is 200): the loss falls well
# within them, and each launch count is exact from the first step
CLI_STEPS = 50


def phase_cli(torch) -> None:
    """The CLI at its defaults but ``CLI_STEPS`` steps for the ported paths,
    qwen3-1b, minicpm-2b (whose learning rate must follow WSD step by
    step), qwen2-vl-7b (M-RoPE on the text-only default positions, as the
    CLI's loader gives none), ``--d-model 128`` (4 heads of 32: K2 on a
    padded head dim), ``--d-model 200`` (4 heads of 50: K2 on a head dim
    no multiple of 8, padded by its wrapper) and DeepSeek at ``--d-model
    1020`` (15 heads of 68, and experts of K = 1020 by N = 2040: K3's bf16
    operands padded); the loss must fall in each, and K2 (and K3 in
    DeepSeek's) must launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import wsd_schedule
    for extra in ([], ["--arch", "falcon-mamba-7b"],
                  ["--arch", "deepseek-moe-16b"], ["--arch", "qwen3-1b"],
                  ["--arch", "minicpm-2b"], ["--arch", "qwen2-vl-7b"], ["--d-model", "128"],
                  ["--d-model", "200"], ["--arch", "deepseek-moe-16b", "--d-model", "1020"]):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            sup, _ = train.run(["--ckpt-dir", tmp, "--steps", str(CLI_STEPS), *extra])
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
        if "deepseek-moe-16b" in extra and not (counts["moe_gmm"] and counts["moe_gmm_bwd"]):
            fail(f"CLI {extra}: K3 never launched: {counts}")
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
    traced on meta tensors and compiled from IR_CASE's Strategy document
    (``ir_strategy``, through ``to_json``/``from_json``; the same plan as
    ``pipeline_directives``, which the CPU tests hold): no byte of device
    memory moves, and the chunk and comm counts and the fingerprint are
    IR_CASE's (which tests/test_torch_ir.py holds to the JAX package's).  (2) A region
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
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    strategy = core.Strategy.from_json(ir_strategy(core).to_json())
    dag = proxy.build_strategy_program(cfg, strategy, c["tokens"])[0].dag
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    moved = torch.cuda.memory_allocated() - before
    stats, fp = dag.stats(), dataflow_fingerprint(dag)
    params = sum(b.param_elems for b in dag.buckets.values())
    print(f"  {c['arch']} proxy ({params} parameters in {len(dag.buckets)} stage buckets), "
          f"strategy {strategy.to_json()}: compiled in {build_s:.2f} s; {stats}; fingerprint "
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


# the Piper runtime phase (3f): a Strategy compiled to per-rank programs
# and run on the reference interpreter, one card simulating every logical
# device.  Part (b) trains qwen3-1b's 28 layers through the 1F1B ZeRO-3
# plan of RUNTIME_CASE on one global batch of the synthetic stream.
RUNTIME_CASE = {"pp": 4, "dp": 2, "n_mb": 8, "zero": 3, "batch": 16, "seq": 1024,
                "seed": 17, "fp32_layers": 4}
# the depth of that program on the lanes and under the elastic supervisor
# (phases 3h (b) and 3i (b)): 4 of the 28 layers, one a stage.  Their
# steps are host-bound, and the host's speed varies between the H100
# machines: at 12 layers phase 3h took 283 s on one and 372 s on another,
# whose whole run took 1,139.5 s of the 1,200 s limit (PERF.md, section
# 4).  Phase 3f still holds all 28 layers on the interpreter.
LANES_LAYERS = 4
# the ZeRO stage of 3h (c), the fp32 program on the tcp transport: under
# ZeRO-3 its first step moved 52.7 GB of parameter gathers over TCP in
# 138.7 s (PERF.md, section 4); ZeRO-1 keeps the transport's sends,
# receives and gradient reductions over the same model-sized program
TCP_ZERO = 1
# interpreted step against ``train_loss``'s autograd on the same batch and
# weights: (loss relative error, relative L2 error of each gradient leaf).
# bf16 at phase 3d's limits (the two sum the microbatches' bf16 gradients
# in different orders); fp32 at 4 layers, one per stage
RUNTIME_RTOL = {"bfloat16": PLAIN_RTOL["bfloat16"], "float32": (1e-5, 1e-4)}


def runtime_launches(n_layers: int, n_stages: int, n_mb: int, dp: int, remat: str) -> dict:
    """K1 and K2 launches of one interpreted step, counted from the code:
    the forward chunk of a stage with L_s layers runs 2·L_s rmsnorms (+1,
    the final norm, on the last stage) and L_s attentions; under remat
    "full" its backward chunk re-runs that forward (the flash and rmsnorm
    backwards launch nothing), under "none" it reads the stash and
    launches nothing.  Each chunk runs once per (microbatch, dp device)."""
    per_stage = n_layers // n_stages
    k1 = sum(2 * per_stage + (s == n_stages - 1) for s in range(n_stages))
    k2 = n_layers
    runs = n_mb * dp * (2 if remat == "full" else 1)
    return {"rmsnorm": runs * k1, "flash_attention": runs * k2}


# written down before the first run: 2·8·2·(2·28+1) and 2·8·2·28 under
# "full", half of each under "none"
assert runtime_launches(28, 4, 8, 2, "full") == {"rmsnorm": 1824, "flash_attention": 896}
assert runtime_launches(28, 4, 8, 2, "none") == {"rmsnorm": 912, "flash_attention": 448}


def qwen3_piper(cfg, n_stages: int):
    """The decoder as a Piper forward over ``n_stages`` regions, each under
    ``rec.annotate("pp")``: stage 0 the embedding and its layers, the last
    stage its layers, the final rmsnorm, the tied logits and the
    cross-entropy.  Returns (forward, buckets): ``buckets(params)`` slices
    the stacked layers per stage; the tied embedding sits in stage 0's and
    the last stage's buckets, so its gradient is the sum of theirs.  Each
    region runs its layers without checkpointing: the Strategy's Remat
    fragment decides what the backward chunk recomputes."""
    from repro_torch.models.model import _ce_loss, _dec_layer, _unstack
    from repro_torch.tree import tree_map
    per = cfg.n_layers // n_stages
    lcfg = dataclasses.replace(cfg, remat="none")

    def layers(p, h):
        for lp in _unstack(p["layers"], per):
            h, _ = _dec_layer(lcfg, lp, h)
        return h

    def first(p, tokens):
        return layers(p, p["embed"][tokens])

    def last(p, h, labels):
        return _ce_loss(lcfg, p, layers(p, h), labels)

    def forward(rec, tvs):
        with rec.annotate("pp"):
            h = rec.region(first, "stage0", name="stage0")(tvs["tokens"])
        for s in range(1, n_stages - 1):
            with rec.annotate("pp"):
                h = rec.region(layers, f"stage{s}", name=f"stage{s}")(h)
        with rec.annotate("pp"):
            return rec.region(last, f"stage{n_stages - 1}",
                              name=f"stage{n_stages - 1}")(h, tvs["labels"])

    def buckets(params):
        out = {f"stage{s}": {"layers": tree_map(lambda t: t[s * per:(s + 1) * per],
                                                params["layers"])}
               for s in range(n_stages)}
        out["stage0"]["embed"] = params["embed"]
        out[f"stage{n_stages - 1}"].update(embed=params["embed"],
                                           final_norm=params["final_norm"])
        return out
    return forward, buckets


def merged_grads(torch, grads: dict, n_stages: int) -> dict:
    """The interpreter's per-bucket gradients in the model's tree: the
    stage slices of each layer leaf concatenated, the tied embedding's two
    bucket gradients summed."""
    from repro_torch.tree import tree_map
    last = grads[f"stage{n_stages - 1}"]
    layers = tree_map(lambda *xs: torch.cat(xs), *[grads[f"stage{s}"]["layers"]
                                                 for s in range(n_stages)])
    return {"embed": grads["stage0"]["embed"] + last["embed"],
            "final_norm": last["final_norm"], "layers": layers}


def event_ms(torch, fn):
    """(result, device milliseconds) of one call, by CUDA events."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def ledger_line(res) -> str:
    return ", ".join(f"dev{d} {b / 2**30:.3f}" for d, b in sorted(res.peak_bytes().items()))


def check_ledgers(res, what: str) -> None:
    peaks = res.peak_bytes()
    if not peaks or not all(0 < v < float("inf") for v in peaks.values()):
        fail(f"{what}: ledger peaks {peaks} not all positive and finite")


def phase_runtime_proxy(torch) -> None:
    """(a) The CLI's strategy path at full width: IR_CASE's Strategy
    through ``to_json``/``from_json``, ``build_strategy_program`` on the
    full qwen3-1b proxy, real draws for its parameters and batch on the
    card, and one step on the ``reference`` executor."""
    from repro_torch import core, runtime
    from repro_torch.analysis import dataflow_fingerprint
    from repro_torch.configs import get_config
    from repro_torch.tune import build_strategy_program, materialize_params, synth_batch
    c = IR_CASE
    strategy = core.Strategy.from_json(ir_strategy(core).to_json())
    prog, _ = build_strategy_program(get_config(c["arch"]), strategy, c["tokens"])
    stats, digest = prog.dag.stats(), dataflow_fingerprint(prog.dag).digest()
    if (stats["chunks"], stats["comms"], digest) != (c["chunks"], c["comms"], c["digest"]):
        fail(f"runtime (a): {stats['chunks']} chunks, {stats['comms']} comms, digest "
             f"{digest}; expected {c['chunks']}, {c['comms']}, {c['digest']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = materialize_params(prog.params, seed=0, device="cuda")
    batch = synth_batch(prog, seed=1, device="cuda")
    (res, ms) = event_ms(torch, lambda: runtime.make_executor("reference", prog, params)
                         .run(batch))
    peak = torch.cuda.max_memory_allocated()
    print(f"  (a) {c['arch']} proxy, {strategy.label()}: {stats['chunks']} chunks, "
          f"{stats['comms']} comms, digest {digest}; reference executor: loss {res.loss:.6f}, "
          f"{res.stats['tasks']} tasks in {ms:.1f} ms; ledger peaks (GiB) {ledger_line(res)}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB (one card holds all "
          f"{len(res.ledgers)} logical devices and every replica's gradients, so it is not "
          "comparable to a ledger peak)", flush=True)
    if not math.isfinite(res.loss):
        fail(f"runtime (a): loss {res.loss}")
    check_ledgers(res, "runtime (a)")


def phase_runtime_model(torch, cfg, timed: bool = True) -> dict:
    """(b) ``cfg``'s decoder as a Piper forward (``qwen3_piper``), compiled
    with RUNTIME_CASE's Strategy under each remat policy and run on the
    reference executor on one global batch, weights from the port's
    ``init`` (seed 0) on the card.  Held against ``train_loss``'s autograd
    on the same batch and weights (``RUNTIME_RTOL``), with exact K1 and K2
    launch counts (``runtime_launches``) and the replayed dispatch order
    equal to the run's.  With ``timed``, one warm interpreted step and the
    plain step (median of 3) are timed.  Returns the launch counts and the
    ledger peaks (bytes per logical device), each by policy."""
    from repro_torch import core, runtime
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    from repro_torch.kernels import ops
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init, train_loss
    from repro_torch.tree import tree_flatten_with_path, tree_map
    rc = RUNTIME_CASE
    n_st = rc["pp"]
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    first = TokenLoader(SyntheticTokenSource(cfg.vocab, seed=rc["seed"]), batch=rc["batch"],
                        seq=rc["seq"]).next_batch()
    batch = device_batch(first, "cuda")
    ops.register_kernels()

    def plain_step():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = train_loss(cfg, p, batch)
        leaves = [leaf for _, leaf in tree_flatten_with_path(p)]
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    want_loss, want = plain_step()
    paths = ["/".join(path) for path, _ in tree_flatten_with_path(params)]
    plain_ms = None
    if timed:
        plain_ms = statistics.median(event_ms(torch, plain_step)[1] for _ in range(3))
    forward, buckets = qwen3_piper(cfg, n_st)
    bparams = buckets(params)
    shape = ((rc["batch"], rc["seq"]), "int64")
    loss_rtol, grad_rtol = RUNTIME_RTOL[cfg.dtype]
    counts, peaks = {}, {}
    for remat in ("full", "none"):
        strategy = core.Strategy(core.Mesh(pp=n_st, dp=rc["dp"]),
                                 core.Pipeline("1f1b", n_mb=rc["n_mb"], n_stages=n_st)
                                 | core.ZeRO(stage=rc["zero"]) | core.Remat(remat))
        prog = core.compile_training(forward, bparams, {"tokens": shape, "labels": shape},
                                     strategy=strategy)
        ex = runtime.make_executor("reference", prog, bparams)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = ex.run(batch)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        expect = runtime_launches(cfg.n_layers, n_st, rc["n_mb"], rc["dp"], remat)
        counts[remat] = launched
        peaks[remat] = res.peak_bytes()
        replayed = runtime.replay_schedule(prog, batch).exec_order
        got = merged_grads(torch, res.grads, n_st)
        got_leaves = [leaf for _, leaf in tree_flatten_with_path(got)]
        errs = {name: rel_l2(g, w) for name, g, w in zip(paths, got_leaves, want)}
        worst = max(errs, key=errs.get)
        loss_err = abs(res.loss - want_loss) / abs(want_loss)
        res.grads = None
        del got, got_leaves
        line = (f"  (b) {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {strategy.label()}: "
                f"{prog.stats['chunks']} chunks, {res.stats['tasks']} tasks; loss "
                f"{res.loss:.6f} against train_loss {want_loss:.6f} (rel {loss_err:.3e}, "
                f"limit {loss_rtol}); worst leaf {worst} rel L2 {errs[worst]:.3e} (limit "
                f"{grad_rtol}); launches {launched}, expected {expect}; replayed order "
                f"{'equal' if replayed == res.exec_order else 'DIFFERENT'} "
                f"({len(res.exec_order)} tasks); ledger peaks (GiB) {ledger_line(res)}; "
                f"max_memory_allocated {peak / 2**30:.2f} GiB (all 8 logical devices on one "
                "card: not comparable to a ledger peak)")
        if timed:       # one warm step: the checked run above warmed it
            ms = event_ms(torch, lambda: ex.run(batch))[1]
            line += f"; interpreted step {ms:.1f} ms (warm), plain step {plain_ms:.1f} ms"
        print(line, flush=True)
        for name, err in errs.items():
            print(f"    {name:24s} {err:.3e}", flush=True)
        if launched != expect:
            fail(f"runtime (b) remat={remat}: launches {launched} != {expect}")
        if replayed != res.exec_order:
            fail(f"runtime (b) remat={remat}: the replayed exec_order differs from the run's")
        if not math.isfinite(res.loss) or loss_err > loss_rtol:
            fail(f"runtime (b) remat={remat}: loss {res.loss} against {want_loss}")
        if not all(math.isfinite(e) for e in errs.values()) or errs[worst] > grad_rtol:
            fail(f"runtime (b) remat={remat}: {worst} at {errs[worst]:.3e}")
        check_ledgers(res, f"runtime (b) remat={remat}")
        # no profiled interpreted step since phase 3o came (the script's
        # time limit); the lanes' profiles in phase 3h stand in for it
        if timed and remat == "none":
            stash_profile(torch, prog, bparams, batch, forward, shape)
        del ex, res, prog
        gc.collect()
    ops.unregister_kernels()
    return counts, peaks


def step_profile(torch, label: str, fn) -> dict:
    """One warm call of ``fn`` under torch.profiler (device activity):
    the wall time, the device's busy time and share, the launches, and
    the device time by kernel family (``FAMILIES``), printed and returned."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, ms = event_ms(torch, fn)
    kernels = [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t in kernels)
    fam: dict[str, float] = {}
    for name, t in kernels:
        fam[_family(name)] = fam.get(_family(name), 0.0) + t
    top = ", ".join(f"{f} {t:.1f}" for f, t in sorted(fam.items(), key=lambda kv: -kv[1])[:6])
    print(f"  profiled {label}: {ms:.1f} ms, device busy {busy:.1f} ms ({busy / ms:.1%}), "
          f"{len(kernels)} launches; ms by family: {top}", flush=True)
    return {"ms": ms, "busy_ms": busy, "busy_share": busy / ms, "launches": len(kernels),
            "ms_by_family": fam}


def stash_profile(torch, prog, bparams, batch, forward, shape) -> None:
    """Where a warm Remat("none") stash forward's time goes (phase 3e's
    two-layer stash F can read ten times the plain F's time).  Stage 0's forward chunk (embedding and 7 layers) on one microbatch of
    one dp device, each call warm and timed by CUDA events:
      plain      the remat "full" F (no autograd recorded);
      recorded   the same region recording autograd (bucket leaves that
                 require grad) with no hooks: what recording through K1's
                 and K2's Functions costs;
      stash      the stash F, the previous stash freed before it;
      stash+1    the stash F while the previous stash is alive (a second
                 stash to allocate, as in phase 3e's loop);
      cold       the same after ``empty_cache``: every residual a fresh
                 ``cudaMalloc``, as phase 3e meets it after the training
                 phases;
    and their B chunks; then one warm stash F/B pair under torch.profiler
    (CPU and CUDA): the allocator's cudaMalloc calls, the device's busy
    time and the top host ops."""
    from repro_torch import core
    from repro_torch.core import passes
    from repro_torch.tree import tree_map
    f = next(n for n in prog.dag.chunks()
             if n.dims.get("pp") == 0 and n.dims["PASS"] == "F" and n.dims.get("MB", 0) == 0)
    b = prog.dag.nodes[f.meta["bwd_node"]]
    k = f.n_outputs - f.meta["n_res"]
    full = core.build_dag(forward, bparams, {"tokens": shape, "labels": shape})
    f_full = next(n for n in full.chunks() if n.dims.get("pp") == 0 and n.dims["PASS"] == "F")
    b_full = full.nodes[f_full.meta["bwd_node"]]
    bucket = bparams["stage0"]
    x = batch["tokens"][:1]
    cot = torch.randn((1, x.shape[1], bucket["embed"].shape[1]), device=x.device,
                      generator=torch.Generator(device=x.device).manual_seed(5)).to(
                          bucket["embed"].dtype)

    def run_f(key):
        with torch.no_grad(), passes.microbatch(key):
            return f.fn(bucket, x)

    def run_b(key, outs):
        with torch.no_grad(), passes.microbatch(key):
            return b.fn(bucket, *outs[k:], cot)

    def pair(key):
        outs, f_ms = event_ms(torch, lambda: run_f(key))
        _, b_ms = event_ms(torch, lambda: run_b(key, outs))
        return outs, f_ms, b_ms

    def plain():
        with torch.no_grad():
            return f_full.fn(bucket, x)

    def recorded():
        with torch.enable_grad():
            return f_full.fn(tree_map(lambda t: t.detach().requires_grad_(
                t.is_floating_point()), bucket), x)

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def mallocs(prof) -> tuple:
        """(cudaMalloc calls, their host ms) in a profile."""
        found = [e for e in prof.key_averages() if e.key == "cudaMalloc"]
        return sum(e.count for e in found), sum(e.cpu_time_total for e in found) / 1e3

    pair("warm-up")
    gc.collect()
    outs_a, f_freed, b_stash = pair("a")
    res_bytes = sum(t.numel() * t.element_size() for t in outs_a[k:])
    outs_b, f_alive, _ = pair("b")
    # as phase 3e meets it: earlier stashes alive and the allocator's cache
    # emptied (each training phase ends with empty_cache), so every
    # residual of the new stash is a fresh cudaMalloc
    torch.cuda.empty_cache()
    with torch.profiler.profile(activities=act) as prof:
        outs_c, f_cold = event_ms(torch, lambda: run_f("c"))
    n_cold, cold_ms = mallocs(prof)
    run_b("c", outs_c)
    del outs_a, outs_b, outs_c
    gc.collect()
    times = {}
    for name, fn in (("plain", plain), ("recorded", recorded)):
        event_ms(torch, fn)
        times[name] = event_ms(torch, fn)[1]
    event_ms(torch, lambda: b_full.fn(bucket, x, cot))
    b_recompute = event_ms(torch, lambda: b_full.fn(bucket, x, cot))[1]
    with torch.profiler.profile(activities=act) as prof:
        _, f_prof, b_prof = pair("profiled")
    device_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
    avgs = prof.key_averages()
    n_malloc, malloc_ms = mallocs(prof)
    print(f"  stash profile, stage 0 (the embedding and its layers; {f.meta['n_res']} "
          f"residuals, {res_bytes / 2**20:.1f} MiB) on (1, {x.shape[1]}) "
          f"tokens, warm: F plain {times['plain']:.2f} ms, F recording autograd "
          f"{times['recorded']:.2f} ms, stash F {f_freed:.2f} ms (previous stash freed), "
          f"{f_alive:.2f} ms (previous stash alive), {f_cold:.2f} ms (previous stashes alive, "
          f"the allocator's cache emptied: {n_cold} cudaMalloc calls, {cold_ms:.2f} ms of host "
          f"time); B reading the stash {b_stash:.2f} ms, B recomputing (remat full) "
          f"{b_recompute:.2f} ms", flush=True)
    print(f"  profiled stash pair: F {f_prof:.2f} ms, B {b_prof:.2f} ms, device busy "
          f"{device_ms:.2f} ms; cudaMalloc {n_malloc} calls, {malloc_ms:.2f} ms of host time",
          flush=True)
    for e in sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"    host {e.self_cpu_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}",
              flush=True)


# kernel-name substrings -> family, first match wins
# the scoring, tuning and verification phase (3g): the training CLI's
# --autotune and --strategy paths and the lint CLI at full width, then the
# cost model's chunk predictions held against real-layer chunks on the card
TUNE_CASE = {"arch": "qwen3-1b", "pp": 4, "dp": 2, "steps": 30}
# every forward chunk's counted FLOPs against the closed form (relative)
FLOP_RTOL = 1e-2


@contextlib.contextmanager
def captured():
    """Standard output of the block, as a list of lines once it ends."""
    import io
    buf, lines = io.StringIO(), []
    with contextlib.redirect_stdout(buf):
        yield lines
    lines.extend(buf.getvalue().splitlines())


def phase_tune_cli(torch, tmp: str) -> tuple:
    """(a) ``--autotune`` for the full qwen3-1b on a pp 4 x dp 2 mesh at
    ``tune.DEFAULT_TOKENS`` on the H100 constants (a fresh plan cache),
    then training of the reduced config, whose loss must fall.  (b) The
    winner's ``strategy.json`` replayed with ``--backend reference`` on
    the card: the ``strategy[...]`` and ``backend[...]`` lines, a finite
    loss.  (c) ``lint --grid --depth deep`` over the ported configs: exit
    code 0, every cell clean.  Returns the launches of (a) and (b), the
    winning Strategy, the search's 1F1B baseline and the numbers for the
    summary line."""
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import lint, train
    c = TUNE_CASE
    ops.reset_launch_counts()
    ckpt = pathlib.Path(tmp) / "ckpt"
    argv = ["--arch", c["arch"], "--autotune", "--tune-pp", str(c["pp"]), "--tune-dp",
            str(c["dp"]), "--steps", str(c["steps"]), "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    with captured() as out:
        rc = train.plan_phase(argv)
    search_s = time.perf_counter() - t0
    plan_dir = ckpt / get_config(c["arch"]).name
    if rc is not None or not (plan_dir / "strategy.json").exists():
        fail(f"3g (a): --autotune returned {rc}: {out}")
    plan = json.loads((plan_dir / "plan.json").read_text())
    for line in out:
        print(f"  (a) {line}", flush=True)
    print(f"  (a) search: {plan['n_evaluated']} candidates ({plan['n_rejected']} over budget) "
          f"in {search_s:.1f} s; winner {(plan_dir / 'strategy.json').read_text()}", flush=True)
    t0 = time.perf_counter()
    sup, _ = train.run(argv)
    torch.cuda.synchronize()
    losses = [h["loss"] for h in sup.history]
    print(f"  (a) reduced {c['arch']} trained {len(losses)} steps in "
          f"{time.perf_counter() - t0:.1f} s: loss {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    if not losses[-1] < losses[0]:
        fail(f"3g (a): the loss did not fall ({losses[0]} -> {losses[-1]})")

    t0 = time.perf_counter()
    with captured() as out:
        rc = train.main(["--arch", c["arch"], "--strategy", str(plan_dir / "strategy.json"),
                         "--backend", "reference", "--ckpt-dir", str(pathlib.Path(tmp) / "b")])
    for line in out:
        print(f"  (b) {line}", flush=True)
    backend = [x for x in out if x.startswith("backend[reference] loss=")]
    if rc != 0 or not backend or not any(x.startswith("strategy[") for x in out):
        fail(f"3g (b): --strategy --backend reference returned {rc}: {out}")
    loss = float(backend[0].split("loss=")[1].split()[0])
    print(f"  (b) replayed in {time.perf_counter() - t0:.1f} s", flush=True)
    if not math.isfinite(loss):
        fail(f"3g (b): loss {loss}")
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"  (a)-(b) launches {launched}", flush=True)
    if not launched.get("rmsnorm") or not launched.get("flash_attention"):
        fail(f"3g (a)-(b): K1 or K2 never launched: {launched}")

    report = pathlib.Path(tmp) / "lint.json"
    t0 = time.perf_counter()
    with captured() as out:
        rc = lint.main(["--grid", "--depth", "deep", "--out", str(report)])
    result = json.loads(report.read_text())
    dirty = [cell for cell in result["cells"] if not cell["ok"] or cell["codes"]]
    print(f"  (c) lint --grid --depth deep: exit {rc}, {len(result['cells'])} cells in "
          f"{time.perf_counter() - t0:.1f} s, {len(dirty)} not clean; {out[-1]}", flush=True)
    if rc != 0 or dirty or len(result["cells"]) != 108:       # 12 configs x 9 cells
        fail(f"3g (c): lint exit {rc}, {len(result['cells'])} cells, not clean: {dirty}")
    winner = core.Strategy.from_json((plan_dir / "strategy.json").read_text())
    baseline = core.Strategy.from_dict(plan["baseline"]["strategy"])
    summary = {"search_s": search_s, "n_evaluated": plan["n_evaluated"], "tokens": plan["tokens"],
               "winner": winner.label(), "predicted_step_ms": plan["predicted_step_seconds"] * 1e3,
               "baseline": baseline.label(),
               "baseline_predicted_step_ms": plan["baseline"]["step_seconds"] * 1e3,
               "loss": [losses[0], losses[-1]], "reference_loss": loss,
               "lint_cells": len(result["cells"]), "lint_s": time.perf_counter() - t0}
    return launched, winner, baseline, summary


def layer_flops(cfg, b: int, s: int) -> int:
    """FLOPs of one decoder layer's forward as ``FlopCounterMode`` counts
    it (the matmul family only): the q, k, v and o projections, the SwiGLU
    MLP, and the plain flash forward's two products over the full S x S
    scores, masked blocks included."""
    t, d, hd = b * s, cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    return (2 * t * d * (hq + 2 * hkv) * hd + 2 * t * hq * hd * d + 2 * t * 3 * d * cfg.d_ff
            + 2 * 2 * b * hq * s * s * hd)


def chunk_closed_form(cfg, n_layers: int, last: bool, b: int, s: int, pass_: str) -> int:
    """The closed form of a stage chunk of ``qwen3_piper``.  F: its layers,
    plus the tied logits on the last stage.  B (remat "full"): F again,
    then twice F's products for the input and weight gradients, except
    attention, whose plain backward runs five S x S products (the score
    recompute, dV, dP, dQ, dK) where the forward runs two."""
    head = 2 * b * s * cfg.d_model * cfg.vocab if last else 0
    attn = 2 * 2 * b * cfg.n_heads * s * s * cfg.head_dim
    f = n_layers * layer_flops(cfg, b, s) + head
    if pass_ == "F":
        return f
    return f + 2 * (f - n_layers * attn) + n_layers * attn * 5 // 2


def phase_cost_model(torch, cfg, ledger_peaks: dict, winner) -> tuple:
    """(d) RUNTIME_CASE's program (phase 3f's, remat "full"): for each
    distinct stage chunk, F and B, ``analyze_fn``'s count on meta tensors
    and the H100 constants' prediction beside the chunk's device time on
    the card (CUDA events, warm, median of 3) on the inputs one device
    runs (the simulator's sample inputs, made real); the chunks launch K1
    and K2, counted exactly.  ``calibrate`` folds the ratios into the cost
    model, and the calibrated model simulates the plan; its
    ``timeline_peak_bytes`` stand beside phase 3f's ledger peaks.  (e) The
    program as compiled (``analyze="quick"``, the default) and again at
    ``deep``: the PIPER codes and seconds of each depth.  Last, (a)'s
    ``winner`` scored on the calibrated model, on the analytic chunk cost
    and on the counted one.  Returns the K1 and K2 launches of the timed
    chunks (calls made to time them, not steps) and the summary's
    numbers."""
    from repro_torch import core
    from repro_torch.analysis import analyze
    from repro_torch.kernels import ops
    from repro_torch.models import init
    from repro_torch.runtime import CostModel, TimelineSimulator, timeline_peak_bytes
    from repro_torch.runtime.costmodel import analyze_fn
    from repro_torch import tune
    from repro_torch.tune import MeasuredCell, calibrate
    rc = RUNTIME_CASE
    n_st = rc["pp"]
    per = cfg.n_layers // n_st
    forward, buckets = qwen3_piper(cfg, n_st)
    bparams = buckets(init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    shape = ((rc["batch"], rc["seq"]), "int64")
    strategy = core.Strategy(core.Mesh(pp=n_st, dp=rc["dp"]),
                             core.Pipeline("1f1b", n_mb=rc["n_mb"], n_stages=n_st)
                             | core.ZeRO(stage=rc["zero"]))
    t0 = time.perf_counter()
    prog = core.compile_training(forward, bparams, {"tokens": shape, "labels": shape},
                                 strategy=strategy)
    compile_s = time.perf_counter() - t0
    print(f"  (e) {cfg.name} {cfg.n_layers} layers, {strategy.label()}: compiled in "
          f"{compile_s:.1f} s with the default analyze='quick': {prog.stats['analysis']}",
          flush=True)
    for depth in ("quick", "deep"):
        t0 = time.perf_counter()
        report = analyze(prog, depth=depth)
        print(f"  (e) analyze(depth={depth!r}): {time.perf_counter() - t0:.2f} s, codes "
              f"{sorted(set(report.codes()))}, {report.meta}", flush=True)
        if report.errors():
            fail(f"3g (e): {depth} analysis found errors: {report.format_text()}")
    ir = IR_CASE
    from repro_torch.configs import get_config
    from repro_torch.tune import build_strategy_program
    t0 = time.perf_counter()
    proxy = build_strategy_program(get_config(ir["arch"]), ir_strategy(core), ir["tokens"])[0]
    deep = analyze(proxy, depth="deep")
    print(f"  (e) phase 3e's proxy: compiled with {proxy.stats['analysis']}; deep (with the "
          f"memory cross-check on the simulator) {sorted(set(deep.codes()))} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if deep.errors():
        fail(f"3g (e): the proxy's deep analysis found errors: {deep.format_text()}")

    sim = TimelineSimulator(prog, CostModel())
    cost = CostModel()
    g = torch.Generator(device="cuda").manual_seed(5)

    def real(t):
        if t is None:
            return None
        if t.dtype == torch.int64:
            return torch.randint(0, cfg.vocab, tuple(t.shape), generator=g, device="cuda")
        return torch.randn(tuple(t.shape), generator=g, device="cuda").to(t.dtype)

    ops.register_kernels()
    ops.reset_launch_counts()
    cells, rows, gate = [], [], []
    launched_total = {}
    for s in range(n_st):
        for pass_ in ("F", "B"):
            node = next(n for n in prog.dag.chunks()
                        if n.dims.get("pp") == s and n.dims.get("PASS") == pass_)
            sample = sim.sample_inputs(node)
            flops, nbytes = analyze_fn(node.fn, bparams[node.bucket], sample, name=node.name)
            predicted = cost.chunk_seconds(node, bparams, sample)
            ins = [real(t) for t in sample]
            b, sq = next(t.shape[:2] for t in sample if t is not None and t.dim() >= 2)
            closed = chunk_closed_form(cfg, per, s == n_st - 1, b, sq, pass_)
            call = lambda: node.fn(bparams[node.bucket], *ins)  # noqa: E731
            before = ops.launch_counts()
            call()
            ms = statistics.median(event_ms(torch, call)[1] for _ in range(3))
            after = ops.launch_counts()
            launched = {k: after[k] - before.get(k, 0) for k in after
                        if after[k] - before.get(k, 0)}
            want = {"rmsnorm": 4 * (2 * per + (s == n_st - 1)), "flash_attention": 4 * per}
            for k, v in launched.items():
                launched_total[k] = launched_total.get(k, 0) + v
            ratio = ms * 1e-3 / predicted
            label = f"stage{s} {pass_}"
            cells.append(MeasuredCell(label, predicted, ms * 1e-3))
            rows.append((label, b, sq, flops, closed, nbytes, predicted, ms, ratio, launched))
            print(f"  (d) {label} ({b} x {sq} tokens a device): counted {flops:.6e} FLOP, "
                  f"closed form {closed:.6e} ({flops / closed - 1:+.2e}), {nbytes / 2**20:.1f} "
                  f"MiB; predicted {predicted * 1e3:.3f} ms, measured {ms:.3f} ms, ratio "
                  f"{ratio:.3f}; launches {launched} (4 calls, expected {want})", flush=True)
            if launched != want:
                fail(f"3g (d) {label}: launches {launched} != {want}")
            if not (math.isfinite(ratio) and ratio > 0):
                fail(f"3g (d) {label}: ratio {ratio}")
            if pass_ == "F":
                gate.append(abs(flops / closed - 1))
                if abs(flops / closed - 1) > FLOP_RTOL:
                    fail(f"3g (d) {label}: counted {flops} against the closed form {closed}")
            del ins
    ops.unregister_kernels()
    cal = calibrate(cost, cells)
    print(f"  (d) calibrate over {len(cells)} chunks: scale {cal.scale:.4f}, dispersion "
          f"{cal.dispersion:.4f}, mfu {cost.mfu} -> {cal.cost.mfu:.6f} (recorded, not "
          f"adopted); worst F FLOP gap {max(gate):.2e} (limit {FLOP_RTOL})", flush=True)
    t0 = time.perf_counter()
    res = TimelineSimulator(prog, cal.cost).run()
    est = timeline_peak_bytes(prog, res.records)
    ledger = ledger_peaks["full"]
    print(f"  (d) the plan on the calibrated model: makespan {res.makespan * 1e3:.3f} ms "
          f"(simulated in {time.perf_counter() - t0:.1f} s); per device timeline_peak_bytes "
          f"against phase 3f's interpreter ledger peak (GiB): "
          + ", ".join(f"dev{d} {est[d] / 2**30:.3f} / {ledger[d] / 2**30:.3f}"
                      for d in sorted(est)), flush=True)
    print("  (d) " + json.dumps({"cost_model_cells": [
        {"chunk": r[0], "tokens": [int(r[1]), int(r[2])], "flops": r[3], "closed_form": r[4],
         "bytes": r[5], "predicted_ms": r[6] * 1e3, "measured_ms": r[7], "ratio": r[8]}
        for r in rows], **cal.to_dict(), "makespan_ms": res.makespan * 1e3}), flush=True)
    mesh = tune.MeshSpec(pp=TUNE_CASE["pp"], dp=TUNE_CASE["dp"])
    cand = tune.Candidate.from_strategy(winner)
    t0 = time.perf_counter()
    analytic = tune.score_candidate(cfg, mesh, cand, cost=cal.cost)
    counted = tune.score_candidate(cfg, mesh, cand, cost=cal.cost, use_counted_cost=True)
    print(f"  (d) (a)'s winner {cand.label()} on the calibrated model: step "
          f"{analytic.step_seconds * 1e3:.3f} ms on the analytic chunk cost, "
          f"{counted.step_seconds * 1e3:.3f} ms on the counted one (scored in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    for s in (analytic, counted):
        if not (math.isfinite(s.step_seconds) and s.step_seconds > 0):
            fail(f"3g (d): the winner's score {s}")
    summary = {"scale": cal.scale, "dispersion": cal.dispersion, "mfu": cal.cost.mfu,
               "worst_f_flop_gap": max(gate), "makespan_ms": res.makespan * 1e3,
               "winner_step_ms": {"analytic": analytic.step_seconds * 1e3,
                                  "counted": counted.step_seconds * 1e3},
               "ratios": {r[0]: r[8] for r in rows}}
    return launched_total, summary


# the multi-rank runtimes phase (3h): the ``spmd`` and ``mpmd`` lanes held
# to the interpreter bit for bit on the card, first on the CPU tests' grids
# (the toy MLP in fp64), then on phase 3f's full-width program
TOY = {"stages": 8, "batch": 16, "d": 16}
LANE_GRIDS = {
    "spmd": ["1f1b-z0-full", "1f1b-z3-none", "gpipe-z1-full", "gpipe-z3-overlap",
             "dualpipev-z1-none", "dualpipev-z3-full", "zb1f1b-z1-full", "1f1b-z2-offload",
             "1f1b-z1-ep"],
    "mpmd": ["1f1b-z0-full", "1f1b-z3-full", "gpipe-z0-full", "gpipe-z3-full",
             "dualpipev-z0-full", "dualpipev-z3-full"],
    "mpmd/tcp": ["1f1b-z3-full"],
}


def lane_strategy(core, name: str):
    """``<schedule>-z<stage>-<extra>`` as the CPU tests spell their cases."""
    kind, zero, extra = name.split("-")
    frags = core.Pipeline(kind, n_mb=8 if kind == "dualpipev" else 4) \
        | core.ZeRO(stage=int(zero[1:]))
    more = {"none": lambda: core.Remat(policy="none"),
            "overlap": lambda: core.Overlap(prefetch=2, bucket_mb=32),
            "offload": lambda: core.Offload(depth=2), "ep": core.ExpertParallel}.get(extra)
    return core.Strategy(core.Mesh(pp=4, dp=2), frags | more() if more else frags)


def toy_program(torch, name: str):
    """The CPU tests' toy MLP (``tests/test_torch_spmd.py``) in fp64 on the
    card: TOY["stages"] tanh-MLP stages (an expert region after stages 1,
    3 and 5 for the EP case), weights and batch from numpy seed 0."""
    import numpy as np
    from repro_torch import core
    n, bsz, d = TOY["stages"], TOY["batch"], TOY["d"]
    experts = (1, 3, 5) if name.endswith("-ep") else ()

    def stage_fn(p, x):
        return torch.tanh(torch.tanh(x @ p["w1"]) @ p["w2"])

    def loss_fn(p, x, y):
        return torch.mean((stage_fn(p, x) - y) ** 2)

    def forward(rec, tvs):
        h = tvs["x"]
        for i in range(n - 1):
            with rec.annotate("pp"):
                h = rec.region(stage_fn, f"stage{i}", name=f"s{i}")(h)
                if i in experts:
                    with rec.annotate("ep"):
                        h = rec.region(stage_fn, f"exp{i}", name=f"e{i}")(h)
        with rec.annotate("pp"):
            return rec.region(loss_fn, f"stage{n - 1}", name="head")(h, tvs["y"])
    rng = np.random.default_rng(0)
    names = [f"stage{i}" for i in range(n)] + [f"exp{i}" for i in experts]
    params = {b: {w: torch.from_numpy(rng.standard_normal((d, d)) * 0.1).cuda()
                  for w in ("w1", "w2")} for b in names}
    batch = {k: torch.from_numpy(rng.standard_normal((bsz, d))).cuda() for k in ("x", "y")}
    prog = core.compile_training(forward, params, {"x": ((bsz, d), "float64"),
                                                   "y": ((bsz, d), "float64")},
                                 strategy=lane_strategy(core, name))
    return prog, params, batch


def same_bits(torch, a, b) -> bool:
    a, b = a.detach().contiguous().reshape(-1), b.detach().contiguous().reshape(-1)
    if a.device != b.device:
        a = a.to(b.device)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


def result_diff(torch, got, ref) -> str | None:
    """None when ``got`` is ``ref`` bit for bit (loss and every grad
    leaf), else what differs first."""
    from repro_torch.tree import tree_flatten_with_path
    if got.loss.hex() != ref.loss.hex():
        return f"loss {got.loss!r} != {ref.loss!r}"
    if sorted(got.grads) != sorted(ref.grads):
        return f"buckets {sorted(got.grads)} != {sorted(ref.grads)}"
    for bkt in ref.grads:
        mine = dict(tree_flatten_with_path(got.grads[bkt]))
        for path, leaf in tree_flatten_with_path(ref.grads[bkt]):
            if not same_bits(torch, mine[path], leaf):
                err = rel_l2(mine[path].float().to(leaf.device), leaf.float())
                return f"{bkt}/{'/'.join(path)} differs (relative L2 {err:.3e})"
    return None


def lane_order_diff(lane: str, got, ref) -> str | None:
    """None when the lane ran the interpreter's order: ``exec_order`` for
    ``spmd``; for ``mpmd``, each rank's compute and collective order, the
    interpreter's restricted to the rank, with every one of its tasks."""
    if lane == "spmd":
        return None if got.exec_order == ref.exec_order else "exec_order differs"
    for r, order in got.stats["rank_orders"].items():
        want = [(n, role) for (n, d, role) in ref.exec_order
                if d == r and role not in ("send", "recv")]
        if [(n, role) for (n, role) in order if role not in ("send", "recv")] != want:
            return f"rank {r}'s compute/collective order differs"
        if len(order) != sum(1 for k in ref.exec_order if k[1] == r):
            return f"rank {r} ran {len(order)} tasks"
    return None


def gb(n: int) -> str:
    return f"{n / 1e9:.3f} GB"


def moved_line(res) -> str:
    m = res.stats["bytes_moved"]
    return ("moved p2p " + gb(m["p2p"]) + ", gathers " + gb(m["gather"]) + ", reductions "
            + gb(m["reduce"]) + (f", all-to-all {gb(m['all_to_all'])}" if m["all_to_all"] else ""))


def phase_lanes_grid(torch) -> None:
    """(a) The CPU tests' grids on the card in fp64: nine ``spmd`` cases,
    six ``mpmd`` ones and one on ``tcp``.  The interpreter runs each
    twice (the same bits, or the comparison means nothing), then the lane
    must return its result bit for bit, in its order."""
    from repro_torch import runtime
    for lane, names in LANE_GRIDS.items():
        backend, _, transport = lane.partition("/")
        t0 = time.perf_counter()
        for name in names:
            prog, params, batch = toy_program(torch, name)
            ref = runtime.make_executor("reference", prog, params).run(batch)
            diff = result_diff(torch, runtime.make_executor("reference", prog, params)
                               .run(batch), ref)
            if diff:
                fail(f"3h (a) {name}: the interpreter is not reproducible on the card: {diff}")
            opts = {"transport": transport} if transport else {}
            ex = runtime.make_executor(backend, prog, params, **opts)
            got = ex.run(batch)
            getattr(ex, "close", lambda: None)()
            diff = result_diff(torch, got, ref) or lane_order_diff(backend, got, ref)
            if diff:
                fail(f"3h (a) {lane} {name}: {diff}")
            if any(t.device.type != "cuda" for g in got.grads.values() for t in g.values()):
                fail(f"3h (a) {lane} {name}: a gradient left the card")
        print(f"  (a) {lane}: {len(names)} cases bit-equal to the interpreter on the card, "
              f"fp64, in {time.perf_counter() - t0:.1f} s ({', '.join(names)})", flush=True)


def phase_lanes_model(torch, cfg, lanes=("spmd", "mpmd"), remats=("full", "none"),
                      timed: tuple = ("full", "none"), tag: str = "(b)",
                      zero: int = RUNTIME_CASE["zero"], **opts) -> dict:
    """(b) Phase 3f's program (``cfg``'s decoder as a Piper forward,
    RUNTIME_CASE's pp 4 x dp 2 1F1B ZeRO-3 Strategy, one global batch,
    weights from seed 0) on each lane under each remat policy.  The
    interpreter runs twice first (the same bits: trap 5); each lane must
    then return the interpreter's loss and every gradient leaf bit for
    bit, launch K1 and K2 exactly ``runtime_launches`` times and run the
    interpreter's order.  For the policies in ``timed``: a warm step
    beside the interpreter's (the median of its two runs) and the
    device's busy share (torch.profiler); for every policy
    ``max_memory_allocated`` and the bytes moved.  ``zero`` is the
    Strategy's ZeRO stage.  Returns the launches by lane and policy."""
    from repro_torch import core, runtime
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    from repro_torch.kernels import ops
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init
    from repro_torch.tree import tree_map
    rc = RUNTIME_CASE
    n_st = rc["pp"]
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    first = TokenLoader(SyntheticTokenSource(cfg.vocab, seed=rc["seed"]), batch=rc["batch"],
                        seq=rc["seq"]).next_batch()
    batch = device_batch(first, "cuda")
    forward, buckets = qwen3_piper(cfg, n_st)
    bparams = buckets(params)
    shape = ((rc["batch"], rc["seq"]), "int64")
    ops.register_kernels()
    counts = {}
    for remat in remats:
        strategy = core.Strategy(core.Mesh(pp=n_st, dp=rc["dp"]),
                                 core.Pipeline("1f1b", n_mb=rc["n_mb"], n_stages=n_st)
                                 | core.ZeRO(stage=zero) | core.Remat(remat))
        prog = core.compile_training(forward, bparams, {"tokens": shape, "labels": shape},
                                     strategy=strategy)
        expect = runtime_launches(cfg.n_layers, n_st, rc["n_mb"], rc["dp"], remat)
        interp = runtime.make_executor("reference", prog, bparams)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ref, ref_ms = event_ms(torch, lambda: interp.run(batch))
        ref_peak = torch.cuda.max_memory_allocated()
        # the reference grads wait on the host: the lanes need the card's memory
        ref.grads = tree_map(lambda t: t.cpu(), ref.grads)
        again, again_ms = event_ms(torch, lambda: interp.run(batch))
        diff = result_diff(torch, again, ref)
        del again
        if diff:
            fail(f"3h {tag} remat={remat}: the interpreter is not reproducible on the card: {diff}")
        print(f"  {tag} {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {strategy.label()}: the "
              f"interpreter twice, the same bits; step {again_ms:.1f} ms (the second, warm; "
              f"the first {ref_ms:.1f}), max_memory_allocated {ref_peak / 2**30:.2f} GiB",
              flush=True)
        for lane in lanes:
            backend, _, transport = lane.partition("/")
            lane_opts = dict(opts, transport=transport) if transport else dict(opts)
            t0 = time.perf_counter()
            ex = runtime.make_executor(backend, prog, bparams, **lane_opts)
            built_s = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res, ms = event_ms(torch, lambda: ex.run(batch))
            first_s = time.perf_counter() - t0
            launched = {k: v for k, v in ops.launch_counts().items() if v}
            peak = torch.cuda.max_memory_allocated()
            diff = result_diff(torch, res, ref)
            order = lane_order_diff(backend, res, ref)
            line = (f"  {tag} {lane} remat {remat}: {'bit-equal to the interpreter' if not diff else diff}; "
                    f"launches {launched}, expected {expect}; order "
                    f"{'equal' if not order else order}; {moved_line(res)}; built in "
                    f"{built_s:.1f} s, first step {first_s:.1f} s; max_memory_allocated "
                    f"{peak / 2**30:.2f} GiB (the interpreter's {ref_peak / 2**30:.2f})")
            print(line, flush=True)
            res.grads = None
            if remat in timed:      # one warm step, then a profiled one
                gc.collect()
                torch.cuda.empty_cache()
                warm = event_ms(torch, lambda: ex.run(batch).loss)[1]
                print(f"  {tag} {lane} remat {remat}: step {warm:.1f} ms (warm) against the "
                      f"interpreter's {again_ms:.1f} (warm)", flush=True)
                step_profile(torch, f"{lane} step, remat {remat}", lambda: ex.run(batch).loss)
            getattr(ex, "close", lambda: None)()
            counts[f"3h {lane}, remat {remat}"] = launched
            if diff:
                fail(f"3h {tag} {lane} remat={remat}: {diff}")
            if order:
                fail(f"3h {tag} {lane} remat={remat}: {order}")
            if launched != expect:
                fail(f"3h {tag} {lane} remat={remat}: launches {launched} != {expect}")
            del ex, res
        del interp, ref, prog
        gc.collect()
    ops.unregister_kernels()
    return counts


def phase_lanes_measured(torch, winner, baseline, summary_3g: dict) -> dict:
    """(d) The first measured step cell: ``tune.measure_program`` on the
    ``spmd`` lane for phase 3g's tuned winner and for the 1F1B baseline
    of the same search (the qwen3-1b proxy at the search's tokens, real
    draws on the card), each beside its predicted step on the H100
    constants (the search's) and on 3g (d)'s calibration.  Recorded, not
    gated, apart from finite and positive."""
    from repro_torch import tune
    from repro_torch.configs import get_config
    from repro_torch.runtime import CostModel
    cfg = get_config(TUNE_CASE["arch"])
    mesh = tune.MeshSpec(pp=TUNE_CASE["pp"], dp=TUNE_CASE["dp"])
    cal = dataclasses.replace(CostModel(), mfu=summary_3g["cost_model"]["mfu"])
    tokens = summary_3g["tokens"]
    rows = {}
    for label, strat, predicted in (("winner", winner, summary_3g["predicted_step_ms"] / 1e3),
                                    ("baseline", baseline,
                                     summary_3g["baseline_predicted_step_ms"] / 1e3)):
        prog, _ = tune.build_strategy_program(cfg, strat, tokens)
        t0 = time.perf_counter()
        measured = tune.measure_program(prog, reps=1)
        wall = time.perf_counter() - t0
        calibrated = tune.score_candidate(cfg, mesh, tune.Candidate.from_strategy(strat),
                                          tokens=tokens, cost=cal).step_seconds
        rows[label] = {"strategy": strat.label(), "measured_s": measured,
                       "predicted_s": predicted, "calibrated_s": calibrated}
        print(f"  (d) {label} {strat.label()} ({tokens} tokens): measured on spmd "
              f"{measured:.4f} s a step (2 steps in {wall:.1f} s), predicted {predicted:.4f} s "
              f"on the H100 constants and {calibrated:.4f} s on 3g (d)'s calibration (mfu "
              f"{cal.mfu:.6f})", flush=True)
        if not (math.isfinite(measured) and measured > 0):
            fail(f"3h (d) {label}: measured {measured}")
        del prog
        gc.collect()
        torch.cuda.empty_cache()
    w, b = rows["winner"], rows["baseline"]
    agree = (w["measured_s"] < b["measured_s"]) == (w["predicted_s"] < b["predicted_s"])
    print(f"  (d) measured order {'winner first' if w['measured_s'] < b['measured_s'] else 'baseline first'}"
          f", predicted {'winner first' if w['predicted_s'] < b['predicted_s'] else 'baseline first'}:"
          f" {'they agree' if agree else 'they DISAGREE'} (measured/predicted "
          f"{w['measured_s'] / w['predicted_s']:.2f} and {b['measured_s'] / b['predicted_s']:.2f})",
          flush=True)
    return {**rows, "order_agrees": agree}


def phase_lanes_cli(torch, strategy_json: str, tmp: str) -> None:
    """(e) The training CLI: ``--strategy`` with 3g's winner and
    ``--backend`` reference, spmd and mpmd on the card; each takes one
    step, and the lanes' losses must equal the reference's bit for bit
    (read from the executors the CLI made)."""
    from repro_torch.launch import train
    from repro_torch.runtime import executor
    make, losses = executor.make_executor, {}

    def recording(name, prog, params=None, **kw):
        ex = make(name, prog, params=params, **kw)
        run = ex.run

        def run_and_keep(batch):
            res = run(batch)
            losses[name] = res.loss
            return res
        ex.run = run_and_keep
        return ex
    executor.make_executor = recording
    try:
        for name in ("reference", "spmd", "mpmd"):
            t0 = time.perf_counter()
            with captured() as out:
                rc = train.main(["--arch", TUNE_CASE["arch"], "--strategy", strategy_json,
                                 "--backend", name, "--ckpt-dir",
                                 str(pathlib.Path(tmp) / name)])
            line = next((x for x in out if x.startswith(f"backend[{name}] loss=")), None)
            print(f"  (e) --backend {name}: {line} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            if rc != 0 or line is None or "cuda" not in line:
                fail(f"3h (e) --backend {name} returned {rc}: {out}")
    finally:
        executor.make_executor = make
    if not (losses["spmd"].hex() == losses["mpmd"].hex() == losses["reference"].hex()):
        fail(f"3h (e): losses {losses} are not bit-equal")
    print(f"  (e) the three losses are bit-equal ({losses['reference'].hex()})", flush=True)


# the elastic recovery and chaos phase (3i): the supervisor on the lanes,
# first on the CPU tests' grids (the toy MLP in fp64), then on phase 3f's
# full-width program through a kill and a regrowth, then the CLI
ELASTIC_GRID = {"steps": 10, "every": 4, "kill_at": 6, "kill_rank": 3,
                "cases": ["1f1b-z0-full", "1f1b-z3-full", "gpipe-z0-full", "gpipe-z3-full"]}
SOAK = {"steps": 24, "every": 4, "case": "1f1b-z3-full", "seed": 23,
        "events": [dict(step=6, kind="kill", rank=3), dict(step=8, kind="arrive", devices=(3,)),
                   dict(step=8, kind="straggle", rank=2, factor=3.0, duration=16),
                   dict(step=16, kind="corrupt", flips=8), dict(step=19, kind="nan_spike")]}
# (b): RUNTIME_CASE's program for 8 steps, a checkpoint every 2; rank 3
# dies at step 3 (world 8 -> 4, ZeRO shards 2 -> 1), slot 3 arrives back
# at step 5 (world 4 -> 8, shards 1 -> 2, the first program from the plan
# cache)
ELASTIC_MODEL = {"steps": 8, "every": 2, "kill_at": 3, "kill_rank": 3, "arrive_at": 5,
                 "keep": 2}
# (c): the CLI's --chaos schedule on 3g's winner (pp 4 x dp 2; the CLI
# checkpoints every 3 steps of 8): a kill, the slot's arrival, a
# corrupted checkpoint and a NaN spike that must skip it
CLI_CHAOS = [dict(step=4, kind="kill", rank=7), dict(step=6, kind="arrive", devices=(7,)),
             dict(step=6, kind="corrupt", flips=8), dict(step=7, kind="nan_spike")]


class DeviceTokens:
    """A token loader whose batches land on the card, integers as int64
    (the programs' declared input dtype); its stream position is the
    wrapped loader's, so the supervisor checkpoints and restores it."""

    def __init__(self, torch, loader) -> None:
        self.torch, self.loader = torch, loader

    def next_batch(self) -> dict:
        from repro_torch.launch.train import device_batch
        return device_batch(self.loader.next_batch(), "cuda")

    def state_dict(self) -> dict:
        return self.loader.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self.loader.load_state_dict(d)


def tree_diff(torch, got: dict, want: dict) -> str | None:
    """None when every leaf of ``got`` is ``want``'s bit for bit."""
    from repro_torch.tree import tree_flatten_with_path
    mine = dict(tree_flatten_with_path(got))
    for path, leaf in tree_flatten_with_path(want):
        if not same_bits(torch, mine[path], leaf):
            return f"{'/'.join(path)} differs"
    return None


def lane_factory(lane: str, built: list):
    """The registry's runner factory for ``lane`` (``mpmd/tcp`` names the
    transport), recording the device slots of every runner it builds."""
    from repro_torch import runtime
    backend, _, transport = lane.partition("/")
    factory = runtime.executor_factory(backend, **({"transport": transport} if transport else {}))

    def build(prog, params, devices):
        built.append(None if devices is None else tuple(devices))
        return factory(prog, params, devices)
    return build


def piecewise(torch, lane: str, pieces: list, params: dict, loader, n_steps: int) -> tuple:
    """The fault-free reference of an elastic run: ``pieces`` is [(start
    step, program)], each piece on a fresh executor of ``lane`` from live
    params resharded to its ZeRO degree, with the supervisor's SGD.
    Returns ({step: loss}, final params)."""
    from repro_torch import ft
    from repro_torch.checkpoint import reshard_tree
    update, starts = ft.sgd_update(), dict(pieces)
    p, ex, deg, losses = params, None, None, {}
    try:
        for step in range(n_steps):
            if step in starts:
                prog = starts[step]
                new = ft.zero_shard_degree(prog.strategy)
                if deg is not None and deg != new:
                    p = reshard_tree(p, deg, new)
                deg = new
                if ex is not None:
                    getattr(ex, "close", lambda: None)()
                    ex = None
                    gc.collect()
                ex = lane_factory(lane, [])(prog, p, None)
            res = ex.run(loader.next_batch())
            p = update(p, res.grads, step)
            ex.params = p
            losses[step + 1] = res.loss
            del res
    finally:
        getattr(ex, "close", lambda: None)()
    return losses, p


def check_history(history: list, want: dict, what: str) -> None:
    """Every kept loss of a supervisor's ``history`` (the last record of
    each step) equals ``want``'s bit for bit."""
    got = {h["step"]: h["loss"] for h in history}
    bad = [s for s in want if got[s].hex() != want[s].hex()]
    if bad or sorted(got) != sorted(want):
        fail(f"{what}: losses at steps {bad} differ from the fault-free reference "
             f"({[(s, got.get(s), want[s]) for s in bad[:3]]})")


def phase_elastic_grid(torch) -> None:
    """(a) The CPU tests' grids on the card in fp64 (``ELASTIC_GRID``,
    ``SOAK``): the kill-a-rank grid on ``spmd`` and ``mpmd`` (pp 4 x dp 2,
    rank 3 dies at step 6, a checkpoint every 4), each resumed loss and
    the final params bit-equal to the same lane run uninterrupted from the
    restored checkpoint on the shrunk mesh; then the 24-step soak (kill,
    arrival, straggler and rebalance, corruption, NaN spike) on ``spmd``,
    bit-equal to the piecewise fault-free reference."""
    from repro_torch import ft
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticVectorSource, VectorLoader

    def loader():
        return VectorLoader(SyntheticVectorSource(TOY["d"], seed=11), batch=TOY["batch"],
                            device="cuda", dtype=torch.float64)
    g = ELASTIC_GRID
    for lane in ("spmd", "mpmd"):
        t0 = time.perf_counter()
        for name in g["cases"]:
            prog, params, _ = toy_program(torch, name)
            built: list = []
            with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as tmp:
                sup = ft.ElasticSupervisor(
                    prog, CheckpointManager(tmp, keep=10, async_save=False), loader(),
                    runner_factory=lane_factory(lane, built), checkpoint_every=g["every"],
                    injector=ft.RankFailureInjector({g["kill_at"]: g["kill_rank"]}))
                final = sup.run(params, g["steps"])
                r, = sup.reports
                if (r.resume_step, r.new_world, r.shrunk_axis) != (4, 4, "dp") \
                        or not 0 < r.steps_lost <= g["every"]:
                    fail(f"3i (a) {lane} {name}: recovery {r.to_dict()}")
                if any(g["kill_rank"] in b for b in built[1:]):
                    fail(f"3i (a) {lane} {name}: the killed slot was named again: {built}")
                plan = ft.shrink_for_survivors(prog.strategy, [x for x in range(8)
                                                               if x != g["kill_rank"]])
                state, extra = sup.ckpt.restore({"params": params}, step=r.resume_step)
            ref_loader = loader()
            ref_loader.load_state_dict(extra["data"])
            want, p = piecewise(torch, lane, [(0, prog.recompile(strategy=plan.strategy))],
                                state["params"], ref_loader, g["steps"] - r.resume_step)
            want = {s + r.resume_step: v for s, v in want.items()}
            check_history([h for h in sup.history if h["step"] > r.resume_step], want,
                          f"3i (a) {lane} {name}")
            if tree_diff(torch, final, p):
                fail(f"3i (a) {lane} {name}: final params {tree_diff(torch, final, p)}")
        print(f"  (a) {lane}: kill-a-rank on {len(g['cases'])} cases, world 8 -> 4, each "
              f"resumed loss and the final params bit-equal to an uninterrupted run from the "
              f"restored checkpoint, fp64, in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    s = SOAK
    prog, params, _ = toy_program(torch, s["case"])
    schedule = ft.FaultSchedule(tuple(ft.FaultEvent(**e) for e in s["events"]), seed=s["seed"])
    built = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as tmp:
        sup = ft.ElasticSupervisor(
            prog, CheckpointManager(tmp, keep=10, async_save=False), loader(),
            runner_factory=lane_factory("spmd", built), checkpoint_every=s["every"],
            injector=ft.ChaosInjector(schedule), rebalance=True, rebalance_patience=2,
            rebalance_cooldown=s["every"])
        final = sup.run(params, s["steps"])
    rep = sup.chaos_report(s["steps"])
    if (len(rep.recoveries), len(rep.growths), len(rep.rebalances), rep.numeric_rewinds,
            rep.corrupt_detected, rep.final_world) != (2, 1, 1, 1, 1, 8):
        fail(f"3i (a) soak: {rep.to_json()}")
    if 3 in built[1] or sorted(sup.physical) != list(range(8)):
        fail(f"3i (a) soak: slots {built}, physical {sup.physical}")
    plan = ft.shrink_for_survivors(prog.strategy, [x for x in range(8) if x != 3])
    gplan = ft.grow_for_arrivals(plan.strategy, 8)
    # the shrunk piece starts from the checkpoint the kill restored: the
    # fault-free run's live params at step 4 are those bits
    want, p = piecewise(torch, "spmd", [(0, prog), (4, prog.recompile(strategy=plan.strategy)),
                                        (8, prog.recompile(strategy=gplan.strategy))],
                        params, loader(), s["steps"])
    check_history(sup.history, want, "3i (a) soak")
    if tree_diff(torch, final, p):
        fail(f"3i (a) soak: final params {tree_diff(torch, final, p)}")
    print(f"  (a) spmd soak: {len(schedule.events)} faults over {s['steps']} steps (2 "
          f"recoveries, 1 regrowth, 1 rebalance {rep.rebalances[0]['split']}, 1 corrupt "
          f"checkpoint skipped, {rep.steps_lost_total} steps lost), every loss and the final "
          f"params bit-equal to the piecewise fault-free reference, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_elastic_model(torch, cfg) -> dict:
    """(b) Phase 3f's program (``cfg``'s layers in bf16, remat "full",
    RUNTIME_CASE's pp 4 x dp 2 1F1B ZeRO-3 Strategy) under an
    ``ElasticSupervisor`` on ``spmd`` (``ELASTIC_MODEL``): rank 3 dies,
    the mesh shrinks to pp 4 x dp 1 and recompiles, the last checkpoint is
    restored and resharded, and slot 3's arrival regrows the original
    mesh from the plan cache.  Held to the piecewise fault-free reference
    (each piece on a fresh ``spmd`` executor): every kept loss and every
    final param leaf bit for bit, with exact K1 and K2 launches over the
    steps each world ran (lost steps included).  Prints the recovery,
    recompile, checkpoint and reshard seconds, the checkpoint's bytes,
    ``max_memory_allocated`` and each world's median step.  Returns the
    launches."""
    from repro_torch import core, ft
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticTokenSource, TokenLoader
    from repro_torch.ft import elastic
    from repro_torch.kernels import ops
    from repro_torch.models import init
    rc, m = RUNTIME_CASE, ELASTIC_MODEL
    n_st = rc["pp"]
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    forward, buckets = qwen3_piper(cfg, n_st)
    bparams = buckets(params)
    del params
    shape = ((rc["batch"], rc["seq"]), "int64")
    strategy = core.Strategy(core.Mesh(pp=n_st, dp=rc["dp"]),
                             core.Pipeline("1f1b", n_mb=rc["n_mb"], n_stages=n_st)
                             | core.ZeRO(stage=rc["zero"]) | core.Remat("full"))
    prog = core.compile_training(forward, bparams, {"tokens": shape, "labels": shape},
                                 strategy=strategy)

    def loader():
        return DeviceTokens(torch, TokenLoader(SyntheticTokenSource(cfg.vocab, seed=rc["seed"]),
                                               batch=rc["batch"], seq=rc["seq"]))
    timed: dict = {"save": [], "restore": [], "reshard": []}

    def timing(what, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timed[what].append(time.perf_counter() - t0)
            return out
        return run
    schedule = ft.FaultSchedule((ft.FaultEvent(step=m["kill_at"], kind="kill", rank=m["kill_rank"]),
                                 ft.FaultEvent(step=m["arrive_at"], kind="arrive",
                                               devices=(m["kill_rank"],))))
    built: list = []
    ops.register_kernels()
    real_reshard = elastic.reshard_tree
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_model_") as tmp:
        free = shutil.disk_usage(tmp).free
        # asynchronous saves: the supervisor waits for the write before a
        # restore, so the run restores what it would have synchronously,
        # and a save costs its host copy, not the copy, sha256 and write
        # (7.7-8.6 s each at 12 layers, ROADMAP Queue 2)
        ckpt = CheckpointManager(tmp, keep=m["keep"], async_save=True)
        ckpt.save, ckpt.restore = timing("save", ckpt.save), timing("restore", ckpt.restore)
        elastic.reshard_tree = timing("reshard", real_reshard)
        try:
            sup = ft.ElasticSupervisor(prog, ckpt, loader(),
                                       runner_factory=lane_factory("spmd", built),
                                       checkpoint_every=m["every"],
                                       injector=ft.ChaosInjector(schedule))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            final = sup.run(bparams, m["steps"], log_every=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: v for k, v in ops.launch_counts().items() if v}
            peak = torch.cuda.max_memory_allocated()
            ckpt.wait()
            on_disk = {s: sum(f.stat().st_size for f in ckpt.step_dir(s).iterdir())
                       for s in ckpt.steps()}
        finally:
            elastic.reshard_tree = real_reshard
    r, = sup.reports
    g, = sup.growths
    worlds = [h["world"] for h in sup.history]
    by_world: dict = {}
    for h in sup.history:
        by_world.setdefault(h["world"], []).append(h["dt"])
    expect: dict = {}
    for w in worlds:
        for k, v in runtime_launches(cfg.n_layers, n_st, rc["n_mb"], w // n_st, "full").items():
            expect[k] = expect.get(k, 0) + v
    print(f"  (b) {cfg.name} {cfg.n_layers} layers {cfg.dtype}, {strategy.label()} on spmd under "
          f"an ElasticSupervisor, {m['steps']} steps in {wall:.1f} s: rank {r.failed_rank} lost "
          f"at step {r.step_failed}, world {r.old_world}->{r.new_world} (shrunk "
          f"{r.shrunk_axis}), resumed at step {r.resume_step} ({r.steps_lost} steps lost), "
          f"recovery {r.recovery_seconds:.2f} s (recompile {r.compile_seconds:.2f} s); slot "
          f"{m['kill_rank']} back at step {g.step}, world {g.old_world}->{g.new_world} (grew "
          f"{g.grown_axis}, plan cache hit {g.cache_hit}, {g.recovery_seconds:.2f} s)", flush=True)
    print(f"  (b) checkpoints: saves {[round(t, 2) for t in timed['save']]} s (asynchronous: "
          f"the host copy), restores "
          f"{[round(t, 2) for t in timed['restore']]} s, reshards "
          f"{[round(t, 2) for t in timed['reshard']]} s, {gb(max(on_disk.values()))} a "
          f"checkpoint on disk ({len(on_disk)} kept, {free / 1e9:.1f} GB free before); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; median step by world "
          f"{ {w: round(statistics.median(d), 3) for w, d in sorted(by_world.items())} } s "
          f"(steps run by world {worlds}); launches {launched}, expected {expect}", flush=True)
    if (r.failed_rank, r.step_failed, r.old_world, r.new_world, r.shrunk_axis) != \
            (m["kill_rank"], m["kill_at"], 8, 4, "dp") or r.steps_lost > m["every"]:
        fail(f"3i (b): recovery {r.to_dict()}")
    if (g.old_world, g.new_world, g.grown_axis, g.cache_hit) != (4, 8, "dp", True):
        fail(f"3i (b): regrowth {g.to_dict()}")
    if any(m["kill_rank"] in b for b in built[1:-1]) or sorted(sup.physical) != list(range(8)):
        fail(f"3i (b): slots {built}, physical {sup.physical}")
    if launched != expect:
        fail(f"3i (b): launches {launched} != {expect}")
    history = sup.history
    del sup
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shrunk = prog.recompile(strategy=ft.shrink_for_survivors(
        strategy, [x for x in range(8) if x != m["kill_rank"]]).strategy)
    want, p = piecewise(torch, "spmd", [(0, prog), (r.resume_step, shrunk), (g.step, prog)],
                        bparams, loader(), m["steps"])
    check_history(history, want, "3i (b)")
    diff = tree_diff(torch, final, p)
    print(f"  (b) the piecewise fault-free reference (original program to step "
          f"{r.resume_step}, shrunk to step {g.step}, original to {m['steps']}, each on a fresh "
          f"spmd executor) in {time.perf_counter() - t0:.1f} s: every kept loss "
          f"{'and every final param leaf bit-equal' if not diff else 'equal, but ' + diff}; "
          f"losses {[round(want[s], 6) for s in sorted(want)]}", flush=True)
    if diff:
        fail(f"3i (b): final params: {diff}")
    ops.unregister_kernels()
    return launched


def phase_elastic_cli(torch, strategy_json: str, tmp: str) -> None:
    """(c) The training CLI on the card with 3g's winner: ``--backend spmd
    --elastic`` (the last rank dies at step 4) and ``--backend mpmd
    --chaos`` (``CLI_CHAOS``) with ``--chaos-report``; each must exit 0
    and report every fault recovered."""
    from repro_torch import ft
    from repro_torch.launch import train
    sched, report = pathlib.Path(tmp) / "chaos.json", pathlib.Path(tmp) / "chaos_report.json"
    sched.write_text(ft.FaultSchedule(tuple(ft.FaultEvent(**e) for e in CLI_CHAOS),
                                      seed=5).to_json())
    for backend, extra in (("spmd", ["--elastic"]),
                           ("mpmd", ["--chaos", str(sched), "--chaos-report", str(report)])):
        t0 = time.perf_counter()
        with captured() as out:
            rc = train.main(["--arch", TUNE_CASE["arch"], "--strategy", strategy_json,
                             "--backend", backend, "--ckpt-dir", str(pathlib.Path(tmp) / backend),
                             *extra])
        said = [x for x in out if x.startswith("elastic")]
        print(f"  (c) --backend {backend} {extra[0]}: exit {rc} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in said:
            print(f"      {line}", flush=True)
        if rc != 0 or not any(x.startswith("elastic: recovered from rank 7 loss — world 8->4")
                              for x in said):
            fail(f"3i (c) --backend {backend}: exit {rc}: {out}")
    doc = json.loads(report.read_text())
    if (len(doc["recoveries"]), len(doc["growths"]), doc["numeric_rewinds"],
            doc["corrupt_detected"], doc["final_world"]) != (2, 1, 1, 1, 8):
        fail(f"3i (c): chaos report {doc}")


FAMILIES = [("moe_gmm_wgmma_kernel", "K3 grouped mm"), ("moe_gmm_kernel", "K3 grouped mm"),
            ("flash_fwd_wgmma_kernel", "K2 flash fwd"), ("flash_fwd_wgmma_wide", "K2 flash fwd"),
            ("flash_fwd_fp32", "K2 flash fwd"),
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


def device_kernels(torch, prof, n_steps: int) -> list:
    """(name, device ms per step) of every kernel a ``torch.profiler``
    run recorded: the raw device events, since prof.events() would build
    a Python event tree over every one, minutes for the plain scans'
    launches."""
    return [(e.name(), e.duration_ns() / n_steps / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def phase_profile(torch, train: dict, plain_steps: int = PROFILED_STEPS) -> dict:
    """Where a full-width step's device time goes, continuing a training
    phase's state (taken out of ``train``, so that only the steps' states
    stay alive): with the kernels, then with their plain versions, one
    warm-up step and then steps under ``torch.profiler`` (device activity
    only): PROFILED_STEPS with the kernels, ``plain_steps`` plain (none:
    the plain profile is skipped, as
    for the Mamba paths, whose plain scans launch ~445k kernels a Falcon
    step).  Returns {mode: {step_ms, busy_share, launches}}."""
    from repro_torch.kernels import ops
    state, step_fn, loader = train.pop("state"), train["step_fn"], train["loader"]
    act = [torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for mode, n_steps in (("kernels", PROFILED_STEPS), ("plain", plain_steps)):
        if not n_steps:
            continue
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
        kernels = device_kernels(torch, prof, n_steps)
        busy_ms = sum(ms for _, ms in kernels)
        fam: dict[str, float] = {}
        by_name: dict[str, list] = {}
        for name, ms in kernels:
            fam[_family(name)] = fam.get(_family(name), 0.0) + ms
            rec = by_name.setdefault(name, [0.0, 0])
            rec[0] += ms
            rec[1] += 1
        out[mode] = {"step_ms": step_ms, "busy_share": busy_ms / step_ms,
                     "launches": len(kernels) // n_steps}
        print(f"  {mode}: step {step_ms:.2f} ms (CUDA events, profiled), device busy "
              f"{busy_ms:.2f} ms/step = {busy_ms / step_ms:.1%} of the step, "
              f"{len(kernels) // n_steps} kernel launches/step", flush=True)
        for f, ms in sorted(fam.items(), key=lambda kv: -kv[1]):
            print(f"    {f:16s} {ms:8.2f} ms/step  {ms / busy_ms:6.1%}", flush=True)
        print("    top kernels (ms/step, launches/step):", flush=True)
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"    {ms:8.3f} {n // n_steps:5d}  {name[:100]}", flush=True)
    ops.unregister_kernels()
    return out


ROUTE_REPS = 10


def ssd_scan_profile(torch, cfg) -> None:
    """One Mamba-2 layer's SSD scan alone at the path's shape (BATCH x SEQ
    tokens, the config's heads, head dim and state) and dtypes, plain
    (``_ssd_scan``) and through K4 and K4-bwd (``ops.ssd_scan``): a
    forward without autograd, and a forward with its backward (the plain
    scan recomputes each checkpointed chunk there; the route runs K4
    saving its chunk states, then K4-bwd), each timed by the host clock
    after a warm-up and again under ``torch.profiler`` for its launches
    and device time, once plain and as the mean of ``ROUTE_REPS`` calls
    through K4 (a few-millisecond window under the profiler lost its
    device events).  A step with remat "full" runs the first
    once and the second once per layer (the group's first forward, then
    its recompute and the backward), so the scan's share of a step is
    their sum times the layers."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import _ssd_scan
    g = torch.Generator(device="cuda").manual_seed(99)
    h, p_ = cfg.ssm.expand * cfg.d_model // cfg.ssm.headdim, cfg.ssm.headdim

    def randn(shape, scale=1.0, dtype=torch.float32):
        t = torch.randn(shape, generator=g, device="cuda") * scale
        return t.to(dtype).requires_grad_(True)
    x = randn((BATCH, SEQ, h, p_), 0.5, cfg.tdtype)
    dt = torch.nn.functional.softplus(randn((BATCH, SEQ, h))).detach().requires_grad_(True)
    A = (-torch.exp(randn((h,), 0.2))).detach().requires_grad_(True)
    B, C = (randn((BATCH, SEQ, cfg.ssm.state), 0.5, cfg.tdtype) for _ in range(2))
    D = torch.ones((h,), device="cuda", requires_grad=True)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(cfg.tdtype)

    for label, scan, reps in (("plain SSD scan", _ssd_scan, 1),
                              ("SSD scan through K4", ops.ssd_scan, ROUTE_REPS)):
        def forward(scan=scan):
            with torch.no_grad():
                scan(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)

        def forward_backward(scan=scan):
            y, _ = scan(x, dt, A, B, C, D, chunk=cfg.ssm_chunk)
            torch.autograd.grad(y, [x, dt, A, B, C, D], dy)

        per_layer = {}
        for name, fn in (("forward", forward), ("forward+backward", forward_backward)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            kernels = device_kernels(torch, prof, reps)
            busy = sum(ms for _, ms in kernels)
            per_layer[name] = (len(kernels) / reps, busy, wall)
            print(f"  {label} {name}, one layer {(BATCH, SEQ, h, p_, cfg.ssm.state)}: "
                  f"{len(kernels) / reps:g} launches, device {busy:.2f} ms (profiled), wall "
                  f"{wall * 1e3:.1f} ms (unprofiled)", flush=True)
        n, busy, wall = (sum(v[i] for v in per_layer.values()) * cfg.n_layers for i in range(3))
        print(f"  {label}'s share of a step at {cfg.n_layers} layers: {int(n)} launches, "
              f"device {busy:.1f} ms, wall {wall:.1f} s", flush=True)


# bf16 K2 shapes timed against another checkout (``--k2-against``)
# the serving phase (3m): the port's init_cache, prefill and decode_step
# on the card, all in bf16 under inference mode with BATCH sequences.
# (a) qwen3-1b whole at its published widths: a prefill of SERVE_PROMPT
# tokens, then SERVE_TOKENS greedy decode steps in a cache of SERVE_PROMPT +
# SERVE_TOKENS positions, with the kernels and then with their plain
# versions fed the kernel run's tokens; (b) decode from an empty cache,
# teacher-forced over INCREMENTAL_TOKENS prompt tokens, against the
# training forward (in bf16 at full depth, in fp32 at FP32_LAYERS); (c) the
# other families' decode branches at published widths, each at its
# training phase's depth, SERVE_FAMILY_TOKENS steps each; (d)
# examples/serve_torch.py at its defaults.
SERVE_PROMPT = SEQ
SERVE_TOKENS = 32
SERVE_FAMILY_TOKENS = 8
INCREMENTAL_TOKENS = 64
# relative L2 error of each step's logits (B, 1, vocab): kernels against
# plain versions in bf16 at the training comparison's leaf limit, and
# decode against the forward at it in bf16 and at 1e-5 in fp32 (the two
# differ in the order of fp32 sums only: the decode attention is one
# softmax over the cache, the forward's K2 an online one over key tiles)
SERVE_RTOL = {"bfloat16": PLAIN_RTOL["bfloat16"][1], "float32": 1e-5}


def serve_launches(cfg) -> tuple:
    """(prefill, one decode step) kernel launches, counted from the code:
    under inference mode ``remat="full"`` recomputes nothing.  A decoder
    layer runs two norms and one attention in prefill, two norms and no
    K2 in decode (its attention is ``decode_attention``); a Whisper
    decoder layer three norms and two attentions (one in decode: none);
    a Mamba layer one norm and one scan (K4, Mamba-1's or Mamba-2's SSD
    scan); Zamba2's shared block two norms and one attention per group;
    an MoE layer three (or, without SwiGLU, two) grouped matmuls; one
    final norm."""
    if cfg.hybrid_every:
        groups = cfg.n_layers // cfg.hybrid_every
        k1 = cfg.n_layers + 2 * groups + 1
        return ({"rmsnorm": k1, "flash_attention": groups, "mamba_scan": cfg.n_layers},
                {"rmsnorm": k1, "mamba_scan": cfg.n_layers})
    if cfg.ssm:
        per = {"rmsnorm": cfg.n_layers + 1, "mamba_scan": cfg.n_layers}
        return per, dict(per)
    if cfg.n_enc_layers:
        enc, dec = cfg.n_enc_layers, cfg.n_layers
        return ({"rmsnorm": 2 * enc + 3 * dec + 1, "flash_attention": enc + 2 * dec},
                {"rmsnorm": 3 * dec + 1})
    k1 = 2 * cfg.n_layers + 1
    prefill, step = {"rmsnorm": k1, "flash_attention": cfg.n_layers}, {"rmsnorm": k1}
    if cfg.moe:
        prefill["moe_gmm"] = step["moe_gmm"] = (3 if cfg.act == "swiglu" else 2) * cfg.n_layers
    return prefill, step


def serve_inputs(torch, cfg, prompt: int) -> dict:
    """A served batch: BATCH prompts of ``prompt`` tokens (seed 17), with
    (BATCH, enc_seq, d_model) bf16 frames for the encoder-decoder and
    Qwen2-VL's image-layout positions for the VLM."""
    g = torch.Generator(device="cuda").manual_seed(17)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, prompt), generator=g, device="cuda")}
    if cfg.n_enc_layers:
        batch["frames"] = torch.randn((BATCH, cfg.enc_seq, cfg.d_model), generator=g,
                                      device="cuda").to(torch.bfloat16)
    if cfg.mrope:
        batch["mrope_positions"] = torch.from_numpy(
            image_positions(BATCH, prompt, IMAGE_GRID, IMAGE_PREFIXES)).cuda()
    return batch


def serve_run(torch, cfg, params, batch: dict, n_steps: int, forced=None) -> dict:
    """``prefill`` over the batch, then ``n_steps`` decode steps, greedy or
    fed ``forced`` (a list of (BATCH, 1) tokens), in a cache of prompt +
    n_steps positions, under inference mode.  Returns every logits
    (prefill's first), the tokens fed, the last step's inputs, each part's
    seconds by the host clock around synchronised work, each part's
    kernel launches (counts set to 0 just before it) and the decode
    steps' peak (``max_memory_allocated``, reset after prefill)."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, prefill
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, params, batch, max_seq=batch["tokens"].shape[1] + n_steps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_launches = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out, fed = [logits], []
        for i in range(n_steps):
            tok = logits[:, -1].argmax(-1).reshape(-1, 1) if forced is None else forced[i]
            last = (tok, cache)
            logits, cache = decode_step(cfg, params, tok, cache)
            out.append(logits)
            fed.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        decode_launches = ops.launch_counts()
    return {"logits": out, "fed": fed, "last": last, "cache": cache, "prefill_s": t1 - t0,
            "decode_s": t2 - t1, "prefill_launches": prefill_launches,
            "decode_launches": decode_launches,
            "decode_peak": torch.cuda.max_memory_allocated()}


def check_serve_launches(label: str, run: dict, cfg, n_steps: int, none: dict) -> dict:
    """A kernel run's launches held to ``serve_launches``, exactly."""
    prefill, step = serve_launches(cfg)
    want = {"prefill": {**none, **prefill},
            "decode": {**none, **{k: v * n_steps for k, v in step.items()}}}
    got = {"prefill": run["prefill_launches"], "decode": run["decode_launches"]}
    print(f"  {label}: launches {got}, expected {want}", flush=True)
    if got != want:
        fail(f"{label}: kernel launches {got} != {want}")
    return got


def check_served(torch, label: str, kernel: dict, plain: dict, dtype: str) -> dict:
    """Each step's logits of a kernel run against a plain run fed its
    tokens: relative L2 error per step within SERVE_RTOL; the greedy
    tokens on which both agree are counted."""
    errs = [rel_l2(k, p) for k, p in zip(kernel["logits"], plain["logits"])]
    max_abs = max((k.float() - p.float()).abs().max().item()
                  for k, p in zip(kernel["logits"], plain["logits"]))
    agree = sum(int((k[:, -1].argmax(-1) == p[:, -1].argmax(-1)).sum())
                for k, p in zip(kernel["logits"], plain["logits"]))
    total = len(errs) * BATCH
    limit = SERVE_RTOL[dtype]
    print(f"  {label}: kernels against their plain versions fed the kernel run's tokens: "
          f"logits relative L2 error, prefill {errs[0]:.3e}, decode steps max "
          f"{max(errs[1:]):.3e} (limit {limit}); max abs err {max_abs:.3e}; greedy tokens "
          f"agreeing {agree} of {total}", flush=True)
    if not all(math.isfinite(e) for e in errs) or max(errs) > limit:
        fail(f"{label}: kernel and plain logits disagree: {max(errs):.3e} > {limit}")
    return {"max_rel_l2": max(errs), "max_abs_err": max_abs, "greedy_agree": agree,
            "greedy_total": total}


def check_incremental(torch, label: str, cfg, params, tokens) -> float:
    """``decode_step`` from ``init_cache``, teacher-forced over ``tokens``,
    against the training forward's logits at every position: the relative
    L2 error over all of them within SERVE_RTOL of the config's dtype."""
    from repro_torch.models import decode_step, init_cache
    from repro_torch.models.model import _logits, _run_decoder
    with torch.inference_mode():
        want = _logits(cfg, params, _run_decoder(cfg, params, params["embed"][tokens])[0])
        cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cuda")
        got = []
        for t in range(tokens.shape[1]):
            logits, cache = decode_step(cfg, params, tokens[:, t:t + 1], cache)
            got.append(logits)
        got = torch.cat(got, dim=1)
    err = rel_l2(got, want)
    worst = max(rel_l2(got[:, t], want[:, t]) for t in range(tokens.shape[1]))
    limit = SERVE_RTOL[cfg.dtype]
    print(f"  {label}: decode from an empty cache over {tokens.shape[1]} tokens against the "
          f"forward, {cfg.dtype} at {cfg.n_layers} layers: logits relative L2 error {err:.3e} "
          f"(worst position {worst:.3e}; limit {limit}), max abs err "
          f"{(got.float() - want.float()).abs().max().item():.3e}", flush=True)
    if not math.isfinite(err) or err > limit:
        fail(f"{label}: incremental decode and forward disagree: {err:.3e} > {limit}")
    return err


def phase_serve_qwen3(torch, cfg, none: dict) -> tuple:
    """(a) and (b) for one of the paper's Qwen3 models whole (qwen3-1b,
    then qwen3-9b): a warm-up run, then the timed kernel run (launches
    exact, peak memory, cache bytes, one decode step profiled), the plain
    run fed its tokens, and decode against the forward.  Returns ({path:
    launches}, the summary)."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = serve_inputs(torch, cfg, SERVE_PROMPT)
    ops.register_kernels()
    serve_run(torch, cfg, params, batch, SERVE_TOKENS)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    k = serve_run(torch, cfg, params, batch, SERVE_TOKENS)
    peak = torch.cuda.max_memory_allocated()
    launches = check_serve_launches(f"(a) {cfg.name}", k, cfg, SERVE_TOKENS, none)
    cache_bytes = sum(t.numel() * t.element_size() for t in k["cache"].values())
    tok, cache = k["last"]
    with torch.inference_mode():
        prof = step_profile(torch, "decode step (kernels)",
                            lambda: decode_step(cfg, params, tok, cache))
    ops.unregister_kernels()
    p = serve_run(torch, cfg, params, batch, SERVE_TOKENS, forced=k["fed"])
    if any(p["prefill_launches"].values()) or any(p["decode_launches"].values()):
        fail(f"(a) plain run launched kernels: {p['prefill_launches']} {p['decode_launches']}")
    served = check_served(torch, f"(a) {cfg.name}", k, p, cfg.dtype)
    summary = {"prefill_ms": k["prefill_s"] * 1e3,
               "decode_ms_per_token": k["decode_s"] / SERVE_TOKENS * 1e3,
               "tokens_per_s": BATCH * SERVE_TOKENS / k["decode_s"],
               "decode_step_busy_share": prof["busy_share"],
               "decode_step_profiled_ms": prof["ms"], "decode_step_launches": prof["launches"],
               "cache_bytes": cache_bytes, "peak_gib": peak / 2**30,
               "plain_prefill_ms": p["prefill_s"] * 1e3,
               "plain_decode_ms_per_token": p["decode_s"] / SERVE_TOKENS * 1e3, **served}
    print(f"  (a) {cfg.name}, {cfg.n_layers} layers, batch {BATCH}: prefill of {SERVE_PROMPT} "
          f"tokens {summary['prefill_ms']:.1f} ms (plain {summary['plain_prefill_ms']:.1f}); "
          f"decode {summary['decode_ms_per_token']:.2f} ms a token (plain "
          f"{summary['plain_decode_ms_per_token']:.2f}), {summary['tokens_per_s']:.1f} "
          f"tokens/s; "
          f"cache {cache_bytes / 1e9:.3f} GB; peak {summary['peak_gib']:.2f} GiB "
          f"(max_memory_allocated)", flush=True)
    del k, p, cache, tok
    ops.register_kernels()
    check_incremental(torch, "(b)", cfg, params, batch["tokens"][:, :INCREMENTAL_TOKENS])
    del params
    cfg32 = dataclasses.replace(cfg, n_layers=FP32_LAYERS, dtype="float32")
    check_incremental(torch, "(b)", cfg32,
                      init(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda"),
                      batch["tokens"][:, :INCREMENTAL_TOKENS])
    ops.unregister_kernels()
    paths = {f"3m {cfg.name} prefill": launches["prefill"],
             f"3m {cfg.name} decode, {SERVE_TOKENS} steps": launches["decode"]}
    return paths, summary


def phase_serve_family(torch, cfg, none: dict, incremental: bool) -> dict:
    """(c) one family's serving path: prefill (Whisper's decoder prompt
    leaves room for the steps in its 448 positions), SERVE_FAMILY_TOKENS
    greedy steps with the kernels (launches exact), the plain run fed its
    tokens (for an MoE, routed as the kernel run: see ``PLAIN_RTOL``), and,
    where the property holds, decode against the forward."""
    from repro_torch.kernels import ops
    from repro_torch.models import init
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt = WHISPER_SEQ - SERVE_FAMILY_TOKENS if cfg.n_enc_layers else SERVE_PROMPT
    batch = serve_inputs(torch, cfg, prompt)
    enc = f"{cfg.n_enc_layers} + " if cfg.n_enc_layers else ""
    label = f"(c) {cfg.name}, {enc}{cfg.n_layers} layers, prompt {prompt}"
    ops.register_kernels()
    with recorded_routing() as routes:
        k = serve_run(torch, cfg, params, batch, SERVE_FAMILY_TOKENS)
    launches = check_serve_launches(label, k, cfg, SERVE_FAMILY_TOKENS, none)
    ops.unregister_kernels()
    with recorded_routing(routes if cfg.moe else None) as plain_routes:
        p = serve_run(torch, cfg, params, batch, SERVE_FAMILY_TOKENS, forced=k["fed"])
    if cfg.moe:
        print(f"  {label}: routing choices the plain run would make otherwise, per router "
              f"call (prefill's layers, then each step's): "
              f"{routing_diffs(routes, plain_routes)}", flush=True)
    check_served(torch, label, k, p, cfg.dtype)
    print(f"  {label}: prefill {k['prefill_s'] * 1e3:.1f} ms, decode "
          f"{k['decode_s'] / SERVE_FAMILY_TOKENS * 1e3:.2f} ms a token (plain "
          f"{p['prefill_s'] * 1e3:.1f} and {p['decode_s'] / SERVE_FAMILY_TOKENS * 1e3:.2f})",
          flush=True)
    del k, p
    if incremental:
        ops.register_kernels()
        check_incremental(torch, label, cfg, params, batch["tokens"][:, :INCREMENTAL_TOKENS])
        ops.unregister_kernels()
    return {f"3m {cfg.name} prefill": launches["prefill"],
            f"3m {cfg.name} decode, {SERVE_FAMILY_TOKENS} steps": launches["decode"]}


def phase_serve_example(torch, none: dict) -> dict:
    """(d) ``examples/serve_torch.py`` at its defaults (the reduced
    qwen1.5-0.5b on the card, kernels registered), called as its
    ``main``; its four lines are printed and its launches held exact."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    sys.path.insert(0, str(ROOT / "examples"))
    import serve_torch
    buf = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        gen = serve_torch.main([])
    launched = ops.launch_counts()
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"  (d) {line}", flush=True)
    prefill, step = serve_launches(get_config("qwen1.5-0.5b").reduced())
    want = {**none, **{k: prefill.get(k, 0) + 15 * step.get(k, 0) for k in prefill}}
    if len(lines) != 4 or tuple(gen.shape) != (4, 16) or launched != want:
        fail(f"(d) serve_torch.py: {len(lines)} lines, ids {tuple(gen.shape)}, launches "
             f"{launched} (expected {want})")
    return {"3m examples/serve_torch.py": launched}


K2_AB = [(BATCH, 16, SEQ, 64), (BATCH, 16, SEQ, 128)]


# the production SPMD lane (phase 3n): a one-rank world on a (1, 1)
# ("data", "model") mesh; NCCL refuses two ranks on one card, so the
# multi-rank worlds run on the CPU (tests/test_torch_production.py)
SHARDED_MESH = ((1, 1), ("data", "model"))
SHARDED_STEPS = 5
SHARDED_LR = 3e-4
SHARDED_DECODE = 8


@contextlib.contextmanager
def one_rank_world(torch):
    """A one-rank NCCL process group at a free localhost port, destroyed
    on the way out; a failure to start it fails the phase."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def same_tree_bits(torch, got: dict, want: dict, what: str) -> None:
    """Every leaf of two trees of host tensors equal bit for bit."""
    from repro_torch.tree import tree_flatten_with_path
    g, w = dict(tree_flatten_with_path(got)), dict(tree_flatten_with_path(want))
    if g.keys() != w.keys():
        fail(f"{what}: leaves differ: {sorted(g)} != {sorted(w)}")
    bad = [path for path in w if g[path].dtype != w[path].dtype
           or g[path].shape != w[path].shape
           or not torch.equal(g[path].reshape(-1).view(torch.uint8),
                              w[path].reshape(-1).view(torch.uint8))]
    if bad:
        worst = max(bad, key=lambda p: (g[p].float() - w[p].float()).abs().max().item())
        fail(f"{what}: {len(bad)} of {len(w)} leaves differ in their bits, e.g. "
             f"{'/'.join(worst)} by {(g[worst].float() - w[worst].float()).abs().max().item():.3e}")


def host(torch, tree):
    """A tree's local tensors (a DTensor's shard: on one rank the whole)
    copied to the host."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: (t.to_local() if hasattr(t, "to_local") else t).detach().cpu(),
                    tree)


def sharded_loss_grads(torch, cfg, fn, params, batch, replay=None) -> tuple:
    """Loss and every gradient leaf (host) of ``train_loss`` on the
    sharded step's placed params and batch, under its axis map, with the
    router calls recorded (or replaying ``replay``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.steps import axis_map, place_tree
    from repro_torch.models import train_loss
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    p = place_tree(params, fn.in_shardings[0]["params"])
    b = place_tree(batch, fn.in_shardings[1])
    p = tree_map(lambda t: t.detach().requires_grad_(True), p)
    with recorded_routing(replay) as calls, axis_map(fn.mesh, fn.strat), implicit_replication():
        loss = train_loss(cfg, p, b)
        grads = torch.autograd.grad(loss, tree_leaves(p))
    return (loss.to_local().item(), host(torch, tree_unflatten(p, list(grads))),
            [c.clone() for c in calls])


def phase_sharded_train(torch, cfg, none: dict, step_3c: float, peak_3c: int,
                        per_step: dict | None = None, ref_phase: str = "3c",
                        strategy_kw: dict | None = None, tag: str = "(a)",
                        path: str = "3n", checked: bool = True) -> tuple:
    """(a) ``cfg`` (DeepSeek-MoE-16B at DEEPSEEK_LAYERS layers, bf16,
    remat "full") through ``sharded_train_step`` on the one-rank mesh:
    ZeRO-3 rules with ``moe_impl="a2a"`` from ``strategy_for``, so
    ``_moe_dispatch`` takes ``moe_block_ep`` and K3 computes its experts.
    SHARDED_STEPS steps from seed 0's weights with exact launches; the
    first step's loss and every new leaf (params, m, v) bit-equal to
    ``build_step`` on local tensors under the same axis map, each run from
    one host snapshot, one after the other; the loss and every gradient
    leaf with the kernels against their plain versions routed alike
    (PLAIN_RTOL); the median sharded step beside the median of the local
    steps (their difference is DTensor's dispatch), a profiled step's
    busy share, and the peak beside phase 3c's.  Phase 3o(a) runs
    Falcon-Mamba-7B so (``per_step`` its launches a step, ``ref_phase``
    the phase whose step and peak it prints beside its own, ``strategy_kw``
    the rules' options).  Without ``checked`` the profiled step and the
    comparison with the plain versions are left out (the grouped MoE's run,
    whose kernels the all-to-all run holds to their plain versions).
    Returns (launches, summary)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import axis_map, local_bytes, sharded_train_step, strategy_for
    from repro_torch.launch.train import build_step
    from repro_torch.models import init
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    mesh = make_mesh(*SHARDED_MESH, device_type="cuda")
    strat = strategy_for(mesh, zero_stage=3,
                         **(strategy_kw if strategy_kw is not None else {"moe_impl": "a2a"}))
    snapshot = host(torch, init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"))
    first = path_loader(torch, cfg).next_batch()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in first.items()}   # int32

    def fresh():
        params = tree_map(lambda t: t.cuda(), snapshot)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device="cuda")}

    def meta(tree):
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    state = fresh()
    fn, _ = sharded_train_step(cfg, mesh, strat, lr=SHARDED_LR, state_avals=meta(state),
                               batch_avals=meta(batch))
    placed = fn.place(state, batch)
    arg_bytes = local_bytes(placed[0]) + local_bytes(placed[1])
    del placed
    print(f"  {tag} {cfg.name}, {cfg.n_layers} layers, bf16, batch {BATCH} x {SEQ}, remat "
          f"{cfg.remat}, mesh {SHARDED_MESH}: {strat}; placed state and batch {arg_bytes} B",
          flush=True)
    ops.register_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times, out = [], None
    for i in range(SHARDED_STEPS):
        t0 = time.perf_counter()
        state, met = fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            out = host(torch, {"loss": met["loss"], "params": state["params"],
                               "m": state["opt"]["m"], "v": state["opt"]["v"]})
        if not math.isfinite(met["loss"].to_local().item()):
            fail(f"{tag} step {i}: loss {met['loss'].to_local().item()}")
    launched = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    if per_step is None:
        per_step = {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L, "moe_gmm": 6 * L,
                    "moe_gmm_bwd": 6 * L}
    want = {**none, **{k: v * SHARDED_STEPS for k, v in per_step.items()}}
    print(f"  {tag} launches over {SHARDED_STEPS} steps {launched}, expected {want}",
          flush=True)
    if launched != want:
        fail(f"{tag} kernel launches {launched} != {want}")
    prof = step_profile(torch, f"sharded step {tag}", lambda: fn(state, batch)) if checked \
        else {"busy_share": None, "ms": None, "launches": None}
    del state, met
    gc.collect()
    torch.cuda.empty_cache()
    # the same step functions on local tensors, from the same snapshot,
    # timed as the sharded steps: the difference is DTensor's dispatch
    local, ref, local_times = fresh(), None, []
    step = build_step(cfg, lambda step: SHARDED_LR, "cuda")
    with axis_map(mesh, strat):
        for i in range(SHARDED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            local, lmet = step(local, batch)
            torch.cuda.synchronize()
            local_times.append(time.perf_counter() - t0)
            if i == 0:
                ref = host(torch, {"loss": lmet["loss"], "params": local["params"],
                                   "m": local["opt"]["m"], "v": local["opt"]["v"]})
    del local, lmet
    gc.collect()
    torch.cuda.empty_cache()
    same_tree_bits(torch, out, ref, f"{tag} sharded step against build_step on local tensors")
    print(f"  {tag} the first sharded step: loss {out['loss'].item():.6f} and every new leaf "
          f"(params, m, v) bit-equal to build_step on local tensors under the same axis map",
          flush=True)
    loss_err = worst_err = None
    if checked:
        loss_err, worst_err = sharded_against_plain(torch, cfg, fn, snapshot, batch, tag)
    step_s = statistics.median(times[1:])
    local_s = statistics.median(local_times[1:])
    summary = {"step_ms": step_s * 1e3, "steps_ms": [t * 1e3 for t in times],
               "local_step_ms": local_s * 1e3, "local_steps_ms": [t * 1e3 for t in local_times],
               "dispatch_ms": (step_s - local_s) * 1e3,
               "ref": ref_phase, "step_3c_ms": step_3c * 1e3, "busy_share": prof["busy_share"],
               "profiled_ms": prof["ms"], "profiled_launches": prof["launches"],
               "peak_gib": peak / 2**30, "peak_3c_gib": peak_3c / 2**30,
               "arg_bytes": arg_bytes, "loss_rel_err_plain": loss_err,
               "worst_leaf_rel_l2_plain": worst_err}
    print(f"  {tag} sharded step median {step_s * 1e3:.1f} ms over steps 2-{SHARDED_STEPS}, "
          f"the same step functions on local tensors {local_s * 1e3:.1f} ms (steps "
          f"{', '.join(f'{t * 1e3:.1f}' for t in local_times)}): DTensor's "
          f"dispatch costs {(step_s - local_s) * 1e3:.1f} ms of host; "
          f"{BATCH * SEQ / step_s:.0f} tokens/s, "
          + (f"busy {prof['busy_share']:.1%} of a profiled step, " if checked else "")
          + f"peak {peak / 2**30:.2f} GiB (phase {ref_phase} on local tensors: step "
          f"{step_3c * 1e3:.1f} ms, peak {peak_3c / 2**30:.2f} GiB)", flush=True)
    ops.unregister_kernels()
    return {f"{path} {cfg.name} sharded train, {SHARDED_STEPS} steps": launched}, summary


def sharded_against_plain(torch, cfg, fn, snapshot, batch, tag: str) -> tuple:
    """The loss and every gradient leaf on the sharded path with the
    kernels against their plain versions, routed as the kernel run: each
    within PLAIN_RTOL.  Returns (the loss's relative error, the worst
    leaf's relative L2 error)."""
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_flatten_with_path, tree_map
    params = tree_map(lambda t: t.cuda(), snapshot)
    loss_k, grads_k, route = sharded_loss_grads(torch, cfg, fn, params, batch)
    ops.unregister_kernels()
    loss_p, grads_p, _ = sharded_loss_grads(torch, cfg, fn, params, batch, replay=route)
    del params
    loss_rtol, grad_rtol = PLAIN_RTOL[cfg.dtype]
    gp = dict(tree_flatten_with_path(grads_p))
    errs = {"/".join(path): rel_l2(g, gp[path]) for path, g in tree_flatten_with_path(grads_k)}
    worst = max(errs, key=errs.get)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"  {tag} kernels against plain versions on the sharded path, routed alike: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.3e}, limit {loss_rtol}); worst leaf "
          f"{worst} {errs[worst]:.3e} (limit {grad_rtol}) over {len(errs)} leaves", flush=True)
    if loss_err > loss_rtol or not all(math.isfinite(e) for e in errs.values()) \
            or errs[worst] > grad_rtol:
        fail(f"{tag} kernels and plain versions disagree: loss {loss_err:.3e}, "
             f"{worst} {errs[worst]:.3e}")
    return loss_err, errs[worst]


def phase_sharded_serve(torch, cfg, none: dict) -> tuple:
    """(b) ``cfg`` (Qwen3-1.7B whole, bf16) through ``sharded_prefill_step``
    over phase 3m's prompt and SHARDED_DECODE greedy
    ``sharded_decode_step``s on the one-rank mesh, launches exact; every
    logits and every cache leaf bit-equal to phase 3m's functions
    (``serve_run``) on local tensors fed the same tokens.  The decode
    steps consume their cache: each leaf must stay in the caller's buffer
    (its ``data_ptr``) with new contents.  The same steps on a copy of the
    prefilled cache through a step that does not donate it (a new cache a
    step, as before the cache was written in place), fed the same tokens,
    give the same logits; the ms a token and the decode peak
    (``max_memory_allocated``) of both print beside the local path's."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import prefill_cache_specs
    from repro_torch.launch.steps import (place_tree, sharded_decode_step, sharded_prefill_step,
                                          strategy_for)
    from repro_torch.models import init
    from repro_torch.tree import tree_map
    mesh = make_mesh(*SHARDED_MESH, device_type="cuda")
    strat = strategy_for(mesh, zero_stage=3)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = serve_inputs(torch, cfg, SERVE_PROMPT)
    max_seq = SERVE_PROMPT + SHARDED_DECODE

    def meta(tree):
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    pfn, _ = sharded_prefill_step(cfg, mesh, strat, batch_avals=meta(batch), max_seq=max_seq)
    dfn, _ = sharded_decode_step(cfg, mesh, strat,
                                 cache_avals=prefill_cache_specs(cfg, BATCH, max_seq),
                                 batch_avals={"token": torch.empty((BATCH, 1), dtype=torch.int64,
                                                                   device="meta")})
    copying, _ = sharded_decode_step(cfg, mesh, strat,
                                     cache_avals=prefill_cache_specs(cfg, BATCH, max_seq),
                                     batch_avals={"token": torch.empty(
                                         (BATCH, 1), dtype=torch.int64, device="meta")},
                                     donate=False)
    placed, _ = pfn.place(params, batch)
    ops.register_kernels()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = pfn(placed, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill_launches = ops.launch_counts()
    before = host(torch, cache)
    buffers = {k: t.to_local().data_ptr() for k, t in cache.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    td = time.perf_counter()
    ops.reset_launch_counts()
    outs, fed = [host(torch, logits)], []
    for _ in range(SHARDED_DECODE):
        tok = logits.to_local()[:, -1].argmax(-1).reshape(-1, 1)
        logits, cache = dfn(placed, cache, {"token": tok})
        outs.append(host(torch, logits))
        fed.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    decode_launches = ops.launch_counts()
    decode_peak = torch.cuda.max_memory_allocated()
    moved = [k for k, ptr in buffers.items() if cache[k].to_local().data_ptr() != ptr]
    sharded_cache = host(torch, cache)
    same = [k for k in before if torch.equal(before[k], sharded_cache[k])]
    print(f"  (b) the decode steps wrote the caller's cache in place: every leaf's data_ptr "
          f"kept ({len(buffers) - len(moved)} of {len(buffers)}), contents changed in "
          f"{len(before) - len(same)} of {len(before)} (len {before['len'].item()} -> "
          f"{sharded_cache['len'].item()})", flush=True)
    if moved or same:
        fail(f"(b) the donated cache was not written in place: moved {moved}, unchanged {same}")
    del logits, cache
    gc.collect()
    # the donated step and one that copies its cache, in turns (copying,
    # donated, donated, copying), each from the prefilled cache placed
    # anew and fed the same tokens: ms a step (steps 2 on) and the peak
    turns = {"donated": [], "copying": []}
    peaks = dict.fromkeys(turns, 0)
    for name in ("copying", "donated", "donated", "copying"):
        fn = dfn if name == "donated" else copying
        c = place_tree(tree_map(lambda t: t.cuda(), before), dfn.in_shardings[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = []
        for i, tok in enumerate(fed):
            t3 = time.perf_counter()
            clogits, c = fn(placed, c, {"token": tok})
            torch.cuda.synchronize()
            if i:
                turns[name].append(time.perf_counter() - t3)
            got.append(host(torch, clogits))
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
        same_tree_bits(torch, {str(i): t for i, t in enumerate(got)},
                       {str(i): t for i, t in enumerate(outs[1:])},
                       f"(b) the {name} decode steps in turn against the first run")
        del c, clogits
    del before
    prefill, step = serve_launches(cfg)
    want = {"prefill": {**none, **prefill},
            "decode": {**none, **{k: v * SHARDED_DECODE for k, v in step.items()}}}
    got = {"prefill": prefill_launches, "decode": decode_launches}
    print(f"  (b) {cfg.name}: launches {got}, expected {want}", flush=True)
    if got != want:
        fail(f"(b) kernel launches {got} != {want}")
    del placed
    gc.collect()
    ref = serve_run(torch, cfg, params, batch, SHARDED_DECODE, forced=fed)
    ops.unregister_kernels()
    same_tree_bits(torch, {str(i): t for i, t in enumerate(outs)},
                   {str(i): t.cpu() for i, t in enumerate(ref["logits"])},
                   "(b) sharded logits against phase 3m's functions")
    same_tree_bits(torch, sharded_cache, host(torch, ref["cache"]),
                   "(b) sharded cache against phase 3m's functions")
    summary = {"prefill_ms": (t1 - t0) * 1e3, "decode_ms_per_token":
               (t2 - td) / SHARDED_DECODE * 1e3, "local_prefill_ms": ref["prefill_s"] * 1e3,
               "local_decode_ms_per_token": ref["decode_s"] / SHARDED_DECODE * 1e3,
               "decode_peak_gib": decode_peak / 2**30,
               "local_decode_peak_gib": ref["decode_peak"] / 2**30,
               **{f"{k}_step_ms_median": statistics.median(v) * 1e3 for k, v in turns.items()},
               **{f"{k}_peak_gib": v / 2**30 for k, v in peaks.items()}}
    print(f"  (b) {cfg.name}, {cfg.n_layers} layers, batch {BATCH}: prefill of {SERVE_PROMPT} "
          f"tokens and {SHARDED_DECODE} greedy decode steps through the sharded steps, every "
          f"logits and cache leaf bit-equal to phase 3m's functions fed the same tokens; "
          f"prefill {summary['prefill_ms']:.1f} ms (local {summary['local_prefill_ms']:.1f}), "
          f"decode {summary['decode_ms_per_token']:.2f} ms a token (local "
          f"{summary['local_decode_ms_per_token']:.2f}), peak {summary['decode_peak_gib']:.2f} "
          f"GiB (local {summary['local_decode_peak_gib']:.2f}); in turns, median step "
          f"{summary['donated_step_ms_median']:.2f} ms and peak "
          f"{summary['donated_peak_gib']:.2f} GiB with the cache written in place, "
          f"{summary['copying_step_ms_median']:.2f} ms and {summary['copying_peak_gib']:.2f} "
          f"GiB copying it", flush=True)
    del ref, params
    return {f"3n {cfg.name} sharded prefill": prefill_launches,
            f"3n {cfg.name} sharded decode, {SHARDED_DECODE} steps": decode_launches}, summary


def one_rank_cell(cfg, moe: str = "grouped") -> list:
    """The dry run's command line for ``cfg``'s cell cut to one card, as
    the sharded training phases run it."""
    return ["--arch", cfg.name, "--shape", "train_4k", "--mesh", "single", "--layers",
            str(cfg.n_layers), "--batch", str(BATCH), "--seq", str(SEQ), "--loss-chunk",
            str(cfg.loss_chunk), "--moe", moe, "--remat", cfg.remat]


def dryrun_cells(deepseek) -> list:
    """(c) the dry run's two cells: (a)'s on the one-rank mesh, and
    qwen3-1b ``train_4k`` on ``pod1``; each a ``python -m
    repro_torch.launch.dryrun`` command line."""
    return [one_rank_cell(deepseek, "a2a"),
            ["--arch", "qwen3-1b", "--shape", "train_4k", "--mesh", "pod1"]]


def start_dryruns(cells: list) -> list:
    """Dry-run cells started in subprocesses at once (each its own fake
    world, meta tensors, no device work): [(cell, start, process)]."""
    out = ROOT / "build" / "dryrun_torch_smoke"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for cell in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *cell, "--device", "cuda",
               "--out", str(out), "--force"]
        procs.append((cell, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)))
    return procs


def run_dryruns(cells, tag: str, timeout: float = 600.0) -> list:
    """Dry-run cells (command lines, or ``start_dryruns``' processes)
    each within ``timeout`` seconds of its start (the phase fails
    otherwise); every cell's memory per device, FLOPs, collective bytes
    by kind, roofline terms and seconds print.  Returns the cells'
    records, each with its wall seconds."""
    procs = cells if cells and isinstance(cells[0], tuple) else start_dryruns(cells)
    res = []
    for cell, t0, proc in procs:
        left = max(timeout - (time.perf_counter() - t0), 1.0)
        try:
            stdout, stderr = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for _, _, other in procs:
                other.kill()
                other.communicate()
            fail(f"{tag} dry run {cell} did not end in {timeout:.0f} s")
        wall = time.perf_counter() - t0
        line = [ln for ln in stdout.splitlines() if ln.startswith("DRYRUN ")]
        if proc.returncode or not line:
            fail(f"{tag} dry run {cell} failed ({proc.returncode}): {stdout[-1500:]} "
                 f"{stderr[-3000:]}")
        r = json.loads(line[-1][len("DRYRUN "):])
        r["wall_s"] = wall
        res.append(r)
        print(f"  {tag} dry run {r['arch']} {r['shape']} {r['mesh']} ({r['chips']} ranks): "
              f"memory {r['memory']}, flops {r['flops']:.6e}, collective {r['collective']}, "
              f"roofline {r['roofline']}, step run in {r['run_s']} s, {wall:.1f} s in all",
              flush=True)
    return res


def check_one_rank_cell(one: dict, summary_a: dict, tag: str, peak_rtol=None) -> None:
    """The one-rank cell's ``argument_size_in_bytes`` must equal the
    sharded phase's placed state and batch; its counted peak prints
    beside that phase's ``max_memory_allocated`` (and must lie within
    ``peak_rtol`` of it when given)."""
    got = one["memory"]["argument_size_in_bytes"]
    peak = one["memory"]["peak_bytes"] / 2**30
    print(f"  {tag} one-rank cell: argument_size_in_bytes {got} against the sharded step's "
          f"placed state and batch {summary_a['arg_bytes']}; peak {peak:.2f} GiB counted "
          f"against its max_memory_allocated {summary_a['peak_gib']:.2f} GiB "
          f"({peak / summary_a['peak_gib'] - 1:+.2%})", flush=True)
    if got != summary_a["arg_bytes"]:
        fail(f"{tag} dry-run argument bytes {got} != the sharded step's {summary_a['arg_bytes']}")
    if peak_rtol is not None and abs(peak / summary_a["peak_gib"] - 1) > peak_rtol:
        fail(f"{tag} dry-run peak {peak:.2f} GiB not within {peak_rtol:.0%} of "
             f"{summary_a['peak_gib']:.2f} GiB")


def phase_dryrun(torch, dry: list, summary_a: dict) -> dict:
    """(c) both dry-run cells (``start_dryruns``' processes of
    ``dryrun_cells``, each its own fake world of 1 or 256 ranks): the
    one-rank cell's ``argument_size_in_bytes`` must equal (a)'s placed
    state and batch; its peak prints beside (a)'s
    ``max_memory_allocated``."""
    one, pod = run_dryruns(dry, "(c)")
    check_one_rank_cell(one, summary_a, "(c)")
    return {"single": one, "pod1": pod}


def phase_production(torch, deepseek, qwen3, none: dict, step_3c: float, peak_3c: int) -> tuple:
    """Phase 3n: (a)-(b) in a one-rank NCCL world, destroyed at the end;
    (c)'s dry runs take the host's other cores meanwhile, as 3o's do."""
    t0 = time.perf_counter()
    dry = start_dryruns(dryrun_cells(deepseek))
    try:
        summary, counts = phase_production_steps(torch, deepseek, qwen3, none, step_3c,
                                                 peak_3c)
        summary["c"] = phase_dryrun(torch, dry, summary["a"])
    finally:
        for _, _, proc in dry:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    summary["seconds"] = time.perf_counter() - t0
    print(f"  phase 3n took {summary['seconds']:.1f} s", flush=True)
    return {path: {**none, **launched} for path, launched in counts.items()}, summary


def phase_production_steps(torch, deepseek, qwen3, none: dict, step_3c: float,
                           peak_3c: int) -> tuple:
    """3n (a) and (b): (summaries, launches by path)."""
    with one_rank_world(torch):
        counts, summary = phase_sharded_train(torch, deepseek, none, step_3c, peak_3c)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        grouped, summary_g = phase_sharded_train(
            torch, deepseek, none, step_3c, peak_3c, strategy_kw={"moe_impl": "grouped"},
            tag="(a) grouped", path="3n grouped", checked=False)
        counts.update(grouped)
        summary_g["seconds"] = time.perf_counter() - t1
        print(f"  (a) grouped sharded step median {summary_g['step_ms']:.1f} ms beside the "
              f"all-to-all block's {summary['step_ms']:.1f} ms (local tensors "
              f"{summary_g['local_step_ms']:.1f} and {summary['local_step_ms']:.1f} ms); peak "
              f"{summary_g['peak_gib']:.2f} and {summary['peak_gib']:.2f} GiB; the grouped run "
              f"took {summary_g['seconds']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        served, summary_b = phase_sharded_serve(torch, qwen3, none)
        counts.update(served)
        gc.collect()
        torch.cuda.empty_cache()
    return {"a": summary, "a_grouped": summary_g, "b": summary_b}, counts



# phase 3o: the SSM family through the production SPMD lane, the SSM and
# hybrid dry-run cells, and the ported examples
SSM_POD_CELLS = [["--arch", "zamba2-2.7b", "--shape", "train_4k", "--mesh", "pod1"],
                 ["--arch", "falcon-mamba-7b", "--shape", "prefill_32k", "--mesh", "pod1"]]
SSM_POD_TIMEOUT = 300.0
DRYRUN_PEAK_RTOL = 0.10
QUICKSTART_STEPS = 100


def quickstart_launches(none: dict) -> dict:
    """K1 and K2 launches of ``examples/quickstart_torch.py``: the CLI's
    reduced qwen1.5-0.5b (2 layers at width 128), QUICKSTART_STEPS steps;
    each layer's two norms and attention run again in a "full" remat's
    recompute, the final norm once."""
    from types import SimpleNamespace
    from repro_torch.configs import get_config
    from repro_torch.launch.train import _reduced
    cfg = _reduced(get_config("qwen1.5-0.5b"), SimpleNamespace(layers=2, d_model=128, vocab=512))
    runs = 2 if cfg.remat == "full" else 1
    return {**none, "rmsnorm": (2 * runs * cfg.n_layers + 1) * QUICKSTART_STEPS,
            "flash_attention": runs * cfg.n_layers * QUICKSTART_STEPS}


def run_example_main(name: str, argv: list):
    """``examples/<name>.py``'s ``main(argv)`` with its lines captured;
    returns (its result, the lines)."""
    sys.path.insert(0, str(ROOT / "examples"))
    module = __import__(name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main(argv)
    return result, buf.getvalue().strip().splitlines()


def phase_examples(torch, none: dict) -> tuple:
    """(d) ``examples/quickstart_torch.py`` (the Strategy scored on the
    simulator, then QUICKSTART_STEPS steps of the CLI on the card with the
    kernels registered: K1 and K2 launches exact, the loss falling) and
    ``examples/dualpipe_moe_torch.py`` (three schedules' interpreter
    losses against the unscheduled oracle within 1e-6, on the card), each
    called as its ``main``."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc, lines = run_example_main("quickstart_torch", [])
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    ops.unregister_kernels()
    secs = time.perf_counter() - t0
    for line in lines[:2] + lines[-1:]:
        print(f"  (d) quickstart_torch: {line}", flush=True)
    want = quickstart_launches(none)
    print(f"  (d) quickstart_torch: {secs:.1f} s, launches {launched}, expected {want}",
          flush=True)
    if rc != 0 or launched != want:
        fail(f"(d) quickstart_torch: exit {rc}, launches {launched} (expected {want})")
    t1 = time.perf_counter()
    results, lines = run_example_main("dualpipe_moe_torch", [])
    for line in lines:
        if line:
            print(f"  (d) dualpipe_moe_torch: {line}", flush=True)
    worst = max(abs(loss - oracle) for loss, oracle, _ in results.values())
    print(f"  (d) dualpipe_moe_torch: {len(results)} schedules, worst |loss - oracle| "
          f"{worst:.3e} (limit 1e-6), {time.perf_counter() - t1:.1f} s", flush=True)
    if len(results) != 3 or worst >= 1e-6:
        fail(f"(d) dualpipe_moe_torch: {results}")
    return ({"3o examples/quickstart_torch.py": launched},
            {"quickstart_s": secs, "dualpipe_s": time.perf_counter() - t1,
             "dualpipe_worst_loss_err": worst,
             "makespans_ms": {k: v[2] * 1e3 for k, v in results.items()}})


def phase_production_ssm(torch, falcon, none: dict, step_3b: float, peak_3b: int) -> tuple:
    """Phase 3o: (a) ``falcon`` (Falcon-Mamba-7B at FALCON_LAYERS, as phase
    3b) through ``sharded_train_step`` in a one-rank NCCL world on phase
    3n's (1, 1) mesh with ZeRO-3, K4 and K4-bwd on local shards under
    ``scan_on_shards``, against ``build_step`` on local tensors; (b) the
    dry run of the same cut cell on one rank: its argument bytes equal
    (a)'s placed state and batch, its counted peak within
    DRYRUN_PEAK_RTOL of (a)'s ``max_memory_allocated``; (c) the SSM and
    the hybrid family's pod cells (SSM_POD_CELLS) at once, each within
    SSM_POD_TIMEOUT s; (d) the ported examples."""
    t0 = time.perf_counter()
    L = falcon.n_layers
    # the dry runs take the host's other cores while (a) and (d) run
    dry = start_dryruns([one_rank_cell(falcon)] + SSM_POD_CELLS)
    try:
        with one_rank_world(torch):
            counts, summary_a = phase_sharded_train(
                torch, falcon, none, step_3b, peak_3b,
                per_step={"rmsnorm": 2 * L + 1, "mamba_scan": 2 * L, "mamba_scan_bwd": L},
                ref_phase="3b", strategy_kw={}, path="3o")
            gc.collect()
            torch.cuda.empty_cache()
        launched, summary_d = phase_examples(torch, none)
        counts.update(launched)
        (one,) = run_dryruns(dry[:1], "(b)")
        check_one_rank_cell(one, summary_a, "(b)", peak_rtol=DRYRUN_PEAK_RTOL)
        pods = run_dryruns(dry[1:], "(c)", timeout=SSM_POD_TIMEOUT)
    finally:
        for _, _, proc in dry:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    summary = {"a": summary_a, "b": one, "c": pods, "d": summary_d,
               "seconds": time.perf_counter() - t0}
    print(f"  phase 3o took {summary['seconds']:.1f} s", flush=True)
    return {path: {**none, **launched} for path, launched in counts.items()}, summary


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
    # phase 3h runs eight rank streams on one card; the caching
    # allocator keeps a pool per stream, and in fixed-size segments those
    # pools fragmented until an mpmd remat-"none" step ran out of memory
    # with about as much reserved but unallocated as allocated (PERF.md,
    # section 6, PR 19)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    zamba2 = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=ZAMBA2_LAYERS)
    whisper = get_config("whisper-large-v3")
    qwen2_vl = dataclasses.replace(get_config("qwen2-vl-7b"), n_layers=QWEN2_VL_LAYERS)
    dbrx = dataclasses.replace(get_config("dbrx-132b"), n_layers=1)
    results.update(phase_gmm_kernels(torch, mg, deepseek, (dbrx,)))
    phase("2/5 grids past 65,535 blocks")
    for name, rows in phase_grid_limits(torch, fa, mg, ms).items():
        results[name].update(rows)
    gc.collect()
    torch.cuda.empty_cache()
    none = dict.fromkeys(LAUNCH_KEYS, 0)
    paths = [(cfg, train_launches(cfg)) for cfg in (qwen, falcon, deepseek, qwen3, zamba2,
                                                    whisper, qwen2_vl)]
    for (cfg, want), tag in zip(paths, ("3", "3b", "3c", "3d", "3j", "3k", "3l")):
        enc = f"{cfg.n_enc_layers} encoder and " if cfg.n_enc_layers else ""
        phase(f"{tag}/5 full-width training: {cfg.name}, {enc}{cfg.n_layers} layers")
        if cfg.hybrid_every:
            # the fp32 check at one group: FP32_LAYERS is no multiple of it
            counts[cfg.name], train = phase_train(torch, cfg, want, save=False,
                                                  fp32_layers=cfg.hybrid_every)
        else:
            counts[cfg.name], train = phase_train(torch, cfg, want, save=tag == "3")
        if tag == "3c":
            step_3c, peak_3c = train["step_s"], train["peak"]
        if tag == "3b":
            step_3b, peak_3b = train["step_s"], train["peak"]
        phase(f"5/5 where a full-width {cfg.name} step's device time goes")
        if cfg.ssm:
            kernels = "K1, K2, K4 and K4-bwd" if cfg.hybrid_every else "K1, K4 and K4-bwd"
            print(f"  plain profile skipped: the plain run differs from the kernel run only "
                  f"in {kernels}, whose plain versions phase 2 times", flush=True)
        phase_profile(torch, train, plain_steps=0 if cfg.ssm else PROFILED_STEPS)
        if cfg.hybrid_every:
            ssd_scan_profile(torch, cfg)
        del train                      # free this path's state before the next one
        gc.collect()
        torch.cuda.empty_cache()

    summary_zoo = {}
    for tag, arch, layers, optimizer in ZOO:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        what = "training" if optimizer else "forward and backward, no optimizer step"
        phase(f"{tag}/5 full-width {what}: {cfg.name}, {layers} of "
              f"{get_config(arch).n_layers} layers")
        counts[cfg.name], summary_zoo[cfg.name] = phase_train_zoo(torch, cfg, optimizer)
        gc.collect()
        torch.cuda.empty_cache()

    summary_3u = {}
    for tag, label, cfg, fp32_layers in wide_paths(get_config):
        phase(f"{tag}/5 full-width training past the old kernel limits: {label}, "
              f"{cfg.n_layers} layers")
        counts[label], summary_3u[label] = phase_train_zoo(torch, cfg, True, WIDE_STEPS,
                                                           fp32_layers)
        gc.collect()
        torch.cuda.empty_cache()

    phase("3m/5 serving: init_cache, prefill and decode_step at full width")
    summary_3m = {}
    for cfg in (qwen3, get_config("qwen3-9b")):
        served, summary_3m[cfg.name] = phase_serve_qwen3(torch, cfg, none)
        counts.update({path: {**none, **launched} for path, launched in served.items()})
        gc.collect()
        torch.cuda.empty_cache()
    for cfg, incremental in ((deepseek, False), (falcon, True),
                             (dataclasses.replace(zamba2, n_layers=zamba2.hybrid_every), True),
                             (dataclasses.replace(whisper, n_layers=FP32_LAYERS,
                                                  n_enc_layers=FP32_LAYERS), False),
                             (qwen2_vl, True)):
        served = phase_serve_family(torch, cfg, none, incremental)
        counts.update({path: {**none, **launched} for path, launched in served.items()})
        gc.collect()
        torch.cuda.empty_cache()
    counts.update({path: {**none, **launched}
                   for path, launched in phase_serve_example(torch, none).items()})
    phase("3m/5 serving done")

    phase("3n/5 the production SPMD lane: sharded train, prefill and decode steps, the dry run")
    launched_3n, summary_3n = phase_production(torch, deepseek, qwen3, none, step_3c, peak_3c)
    counts.update(launched_3n)
    gc.collect()
    torch.cuda.empty_cache()

    phase("3o/5 the SSM family on the production SPMD lane, the SSM dry-run cells, the examples")
    launched_3o, summary_3o = phase_production_ssm(torch, falcon, none, step_3b, peak_3b)
    counts.update(launched_3o)
    gc.collect()
    torch.cuda.empty_cache()

    phase("3e/5 Piper IR: the qwen3-1b proxy traced on meta tensors, chunks of real layers")
    counts["ir"] = {**none, **phase_ir(torch)}
    gc.collect()
    torch.cuda.empty_cache()

    phase("3f/5 Piper runtime on the card: Strategy -> per-rank programs -> reference interpreter")
    phase_runtime_proxy(torch)
    gc.collect()
    torch.cuda.empty_cache()
    runtime_counts, ledger_peaks = phase_runtime_model(torch, qwen3)
    for remat, launched in runtime_counts.items():
        counts[f"piper runtime, remat {remat}"] = {**none, **launched}
    gc.collect()
    torch.cuda.empty_cache()
    phase_runtime_model(torch, dataclasses.replace(qwen3, n_layers=RUNTIME_CASE["fp32_layers"],
                                                   dtype="float32"), timed=False)
    gc.collect()
    torch.cuda.empty_cache()

    phase("3g/5 scoring, tuning and verification: --autotune, --strategy, lint, the cost model")
    cache_var = "REPRO_TORCH_TUNE_CACHE"
    prev_cache = os.environ.get(cache_var)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        os.environ[cache_var] = str(pathlib.Path(tmp) / "plan-cache")
        try:
            launched, winner, baseline, summary_3g = phase_tune_cli(torch, tmp)
        finally:
            if prev_cache is None:
                del os.environ[cache_var]
            else:
                os.environ[cache_var] = prev_cache
    counts["tune CLI (3g a-b)"] = {**none, **launched}
    chunk_calls, summary_3g["cost_model"] = phase_cost_model(torch, qwen3, ledger_peaks, winner)
    gc.collect()
    torch.cuda.empty_cache()

    phase("3h/5 the multi-rank runtimes: the spmd and mpmd lanes against the interpreter")
    phase_lanes_grid(torch)
    # remat "none" runs untimed, so that the whole run with phase 3i stays
    # well within its limit; its warm steps stand in PERF.md
    lanes_cfg = dataclasses.replace(qwen3, n_layers=LANES_LAYERS)
    for path, launched in phase_lanes_model(torch, lanes_cfg, timed=("full",)).items():
        counts[path] = {**none, **launched}
    gc.collect()
    torch.cuda.empty_cache()
    fp32 = dataclasses.replace(qwen3, n_layers=RUNTIME_CASE["fp32_layers"], dtype="float32")
    for path, launched in phase_lanes_model(torch, fp32, lanes=("mpmd/tcp",), remats=("full",),
                                            timed=(), tag="(c)", zero=TCP_ZERO,
                                            timeout=900.0).items():
        counts[path] = {**none, **launched}
    gc.collect()
    torch.cuda.empty_cache()
    summary_3h = phase_lanes_measured(torch, winner, baseline, summary_3g)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lanes_") as tmp:
        strategy_json = pathlib.Path(tmp) / "strategy.json"
        strategy_json.write_text(winner.to_json())
        phase_lanes_cli(torch, str(strategy_json), tmp)
    gc.collect()
    torch.cuda.empty_cache()

    phase("3i/5 elastic recovery and chaos: the supervisor on the lanes through faults")
    phase_elastic_grid(torch)
    gc.collect()
    torch.cuda.empty_cache()
    counts["3i spmd, kill and regrowth"] = {**none, **phase_elastic_model(torch, lanes_cfg)}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_cli_") as tmp:
        strategy_json = pathlib.Path(tmp) / "strategy.json"
        strategy_json.write_text(winner.to_json())
        phase_elastic_cli(torch, str(strategy_json), tmp)
    gc.collect()
    torch.cuda.empty_cache()

    phase("4/5 training CLI")
    phase_cli(torch)

    meta = {"rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:19"),
            "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:27"),
            "mamba_scan": ("mamba_scan.cuh", "src/repro/kernels/mamba_scan.py:43"),
            "mamba_scan_bwd": ("mamba_scan.cuh", "src/repro/kernels/mamba_scan.py:43"),
            "moe_gmm": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:19"),
            "moe_gmm_bwd": ("moe_gmm.cu", "src/repro/kernels/moe_gmm.py:19")}
    # the fp32 instantiations' own sources (their rows are the at_fp32_* keys)
    fp32_sources = {"flash_attention": "flash_attention_fp32.cu", "moe_gmm": "moe_gmm_fp32.cu",
                    "moe_gmm_bwd": "moe_gmm_fp32.cu"}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = results[name]
        by_path = {arch: c[name] for arch, c in counts.items() if c[name]}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        **({"fp32_source": f"src/repro_torch/kernels/csrc/{fp32_sources[name]}"}
                           if name in fp32_sources else {}),
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        **({"cost_model_calls": chunk_calls[name]} if name in chunk_calls
                           else {}),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **{key: r[key] for key in r if key.startswith("at_")
                           or key in ("tflops", "two_bmm_ms", "max_abs_err_fp32_p", "ms_cold",
                                      "library_ms_cold", "launch_floor_ms", "host_us",
                                      "library_host_us")}})
    phase("done")
    print("3g " + json.dumps(summary_3g), flush=True)
    print("3h " + json.dumps(summary_3h), flush=True)
    print("3m " + json.dumps(summary_3m), flush=True)
    print("3n " + json.dumps(summary_3n), flush=True)
    print("3o " + json.dumps(summary_3o), flush=True)
    print("zoo " + json.dumps(summary_zoo), flush=True)
    print("3u " + json.dumps(summary_3u), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
