"""A set of kernels of two checkouts timed in turns on one card.

Usage (on a machine with a CUDA card, from the root of a checkout):

    python3 scripts/kernel_ab.py {k1,k4,fp32,wide} OTHER_CHECKOUT

Times the set's kernels in OTHER_CHECKOUT and in this one, in turns:
other, this, this, other.  Each turn is a subprocess that builds its
checkout's kernels and times them with CUDA events, on the same inputs
from the same seed.  Prints the card's name and power limit, then one
line a turn, in microseconds.  The sets:

- ``k1``: RMSNorm at ``chip_smoke.K1_SHAPES`` in fp32 and bf16 (the
  training widths at 4096 rows, Whisper's encoder rows, the serving
  models' decode rows), L2-warm and L2-cold (``_cold``), beside
  ``F.rms_norm`` (``_library``, ``_library_cold``) and the plain version
  (``_plain``), timed by this checkout's ``chip_smoke.k1_sweep``, which
  also holds each case to the plain version and two rows alone to the
  same rows of the whole call; the launch floor (``floor``:
  ``torch.cuda._sleep(0)`` by the same timer); and the host's time a
  call at the decode shape (``host``, ``host_library``).
- ``k4``: the scan kernels at Falcon-Mamba-7B's training shape (4, 1024,
  8192, 16) in bf16 (the forward saving its chunk states, the backward)
  and at its decode step (S = 1 from a cached state); and at Zamba2's
  scan shape (4, 1024, 5120, N) with bf16 x and fp32 dt at N = 32, 64
  and 128 (``fwd_n64``, ``bwd_n64``, ...).
- ``fp32``: the kernels that run fp32 inputs, beside the PyTorch call
  computing the same function (fp32 SDPA, ``torch.bmm`` with TF32 off):
  K2 at (4, 16, 1024, D) causal for D = 64 and 128, and K3 at
  DeepSeek-MoE-16B's decode shapes (64 experts x 4 rows: (2048 -> 1408)
  and (1408 -> 2048)) and its training shape (64 x 448 rows, 2048 ->
  1408: the forward, dx and dw).
- ``wide``: the shapes past the kernels' first instantiations: K2 at
  qwen3-1b's (4, 16/8, 1024, 512) causal in bf16 and fp32 (the wide
  kernels) beside SDPA, and K4 and K4-bwd at Zamba2's scan shape at 256
  states, (4, 1024, 5120, 256) with bf16 x and fp32 dt (two groups of
  128).  Both checkouts must take these shapes (the port's commits
  before the wide kernels refuse them)."""
import json
import os
import subprocess
import sys

PRELUDE = r'''
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
import torch.nn.functional as F
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
def us_of(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps * 1e3
'''

SETS = {"k1": r'''
sys.path.insert(1, sys.argv[2])          # this checkout's chip_smoke, the timed one's kernels
import chip_smoke
from repro_torch.kernels import rmsnorm as rn
res = chip_smoke.k1_sweep(torch, rn, lambda x, w: F.rms_norm(x, x.shape[-1:], w, 1e-6))
out = {"floor": res.pop("launch_floor_ms") * 1e3, "host": res.pop("host_us"),
       "host_library": res.pop("library_host_us")}
suffixes = {"ms": "", "ms_cold": "_cold", "library_ms": "_library",
            "library_ms_cold": "_library_cold", "plain_ms": "_plain"}
for key, case in res.items():
    for k, suffix in suffixes.items():
        out[key + suffix] = case[k] * 1e3
''', "k4": r'''
from repro_torch.kernels import mamba_scan as ms
g = torch.Generator(device="cuda").manual_seed(7)
b, s, c, n = 4, 1024, 8192, 16
def randn(shape, scale=1.0):
    return torch.randn(shape, generator=g, device="cuda") * scale
x = randn((b, s, c), 0.5).bfloat16()
dt = torch.nn.functional.softplus(randn((b, s, c))).bfloat16()
A = -torch.exp(randn((c, n), 0.2))
B, C = randn((b, s, n), 0.5).bfloat16(), randn((b, s, n), 0.5).bfloat16()
h0 = randn((b, c, n), 0.5)
_, _, hs = ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)
dy = torch.randn(x.shape, device="cuda").bfloat16()
x1, dt1, B1, C1 = (t[:, :1].contiguous() for t in (x, dt, B, C))
out = {"fwd": us_of(lambda: ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)),
       "bwd": us_of(lambda: ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy)),
       "decode": us_of(lambda: ms.mamba_scan_fwd(x1, dt1, A, B1, C1, h0))}
c = 5120
x, dy = randn((b, s, c), 0.5).bfloat16(), randn((b, s, c)).bfloat16()
dt = torch.nn.functional.softplus(randn((b, s, c)))
for n in (32, 64, 128):
    A = -torch.exp(randn((c, n), 0.2))
    B, C = randn((b, s, n), 0.5).bfloat16(), randn((b, s, n), 0.5).bfloat16()
    _, _, hs = ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)
    out[f"fwd_n{n}"] = us_of(lambda: ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True))
    out[f"bwd_n{n}"] = us_of(lambda: ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy), reps=5)
    del hs
''', "fp32": r'''
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg
g = torch.Generator(device="cuda").manual_seed(11)
def randn(*shape, scale=1.0):
    return torch.randn(shape, generator=g, device="cuda") * scale
out = {}
for d in (64, 128):
    q, k, v = (randn(4, 16, 1024, d) for _ in range(3))
    out[f"k2_d{d}"] = us_of(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    out[f"sdpa_d{d}"] = us_of(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
for e, m, k_, n in ((64, 4, 2048, 1408), (64, 4, 1408, 2048)):
    x, w = randn(e, m, k_), randn(e, k_, n, scale=k_ ** -0.5)
    out[f"k3_decode_{k_}_{n}"] = us_of(lambda: mg.moe_gmm_fwd(x, w))
    out[f"bmm_decode_{k_}_{n}"] = us_of(lambda: torch.bmm(x, w))
x, w, dy = randn(64, 448, 2048), randn(64, 2048, 1408, scale=2048 ** -0.5), randn(64, 448, 1408)
out["k3_train_fwd"] = us_of(lambda: mg.moe_gmm_fwd(x, w), reps=5)
out["bmm_train_fwd"] = us_of(lambda: torch.bmm(x, w), reps=5)
out["k3_train_dx"] = us_of(lambda: mg.moe_gmm_bwd(x, w, dy, need_dw=False), reps=5)
out["bmm_train_dx"] = us_of(lambda: torch.bmm(dy, w.transpose(1, 2)), reps=5)
out["k3_train_dw"] = us_of(lambda: mg.moe_gmm_bwd(x, w, dy, need_dx=False), reps=5)
out["bmm_train_dw"] = us_of(lambda: torch.bmm(x.transpose(1, 2), dy), reps=5)
''', "wide": r'''
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
g = torch.Generator(device="cuda").manual_seed(13)
def randn(*shape, scale=1.0):
    return torch.randn(shape, generator=g, device="cuda") * scale
out = {}
for dt_, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
    q = randn(4, 16, 1024, 512).to(dt_)
    k, v = randn(4, 8, 1024, 512).to(dt_), randn(4, 8, 1024, 512).to(dt_)
    out[f"k2_d512_{name}"] = us_of(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    out[f"sdpa_d512_{name}"] = us_of(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    del q, k, v
b, s, c, n = 4, 1024, 5120, 256
x, dy = randn(b, s, c, scale=0.5).bfloat16(), randn(b, s, c).bfloat16()
dt = torch.nn.functional.softplus(randn(b, s, c))
A = -torch.exp(randn(c, n, scale=0.2))
B, C = randn(b, s, n, scale=0.5).bfloat16(), randn(b, s, n, scale=0.5).bfloat16()
_, _, hs = ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)
out["fwd_n256"] = us_of(lambda: ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True), reps=5)
out["bwd_n256"] = us_of(lambda: ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy), reps=5)
'''}


def main() -> int:
    if len(sys.argv) != 3 or sys.argv[1] not in SETS:
        print(__doc__, file=sys.stderr)
        return 2
    child = PRELUDE + SETS[sys.argv[1]] + "print(json.dumps(out))\n"
    other = os.path.abspath(sys.argv[2])
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        run = subprocess.run([sys.executable, "-c", child, root, this], capture_output=True,
                             text=True)
        if run.returncode:
            print(f"{name} ({root}) failed:\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}",
                  file=sys.stderr, flush=True)
            return 1
        times = json.loads(run.stdout.strip().splitlines()[-1])
        print(name, {k: round(v, 2) for k, v in times.items()}, "us", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
