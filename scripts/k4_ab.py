"""K4 and K4-bwd of two checkouts timed in turns on one card.

Usage (on a machine with a CUDA card, from the root of a checkout):

    python3 scripts/k4_ab.py OTHER_CHECKOUT

Times the scan kernels at Falcon-Mamba-7B's training shape (4, 1024,
8192, 16) in bf16 (the forward saving its chunk states, the backward)
and at its decode step (S = 1 from a cached state), in OTHER_CHECKOUT
and in this one, in turns: other, this, this, other.  Each turn is a
subprocess that builds its checkout's kernels and times them with CUDA
events, on the same inputs from the same seed.  Prints the card's name
and power limit, then one line a turn, in microseconds."""
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels import mamba_scan as ms
_build.build()
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
print(json.dumps({"fwd": us_of(lambda: ms.mamba_scan_fwd(x, dt, A, B, C, save_states=True)),
                  "bwd": us_of(lambda: ms.mamba_scan_bwd(x, dt, A, B, C, hs, dy)),
                  "decode": us_of(lambda: ms.mamba_scan_fwd(x1, dt1, A, B1, C1, h0))}))
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, root in (("other", other), ("this", this), ("this", this), ("other", other)):
        out = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()[-1]
        times = json.loads(out)
        print(name, {k: round(v, 2) for k, v in times.items()}, "us", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
