"""Quickstart with the PyTorch port: declare a distributed strategy with
the Strategy API, save it as JSON, then train a tiny reduced-config model
end-to-end with the full substrate (data pipeline, AdamW+cosine,
checkpoint/restart) — the saved strategy is validated and scored on the
timeline simulator before training starts (``--strategy``).  Trains on
the card with the hand-written kernels unless given ``--device cpu``.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import pathlib
import sys
import tempfile

from repro_torch import Mesh, Overlap, Pipeline, Strategy, ZeRO
from repro_torch.launch.train import main as train_main

# the whole distributed plan in one declarative, serializable object:
# 1F1B over a pp=2 x dp=2 named-axis mesh, ZeRO-3 on the DP groups,
# and the overlap engine prefetching param gathers 4 chunks ahead
STRATEGY = Strategy(
    Mesh(pp=2, dp=2),
    Pipeline("1f1b", n_mb=4)
    | ZeRO(stage=3)
    | Overlap(prefetch=4, bucket_mb=32),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    doc = STRATEGY.to_json()
    assert Strategy.from_json(doc) == STRATEGY   # byte-stable round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "strategy.json"
        path.write_text(doc)
        print(f"strategy {STRATEGY.label()} -> {path}")
        return train_main([
            "--arch", "qwen1.5-0.5b",
            "--strategy", str(path),
            "--tune-tokens", "16384",
            "--steps", "100",
            "--batch", "8", "--seq", "64",
            "--d-model", "128", "--layers", "2", "--vocab", "512",
            "--ckpt-dir", str(pathlib.Path(tmp) / "ckpt"),
            "--device", args.device,
        ])


if __name__ == "__main__":
    sys.exit(main())
