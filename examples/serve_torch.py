"""Batched serving with the PyTorch port: prefill a batch of prompts,
then greedy-decode with the per-architecture KV/SSM caches.  Runs any
assigned arch at reduced scale, on the card (with the hand-written
kernels registered) or, with ``--device cpu``, on the CPU (their plain
versions).

  PYTHONPATH=src python examples/serve_torch.py --arch zamba2-2.7b --tokens 16
  PYTHONPATH=src python examples/serve_torch.py --device cpu --arch qwen3-1b
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import decode_step, init, prefill


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> torch.Tensor:
    """Prints the lines of ``examples/serve.py`` and returns the generated
    ids (batch, tokens)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = init(cfg, torch.Generator().manual_seed(0), dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    batch = {"tokens": prompts}
    if cfg.n_enc_layers:
        batch["frames"] = torch.randn((args.batch, cfg.enc_seq, cfg.d_model),
                                      generator=torch.Generator().manual_seed(2)).to(dev)

    max_seq = args.prompt_len + args.tokens
    if dev.type == "cuda":
        ops.register_kernels()
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, cache = prefill(cfg, params, batch, max_seq=max_seq)
            _sync(dev)
            t_prefill = time.perf_counter() - t0

            tok = logits[:, -1].argmax(-1).reshape(args.batch, 1)
            out = [tok]
            t0 = time.perf_counter()
            for _ in range(args.tokens - 1):
                logits, cache = decode_step(cfg, params, tok, cache)
                tok = logits[:, -1].argmax(-1).reshape(args.batch, 1)
                out.append(tok)
            _sync(dev)
            t_decode = time.perf_counter() - t0
    finally:
        if dev.type == "cuda":
            ops.unregister_kernels()

    gen = torch.cat(out, dim=1).cpu()
    print(f"arch={cfg.name} ({cfg.family})  batch={args.batch}")
    print(f"prefill {args.prompt_len} tokens: {t_prefill*1e3:.0f} ms")
    print(f"decode {args.tokens} tokens: {t_decode*1e3:.0f} ms "
          f"({args.batch*(args.tokens-1)/max(t_decode,1e-9):.0f} tok/s)")
    print("generated ids[0]:", gen[0].tolist())
    return gen


if __name__ == "__main__":
    main()
