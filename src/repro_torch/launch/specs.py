"""Input shape specs for every (architecture x shape) dry-run cell (port
of ``repro.launch.specs``).

LM transformer shapes:
  train_4k     seq 4,096  global_batch 256   -> train_step
  prefill_32k  seq 32,768 global_batch 32    -> prefill (serve)
  decode_32k   seq 32,768 global_batch 128   -> decode_step (serve)
  long_500k    seq 524,288 global_batch 1    -> decode_step, only for
               sub-quadratic archs (SSM/hybrid); full-attention archs are
               recorded as skipped(full-attention).

Everything returns meta tensors (the JAX package's ``ShapeDtypeStruct``)
— no device allocation.  Modality frontends are stubs: whisper gets
precomputed frame embeddings, qwen2-vl gets token embeddings + 3-stream
M-RoPE position ids.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models import ArchConfig, init, init_cache

SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}


def cell_status(cfg: ArchConfig, shape_name: str) -> str:
    """'ok' or the skip reason for this (arch, shape) cell."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return "skipped(full-attention)"
    return "ok"


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (a dtype name or a torch
    dtype)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape_name: str, batch: int | None = None,
                seq: int | None = None) -> dict:
    """Graph inputs for the cell (the data-pipeline contract); ``batch``
    and ``seq`` override the cell's (a run cut to one card's size)."""
    info = SHAPES[shape_name]
    b = info["batch"] if batch is None else batch
    s = info["seq"] if seq is None else seq
    if info["kind"] == "train":
        out = {"tokens": sds((b, s), "int32"),
               "labels": sds((b, s), "int32")}
        if cfg.n_enc_layers:
            out["frames"] = sds((b, cfg.enc_seq, cfg.d_model), cfg.dtype)
        if cfg.mrope:
            out["mrope_positions"] = sds((3, b, s), "int32")
        return out
    if info["kind"] == "prefill":
        out = {"tokens": sds((b, s), "int32")}
        if cfg.n_enc_layers:
            out["frames"] = sds((b, cfg.enc_seq, cfg.d_model), cfg.dtype)
        if cfg.mrope:
            out["mrope_positions"] = sds((3, b, s), "int32")
        return out
    # decode: one new token against a seq-long cache
    return {"token": sds((b, 1), "int32")}


def params_specs(cfg: ArchConfig) -> Any:
    return init(cfg, torch.Generator(), device="meta")


def state_specs(cfg: ArchConfig) -> dict:
    """Training state (params + AdamW moments) with no allocation."""
    from ..optim import adamw_init
    params = params_specs(cfg)
    return {"params": params, "opt": adamw_init(params),
            "step": sds((), "int32")}


def cache_specs(cfg: ArchConfig, shape_name: str) -> Any:
    info = SHAPES[shape_name]
    return init_cache(cfg, info["batch"], info["seq"], device="meta")


def prefill_cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> Any:
    """The cache ``prefill`` returns: ``init_cache``'s, plus the encoder
    output for the encoder-decoder (the JAX package takes it with
    ``eval_shape`` of ``prefill``)."""
    cache = init_cache(cfg, batch, max_seq, device="meta")
    if cfg.n_enc_layers:
        cache["enc_out"] = sds((batch, cfg.enc_seq, cfg.d_model), cfg.dtype)
    return cache


def dryrun_config(cfg: ArchConfig) -> ArchConfig:
    """Full config adjusted for the production run: bf16, remat, chunked
    cross-entropy."""
    return dataclasses.replace(cfg, dtype="bfloat16", remat="full",
                               loss_chunk=2048)
