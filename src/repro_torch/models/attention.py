"""Attention implementations (port of ``repro.models.attention``).

Layouts: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D); GQA repeats kv heads.

``chunked_attention`` is the plain online-softmax attention over KV
blocks (the JAX package's default and the oracle of its flash path).
``flash_attention_ref`` is the linear-memory flash attention in plain
PyTorch: the forward scans KV blocks with an online softmax, and the
backward (``_flash_bwd``) recomputes the probabilities block by block
from the saved logsumexp, as in FlashAttention-2.  It is the default
attention of the model and the oracle of the K2 kernel.
``decode_attention`` is the serving path's attention of new queries over
a KV cache, in plain PyTorch, as the JAX package computes it in jnp.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def check_scale(d: int, sm_scale: Optional[float]) -> None:
    """The flash paths use the fixed scale ``d**-0.5``; another scale is
    refused rather than silently ignored."""
    if sm_scale is not None and sm_scale != d ** -0.5:
        raise ValueError(f"flash attention uses the fixed scale d**-0.5 = "
                         f"{d ** -0.5!r}; got sm_scale={sm_scale!r}")


def naive_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """O(Sq*Skv) reference, only for small test shapes."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    skv = k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(NEG_INF, dtype=logits.dtype, device=q.device))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _blk_mask(kpos, qpos, causal, window, skv):
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    else:
        mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=kpos.device)
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask &= (kpos < skv)[None, :]
    return mask


def _pad_blocks(x, nb, block_kv):
    pad = nb * block_kv - x.shape[2]
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def _online_softmax(q, k, v, causal, q_offset, window, block_kv, scale):
    """The KV-block scan of the forward: (row max m, row sum l, unnormalised
    output acc), all fp32; q is scaled before its cast to fp32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    nb = -(-skv // block_kv)
    kp = _pad_blocks(k, nb, block_kv)
    vp = _pad_blocks(v, nb, block_kv)
    qpos = torch.arange(sq, device=q.device) + q_offset
    q32 = (q * scale).float()
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for i in range(nb):
        sl = slice(i * block_kv, (i + 1) * block_kv)
        kblk = repeat_kv(kp[:, :, sl], n_rep).float()
        vblk = repeat_kv(vp[:, :, sl], n_rep).float()
        kpos = torch.arange(i * block_kv, (i + 1) * block_kv, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kblk)
        mask = _blk_mask(kpos, qpos, causal, window, skv)
        s = s.masked_fill(~mask[None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
        m = m_new
    return m, l, acc


def chunked_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      sm_scale: Optional[float] = None, window: Optional[int] = None,
                      block_kv: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block_kv``: the same
    math as ``naive_attention`` in another association order, with no
    (Sq, Skv) score matrix in the forward.  Autograd through it saves
    every block's probabilities; training takes ``flash_attention_ref``,
    whose backward recomputes them."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    _, l, acc = _online_softmax(q, k, v, causal, q_offset, window, block_kv, scale)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def _flash_fwd_impl(q, k, v, causal, q_offset, window, block_kv):
    """Returns (out in q's dtype, lse in fp32 (B, Hq, Sq))."""
    m, l, acc = _online_softmax(q, k, v, causal, q_offset, window, block_kv,
                                q.shape[-1] ** -0.5)
    out = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def _flash_bwd(causal, q_offset, window, block_kv, res, dout):
    """FlashAttention-2 backward over KV blocks, from the saved
    (q, k, v, out, lse); dK and dV are folded over the GQA groups."""
    q, k, v, out, lse = res
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    scale = d ** -0.5
    nb = -(-skv // block_kv)
    kp = _pad_blocks(k, nb, block_kv)
    vp = _pad_blocks(v, nb, block_kv)
    qpos = torch.arange(sq, device=q.device) + q_offset
    q32 = (q * scale).float()
    do32 = dout.float()
    delta = (do32 * out.float()).sum(dim=-1)             # (b, hq, sq)
    dq = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(nb):
        sl = slice(i * block_kv, (i + 1) * block_kv)
        kr = repeat_kv(kp[:, :, sl], n_rep).float()
        vr = repeat_kv(vp[:, :, sl], n_rep).float()
        kpos = torch.arange(i * block_kv, (i + 1) * block_kv, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kr)
        mask = _blk_mask(kpos, qpos, causal, window, skv)
        s = s.masked_fill(~mask[None, None], NEG_INF)
        p = torch.exp(s - lse[..., None])                 # (b, hq, sq, bk)
        dv_r = torch.einsum("bhqk,bhqd->bhkd", p, do32)
        dp = torch.einsum("bhqd,bhkd->bhqk", do32, vr)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
        dk_r = torch.einsum("bhqk,bhqd->bhkd", ds, q32)
        dks.append(dk_r.reshape(b, hkv, n_rep, block_kv, d).sum(dim=2))
        dvs.append(dv_r.reshape(b, hkv, n_rep, block_kv, d).sum(dim=2))
    dk = torch.cat(dks, dim=2)[:, :, :skv]
    dv = torch.cat(dvs, dim=2)[:, :, :skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttentionRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window, block_kv):
        out, lse = _flash_fwd_impl(q, k, v, causal, q_offset, window, block_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, window, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.args, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0, sm_scale=None,
                        window=None, block_kv=512):
    """Signature-compatible wrapper used as the default attention impl."""
    check_scale(q.shape[-1], sm_scale)
    return _FlashAttentionRef.apply(q, k, v, causal, q_offset, window, block_kv)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     sm_scale: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Decode: q (B, Hq, Sq, D) against a (B, Hkv, Smax, D) cache whose
    first ``cache_len`` positions (an int or a 0-d tensor) are valid, and,
    with ``window``, only the last ``window`` of those.  q is scaled in
    its own dtype, then the scores and the softmax are fp32 and the
    result takes q's dtype, as in the JAX package.  No causal mask among
    the Sq queries: the serving path sends one at a time.  The scale is
    fixed at ``d**-0.5`` (``check_scale``)."""
    d = q.shape[-1]
    check_scale(d, sm_scale)
    n_rep = q.shape[1] // k_cache.shape[1]
    k = repeat_kv(k_cache, n_rep)
    v = repeat_kv(v_cache, n_rep)
    s = torch.einsum("bhqd,bhkd->bhqk", (q * d ** -0.5).float(), k.float())
    kpos = torch.arange(k_cache.shape[2], device=q.device)
    mask = kpos < cache_len
    if window is not None:
        mask = mask & (kpos >= cache_len - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
