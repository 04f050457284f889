"""Causal, optionally windowed GQA attention on the card: wrapper of the
hand-written CUDA kernel (``csrc/attn.cuh``), forward and backward.

The kernel replaces no kernel of the reference (the JAX package computes
attention with einsums); its plain version is
:func:`repro_torch.models.attention._chunked_attention`, the torch block
loop that runs on the CPU and that the card tests hold the kernel to.
:func:`flash` is the entry: on CUDA tensors it launches the kernel or
raises with the reason it refuses them; it is never called for others.

The kernel visits only the (64-query, 64-key) tiles that hold a visible
pair (:func:`tiles_visited`), saves (out, lse) and recomputes the scores in
the backward: ``attn_bwd`` launches one kernel for dK, dV (a KV head's key
block summed over its query heads) and one for dQ, so no score is kept in
device memory and no float atomic is used.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from repro_torch import spans
from . import build
from .cuda_src import KernelSource

#: the kernel's query and key tile (``attn::BQ``, ``attn::BK``)
BLOCK = 64
#: the largest head size the kernel is built for: it computes the head
#: rounded up to 64 columns (a thread owns a sixteenth of them) and reads
#: rows as float4, so a head size is a multiple of 4
MAX_HEAD_DIM = 256

#: forward and backward launches (each backward launches two kernels)
launches = 0
backward_launches = 0
_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def source(head_dim: int) -> KernelSource:
    """The kernel's source for one head size."""
    return KernelSource(template="attn",
                        text=f'#define ATTN_D {head_dim}\n'
                             f'#include "attn.cuh"\n',
                        domain=(0, head_dim))


def key_blocks(q0: int, S: int, window: int, block: int) -> range:
    """The key blocks (of ``block`` keys) that the query block starting at
    ``q0`` sees: from the block of its first query's first visible key to
    the block of its last query."""
    first = q0 - window + 1 if window else 0
    return range(max(first, 0) // block, (min(q0 + block, S) - 1) // block + 1)


def tiles_visited(S: int, window: int, block: int = BLOCK) -> int:
    """(query block, key block) tiles one (batch row, head) visits."""
    return sum(len(key_blocks(q0, S, window, block))
               for q0 in range(0, S, block))


def refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_of: Optional[torch.Tensor]) -> Optional[str]:
    """Why the kernel does not take these operands, or None."""
    if not all(t.device.type == "cuda" for t in (q, k, v)):
        return "the attention kernel runs on CUDA tensors only"
    return shape_refusal(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                         None if kv_of is None else tuple(kv_of.shape))


def shape_refusal(q: tuple, k: tuple, v: tuple,
                  kv_of: Optional[tuple] = None) -> Optional[str]:
    """Why the kernel does not take operands of these shapes (q (B, S, H,
    D), k and v (B, S, KV, D), ``kv_of``'s shape or None), or None."""
    if len(q) != 4 or k != v or len(k) != 4:
        return f"q {q}, k {k}, v {v}: (B, S, heads, head_dim) expected"
    B, S, H, D = q
    if (k[0], k[1], k[3]) != (B, S, D):
        return f"k {k} does not match q {q}"
    if D % 4 or not 0 < D <= MAX_HEAD_DIM:
        return (f"head_dim {D}: the attention kernel takes a multiple of 4 "
                f"up to {MAX_HEAD_DIM}")
    KV = k[2]
    if kv_of is None and H % KV:
        return f"{H} query heads over {KV} KV heads"
    if kv_of is not None and kv_of != (H,):
        return f"kv_of {kv_of}: one KV head a query head"
    return None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


class _Flash(torch.autograd.Function):
    """The kernel's forward and backward over fp32, contiguous q (B, S, H,
    D), k and v (B, S, KV, D)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, kv_of):
        global launches
        B, S, H, D = q.shape
        KV = k.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        fn = build.launcher(source(D), "attn_fwd")
        dev = q.device
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_of),
                out.data_ptr(), lse.data_ptr(), B, S, H, KV, int(window),
                D ** -0.5, torch.cuda.current_stream(dev).cuda_stream,
                dev.index)
        if rc != 0:
            raise RuntimeError(f"attention kernel launch failed: cudaError "
                               f"{rc} ({build.library_path(source(D)).name})")
        with _COUNT_LOCK:
            launches += 1
        ctx.save_for_backward(q, k, v, out, lse, kv_of)
        ctx.window = int(window)
        return out

    @staticmethod
    def backward(ctx, dout):
        global backward_launches
        q, k, v, out, lse, kv_of = ctx.saved_tensors
        B, S, H, D = q.shape
        KV = k.shape[2]
        dout = dout.contiguous().float()
        delta = torch.sum(dout * out, dim=-1).transpose(1, 2).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        fn = build.launcher(source(D), "attn_bwd")
        dev = q.device
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_of),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, KV,
                ctx.window, D ** -0.5,
                torch.cuda.current_stream(dev).cuda_stream, dev.index)
        if rc != 0:
            raise RuntimeError(f"attention backward launch failed: "
                               f"cudaError {rc}")
        with _COUNT_LOCK:
            backward_launches += 1
        return dq, dk, dv, None, None


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
          kv_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k, v (B, S, KV, D) at positions 0
    .. S − 1, causal and within ``window`` (0: none): query head h reads KV
    head ``kv_of[h]``, or h // (H / KV).  Computed in fp32 (a bf16 input is
    read as fp32 and the output cast back); raises where the kernel refuses
    the operands."""
    why = refusal(q, k, v, kv_of)
    if why is not None:
        raise NotImplementedError(why)
    B, S, H, _D = q.shape
    spans.count("attn.blocks", B * H * tiles_visited(S, window))
    if kv_of is not None:
        kv_of = kv_of.to(device=q.device, dtype=torch.int32).contiguous()
    out = _Flash.apply(q.float().contiguous(), k.float().contiguous(),
                       v.float().contiguous(), int(window), kv_of)
    return out.to(q.dtype)
