"""Launcher of K9, Swin's (shifted) window attention
(csrc/window_attention.cu).

Counterpart of ``coin_tpu/models/swin.py:57`` ``WindowAttention`` (its
core, ``:69-90``); the plain PyTorch version and the module are in
``coin_tpu_torch/models/swin.py``. bf16 windows of up to 144 tokens run on
the tensor cores (mma.sync), f32 on the CUDA cores.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from coin_tpu_torch.kernels.build import check, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
MAX_BF16_TOKENS = 144  # the bf16 kernel keeps a row's scores in registers
MAX_SMEM = 227 * 1024


def _lib():
    lib = library("window_attention")
    fn = lib.coin_window_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.coin_window_attention_smem.argtypes = [ctypes.c_int] * 4
    lib.coin_window_attention_smem.restype = ctypes.c_longlong
    return lib


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % align else t


def window_attention_cuda(qkv: torch.Tensor, table: torch.Tensor,
                          index: torch.Tensor,
                          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """qkv (B·nW, n, 3, heads, d) f32/bf16 on a CUDA device; table
    ((2w-1)², heads) f32; index (n, n) int32, every entry a row of the
    table (``models/swin._rel_pos_index`` builds it); mask (nW, n, n) f32 or
    None → (B·nW, n, heads·d) in qkv's dtype."""
    dev = qkv.device
    tensors = [table, index] + ([] if mask is None else [mask])
    if not qkv.is_cuda or any(t.device != dev for t in tensors):
        raise ValueError("window_attention_cuda: every tensor must be on one "
                         "CUDA device")
    if (qkv.dtype not in _DTYPES or table.dtype != torch.float32
            or index.dtype != torch.int32
            or (mask is not None and mask.dtype != torch.float32)):
        raise TypeError(f"window_attention_cuda: qkv {qkv.dtype} (f32 or "
                        f"bf16), table {table.dtype} (f32), index "
                        f"{index.dtype} (int32), mask "
                        f"{None if mask is None else mask.dtype} (f32)")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"window_attention_cuda: qkv {tuple(qkv.shape)}")
    bn, n, _, heads, d = qkv.shape
    if (d not in HEAD_DIMS or table.dim() != 2 or table.shape[1] != heads
            or tuple(index.shape) != (n, n)
            or (mask is not None and (mask.dim() != 3
                                      or tuple(mask.shape[1:]) != (n, n)
                                      or bn % mask.shape[0]))):
        raise ValueError(f"window_attention_cuda: qkv {tuple(qkv.shape)}, "
                         f"table {tuple(table.shape)}, index "
                         f"{tuple(index.shape)}, mask "
                         f"{None if mask is None else tuple(mask.shape)}")
    if qkv.dtype == torch.bfloat16 and n > MAX_BF16_TOKENS:
        raise ValueError(f"window_attention_cuda: bf16 windows of at most "
                         f"{MAX_BF16_TOKENS} tokens, not {n}")
    lib = _lib()
    if lib.coin_window_attention_smem(n, d, table.shape[0],
                                      _DTYPES[qkv.dtype]) > MAX_SMEM:
        raise ValueError(f"window_attention_cuda: a window of {n} tokens "
                         "does not fit in shared memory")
    # the bf16 kernel copies rows 16 bytes at a time and reads index and
    # mask rows two entries at a time
    qkv, index = _aligned(qkv, 16), _aligned(index, 8)
    table = table.contiguous()
    mask = None if mask is None else _aligned(mask, 8)
    out = torch.empty((bn, n, heads * d), dtype=qkv.dtype, device=dev)
    if bn == 0:
        return out
    err = lib.coin_window_attention(
        qkv.data_ptr(), table.data_ptr(), index.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), bn, n,
        heads, d, table.shape[0], 0 if mask is None else mask.shape[0],
        _DTYPES[qkv.dtype], torch.cuda.current_stream(dev).cuda_stream)
    check(err, "window_attention")
    window_attention_cuda.launches += 1
    return out


window_attention_cuda.launches = 0
