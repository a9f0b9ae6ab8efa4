"""K4, batched row gather (port of robot3dlotus_tpu/ops/pallas_gather.py
`permute_rows`): out[b, m] = x[b, idx[b, m]].

It serves the decoder's unpool_gather (ops/pooling.py) and the stage-0
entry sort when inputs arrive unsorted (models/ptv3.py). The CUDA kernel is
csrc/gather.cu; gather_rows_plain is the same function in PyTorch, the
path for CPU tensors and the oracle the kernel is held against.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, M) int in [0, N) -> (B, M, D)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. idx must be in range (no clamping, no sentinel rows)."""
    if not x.is_cuda:
        return gather_rows_plain(x, idx)
    cuda_lib.check_cuda_tensor("gather_rows x", x, torch.float32, 3)
    idx = idx.to(torch.int32).contiguous()
    cuda_lib.check_cuda_tensor("gather_rows idx", idx, torch.int32, 2)
    B, N, D = x.shape
    if idx.shape[0] != B:
        raise ValueError(f"gather_rows: batch {idx.shape[0]} != {B}")
    M = idx.shape[1]
    out = torch.empty((B, M, D), dtype=x.dtype, device=x.device)
    cuda_lib.launch("gather_rows", "r3dl_gather_rows", x.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), B, N, M, D)
    return out
