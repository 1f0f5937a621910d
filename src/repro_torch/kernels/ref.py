"""Plain PyTorch references for the LUT kernels.

``ref_amsim_gemm`` folds k strictly in order, one AMSim product at a time,
from +0.0: the order of both CUDA kernels and of the JAX kernels at
chunk=1, so all of them agree bit for bit.  It is the ``amsim_torch``
mode (the twin of the JAX package's ``amsim_jnp``) and the plain version
the kernels are held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.amsim import _amsim, lut_words
from repro_torch.core.float_bits import torch_bits, torch_float


def ref_amsim_gemm(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor, M: int):
    """out[i, j] = sum_k amsim(a[i, k], b[k, j]), k in order, f32 sums.

    a (m, k), b (k, n) float32; ``lut`` in kernel storage (int16 packed or
    int32 canonical).  Bit arithmetic runs on int64 words.
    """
    m, k = a.shape
    n = b.shape[1]
    words, packed = lut_words(lut)
    ua = torch_bits(a)
    ub = torch_bits(b)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for kk in range(k):
        prod = _amsim(ua[:, kk:kk + 1], ub[kk:kk + 1, :], words, M, torch, packed=packed)
        acc = acc + torch_float(prod)
    return acc


def ref_im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
               pad: tuple[int, int, int, int]) -> torch.Tensor:
    """x (N,H,W,C) -> (N*OH*OW, KH*KW*C) patch matrix, columns (ki, kj, c)."""
    n, h, w, c = x.shape
    pt, pb, pl, pr = pad
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    oh = (h + pt + pb - kh) // stride + 1
    ow = (w + pl + pr - kw) // stride + 1
    cols = []
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, i:i + (oh - 1) * stride + 1:stride,
                       j:j + (ow - 1) * stride + 1:stride, :]
            cols.append(patch.reshape(n * oh * ow, c))
    return torch.stack(cols, dim=1).reshape(n * oh * ow, kh * kw * c)
