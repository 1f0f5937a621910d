"""Plain PyTorch references for the LUT kernels.

``ref_amsim_gemm`` folds k strictly in order, one AMSim product at a time,
from +0.0: the order of the CUDA kernels and of the JAX kernels at
chunk=1, so all of them agree bit for bit.  It is the ``amsim_torch``
mode (the twin of the JAX package's ``amsim_jnp``) and the plain version
the kernels are held against on the card.  ``ref_direct_gemm`` folds the
same way with the multiplier model's own bit arithmetic in place of the
LUT (the ``direct`` mode).

The products of a chunk of k are computed as one (m, kc, n) tensor, so a
fold over k = 65 536 (a weight gradient at batch 64) is a few hundred
elementwise launches plus k additions, not k launch chains; the chunk is
sized so that each int64 temporary stays near ``_CHUNK_ELEMENTS``.  An
output of more elements than that is folded a block of columns at a time
(each output element's fold is its own), and the operands' bit patterns
are taken a chunk at a time, so that a product with a 5120 x 202048 LM
head holds no int64 copy of the head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.amsim import _amsim, lut_words
from repro_torch.core.float_bits import torch_bits, torch_float
from repro_torch.core.multipliers import Multiplier

from .common import NEG_INF, attention_mask, lane_sum, live_elements

_CHUNK_ELEMENTS = 1 << 22


def _sequential_gemm(a: torch.Tensor, b: torch.Tensor, products) -> torch.Tensor:
    """out[..., i, j] = sum_k p[..., i, k, j], k in order from +0.0, f32
    sums, where ``products(a[..., :, k0:k1], b[..., k0:k1, :])`` gives p for
    a chunk of k.  a (..., m, k) and b (..., k, n) share their leading
    batch dims (none for a plain GEMM)."""
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"sequential GEMM takes (..., m, k) @ (..., k, n) with equal batch "
                         f"dims, got {tuple(a.shape)} @ {tuple(b.shape)}")
    k, n = a.shape[-1], b.shape[-1]
    out_shape = (*a.shape[:-1], n)
    rows = math.prod(out_shape[:-1])
    nc = max(1, _CHUNK_ELEMENTS // max(1, rows))
    if nc < n:
        out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
        for n0 in range(0, n, nc):
            out[..., n0:n0 + nc] = _sequential_gemm(a, b[..., n0:n0 + nc], products)
        return out
    kc = max(1, min(k, _CHUNK_ELEMENTS // max(1, math.prod(out_shape))))
    acc = torch.zeros(out_shape, dtype=torch.float32, device=a.device)
    for k0 in range(0, k, kc):
        prod = products(a[..., :, k0:k0 + kc], b[..., k0:k0 + kc, :])
        for j in range(prod.shape[-2]):
            acc = acc + prod[..., :, j, :]
    return acc


def ref_amsim_gemm(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor, M: int):
    """out[..., i, j] = sum_k amsim(a[..., i, k], b[..., k, j]), k in order,
    f32 sums.

    a (..., m, k), b (..., k, n) float32 with equal leading batch dims;
    ``lut`` in kernel storage (int16 packed or int32 canonical).  Bit
    arithmetic runs on int64 words.  A batch element whose a has no element
    with a non-zero exponent field (an expert that holds no token) is +0.0
    without a product: AMSim makes every product of such an operand +-0,
    and a fold of those from +0.0 is +0.0.
    """
    if a.ndim > 2:
        live = live_elements(a).flatten(-2).any(dim=-1)
        if not bool(live.all()):
            out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32, device=a.device)
            idx = live.nonzero(as_tuple=True)
            if idx[0].numel():     # detached: b may be a view of a parameter updated since
                out[idx] = ref_amsim_gemm(a.detach()[idx], b.detach()[idx], lut, M)
            return out
    words, packed = lut_words(lut)

    def products(ac, bc):
        return torch_float(_amsim(torch_bits(ac)[..., :, :, None], torch_bits(bc)[..., None, :, :],
                                  words, M, torch, packed=packed))

    return _sequential_gemm(a, b, products)


def ref_kernel_product(ua: torch.Tensor, ub: torch.Tensor, lut: torch.Tensor, M: int, *,
                       expand: bool = True, swizzle: bool = False) -> torch.Tensor:
    """amsim(a, b) as the CUDA GEMM kernel computes it, on int64 words
    holding uint32 values: each operand decoded once (``decode_a``,
    ``decode_b`` in ``csrc/amsim_decoded.cuh``), then ``product``.  Used
    only by the tests, which hold it bit for bit against
    ``core.amsim._amsim``.  ``expand`` reads a packed table as the kernel
    does once it has expanded it to canonical words at staging, else as it
    unpacks a packed entry a product.  ``swizzle`` reads the table as the
    conv kernel stages it in shared memory (``csrc/approx_conv.cu``
    ``stage_table``, ``decode_x``): the low bits of a's mantissa index XORed
    into b's (canonical entries) or into the 32-bit word index (packed
    entries), and the same term folded into the decoded a."""
    words, packed = lut_words(lut)
    mask = (1 << M) - 1
    sign = 0x8000_0000

    def exponent(u, bias):
        e = (u >> 23) & 0xFF
        return torch.where(e == 0, torch.full_like(e, -1024), e - bias)

    ma = (ua >> (23 - M)) & mask
    ixa = (ua & sign) | (ma << M)
    ixb = (ub & sign) | ((ub >> (23 - M)) & mask)
    if swizzle:
        shift = 1 if packed and not expand else 0
        smask = (1 << min(5, M - shift)) - 1
        idx = torch.arange(words.numel(), dtype=words.dtype)
        staged = torch.empty_like(words)
        staged[idx ^ (((idx >> M) & smask) << shift)] = words
        words = staged
        ixa = ixa | ((ma & smask) << shift)
    w = ixa ^ ixb
    entry = words[w & 0xFF_FFFF]
    if not packed:
        entry = entry & 0xFF_FFFF
    elif expand:
        entry = (((entry >> M) & 1) << 23) | ((entry & mask) << (23 - M))
    else:
        entry = (entry << (23 - M)) & 0xFF_FFFF
    e0 = exponent(ua, 127) + exponent(ub, 0)
    v = torch.clamp(((e0 << 23) + entry) & 0xFFFF_FFFF, max=0x7F80_0000)
    return torch.where(e0 > 0, v, torch.zeros_like(v)) | (w & sign)


def ref_attention_tiled(q, k, v, q_pos, k_pos, lut: torch.Tensor, M: int, *, causal: bool,
                        window: int, rows: int, value_slab: int, key_slab: int = 64):
    """The attention kernel's order in torch (``csrc/attention.cuh``
    ``attend_tile``), used only by the tests: (out, skipped).

    For each group (b, kv-head) and each tile of ``rows`` of its S x G query
    rows (row s * G + g: position s, head kv-head * G + g), the scores fold
    dh products ``ref_kernel_product`` in order from +0.0, K slab by K slab
    of ``key_slab`` keys, skipping a slab where no row of the tile has a
    valid key; the softmax is ``approx_attention.softmax_scores``'; the
    outputs fold the keys in order from +0.0, V slab by V slab of
    ``value_slab`` keys, skipping a slab where every probability of the
    tile's rows is exactly +0.0.  ``skipped`` lists the skipped slabs as
    ("scores" or "values", b, kv-head, first row, first key).  On the CPU
    the result is bit for bit ``approx_attention_plain``'s."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dh)
    row_pos = q_pos.repeat_interleave(G)
    scale = torch.tensor(float(dh), dtype=torch.float32).sqrt()
    out = torch.zeros((B, KV, S * G, dh), dtype=torch.float32)
    skipped = []

    def fold(acc, a, b):   # acc + amsim(a, b), the kernel's decoded product
        return acc + torch_float(ref_kernel_product(torch_bits(a), torch_bits(b), lut, M))

    for b in range(B):
        for h in range(KV):
            qrows = qg[b, :, h].reshape(S * G, dh)
            kk, vv = k[b, :, h], v[b, :, h]
            for r0 in range(0, S * G, rows):
                r1 = min(r0 + rows, S * G)
                mask = attention_mask(row_pos[r0:r1], k_pos, causal=causal, window=window)
                scores = torch.full((r1 - r0, T), NEG_INF, dtype=torch.float32)
                for t0 in range(0, T, key_slab):
                    t1 = min(t0 + key_slab, T)
                    live = mask[:, t0:t1]
                    if not live.any():
                        skipped.append(("scores", b, h, r0, t0))
                        continue
                    acc = torch.zeros((r1 - r0, t1 - t0), dtype=torch.float32)
                    for d in range(dh):
                        acc = fold(acc, qrows[r0:r1, d, None], kk[None, t0:t1, d])
                    scores[:, t0:t1] = torch.where(live, acc / scale, NEG_INF)
                e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
                p = e / lane_sum(e)[:, None]
                acc = torch.zeros((r1 - r0, dh), dtype=torch.float32)
                for t0 in range(0, T, value_slab):
                    t1 = min(t0 + value_slab, T)
                    if not (p[:, t0:t1] != 0).any():
                        skipped.append(("values", b, h, r0, t0))
                        continue
                    for t in range(t0, t1):
                        acc = fold(acc, p[:, t, None], vv[None, t])
                out[b, h, r0:r1] = acc
    return out.reshape(B, KV, S, G, dh).permute(0, 2, 1, 3, 4).reshape(B, S, H, dh), skipped


def ref_direct_gemm(a: torch.Tensor, b: torch.Tensor, multiplier: Multiplier):
    """out[..., i, j] = sum_k mul(a[..., i, k], b[..., k, j]) with the
    multiplier model's torch twin (bitwise ``Multiplier.np_mul``), k in
    order, f32 sums; batched like ``ref_amsim_gemm``."""
    return _sequential_gemm(a, b, lambda ac, bc: multiplier.torch_mul(ac[..., :, :, None],
                                                                      bc[..., None, :, :]))


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
