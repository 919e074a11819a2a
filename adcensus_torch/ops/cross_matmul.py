"""Band-matrix ("matmul") backend of the cross-window operators.

Port of ``adcensus_tpu/ops/cross_matmul.py``. A variable-arm window sum
is one batched matrix product against per-row / per-column 0/1 band
matrices built from the arms:

    hsum[d, y, o] = sum_i Mh[y, o, i] * vol[d, y, i],
      Mh[y, o, i] = 1  iff  o - left_arm[y, o] <= i <= o + right_arm[y, o]

and the vertical pass likewise with Mv[x, o, i] from the top/bottom arms.
These are plain matrix products, which the JAX package leaves to XLA, so
here they are ``torch.einsum``.

Precision. JAX multiplies bfloat16 operands with float32 accumulation
(``preferred_element_type``). A torch product of two bfloat16 tensors
returns bfloat16, which would round every window sum to 8 bits, so the
port keeps each bfloat16 part as a float32 tensor of bfloat16-rounded
values and multiplies in float32. Products with 0/1 masks are then exact,
also under TF32 (bfloat16 values are TF32 values), and only the order of
the float32 sums differs from XLA's.

* Aggregation splits the volume into hi = bf16(x) and lo = bf16(x - hi)
  per pass, as ``_split_mm`` does (~2^-17 relative error).
* Voting histograms are exact: one-hot counts times 0/1 masks are exact
  integers below 2^24. CUDA has no int8 product in torch, so JAX's int8
  / int16 branch becomes the same float32 product; its statistics are
  bitwise JAX's.
"""
from __future__ import annotations

from typing import Tuple

import torch


def band_masks(
    arms: torch.Tensor, max_arm: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """0/1 float32 band matrices from per-pixel cross arms (JAX builds
    them bfloat16; the values are the same).

    arms: (H, W, 4) int (left, right, top, bottom).
    Returns (Mh, Mv): Mh (H, W_out, W_in), Mv (W, H_out, H_in).
    """
    al, ar, at, ab = (
        arms[..., k].to(torch.int32).clamp(max=max_arm) for k in range(4)
    )
    h, w = al.shape
    iw = torch.arange(w, dtype=torch.int32, device=arms.device)
    rel_w = iw[None, :] - iw[:, None]  # (W_out, W_in): i - o
    mh = (rel_w[None] >= -al[..., None]) & (rel_w[None] <= ar[..., None])
    ih = torch.arange(h, dtype=torch.int32, device=arms.device)
    rel_h = ih[None, :] - ih[:, None]  # (H_out, H_in)
    at_t, ab_t = at.T, ab.T  # (W, H)
    mv = (rel_h[None] >= -at_t[..., None]) & (rel_h[None] <= ab_t[..., None])
    return mh.to(torch.float32), mv.to(torch.float32)


def vote_band_masks(
    arms: torch.Tensor, max_arm: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band masks for the voting histograms. JAX builds them int8 while
    row counts fit (2*max_arm+1 <= 127) and bfloat16 otherwise; the port
    multiplies in float32 in both branches, so they are band_masks."""
    return band_masks(arms, max_arm)


def _mm_h(mh: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """out[d, y, o] = sum_i mh[y, o, i] * vol[d, y, i] (float32)."""
    return torch.einsum("yoi,dyi->dyo", mh, vol.to(mh.dtype))


def _mm_v(mv: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """out[d, o, x] = sum_i mv[x, o, i] * vol[d, i, x] (float32)."""
    return torch.einsum("xoi,dix->dox", mv, vol.to(mv.dtype))


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest, ties to even), held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split_mm(mm, mask: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """2-term bfloat16 split product (masks are exact 0/1):
    mm(mask, hi) + mm(mask, lo) with hi = bf16(vol), lo = bf16(vol - hi).

    As in JAX, the two parts are either stacked along D into one product
    (reads the mask once, writes and reads a 2-fold volume) or multiplied
    separately (reads the mask twice), whichever moves fewer bytes."""
    d = vol.shape[0]
    hi = _bf16_round(vol)
    lo = _bf16_round(vol - hi)
    if 2 * (2 * vol.numel()) > mask.numel():  # stack bytes > mask bytes
        return mm(mask, hi) + mm(mask, lo)
    res = mm(mask, torch.cat([hi, lo], dim=0))
    return res[:d] + res[d:]


def cross_pass_matmul(
    vol: torch.Tensor,
    arms: torch.Tensor,
    sup: torch.Tensor,
    horizontal_first: bool,
    max_arm: int,
    normalize: bool = True,
    masks: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """One cross-aggregation iteration of a (D, H, W) float32 volume by
    band matrices. Same contract as ``cross_sum.cross_pass``; pass
    ``masks`` (from :func:`band_masks`) to build them once for all
    iterations. Not bitwise: the float32 sums run in the product's
    order."""
    mh, mv = band_masks(arms, max_arm) if masks is None else masks
    if horizontal_first:
        tmp = _split_mm(_mm_h, mh, vol)
        res = _split_mm(_mm_v, mv, tmp)
    else:
        tmp = _split_mm(_mm_v, mv, vol)
        res = _split_mm(_mm_h, mh, tmp)
    if normalize:
        res = res / sup.to(torch.float32)
    return res.contiguous()


def region_vote_stats_matmul(
    di: torch.Tensor,
    valid: torch.Tensor,
    arms: torch.Tensor,
    d_range: int,
    max_arm: int,
    masks: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_index, max_ht, count), each (H, W) int32, of the
    horizontal-first cross-region disparity histogram
    (multistep_refiner.cpp:183-197), as exact integer counts from two
    float32 band products, at any arm length.

    di: (H, W) int32 rounded 0-based disparities; valid: (H, W) bool.
    """
    if masks is None:
        masks = vote_band_masks(arms, max_arm)
    mh, mv = masks
    planes = torch.arange(d_range, dtype=di.dtype, device=di.device)
    onehot = ((di[None] == planes[:, None, None]) & valid[None]).to(
        torch.float32
    )
    # JAX's branches (int8 x int8 -> int16 while 2*max_arm+1 <= 127;
    # bfloat16, split hi/lo past 255) exist for its narrow operands. In
    # float32 (and TF32) the row counts (<= 511) and region counts
    # (< 2^24) are exact, so one product serves every arm length.
    tmp = _mm_h(mh, onehot)  # exact row counts <= 2*max_arm+1
    hist = _mm_v(mv, tmp).to(torch.int32)
    return (
        hist.argmax(dim=0).to(torch.int32),
        hist.amax(dim=0),
        hist.sum(dim=0, dtype=torch.int32),
    )
