"""Batched banded Myers edit-distance verification (fem_tpu/ops/verify.py).

Reference semantics: banded Myers bit-parallel DP with a band of 2e+1 <= 15
bits, over pattern = the reference window starting at the band start and
text = the read, then a 2e-step band scan for (least ED, first end offset
attaining it) (src/align.c:102-147). The 3e early exit is left out: it
only rejects candidates that the full run rejects too.

`verify_candidates` runs the CUDA kernel (csrc/banded_myers.cu) on CUDA
tensors and the plain torch version beside it on CPU tensors. Codes are
below 8 (A C G T N = 0..4): the kernel compares their low three bits.

`used`, an optional 0-d integer tensor on the same device, says how many
leading slots hold a candidate. The rest are not computed: they come back
with edit distance e + 1, end offset -1, not accepted. It stays on the
device, so passing it costs no synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fem_tpu_torch import kernels
from fem_tpu_torch.ops.types import DeviceIndex

_M32 = 0xFFFFFFFF


class VerifyResult(NamedTuple):
    edit_distance: torch.Tensor  # (V,) int32
    end_offset: torch.Tensor  # (V,) int32 end position relative to band start
    accepted: torch.Tensor  # (V,) bool: ED <= e


def gather_windows(
    index: DeviceIndex, sid: torch.Tensor, pos: torch.Tensor, window_length: int
) -> torch.Tensor:
    """(V, window_length) uint8 codes from ref_offsets[sid] + pos: a direct
    byte gather from the flat reference. sid and the byte offsets clamp into
    range, so masked-out slots read sentinel gap bases."""
    sid = sid.long().clamp(0, index.ref_offsets.shape[0] - 1)
    base = index.ref_offsets[sid] + pos.long()
    w = torch.arange(window_length, device=sid.device)
    g = (base[:, None] + w[None, :]).clamp(0, index.ref_flat.shape[0] - 1)
    return index.ref_flat[g]


def compute_eq(window: torch.Tensor, text: torch.Tensor, error_threshold: int):
    """Eq[v, i] bit j = (window[v, i+j] == text[v, i]), as int64."""
    L = text.shape[1]
    eq = torch.zeros(text.shape, dtype=torch.int64, device=text.device)
    for j in range(2 * error_threshold + 1):
        eq |= (window[:, j : j + L] == text).long() << j
    return eq


def banded_myers(
    eq: torch.Tensor, lengths: torch.Tensor, error_threshold: int
) -> VerifyResult:
    """The Myers recurrence on uint32 bit-vectors carried in int64 and
    masked to 32 bits (torch has no uint32 add on the CPU)."""
    V, L = eq.shape
    e = error_threshold
    lengths = lengths.to(torch.int64)
    VP = torch.zeros(V, dtype=torch.int64, device=eq.device)
    VN = torch.zeros_like(VP)
    nerr = torch.zeros_like(VP)
    for i in range(L):
        active = i < lengths
        X = eq[:, i] | VN
        D0 = (((VP + (X & VP)) & _M32) ^ VP) | X
        HN = VP & D0
        HP = VN | (~(VP | D0) & _M32)
        X2 = D0 >> 1
        VN = torch.where(active, X2 & HP, VN)
        VP = torch.where(active, HN | (~(X2 | HP) & _M32), VP)
        nerr = torch.where(active, nerr + 1 - (D0 & 1), nerr)
    end = lengths - 1
    min_err = nerr
    for i in range(2 * e):
        nerr = nerr + ((VP >> i) & 1) - ((VN >> i) & 1)
        end = torch.where(nerr < min_err, lengths + i, end)
        min_err = torch.minimum(min_err, nerr)
    return VerifyResult(min_err.int(), end.int(), min_err <= e)


def verify_candidates_plain(
    index: DeviceIndex, v_sid, v_pos, v_lane, both, lens2, error_threshold: int,
    used: torch.Tensor | None = None,
) -> VerifyResult:
    lane = v_lane.long().clamp(0, both.shape[0] - 1)
    Lmax = both.shape[1]
    window = gather_windows(index, v_sid, v_pos, Lmax + 2 * error_threshold)
    eq = compute_eq(window, both[lane], error_threshold)
    res = banded_myers(eq, lens2[lane], error_threshold)
    if used is None:
        return res
    in_use = torch.arange(v_sid.shape[0], device=v_sid.device) < used
    return VerifyResult(
        torch.where(in_use, res.edit_distance, error_threshold + 1),
        torch.where(in_use, res.end_offset, -1),
        res.accepted & in_use,
    )


def _verify_cuda(index: DeviceIndex, v_sid, v_pos, v_lane, both, lens2, e: int, used):
    V = v_sid.shape[0]
    NB, Lmax = both.shape
    ed = torch.empty(V, dtype=torch.int32, device=v_sid.device)
    end = torch.empty_like(ed)
    if V:
        rc = kernels.library().fem_banded_myers(
            index.ref_flat.data_ptr(), index.ref_flat.shape[0],
            index.ref_offsets.data_ptr(), index.ref_offsets.shape[0],
            v_sid.data_ptr(), v_pos.data_ptr(), v_lane.data_ptr(),
            both.data_ptr(), lens2.data_ptr(), NB, Lmax, e, V,
            None if used is None else used.data_ptr(),
            ed.data_ptr(), end.data_ptr(),
            torch.cuda.current_stream(v_sid.device).cuda_stream,
        )
        kernels.check_launch(rc, "banded_myers")
        kernels.count_launch("banded_myers", (V, NB))
    return VerifyResult(ed, end, ed <= e)


def verify_candidates(
    index: DeviceIndex,
    v_sid: torch.Tensor,  # (V,) int32 chromosome ids
    v_pos: torch.Tensor,  # (V,) int32 band-start positions
    v_lane: torch.Tensor,  # (V,) int32 row of `both` holding each slot's read
    both: torch.Tensor,  # (NB, Lmax) uint8 read codes, both strands
    lens2: torch.Tensor,  # (NB,) int32 read lengths
    error_threshold: int,
    used: torch.Tensor | None = None,  # 0-d int64: leading slots in use
) -> VerifyResult:
    """Banded Myers for every slot: ED and end offset of read v_lane[v]
    against the window at ref_offsets[v_sid[v]] + v_pos[v]."""
    e = error_threshold
    if not 0 <= e <= 7:
        raise ValueError("banded Myers takes 0 <= e <= 7 (a 15-bit band)")
    tensors = dict(v_sid=v_sid, v_pos=v_pos, v_lane=v_lane, lens2=lens2)
    for name, t in tensors.items():
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
    if both.dtype != torch.uint8 or both.dim() != 2:
        raise TypeError("both must be a (NB, Lmax) uint8 tensor")
    if not (v_sid.shape == v_pos.shape == v_lane.shape
            and lens2.shape[0] == both.shape[0]):
        raise ValueError("verify_candidates: mismatched shapes")
    dev = v_sid.device
    if used is not None and (used.dtype != torch.int64 or used.dim() != 0
                             or used.device != dev):
        raise TypeError("used must be a 0-d int64 tensor on the slots' device")
    if any(t.device != dev for t in (v_pos, v_lane, both, lens2, index.ref_flat)):
        raise ValueError("verify_candidates: tensors lie on different devices")
    if dev.type == "cpu":
        return verify_candidates_plain(index, v_sid, v_pos, v_lane, both, lens2, e, used)
    if dev.type != "cuda":
        raise ValueError(f"verify_candidates runs on cpu or cuda, not {dev}")
    if not all(t.is_contiguous() for t in (v_sid, v_pos, v_lane, both, lens2)):
        raise ValueError("verify_candidates takes contiguous tensors")
    return _verify_cuda(index, v_sid, v_pos, v_lane, both, lens2, e, used)
