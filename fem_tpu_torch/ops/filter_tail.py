"""The candidate filter's tail: sort + pigeonhole vote + greedy dedup fold.

Reference semantics (src/filter.c:80-144): per read-strand lane and seed
group, the group's (sid, diag) pairs are sorted, the additional-q-gram
vote keeps a pair only when its a-th successor has the same sid and lies
within e (src/filter.c:118-131), and the survivors merge with the carried
candidate list through the greedy +-e dedup, which can evict earlier
winners (src/filter.c:45-78,210-212). The first cap_cand kept candidates
carry to the next group; overflow marks a lane that kept more.

`filter_tail` runs the CUDA kernel (csrc/filter_tail.cu) on a CUDA tensor,
at any cap_cand + cap_occ (the retry tiers ask for thousands), and the
plain torch version beside it on a CPU tensor. Which of the kernel's
programs a width takes, and the scratch it needs, is `plan`: one rule, in
csrc/filter_tail_core.h, that this wrapper and the host build both ask. Layout as
fem_tpu.ops.filter_tail_pallas: (NB, G, CAP) int32 in, invalid slots at
(SENTINEL_SID, BIG); (NB, CC) int32 candidate lists out, ascending, with
the sentinel in the tail slots, plus an (NB,) bool overflow.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fem_tpu_torch import kernels
from fem_tpu_torch.ops.types import BIG, SENTINEL_SID

# The kernel's programs by route (csrc/filter_tail.cu), as the profiler
# names them.
KERNEL_NAMES = ("filter_tail_kernel", "filter_tail_block_kernel", "filter_tail_ws_kernel")
WORKSPACE_ROUTE = 2
# Rows of the workspace a width of route 2 gets, one a block of 1024
# threads: one such block an SM is resident (its registers leave no room
# for a second) on the H100's 132; each block walks over lanes.
WORKSPACE_ROWS = 132
_M32 = 0xFFFFFFFF
_SENT_KEY = (SENTINEL_SID << 32) | BIG


def filter_tail_plain(
    sid: torch.Tensor, diag: torch.Tensor, cap_cand: int, e: int, a: int
):
    """Plain torch version; keys pack (sid, diag) as sid << 32 | diag."""
    NB, G, CAP = sid.shape
    dev = sid.device
    keys = (sid.long() << 32) | diag.long()
    cand = torch.full((NB, cap_cand), _SENT_KEY, dtype=torch.int64, device=dev)
    overflow = torch.zeros(NB, dtype=torch.bool, device=dev)
    for g in range(G):
        s = torch.sort(keys[:, g], dim=1).values
        if a > 0:
            succ = torch.cat(
                [s[:, a:], torch.full((NB, a), _SENT_KEY, dtype=torch.int64, device=dev)],
                dim=1,
            )
            voted = (
                ((s >> 32) != SENTINEL_SID)
                & ((succ >> 32) == (s >> 32))
                & ((succ & _M32) <= (s & _M32) + e)
            )
            s = torch.where(voted, s, _SENT_KEY)
        merged = torch.sort(torch.cat([cand, s], dim=1), dim=1).values
        last_s = torch.full((NB,), -1, dtype=torch.int64, device=dev)
        last_d = torch.zeros(NB, dtype=torch.int64, device=dev)
        n_keep = torch.zeros(NB, dtype=torch.int64, device=dev)
        kept = torch.full_like(merged, _SENT_KEY)
        for i in range(merged.shape[1]):
            si, di = merged[:, i] >> 32, merged[:, i] & _M32
            keep = (si != SENTINEL_SID) & (
                (si > last_s) | ((si == last_s) & (di > last_d + e))
            )
            last_s = torch.where(keep, si, last_s)
            last_d = torch.where(keep, di, last_d)
            n_keep += keep
            kept[:, i] = torch.where(keep, merged[:, i], _SENT_KEY)
        overflow |= n_keep > cap_cand
        cand = torch.sort(kept, dim=1).values[:, :cap_cand]
    return (cand >> 32).int(), (cand & _M32).int(), overflow


class TailPlan(NamedTuple):
    """Where the kernel runs a width (csrc/filter_tail_core.h:ft::plan)."""

    route: int  # 0 a warp a lane, 1 a block a lane, 2 a block on a workspace row
    threads: int  # threads a lane
    words: int  # int64 words of a lane's scratch (block routes)

    @property
    def kernel(self) -> str:
        return KERNEL_NAMES[self.route]

    @property
    def in_shared_memory(self) -> bool:
        return self.route != WORKSPACE_ROUTE


def plan(cap_occ: int, cap_cand: int, host_check=None) -> TailPlan:
    """ft::plan of the width cap_cand + cap_occ, asked of the kernel library
    (built on first use), or of `host_check`, the g++ build of the same
    header (kernels.build_host_check)."""
    ask = (kernels.library().fem_filter_tail_plan if host_check is None
           else host_check.fem_host_filter_tail_plan)
    threads, words = ctypes.c_int(), ctypes.c_int64()
    route = ask(cap_occ, cap_cand, ctypes.byref(threads), ctypes.byref(words))
    return TailPlan(route, threads.value, words.value)


def _filter_tail_cuda(sid, diag, cap_cand: int, e: int, a: int, threads: int = 0):
    """The kernel; `threads` sets a block lane's T (0: the plan's), for
    timing the choice (tools/torch_tail_bench.py)."""
    NB, G, CAP = sid.shape
    out_sid = torch.empty((NB, cap_cand), dtype=torch.int32, device=sid.device)
    out_pos = torch.empty_like(out_sid)
    overflow = torch.empty(NB, dtype=torch.bool, device=sid.device)
    if NB == 0:
        return out_sid, out_pos, overflow
    ws, ws_rows = None, 0
    p = plan(CAP, cap_cand)
    if p.route == WORKSPACE_ROUTE:
        ws_rows = min(NB, WORKSPACE_ROWS)
        ws = torch.empty(ws_rows * p.words, dtype=torch.int64, device=sid.device)
    rc = kernels.library().fem_filter_tail(
        sid.data_ptr(), diag.data_ptr(), NB, G, CAP, cap_cand, e, a,
        out_sid.data_ptr(), out_pos.data_ptr(), overflow.data_ptr(),
        None if ws is None else ws.data_ptr(), ws_rows, threads,
        torch.cuda.current_stream(sid.device).cuda_stream,
    )
    kernels.check_launch(rc, "filter_tail")
    kernels.count_launch("filter_tail", (CAP, cap_cand))
    return out_sid, out_pos, overflow


def filter_tail(
    sid: torch.Tensor,  # (NB, G, CAP) int32, invalid = SENTINEL_SID
    diag: torch.Tensor,  # (NB, G, CAP) int32 in [0, 2^30], invalid = BIG
    cap_cand: int,
    error_threshold: int,
    num_additional_qgrams: int,
):
    """Returns (cand_sid (NB, CC), cand_pos (NB, CC), overflow (NB,))."""
    if sid.dtype != torch.int32 or diag.dtype != torch.int32:
        raise TypeError("filter_tail takes int32 sid and diag")
    if sid.dim() != 3 or sid.shape != diag.shape:
        raise ValueError(f"filter_tail takes two (NB, G, CAP) slabs, got "
                         f"{tuple(sid.shape)} and {tuple(diag.shape)}")
    if sid.device != diag.device:
        raise ValueError("sid and diag lie on different devices")
    if sid.device.type == "cpu":
        return filter_tail_plain(
            sid, diag, cap_cand, error_threshold, num_additional_qgrams
        )
    if sid.device.type != "cuda":
        raise ValueError(f"filter_tail runs on cpu or cuda, not {sid.device}")
    if not (sid.is_contiguous() and diag.is_contiguous()):
        raise ValueError("filter_tail takes contiguous slabs")
    return _filter_tail_cuda(
        sid, diag, cap_cand, error_threshold, num_additional_qgrams
    )
