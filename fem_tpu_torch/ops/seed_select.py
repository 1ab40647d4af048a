"""Optimal prefix q-gram selection (fem_tpu/ops/seed_select.py).

Reference semantics (generate_optimal_prefix_qgram_for_group_seeding,
src/filter.c:3-43): per seed group pick e+1+a non-overlapping seeds (span
ceil(k/step) in group coordinates) of least total occurrence count, by a
(e+a+2) x (Ng - (e+1+a)*span + 2) DP whose sums wrap at 32 bits and compare
unsigned; ties prefer the horizontal move (skip the seed).

One DP lane per (read, strand, group). PyTorch on the CPU has no uint32
add or compare, so sums ride in int64 and are masked to 32 bits after
every add: in [0, 2^32) a signed compare is the unsigned one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fem_tpu_torch.ops.types import FilterParams

U32 = 0xFFFFFFFF


class SeedSelection(NamedTuple):
    positions: torch.Tensor  # (NL, S) int64 group-coord positions, -1 = unfilled
    min_total: torch.Tensor  # (NL,) int64 in [0, 2^32): uint32 minimum total
    complete: torch.Tensor  # (NL,) bool — all S seeds selected (non-degenerate)
    degenerate: torch.Tensor  # (NL,) bool — DP had < 2 columns


def select_qgrams(
    freqs: torch.Tensor,  # (NL, NGmax) per-group seed frequencies (< 2^32)
    group_sizes: torch.Tensor,  # (NL,) true seeds per group
    occurrence_table_size: int,
    params: FilterParams,
) -> SeedSelection:
    NL, NGmax = freqs.shape
    dev = freqs.device
    S = params.num_qgrams  # seeds to select = R - 1
    R = S + 1
    sl = params.seed_span
    NC = params.max_dp_cols
    sentinel = occurrence_table_size & U32

    # Cell (row, col) reads freqs[col + (row-1)*sl - 1]: a static position.
    freqs_t = freqs.to(torch.int64).T.contiguous()  # (NGmax, NL)

    def xs(col, row):
        return freqs_t[min(max(col + row * sl - 1, 0), NGmax - 1)]

    m_prev = [torch.zeros(NL, dtype=torch.int64, device=dev)] + [
        torch.full((NL,), sentinel, dtype=torch.int64, device=dev)
        for _ in range(R - 1)
    ]
    vert_cols = torch.zeros((NC, R, NL), dtype=torch.bool, device=dev)
    m_last = []
    for col in range(1, NC):
        rows = [m_prev[0]]
        for row in range(1, R):
            with_new = (rows[row - 1] + xs(col, row - 1)) & U32
            take_vertical = with_new < m_prev[row]
            rows.append(torch.where(take_vertical, with_new, m_prev[row]))
            vert_cols[col, row] = take_vertical
        m_prev = rows
        m_last.append(rows[R - 1])
    m_last = torch.stack(m_last)  # (NC-1, NL)

    nc_lane = group_sizes.long() - S * sl + 2
    degenerate = nc_lane < 2
    final_col = (nc_lane - 1).clamp(1, NC - 1)
    min_total = torch.gather(m_last, 0, (final_col - 1)[None])[0]
    # Degenerate groups: the reference's DP never runs and its result cell
    # is the occurrence_table_size sentinel (src/filter.c:9,202).
    min_total = torch.where(degenerate, sentinel, min_total)

    # Traceback (src/filter.c:29-41): lastv[col, row] = the last column
    # <= col whose decision in this row is vertical (0 = the stop sentinel).
    col_ids = torch.arange(NC, device=dev)[:, None, None]
    lastv = torch.cummax(torch.where(vert_cols, col_ids, 0), dim=0).values
    selected = torch.full((NL, S), -1, dtype=torch.int64, device=dev)
    col = final_col
    ok = ~degenerate
    for row in range(R - 1, 0, -1):
        c_star = torch.gather(lastv[:, row], 0, col.clamp(0, NC - 1)[None])[0]
        hit = ok & (c_star > 0)
        selected[:, (R - 1) - row] = torch.where(
            hit, c_star + (row - 1) * sl - 1, -1
        )
        col = c_star  # a vertical move goes up in the same column
        ok = hit
    complete = (selected >= 0).all(dim=1) & ~degenerate
    return SeedSelection(selected, min_total, complete, degenerate)
