"""Seeded input cases shared by the port's kernel tests on the CPU
(test_torch_candidates.py, test_torch_verify.py, test_torch_compact.py) and on the card
(test_torch_cuda.py). No test lives here, and nothing here imports JAX."""

import numpy as np
import torch

from fem_tpu_torch.ops.types import BIG, SENTINEL_SID, DeviceIndex


def masked(sid, diag, valid):
    return (np.where(valid, sid, SENTINEL_SID).astype(np.int32),
            np.where(valid, diag, BIG).astype(np.int32))


def random_slabs(rng, NB, G, CAP, num_sids=3, spread=40):
    """Clustered diagonals so votes pass and dedup windows overlap, 40%
    valid (the generator of tests/test_filter_kernel.py)."""
    sid = rng.integers(0, num_sids, (NB, G, CAP)).astype(np.int32)
    diag = (rng.integers(0, spread, (NB, G, CAP))
            + rng.integers(0, 4, (NB, G, CAP))).astype(np.int32)
    valid = rng.random((NB, G, CAP)) < 0.4
    return sid, diag, valid


# ---- the edges of the kernel's design, at the main path's shape ------------
# cap_occ 80, cap_cand 16, e 5, three groups. The kernel sorts the next power
# of two of the valid count, in registers up to 32 keys and in shared memory
# above; merges with the carried list; folds chains of gaps <= e in parallel.
TAIL_SHAPE = dict(G=3, CAP=80, CC=16, e=5)
# fem_tpu's Pallas kernel runs interpreted here, which is slow: it gets the
# same cases at a narrower slab that still crosses 32 keys, at a = 1.
PALLAS_SHAPE = dict(G=2, CAP=40, CC=8, e=5)
TAIL_COUNTS = (0, 1, 8, 32, 33, "full")
TAIL_CHAINS = ("gap_e", "gap_e_plus_1", "overflow_by_one", "fills_exactly",
               "duplicates", "two_sids_interleaved")


def count_slabs(rng, shape, nvalid, NB=8):
    """Exactly `nvalid` valid keys in every (lane, group), at random slots."""
    G, CAP = shape["G"], shape["CAP"]
    nvalid = CAP if nvalid == "full" else nvalid
    sid, diag, _ = random_slabs(rng, NB, G, CAP, num_sids=2, spread=60)
    valid = np.zeros((NB, G, CAP), bool)
    for b in range(NB):
        for g in range(G):
            valid[b, g, rng.permutation(CAP)[:nvalid]] = True
    return masked(sid, diag, valid)


def chain_slabs(rng, shape, kind, NB=4):
    """One-sid chains at the greedy fold's edges; slots shuffled per lane."""
    G, CAP, CC, e = (shape[k] for k in ("G", "CAP", "CC", "e"))
    sid = np.zeros((NB, G, CAP), np.int32)
    diag = np.zeros((NB, G, CAP), np.int32)
    valid = np.zeros((NB, G, CAP), bool)

    def put(b, g, sids, diags):
        n = len(diags)
        slots = rng.permutation(CAP)[:n]
        sid[b, g, slots], diag[b, g, slots], valid[b, g, slots] = sids, diags, True

    for b in range(NB):
        start = int(rng.integers(1, 50))
        if kind == "gap_e":  # every second key is kept
            put(b, 0, 0, start + e * np.arange(33))
            put(b, 1, 0, start + 2 + e * np.arange(20))
        elif kind == "gap_e_plus_1":  # every key is a chain head: all kept
            put(b, 0, 0, start + (e + 1) * np.arange(10))
            put(b, G - 1, 0, start + (e + 1) * np.arange(10, 15))
        elif kind == "overflow_by_one":  # cap_cand + 1 kept keys
            put(b, 1, 0, start + (e + 1) * np.arange(CC + 1))
        elif kind == "fills_exactly":  # cap_cand kept keys, no overflow
            put(b, 0, 0, start + (e + 1) * np.arange(CC // 2))
            put(b, 1, 0, start + (e + 1) * np.arange(CC // 2, CC))
        elif kind == "duplicates":  # long runs of one key, then one e + 1 on
            put(b, 0, 0, np.r_[np.full(CAP // 2, start), np.full(CAP // 3, start + e + 1)])
            put(b, 1, 0, np.r_[np.full(20, start + 3), start + 2 * e + 2])
        elif kind == "two_sids_interleaved":
            d = start + e * np.arange(30)
            put(b, 0, np.arange(30) % 2, d)
            put(b, 1, 1 - np.arange(24) % 2, d[:24] + 1)
            put(b, G - 1, 0, d[:9] - 1)
    return masked(sid, diag, valid)


def tail_cases(shape):
    rng = np.random.default_rng(4242)
    cases = {f"count_{n}": count_slabs(rng, shape, n) for n in TAIL_COUNTS}
    cases.update({k: chain_slabs(rng, shape, k) for k in TAIL_CHAINS})
    return cases


TAIL_CASE_NAMES = [f"count_{n}" for n in TAIL_COUNTS] + list(TAIL_CHAINS)


# ---- the retry tiers' wide slabs -------------------------------------------
# cap_occ + cap_cand of the default ladder's tier 1 and tier 2 shapes (5120 +
# 4096 at the default G = 3; elsewhere a smaller G where the slab is wide, to
# keep the plain version's loop short), two between, and one whose scratch
# does not fit shared memory (ops/filter_tail.py:plan), so the kernel runs it
# on a workspace.
WIDE_SHAPES = {
    "tier1_640_512": dict(G=3, CAP=640, CC=512, e=5),
    "mid_2048_1024": dict(G=2, CAP=2048, CC=1024, e=5),
    "tier2_4096_4096": dict(G=2, CAP=4096, CC=4096, e=3),
    "tier2_5120_4096": dict(G=3, CAP=5120, CC=4096, e=5),
    "workspace_8200_64": dict(G=2, CAP=8200, CC=64, e=5),
}
WIDE_COUNTS = (0, 1, 33, "half", "full")
WIDE_CHAINS = ("gap_e", "gap_e_plus_1", "overflow_by_one", "fills_exactly", "evicted")
WIDE_CASE_NAMES = [f"count_{n}" for n in WIDE_COUNTS] + list(WIDE_CHAINS)
WIDE_LANES = 2  # lanes per case


def wide_chain_slabs(rng, shape, kind, NB=WIDE_LANES):
    """One-sid chains at the fold's edges, spread over the first two groups
    so that cap_cand + 1 keys fit slabs no wider than cap_cand."""
    G, CAP, CC, e = (shape[k] for k in ("G", "CAP", "CC", "e"))
    sid = np.zeros((NB, G, CAP), np.int32)
    diag = np.zeros((NB, G, CAP), np.int32)
    valid = np.zeros((NB, G, CAP), bool)

    def put(b, g, diags):
        slots = rng.permutation(CAP)[: len(diags)]
        diag[b, g, slots], valid[b, g, slots] = diags, True

    def split(b, chain):  # alternate keys between groups 0 and 1
        put(b, 0, chain[0::2])
        put(b, 1, chain[1::2])

    for b in range(NB):
        start = int(rng.integers(1, 50))
        if kind == "gap_e":  # every second key is kept
            split(b, start + e * np.arange(min(CAP, 400)))
        elif kind == "gap_e_plus_1":  # every key is a chain head: all kept
            split(b, start + (e + 1) * np.arange(CC // 2))
        elif kind == "overflow_by_one":  # cap_cand + 1 kept keys
            split(b, start + (e + 1) * np.arange(CC + 1))
        elif kind == "fills_exactly":  # cap_cand kept keys, no overflow
            split(b, start + (e + 1) * np.arange(CC))
        elif kind == "evicted":  # a full carried list, every key displaced
            chain = start + 1 + 2 * (e + 1) * np.arange(min(CC, CAP))
            put(b, 0, chain)  # kept, and the list full where CC <= CAP
            put(b, 1, chain - 1)  # each one before a carried key, within e
    return masked(sid, diag, valid)


def wide_tail_cases(shape):
    """name -> (sid, diag) of WIDE_LANES lanes each, in WIDE_CASE_NAMES order."""
    rng = np.random.default_rng(777 + shape["CAP"])
    cases = {}
    for n in WIDE_COUNTS:
        nvalid = shape["CAP"] // 2 if n == "half" else n
        cases[f"count_{n}"] = count_slabs(rng, shape, nvalid, NB=WIDE_LANES)
    cases.update({k: wide_chain_slabs(rng, shape, k) for k in WIDE_CHAINS})
    return cases



def slot_case(ref, e, Lmax, seed, NB=48, V=400):
    """Slots against reads copied from the reference with edits (so part are
    accepted), reads with N, lengths 30..Lmax and one empty read, plus
    out-of-range sids, lanes and positions, and windows that start before
    the array, run into the gap between chromosomes, and pass its end."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(30, Lmax + 1, NB).astype(np.int32)
    lens[0] = 0
    lens[-1] = Lmax  # a read of the full width: every 32-base chunk of the loop
    both = rng.integers(0, 5, (NB, Lmax)).astype(np.uint8)
    v_lane = rng.integers(0, NB, V).astype(np.int32)
    v_sid = rng.integers(0, ref.num_seqs, V).astype(np.int32)
    v_pos = np.array([rng.integers(0, ref.lengths[s] - Lmax - 2 * e) for s in v_sid], np.int32)
    for v in range(0, V, 2):  # planted matches: read = window diagonal + edits
        lane = v_lane[v]
        off = int(ref.offsets[v_sid[v]]) + int(v_pos[v]) + e
        both[lane] = ref.flat_codes[off : off + Lmax]
        for _ in range(rng.integers(0, e + 2)):
            both[lane, rng.integers(0, Lmax)] = rng.integers(0, 4)
        if v % 8 == 0:
            both[lane, rng.integers(0, Lmax)] = 4  # an N in the read
    v_sid[1], v_lane[3], v_pos[5], v_pos[7] = 99, -2, -500, 2**30
    total = int(ref.flat_codes.shape[0])
    for v in range(9, 41, 2):  # around a chromosome's end and the array's ends
        s = v_sid[v]
        v_pos[v] = int(ref.lengths[s]) - rng.integers(0, Lmax + 2 * e + 40)
    v_sid[41], v_pos[41] = 0, -int(ref.offsets[0]) - 7  # before byte 0
    v_sid[43], v_pos[43] = ref.num_seqs - 1, total - int(ref.offsets[-1]) - 20  # past the end
    return v_sid, v_pos, v_lane, both, lens


# The parameter sweep of tests/test_config_matrix.py, and e=7 at 150 bp
# inside FEM's step bound (docs/SOAK.md): name -> (k, step, e, a, read
# length, most errors a simulated read carries). Mapped on the CPU by
# tests/test_torch_config_matrix*.py and on the card by
# tests/test_torch_cuda.py.
SWEEP_CONFIGS = {
    "e7_a2": (12, 3, 7, 2, 100, 3),  # max error threshold + max additional q-grams
    "e0": (12, 3, 0, 1, 100, 0),  # zero errors
    "e5_a0": (12, 3, 5, 0, 100, 3),  # no additional q-grams
    "k10_step5": (10, 5, 3, 1, 100, 3),  # non-default k/step
    "len148": (12, 3, 2, 1, 148, 2),  # longer reads (Lmax bucket 160)
    "len76_step2": (12, 2, 4, 1, 76, 3),  # short reads, step 2
    "e7_len150": (12, 3, 7, 2, 150, 7),  # e=7 inside the step bound: reads map
}
SWEEP_CAPS = dict(batch_size=48, cap_occ=256, cap_cand=128, verify_per_read=32,
                  accept_per_read=16)


# ---- the occurrence slab (ops/occ_slab.py, csrc/occ_slab_core.h) ----------
# Seed tables of (NB, G, S) items against a random occurrence table, each
# case at one edge of the slab's rules: the widths are tier 0's, tier 1's
# and tier 2's cap_occ.
OCC_WIDTHS = (256, 2048, 16384)
OCC_CASE_NAMES = ("random", "mid_row", "run_cap", "run_cap_plus_1", "demand_cap",
                  "demand_cap_plus_1", "before_read_offset", "tie", "lane_off",
                  "empty_runs")


def occ_case(name, cap, S=7, NB=4, G=3, seed=0):
    """dict(off, lfreq, start: (NB, G, S) int64; lane_ok: (NB, G) bool;
    occ: (N,) int64 keys sid << 32 | pos) for the case `name`."""
    rng = np.random.default_rng([seed, cap, S, OCC_CASE_NAMES.index(name)])
    n = 4 * cap + 16 * NB * G * S + 4096
    sid = rng.integers(0, 3, n)
    pos = rng.integers(0, 6000, n)
    occ = (sid << 32) | pos
    shape = (NB, G, S)
    lfreq = rng.choice([0, 1, 2, 5, 9, 17, max(cap // 8, 1), max(cap // S, 1)], shape)
    start = rng.integers(0, 60, shape)
    lane_ok = rng.random((NB, G)) < 0.9
    if name == "mid_row":  # every run starts inside its 8-slot row
        lfreq = rng.integers(1, 30, shape)
        off = rng.integers(0, (n - 64) // 8, shape) * 8 + rng.integers(1, 8, shape)
    elif name in ("run_cap", "run_cap_plus_1"):  # one seed a group fills it, or one more
        lfreq = rng.integers(0, 4, shape)
        j = rng.integers(0, S, (NB, G))
        extra = [cap] if name == "run_cap" else [cap + 1, cap + 1000]
        lfreq[np.arange(NB)[:, None], np.arange(G)[None, :], j] = rng.choice(extra, (NB, G))
    elif name in ("demand_cap", "demand_cap_plus_1"):  # rows sum to cap, or a row more
        srow = rng.integers(0, 8, shape)
        rows = np.zeros(shape, np.int64)
        for b in range(NB):
            for g in range(G):
                cut = np.sort(rng.integers(0, cap // 8 + 1, S - 1))
                rows[b, g] = np.diff(np.r_[0, cut, cap // 8])
        rows[..., -1] += name == "demand_cap_plus_1"
        lfreq = np.where(rows > 0, 8 * rows - srow - rng.integers(0, 8, shape) * (rows > 1), 0)
        lfreq = np.where(8 * rows - srow - lfreq >= 8, 8 * rows - srow, lfreq)
        off = rng.integers(0, (n - cap - 64) // 8, shape) * 8 + srow
    elif name == "before_read_offset":  # many occurrences lie before the seed's offset
        start = rng.integers(2000, 5000, shape)
        lfreq = rng.integers(1, 40, shape)
    elif name == "lane_off":
        lane_ok[:] = False
        lane_ok[0, 0] = True
    elif name == "empty_runs":  # no run in some seeds, first and last among them
        lfreq[..., 0] = 0
        lfreq[..., 3 % S] = 0
        lfreq[1, :, -1] = 0
        lfreq[2, 1] = 0  # a group with no run at all
    if name not in ("mid_row", "demand_cap", "demand_cap_plus_1"):
        off = rng.integers(0, n - int(lfreq.max(initial=0)) - 8, shape)
    if name in ("run_cap", "run_cap_plus_1"):  # lane 0: the one run alone, row-aligned
        big = lfreq[0] >= cap
        lfreq[0] = np.where(big, lfreq[0], 0)
        off[0] = np.where(big, off[0] // 8 * 8, off[0])
    if name == "tie":  # the last seed's keys equal to, and one past, the bound
        off = rng.permutation(n // 8)[: NB * G * S].reshape(shape) * 8  # runs apart
        lfreq[:] = 2
        lane_ok[:] = True
        start[:] = 10
        for b in range(NB):
            for g in range(G):
                base = int(off[b, g, 0])
                for j in range(S - 1):  # the other seeds: sid 1, diag <= 100
                    o = int(off[b, g, j])
                    occ[o : o + 2] = (1 << 32) | (10 + rng.integers(0, 100, 2))
                occ[base] = (1 << 32) | 110  # the bound: (1, 100)
                o = int(off[b, g, S - 1])
                occ[o] = (1 << 32) | (110 + (b + g) % 2)  # ties it, or passes it by one
                occ[o + 1] = (rng.integers(0, 3) << 32) | 50
    return dict(off=off.astype(np.int64), lfreq=lfreq.astype(np.int64),
                start=start.astype(np.int64), lane_ok=lane_ok, occ=occ.astype(np.int64))


# ---- the slab compactions (ops/compact.py, csrc/compact_core.h) -----------
# Filter-tail lists as the tail writes them (each lane ascending by (sid,
# pos), the sentinels last), a read length a lane, chromosome lengths, and
# Myers' results for the verify slab those lists fill; each case at one edge
# of the compactions: the widths are tier 0's, tier 1's and tier 2's
# cap_cand, at as many lanes as the CPU's emulated blocks run quickly.
COMPACT_WIDTHS = {256: 24, 2048: 6, 16384: 4}  # cap_cand: lanes
COMPACT_CASE_NAMES = ("random", "empty_lanes", "all_empty", "not_prefix", "full_lane",
                      "verify_cap_mid_lane", "acc_cap_mid_lane", "shard")
COMPACT_REF_LENGTHS = (9000, 5000, 7000)


def compact_case(name, cc, NB=None, seed=0):
    """dict(cand_sid, cand_pos: (NB, CC) int32; lengths: (NB,) int32;
    ref_lengths, own_start, own_end: (S,) int32, the last two None but on
    `shard`; e; verify_cap; acc_cap: None, set by `accept_inputs`)."""
    NB = NB or COMPACT_WIDTHS[cc]
    rng = np.random.default_rng([seed, cc, NB, COMPACT_CASE_NAMES.index(name)])
    e = 5
    ref = np.array(COMPACT_REF_LENGTHS, np.int32)
    lengths = rng.integers(80, 121, NB).astype(np.int32)
    counts = rng.integers(0, min(cc, 60) + 1, NB)
    if name in ("empty_lanes", "verify_cap_mid_lane", "acc_cap_mid_lane"):
        counts[rng.random(NB) < 0.6] = 0
        counts[NB // 2] = max(counts[NB // 2], 12)
    if name == "all_empty":
        counts[:] = 0
    if name == "not_prefix":
        counts = np.maximum(counts, 4)
    if name == "full_lane":  # lane 1 fills its list: no sentinel to stop at
        counts[1] = cc
    sid = np.full((NB, cc), SENTINEL_SID, np.int32)
    pos = np.full((NB, cc), BIG, np.int32)
    for b in range(NB):
        keys = np.zeros(0, np.int64)
        while len(keys) < counts[b]:  # distinct keys, as the fold leaves them
            n = int(counts[b])
            s = rng.integers(0, len(ref), n)
            # most bands inside their chromosome, the rest over an edge
            lo, hi = e, ref[s] - lengths[b] - e
            p = rng.integers(lo, hi)
            edge = rng.random(n)
            if name != "full_lane":
                p = np.where(edge < 0.15, rng.integers(0, e + 1, n), p)
                p = np.where(edge > 0.85, hi + rng.integers(-1, e, n), p)
            keys = np.unique(np.r_[keys, (s.astype(np.int64) << 32) | p])
        keys = np.sort(rng.choice(keys, int(counts[b]), replace=False))
        if name == "not_prefix":  # in every lane, a dropped band between two kept ones
            keys[:3] = np.sort([100, 9000 - int(lengths[b]) - e, (1 << 32) | 50])
            keys = np.unique(keys)
        sid[b, : len(keys)] = keys >> 32
        pos[b, : len(keys)] = keys & 0xFFFFFFFF
    own_start = own_end = None
    if name == "shard":  # this shard owns a middle stretch of each chromosome
        own_start = (ref // 4).astype(np.int32)
        own_end = (ref * 3 // 4).astype(np.int32)
        own_end[2] = own_start[2]  # and nothing of the last
    valid = _compact_valid(sid, pos, lengths, ref, own_start, own_end, e)
    n = valid.sum(axis=1)
    verify_cap = int(n.sum()) + 7
    if name == "verify_cap_mid_lane":
        lane = int(np.flatnonzero(n >= 2)[len(np.flatnonzero(n >= 2)) // 2])
        verify_cap = int(n[:lane].sum() + n[lane] // 2)
    return dict(cand_sid=sid, cand_pos=pos, lengths=lengths, ref_lengths=ref,
                own_start=own_start, own_end=own_end, e=e, verify_cap=verify_cap,
                acc_cap=None)


def _compact_valid(sid, pos, lengths, ref, own_start, own_end, e):
    s = np.clip(sid, 0, len(ref) - 1)
    valid = (sid != SENTINEL_SID) & (pos >= e) & (
        pos.astype(np.int64) + lengths[:, None] + e < ref[s])
    if own_start is not None:
        valid &= (pos >= own_start[s]) & (pos < own_end[s])
    return valid


def compact_reference(c):
    """The compactions by loops over lanes and slots, from the rules alone:
    the verify slab (sid, pos, lane), each lane's count and offset and the
    total; then, from `accept_inputs`' Myers results, the accept slab
    (lane, sid, pos, ed, end), the accepted total and each lane's ok."""
    sid, pos, e, cap = c["cand_sid"], c["cand_pos"], c["e"], c["verify_cap"]
    valid = _compact_valid(sid, pos, c["lengths"], c["ref_lengths"], c["own_start"],
                           c["own_end"], e)
    v = np.zeros((3, cap), np.int32)
    num = valid.sum(axis=1).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(num)[:-1]]).astype(np.int64)
    slot = 0
    for b in range(sid.shape[0]):
        for i in np.flatnonzero(valid[b]):
            if slot < cap:
                v[:, slot] = sid[b, i], pos[b, i] - e, b
            slot += 1
    out = dict(v_sid=v[0], v_pos=v[1], v_lane=v[2], num_candidates=num, offset=off,
               total=slot)
    if c["acc_cap"] is None:
        return out
    acc, ed, end, acap = c["accepted"], c["ed"], c["end"], c["acc_cap"]
    a = np.zeros((5, acap), np.int32)
    ok = np.zeros(sid.shape[0], bool)
    k = 0
    for b in range(sid.shape[0]):
        lo, hi = off[b], min(off[b] + num[b], cap)
        for s in range(lo, max(lo, hi)):
            if acc[s]:
                if k < acap:
                    a[:, k] = b, v[0, s], v[1, s], ed[s], end[s]
                k += 1
        ok[b] = off[b] + num[b] <= cap and k <= acap
    out.update(a_lane=a[0], a_sid=a[1], a_pos=a[2], a_ed=a[3], a_end=a[4], n_accepted=k,
               ok=ok)
    return out


def accept_inputs(c, seed=0):
    """Myers' results for case `c`'s verify slab as banded_myers leaves
    them: about half the slots in use accepted (ed <= e), ed = e + 1 and
    end = -1 past them; sets c's accepted, ed, end and an acc_cap that
    holds every accepted hit."""
    ref = compact_reference(c)
    rng = np.random.default_rng([seed, c["verify_cap"], len(c["lengths"])])
    cap, e = c["verify_cap"], c["e"]
    used = min(ref["total"], cap)
    ed = rng.integers(0, 2 * e + 2, cap).astype(np.int32)
    end = rng.integers(90, 131, cap).astype(np.int32)
    ed[used:], end[used:] = e + 1, -1
    acc = ed <= e
    c.update(accepted=acc, ed=ed, end=end, acc_cap=int(acc.sum()) + 3)
    return c


def cut_accept_mid_lane(c):
    """acc_cap inside the accepted hits of a lane that has two or more."""
    num = compact_reference(c)["num_candidates"]
    off = np.concatenate([[0], np.cumsum(num)[:-1]])
    per_lane = np.array([c["accepted"][o : o + n].sum() for o, n in zip(off, num)])
    two = np.flatnonzero(per_lane >= 2)
    lane = int(two[len(two) // 2])
    c["acc_cap"] = int(per_lane[:lane].sum() + per_lane[lane] // 2)
    return c


def compact_full_case(name, cc, NB=None, seed=0):
    """compact_case with its Myers results (accept_inputs), acc_cap cut
    mid-lane on `acc_cap_mid_lane`."""
    c = accept_inputs(compact_case(name, cc, NB, seed), seed)
    return cut_accept_mid_lane(c) if name == "acc_cap_mid_lane" else c


def compact_index(c, device="cpu") -> DeviceIndex:
    """A DeviceIndex holding what the compactions read of one: case `c`'s
    chromosome lengths and, on `shard`, its owned ranges."""
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)
    z = torch.zeros(1, dtype=torch.int64, device=device)
    return DeviceIndex(occ=z, lookup=z, freq_table=z.int(), ref_flat=z.byte(), ref_offsets=z,
                       ref_lengths=t(c["ref_lengths"]), num_occurrences=1,
                       own_start=t(c["own_start"]), own_end=t(c["own_end"]))


def compact_outputs(v, a) -> dict:
    """A VerifySlab's and an AcceptSlab's tensors under compact_reference's
    names, as numpy."""
    out = dict(v_sid=v.sid, v_pos=v.pos, v_lane=v.lane, num_candidates=v.num_candidates,
               offset=v.offset, total=v.total, a_lane=a.lane, a_sid=a.sid, a_pos=a.pos,
               a_ed=a.ed, a_end=a.end, n_accepted=a.n_accepted, ok=a.ok)
    return {k: x.cpu().numpy() for k, x in out.items()}
