"""Seeded input cases shared by the port's kernel tests on the CPU
(test_torch_candidates.py, test_torch_verify.py) and on the card
(test_torch_cuda.py). No test lives here, and nothing here imports JAX."""

import numpy as np

from fem_tpu_torch.ops.types import BIG, SENTINEL_SID


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
