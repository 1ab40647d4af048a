"""The rest of the port's parameter sweep (tests/test_torch_config_matrix.py
says what is held against what): the read lengths other than 100 bp, where
the step program's key takes another Lmax, and e=7 at 150 bp, where reads
map with the widest band."""

import pytest

from test_torch_config_matrix import NUM_READS, SHORT, check_config, world  # noqa: F401


@pytest.mark.parametrize("n", [NUM_READS, SHORT], ids=["full", "short"])
@pytest.mark.parametrize("name", ["len148", "len76_step2", "e7_len150"])
def test_engine_matches_golden_and_jax_config(world, name, n):  # noqa: F811
    gstats = check_config(world(name), n)
    if name == "len76_step2":  # outside the step bound: no read maps
        assert gstats.num_mapped_reads == 0 and gstats.num_candidates == 0
    else:
        assert gstats.num_mapped_reads > 0
