"""Scaling harness mechanics on the 8-fake-device mesh."""

import pytest

from barcoder_tpu.parallel.scaling import measure_scaling


@pytest.mark.slow
def test_measure_scaling_mechanics():
    r = measure_scaling(
        n_bp=1 << 16, n_spacers=128, repeats=1, device_counts=[1, 2, 8],
        single_chip=False,
    )
    assert r["fake_devices"] is True
    for eng in ("flagship",):
        assert [p["devices"] for p in r[eng]] == [1, 2, 8]
        for p in r[eng]:
            assert p["spacer_positions_per_s"] > 0
        assert r[eng][0]["efficiency"] == 1.0
    # the flagship path returns real hits (the planted workload guarantees
    # every spacer hits its own site at v=1 NGG-permissively >= 0 hits)
    assert all("hits" in p for p in r["flagship"])


@pytest.mark.slow
def test_measure_multihost_mechanics():
    """The multi-HOST scaling harness (SURVEY §7 step 6's efficiency
    harness over DCN): 2 real processes x 2 fake devices, identical hit
    sets across hosts."""
    from barcoder_tpu.parallel.scaling import measure_multihost

    r = measure_multihost(
        n_bp=1 << 16, n_spacers=64, n_processes=2, devices_per_process=2,
        P=256, repeats=1,
    )
    assert r["global_devices"] == 4
    assert r["hit_sets_identical"] is True
    assert len(r["per_process_seconds"]) == 2


@pytest.mark.slow
def test_measure_multihost_count_workload():
    """The counting twin of the scaling harness: 2 real processes run the
    chunk-ownership run_count over a shared FASTQ — identical collated
    counts on every host, disjoint parse shares covering the stream."""
    from barcoder_tpu.parallel.scaling import measure_multihost

    r = measure_multihost(
        n_bp=0, n_spacers=0, n_processes=2, devices_per_process=2,
        P=256, repeats=1, workload="count",
    )
    assert r["counts_identical"] is True
    assert r["owned_covers_stream"] is True
    assert all(o > 0 for o in r["owned_reads"])
