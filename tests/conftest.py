"""Test harness: run everything on a virtual 8-device CPU mesh.

The platform switch goes through jax.config before any op, so it holds even
on a machine whose default backend is a GPU (the backend initializes
lazily). Tests that need the card carry the ``gpu`` marker, take the
``gpu_host`` fixture and skip where there is no GPU; ``python
chip_smoke.py`` covers that path on the card.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


# Heavyweight tests (5s-60s each on this 2-core box, measured 2026-08-20)
# tiered out of the inner loop. They still run in the default `pytest tests`
# and in `-m "slow or e2e"`; the policy lives here so the tier stays one
# greppable list instead of scattered decorators.
_SLOW = {
    "test_recenter.py::test_windowed_run_tracks_long_trajectory",
    "test_e2e_small.py::test_icra_end_to_end",
    "test_e2e_small.py::test_icra_end_to_end_with_optimize_matcher",
    "test_multiprocess.py::test_two_process_distributed",
    "test_engine_features.py::test_async_backend_pipeline",
    "test_engine_features.py::test_async_stress_slow_corrections",
    "test_engine_features.py::test_fused_backend_matches_unfused",
    "test_engine_features.py::test_pub_growth_pad_and_post_match_safety",
    "test_engine_features.py::test_correction_growth_covers_moved_scans",
    "test_engine_features.py::test_pub_map_grows_with_trajectory",
    "test_engine_features.py::test_checkpoint_roundtrip",
    "test_engine_features.py::test_windowed_running_range_match",
    "test_engine_features.py::test_engine_dedistortion_path",
    "test_engine_features.py::test_pipelined_pose_mirror_refreshes_after_correction",
    "test_engine_features.py::test_pipelined_snapshot_drain_keeps_commit_order",
    "test_branch_and_bound.py::test_engine_with_fast_correlation_match",
    "test_branch_and_bound.py::test_bnb_matches_exhaustive_best",
    "test_matchers.py::test_tiered_scan_match_recovers_pose",
    "test_map_export.py::test_save_map_pair",
    "test_scenes.py::test_rm_short_run",
    "test_recenter.py::test_recenter_rebuilds_from_history",
    "test_raster.py::test_batch_stamp_equals_sequential",
    "test_correlative.py::test_match_recovers_known_offset",
    "test_golden.py::test_golden_willow_trajectory",
}


def pytest_collection_modifyitems(config, items):
    """Three tiers: ``fast`` (inner loop, < 2 min total), ``slow``
    (heavyweight unit/feature tests), ``e2e`` (simulation-heavy scene
    runs). Everything not e2e and not in _SLOW is auto-marked fast."""
    for item in items:
        if item.get_closest_marker("e2e") is not None:
            continue
        base = item.nodeid.split("/")[-1].split("[")[0]
        if base in _SLOW:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)


@pytest.fixture
def gpu_host():
    """Skips unless ``nvidia-smi`` lists a GPU on this machine. Decided when
    the test runs (never at import, so every xdist worker collects the same
    tests). This process stays on the CPU; a test that needs the card runs
    its program in a child process."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    listed = ""
    if smi:
        listed = subprocess.run([smi, "-L"], capture_output=True,
                                text=True).stdout
    if "GPU" not in listed:
        pytest.skip("needs a GPU; on the card run `python chip_smoke.py`")
