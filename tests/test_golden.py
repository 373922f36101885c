"""Golden-trajectory regression.

Replays the checked-in icra log slice (tests/data/golden_icra.npz,
generated by tools/make_golden.py) through the engine with the reference
simulation config and pins the full output trajectory tightly. Scene ATE
tests bound quality; this test catches *semantics drift* — a scoring,
gating or map-update change that shifts poses while staying under the ATE
bound passes those but fails here.

Reference analogue: the stage launch files are its de-facto integration
tests (launch/roborts_slam_stage_*.launch, SURVEY §4).
"""

import os

import numpy as np
import pytest

# tolerance: CPU XLA is deterministic for a fixed wheel, but allow minor
# cross-version numeric drift; semantic changes move poses by >= one fine
# cell (0.01 m), comfortably above this
POS_TOL = 2e-3      # m
ANG_TOL = 2e-3      # rad


def _data(scene):
    path = os.path.join(os.path.dirname(__file__), "data",
                        f"golden_{scene}.npz")
    assert os.path.exists(path), (
        f"golden fixture missing — run `python tools/make_golden.py {scene}`")
    return np.load(path)


def _replay_and_pin(scene):
    from roborts_slam.models.scan import LaserModel
    from tools.make_golden import build_engine

    golden = _data(scene)
    laser = LaserModel.from_array(golden["laser"])
    engine = build_engine(laser, scene)
    kept = []
    for i in range(golden["ranges"].shape[0]):
        if engine.process(golden["ranges"][i], golden["odom"][i],
                          float(golden["times"][i])):
            kept.append(i)
    traj = engine.trajectory_array()
    exp = golden["trajectory"]

    assert kept == list(golden["kept_ids"]), (
        "kept-scan set changed: gating semantics drifted")
    assert engine.backend.num_links == int(golden["links"])
    assert engine.backend.num_loop_closures == int(golden["loops"])
    assert traj.shape == exp.shape
    dpos = np.abs(traj[:, 1:3] - exp[:, 1:3]).max()
    dth = np.abs(np.arctan2(np.sin(traj[:, 3] - exp[:, 3]),
                            np.cos(traj[:, 3] - exp[:, 3]))).max()
    assert dpos < POS_TOL, f"trajectory drifted: max|Δxy| = {dpos:.5f} m"
    assert dth < ANG_TOL, f"trajectory drifted: max|Δθ| = {dth:.5f} rad"


def test_golden_icra_trajectory():
    _replay_and_pin("icra")


def test_golden_willow_trajectory():
    """Pins the 1081-beam path (point packing + subsampled scoring)."""
    _replay_and_pin("willow")
