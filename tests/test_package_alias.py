"""The package's former import name still imports, as an alias."""

import importlib
import os
import pkgutil

import roborts_slam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _former_name():
    names = [m.name for m in pkgutil.iter_modules([REPO])
             if m.ispkg and m.name.startswith("roborts_slam_")]
    assert len(names) == 1, names
    return names[0]


def test_former_name_yields_the_same_modules():
    former = _former_name()
    assert importlib.import_module(former) is roborts_slam
    engine = importlib.import_module(former + ".engine")
    assert engine is importlib.import_module("roborts_slam.engine")
    spa = importlib.import_module(former + ".backend.spa")
    assert spa.solve_pose_graph is \
        importlib.import_module("roborts_slam.backend.spa").solve_pose_graph
    assert engine.__name__ == "roborts_slam.engine"
