"""Map export in the reference's asset convention: PGM + map_server YAML
pair (reference ships its GT maps as maps/*.pgm + maps/*.yaml)."""

import numpy as np
import pytest

from roborts_slam.engine import SlamEngine
from roborts_slam.io.scenes import SCENES, load_scene_map
from roborts_slam.io.simulate import simulate_log
from roborts_slam.utils.viz import save_map
from tests.test_e2e_small import _small_config


@pytest.fixture(scope="module")
def short_engine():
    sc = SCENES["icra"]
    gt = load_scene_map(sc)
    log = simulate_log(gt, sc.laser, odom_error=sc.odom_error,
                       range_noise=0.005, seed=3, n_waypoints=2)
    cfg = _small_config()
    eng = SlamEngine(cfg, log.laser)
    eng.run_log(log)
    eng.finish()
    return eng


def test_save_map_pair(tmp_path, short_engine):
    stem = str(tmp_path / "built")
    save_map(short_engine, stem + ".pgm")

    # PGM parses and is non-trivial
    with open(stem + ".pgm", "rb") as f:
        magic = f.readline().strip()
        w, h = map(int, f.readline().split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(), np.uint8)
    assert magic == b"P5" and maxval == 255
    assert data.size == w * h
    assert set(np.unique(data)) <= {0, 205, 254}
    assert (data != 205).any()            # some known cells

    # YAML carries resolution + a world origin consistent with the engine
    from roborts_slam.config import read_flat_yaml

    meta = read_flat_yaml(stem + ".yaml")
    assert meta["image"] == "built.pgm"
    assert meta["resolution"] == pytest.approx(
        short_engine.fspec.pub_spec.resolution)
    assert len(meta["origin"]) == 3
    # origin + extent must cover the robot start (world origin)
    x0, y0 = meta["origin"][:2]
    assert x0 <= 0.0 <= x0 + w * meta["resolution"]
    assert y0 <= 0.0 <= y0 + h * meta["resolution"]
