"""Native RSLG scan-log runtime vs the Python ingest path."""

import numpy as np
import pytest

from roborts_slam.io.native_log import (
    NativeScanStream, decode_scan, native_available, write_rslg,
)
from roborts_slam.io.scan_log import ScanLog
from roborts_slam.models.scan import LaserModel, scan_from_ranges

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no native toolchain")


def _make_log(n=20, beams=64):
    rng = np.random.default_rng(0)
    laser = LaserModel(angle_min=-1.5, angle_max=1.5, range_min=0.05,
                       range_max=8.0, num_beams=beams)
    ranges = rng.uniform(0.0, 9.0, (n, beams)).astype(np.float32)
    odom = rng.normal(0, 1, (n, 3))
    times = np.arange(n) * 0.1
    gt = odom + 0.01
    return ScanLog(ranges=ranges, odom=odom, times=times, laser=laser,
                   gt_poses=gt)


def test_rslg_roundtrip_decode(tmp_path):
    log = _make_log()
    path = str(tmp_path / "log.rslg")
    write_rslg(log, path)

    MP = 96
    for i in (0, 7, 19):
        pts, msk, nv, t, odom = decode_scan(path, i, MP)
        ref = scan_from_ranges(log.ranges[i], log.laser, log.odom[i],
                               log.times[i], MP)
        ref_n = int(np.sum(np.asarray(ref.mask)))
        assert nv == ref_n, (nv, ref_n)
        np.testing.assert_allclose(pts[:nv], np.asarray(ref.points)[:ref_n],
                                   atol=1e-5)
        np.testing.assert_allclose(odom, log.odom[i])
        assert abs(t - log.times[i]) < 1e-12


def test_rslg_stream_order_and_content(tmp_path):
    log = _make_log(n=37)
    path = str(tmp_path / "log.rslg")
    write_rslg(log, path)
    stream = NativeScanStream(path, max_points=96, ring_slots=4)
    assert stream.n_scans == 37
    assert stream.laser.num_beams == 64
    seen = []
    for idx, pts, msk, nv, t, odom in stream:
        seen.append(idx)
        assert msk[:nv].all() and not msk[nv:].any()
    assert seen == list(range(37))
    stream.close()
