"""rosbag v2.0 reader: round-trip against a synthesized bag."""

import bz2
import dataclasses
import struct

import numpy as np
import pytest

from roborts_slam.io.rosbag import bag_to_scan_log, read_bag_messages


def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        f = k.encode() + b"=" + v
        out += struct.pack("<I", len(f)) + f
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _ros_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _laserscan_bytes(t: float, ranges: np.ndarray, angle_min=-1.57,
                     angle_inc=0.01, range_min=0.05, range_max=8.0) -> bytes:
    secs, nsecs = int(t), int((t - int(t)) * 1e9)
    beams = len(ranges)
    out = struct.pack("<I", 0)                       # seq
    out += struct.pack("<II", secs, nsecs)
    out += _ros_string("laser")
    out += struct.pack("<7f", angle_min, angle_min + angle_inc * (beams - 1),
                       angle_inc, 0.0, 0.025, range_min, range_max)
    out += struct.pack("<I", beams) + np.asarray(ranges, "<f4").tobytes()
    out += struct.pack("<I", 0)                      # intensities
    return out


def _odometry_bytes(t: float, x: float, y: float, yaw: float) -> bytes:
    secs, nsecs = int(t), int((t - int(t)) * 1e9)
    out = struct.pack("<I", 0)
    out += struct.pack("<II", secs, nsecs)
    out += _ros_string("odom") + _ros_string("base_link")
    qz, qw = np.sin(yaw / 2), np.cos(yaw / 2)
    out += struct.pack("<7d", x, y, 0.0, 0.0, 0.0, qz, qw)
    out += struct.pack("<36d", *([0.0] * 36))        # pose covariance
    # twist omitted — parser doesn't read past the quaternion
    return out


def _write_bag(path, chunked: bool, compression: str = "none"):
    rng = np.random.default_rng(0)
    scans = [(10.0 + 0.1 * i, rng.uniform(0.1, 7.9, 32)) for i in range(5)]
    odoms = [(9.95 + 0.1 * i, 0.1 * i, -0.05 * i, 0.02 * i) for i in range(7)]

    conn_scan = _record({"op": b"\x07", "conn": (0).to_bytes(4, "little"),
                         "topic": b"/scan"},
                        _header({"type": b"sensor_msgs/LaserScan",
                                 "md5sum": b"x", "message_definition": b""}))
    conn_odom = _record({"op": b"\x07", "conn": (1).to_bytes(4, "little"),
                         "topic": b"/odom"},
                        _header({"type": b"nav_msgs/Odometry",
                                 "md5sum": b"x", "message_definition": b""}))
    msgs = b""
    for t, r in scans:
        msgs += _record({"op": b"\x02", "conn": (0).to_bytes(4, "little"),
                         "time": struct.pack("<II", int(t), 0)},
                        _laserscan_bytes(t, r))
    for t, x, y, yaw in odoms:
        msgs += _record({"op": b"\x02", "conn": (1).to_bytes(4, "little"),
                         "time": struct.pack("<II", int(t), 0)},
                        _odometry_bytes(t, x, y, yaw))

    body = conn_scan + conn_odom + msgs
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record({"op": b"\x03", "index_pos": (0).to_bytes(8, "little"),
                         "conn_count": (2).to_bytes(4, "little"),
                         "chunk_count": (1).to_bytes(4, "little")},
                        b"\x20" * 4096))
        if chunked:
            if compression == "bz2":
                payload = bz2.compress(body)
            elif compression == "lz4":
                from roborts_slam.io.lz4 import compress_frame

                payload = compress_frame(body)
            else:
                payload = body
            f.write(_record({"op": b"\x05", "compression": compression.encode(),
                             "size": len(body).to_bytes(4, "little")}, payload))
        else:
            f.write(body)
    return scans, odoms


@pytest.mark.parametrize("chunked,compression", [
    (False, "none"), (True, "none"), (True, "bz2"), (True, "lz4")])
def test_bag_roundtrip(tmp_path, chunked, compression):
    path = str(tmp_path / "test.bag")
    scans, odoms = _write_bag(path, chunked, compression)

    msgs = list(read_bag_messages(path))
    assert sum(m[1] == "sensor_msgs/LaserScan" for m in msgs) == 5
    assert sum(m[1] == "nav_msgs/Odometry" for m in msgs) == 7

    log = bag_to_scan_log(path)
    assert len(log) == 5
    assert log.laser.num_beams == 32
    np.testing.assert_allclose(log.ranges[2], scans[2][1].astype(np.float32))
    np.testing.assert_allclose(log.times, [t for t, _ in scans], atol=1e-6)
    # odometry interpolated at scan times: scan 0 at t=10.0 sits between
    # odom samples at 9.95 (idx 0) and 10.05 (idx 1) -> midpoint
    np.testing.assert_allclose(log.odom[0], [0.05, -0.025, 0.01], atol=1e-9)


_SCAN_MD5 = b"90c7ef2dc6895d81024acba2ac42f369"     # sensor_msgs/LaserScan
_ODOM_MD5 = b"cd5e73d190d741a2f92e81eda573aca7"     # nav_msgs/Odometry
_SCAN_DEF = (b"# Single scan from a planar laser range-finder\n\n"
             b"Header header\nfloat32 angle_min\nfloat32 angle_max\n"
             b"float32 angle_increment\nfloat32 time_increment\n"
             b"float32 scan_time\nfloat32 range_min\nfloat32 range_max\n"
             b"float32[] ranges\nfloat32[] intensities\n")
_ODOM_DEF = (b"# This represents an estimate of a position and velocity\n"
             b"Header header\nstring child_frame_id\n"
             b"geometry_msgs/PoseWithCovariance pose\n"
             b"geometry_msgs/TwistWithCovariance twist\n")


def _conn_record(conn: int, topic: bytes, mtype: bytes, md5: bytes,
                 mdef: bytes) -> bytes:
    """Connection record exactly as rosbag record emits it: the data part
    is the full connection header incl. message_definition and callerid."""
    return _record(
        {"op": b"\x07", "conn": conn.to_bytes(4, "little"), "topic": topic},
        _header({"topic": topic, "type": mtype, "md5sum": md5,
                 "message_definition": mdef, "callerid": b"/record_123",
                 "latching": b"0"}))


def _write_record_style_bag(path):
    """Byte-exact emulation of `rosbag record -O` output layout (rosbag
    v2.0 format): 4096-byte space-padded file header record with a real
    index_pos, connection records INSIDE the first chunk, several chunks,
    per-connection INDEX_DATA records after every chunk, and the
    post-chunk section (connection copies + CHUNK_INFO records) at
    index_pos — none of which the simple `_write_bag` serializer emits.
    Exercises the reader against the structure a real Hokuyo capture has
    (launch/roborts_slam_realworld_hokuyo_bag.launch replays such bags)."""
    rng = np.random.default_rng(7)
    scans = [(100.0 + 0.1 * i, rng.uniform(0.1, 7.9, 24)) for i in range(6)]
    odoms = [(99.95 + 0.1 * i, 0.2 * i, 0.1 * i, 0.05 * i) for i in range(8)]

    conns = [_conn_record(0, b"/scan", b"sensor_msgs/LaserScan",
                          _SCAN_MD5, _SCAN_DEF),
             _conn_record(1, b"/odom", b"nav_msgs/Odometry",
                          _ODOM_MD5, _ODOM_DEF)]

    def msg_record(conn, t, body):
        secs, nsecs = int(t), int(round((t - int(t)) * 1e9))
        return _record({"op": b"\x02", "conn": conn.to_bytes(4, "little"),
                        "time": struct.pack("<II", secs, nsecs)}, body)

    # interleave by time like a live recorder, then split into 3 chunks
    events = ([(t, 0, _laserscan_bytes(t, r)) for t, r in scans]
              + [(t, 1, _odometry_bytes(t, x, y, yaw))
                 for t, x, y, yaw in odoms])
    events.sort(key=lambda e: e[0])
    chunks = [events[:5], events[5:10], events[10:]]

    out = bytearray()
    out += b"#ROSBAG V2.0\n"
    header_pos = len(out)
    out += b"\x00" * 4096                       # placeholder, rewritten below

    chunk_infos = []
    for ci, chunk_events in enumerate(chunks):
        payload = bytearray()
        index = {0: [], 1: []}
        if ci == 0:
            for c in conns:                     # connections live in chunk 0
                payload += c
        for t, conn, body in chunk_events:
            index[conn].append((t, len(payload)))
            payload += msg_record(conn, t, body)
        chunk_pos = len(out)
        out += _record({"op": b"\x05", "compression": b"none",
                        "size": len(payload).to_bytes(4, "little")},
                       bytes(payload))
        for conn, entries in index.items():     # INDEX_DATA after the chunk
            if not entries:
                continue
            data = b"".join(
                struct.pack("<III", int(t), int(round((t - int(t)) * 1e9)),
                            off) for t, off in entries)
            out += _record({"op": b"\x04", "ver": (1).to_bytes(4, "little"),
                            "conn": conn.to_bytes(4, "little"),
                            "count": len(entries).to_bytes(4, "little")},
                           data)
        ts = [t for t, _, _ in chunk_events]
        counts = {c: sum(1 for _, cc, _ in chunk_events if cc == c)
                  for c in (0, 1)}
        chunk_infos.append((chunk_pos, min(ts), max(ts), counts))

    index_pos = len(out)
    for c in conns:                             # connection copies at the end
        out += c
    for pos, t0, t1, counts in chunk_infos:     # CHUNK_INFO records
        present = [(c, n) for c, n in counts.items() if n]
        data = b"".join(struct.pack("<II", c, n) for c, n in present)
        out += _record(
            {"op": b"\x06", "ver": (1).to_bytes(4, "little"),
             "chunk_pos": pos.to_bytes(8, "little"),
             "start_time": struct.pack("<II", int(t0),
                                       int(round((t0 - int(t0)) * 1e9))),
             "end_time": struct.pack("<II", int(t1),
                                     int(round((t1 - int(t1)) * 1e9))),
             "count": len(present).to_bytes(4, "little")},
            data)

    # 4096-byte space-padded file header record with the real index_pos
    hdr = _header({"op": b"\x03",
                   "index_pos": index_pos.to_bytes(8, "little"),
                   "conn_count": (2).to_bytes(4, "little"),
                   "chunk_count": (3).to_bytes(4, "little")})
    pad = 4096 - 8 - len(hdr)
    rec = (struct.pack("<I", len(hdr)) + hdr
           + struct.pack("<I", pad) + b"\x20" * pad)
    assert len(rec) == 4096
    out[header_pos:header_pos + 4096] = rec

    with open(path, "wb") as f:
        f.write(bytes(out))
    return scans, odoms


def test_record_style_bag_layout(tmp_path):
    """The reader must parse the layout a real `rosbag record` emits —
    padded file header, in-chunk connections, index + chunk-info records,
    end-of-file connection copies — without double-counting messages from
    the duplicated connection records or tripping on index records."""
    path = str(tmp_path / "record_style.bag")
    scans, odoms = _write_record_style_bag(path)

    msgs = list(read_bag_messages(path))
    assert sum(m[1] == "sensor_msgs/LaserScan" for m in msgs) == len(scans)
    assert sum(m[1] == "nav_msgs/Odometry" for m in msgs) == len(odoms)

    log = bag_to_scan_log(path)
    assert len(log) == len(scans)
    assert log.laser.num_beams == 24
    np.testing.assert_allclose(log.ranges[3], scans[3][1].astype(np.float32))
    np.testing.assert_allclose(log.times, [t for t, _ in scans], atol=1e-6)


def test_lz4_codec_vectors():
    """The pure-python LZ4 codec: known-answer block vectors (match copies,
    overlapping RLE copies, literal runs >= 15) and frame round-trips."""
    from roborts_slam.io.lz4 import (
        compress_frame, decompress_block, decompress_frame,
    )

    # hand-built block: 4 literals "abcd", then match offset=4 len=8
    # -> "abcd" + "abcdabcd" (overlap-free copy), then literal tail "XYZWV"
    blk = bytes([0x44]) + b"abcd" + struct.pack("<H", 4)
    blk += bytes([0x50]) + b"XYZWV"
    assert decompress_block(blk) == b"abcd" + b"abcdabcd" + b"XYZWV"

    # overlapping copy (offset 1 = RLE): "a" then match offset=1 len=10
    blk = bytes([0x16]) + b"a" + struct.pack("<H", 1) + bytes([0x50]) + b"tail."
    assert decompress_block(blk) == b"a" * 11 + b"tail."

    # frame round-trips across sizes/content types
    rng = np.random.default_rng(0)
    for data in (b"", b"short", b"ab" * 40000,
                 rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
                 (b"laser scan segment " * 5000)):
        assert decompress_frame(compress_frame(data)) == data


@pytest.mark.e2e
def test_bag_end_to_end_slam(tmp_path):
    """The real-sensor loop, closed: simulate the
    icra scene, WRITE it as a rosbag 2.0 file with the package's own writer
    (io.rosbag.write_bag — LaserScan + Odometry in bz2 chunks, the same
    container subset the reader parses), read it back with bag_to_scan_log,
    run the engine on it, and require the trajectory quality to match the
    direct (npz-path) replay of the same simulation — no fixture shortcuts
    anywhere (ref: launch/roborts_slam_realworld_hokuyo_bag.launch)."""
    from roborts_slam.engine import SlamEngine
    from roborts_slam.io.rosbag import write_bag
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import simulate_log
    from roborts_slam.utils.evaluation import ate_rmse, match_by_time
    from tests.test_e2e_small import _small_config

    sc = SCENES["icra"]
    log = simulate_log(load_scene_map(sc), sc.laser,
                       odom_error=sc.odom_error, range_noise=0.005, seed=5)
    path = str(tmp_path / "icra_sim.bag")
    write_bag(path, log, compression="bz2", chunk_msgs=64)

    from roborts_slam.io.rosbag import bag_to_scan_log

    blog = bag_to_scan_log(
        path, range_threshold_scale=log.laser.range_threshold_scale)
    assert len(blog) == len(log)
    assert blog.laser.num_beams == log.laser.num_beams
    np.testing.assert_allclose(blog.ranges, log.ranges, atol=0)   # exact f32
    np.testing.assert_allclose(blog.odom, log.odom, atol=1e-9)
    np.testing.assert_allclose(blog.times, log.times, atol=2e-9)  # ns grain
    np.testing.assert_allclose(
        [blog.laser.angle_min, blog.laser.angle_max,
         blog.laser.range_min, blog.laser.range_max],
        [log.laser.angle_min, log.laser.angle_max,
         log.laser.range_min, log.laser.range_max], rtol=1e-6)

    cfg = _small_config()
    n = min(len(log), 160)
    # a LaserScan carries its angles as float32, so both paths replay the
    # beams the bag carries. With the simulator's float64 angles the points
    # differ by ~5e-7 m, and whether that moves a later pose by more than
    # 1e-3 m depends on where a score tie or a cell edge happens to fall.
    log = dataclasses.replace(log, laser=blog.laser)

    def run(replay_log):
        eng = SlamEngine(cfg, replay_log.laser, synchronous_backend=True)
        for i in range(n):
            eng.process(replay_log.ranges[i], replay_log.odom[i],
                        float(replay_log.times[i]))
        eng.finish()
        return eng.trajectory_array()

    t_npz = run(log)
    t_bag = run(blog)
    est_n, gt_n = match_by_time(t_npz, log.gt_poses, log.times)
    est_b, gt_b = match_by_time(t_bag, log.gt_poses, log.times)
    ate_npz, ate_bag = ate_rmse(est_n, gt_n), ate_rmse(est_b, gt_b)
    # identical payload modulo ns-grained timestamps and f32 angle fields:
    # the bag path must reproduce the npz path's quality
    assert ate_bag <= max(1.05 * ate_npz, ate_npz + 0.005), (ate_bag, ate_npz)
    assert t_bag.shape == t_npz.shape
    np.testing.assert_allclose(t_bag[:, 1:], t_npz[:, 1:], atol=1e-3)
