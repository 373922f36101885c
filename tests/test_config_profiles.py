"""The shipped YAML profiles (configs/) load through the same path that
accepts reference-format parameter files (reference: src/param_config.h
reads these keys from the ROS parameter server; here load_config reads
them from YAML)."""

import dataclasses
import math
import os

import pytest

from roborts_slam.config import (SIMULATION_REFERENCE_PROFILE, SlamConfig,
                                 load_config, parse_flat_yaml,
                                 read_flat_yaml)

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_simulation_profile_loads():
    cfg = load_config(os.path.join(CONFIGS, "simulation.yaml"))
    assert isinstance(cfg, SlamConfig)
    assert cfg.fine_map_resolution == 0.01
    assert cfg.use_odom_correct is False
    assert cfg.use_move_check is False
    assert cfg.coarse_use_point_size == 100
    # angle offsets land within float tolerance of the dataclass defaults
    assert math.isclose(cfg.coarse_search_angle_offset, 1.745, rel_tol=1e-6)


def test_real_robot_profile_loads():
    cfg = load_config(os.path.join(CONFIGS, "real_robot.yaml"))
    assert cfg.use_odom_correct is True
    assert cfg.use_move_check is True
    assert cfg.fine_map_resolution == 0.025
    assert cfg.match_map_window == 15.0


def test_profile_overrides_win():
    cfg = load_config(os.path.join(CONFIGS, "simulation.yaml"),
                      fine_map_resolution=0.02)
    assert cfg.fine_map_resolution == 0.02


def test_unknown_keys_ignored(tmp_path):
    p = tmp_path / "extra.yaml"
    p.write_text("map_resolution: 0.1\nsome_ros_only_param: 42\n")
    cfg = load_config(str(p))
    assert cfg.map_resolution == 0.1


def test_reference_yaml_profiles_load_unchanged():
    """The rebuilt reference simulation profile (param_config.h keys) loads
    through load_config with no translation step and carries the
    reference's values."""
    assert os.path.samefile(os.path.dirname(SIMULATION_REFERENCE_PROFILE),
                            CONFIGS)
    sim = load_config(SIMULATION_REFERENCE_PROFILE)
    assert sim.fine_map_resolution == 0.01
    assert sim.coarse_map_resolution == 0.08
    assert sim.gaussian_blur_offset == 0.88
    assert sim.map_min_passthrough == 4.0
    # the tiers of native/baseline_correlative.cpp:41-45
    assert (sim.coarse_search_space_size, sim.coarse_search_space_resolution,
            sim.coarse_search_angle_offset) == (0.6, 0.05, 0.523)
    assert sim.super_fine_search_angle_resolution == 0.00349
    assert sim.super_fine_use_point_size == 100

    real = load_config(os.path.join(CONFIGS, "real_robot.yaml"))
    assert isinstance(real, SlamConfig)
    assert real.map_resolution > 0


@pytest.mark.parametrize("name", ["simulation.yaml", "real_robot.yaml",
                                  "simulation_reference.yaml"])
def test_flat_yaml_parser_reads_profiles(name):
    """Every entry of the shipped profiles parses to a typed scalar of a
    known SlamConfig field (booleans, ints, floats)."""
    fields = {f.name: f.type for f in dataclasses.fields(SlamConfig)}
    raw = read_flat_yaml(os.path.join(CONFIGS, name))
    assert len(raw) > 40
    for key, val in raw.items():
        assert key in fields, key
        want = {"bool": bool, "int": (int, float), "float": (int, float),
                "str": str}[str(fields[key])]
        assert isinstance(val, want) and not (
            want != bool and isinstance(val, bool)), (key, val)


def test_flat_yaml_parser_subset():
    text = (
        "# map_server style header comment\n"
        "image: icra.pgm   # trailing comment\n"
        "resolution: 0.05\n"
        "origin: [-1.5, 2.0, 0.0]\n"
        "negate: 0\n"
        "empty_list: []\n"
        "flag: true\n"
        "off_flag: False\n"
        "name: 'a # not a comment'\n"
        "hash#inside: b#c\n"
        "nothing:\n"
        "\n"
        "---\n"
    )
    got = parse_flat_yaml(text)
    assert got == {"image": "icra.pgm", "resolution": 0.05,
                   "origin": [-1.5, 2.0, 0.0], "negate": 0,
                   "empty_list": [], "flag": True, "off_flag": False,
                   "name": "a # not a comment", "hash#inside": "b#c",
                   "nothing": None}
    assert isinstance(got["negate"], int)


@pytest.mark.parametrize("bad", ["parent:\n  child: 1\n", "- item\n",
                                 "origin: [1, 2\n", "no colon here\n"])
def test_flat_yaml_parser_rejects_nesting(bad):
    with pytest.raises(ValueError):
        parse_flat_yaml(bad)
