"""Benchmark scene presets — the reference's three stage worlds.

Laser models and odometry noise read off the world files:
- willow: 1081 beams, 270.25°, 10 m (worlds/willow-pr2-5cm.world:8-17),
  odom_error [0.02 0.02 0 0.02] (:25)
- icra:   270 beams, 270°, 8 m (worlds/icra.world:18-28),
  odom_error [0.03 0.03 0 0.05] (:38)
- rm:     270 beams, 270°, 30 m (worlds/rm.world:18-28)

The ground-truth maps are generated stand-ins, made from a seed at the
sizes and resolution of the reference's maps (maps/*.yaml: willow
1165×945 px, icra 162×102 px, rm 336×574 px, all 0.05 m): rooms, corridors
and obstacles with enough structure for scan matching and for the loop
planner in io/simulate.py. The reference's PGM files are not part of this
repo.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.scan import LaserModel
from .pgm import GroundTruthMap

RESOLUTION = 0.05       # m per pixel, every reference map


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    size_px: tuple          # (width, height) of the reference map
    laser: LaserModel
    odom_error: tuple
    speed: float = 0.5
    n_waypoints: int = 6
    clearance_m: float = 0.3
    seed: int = 0           # map generator seed


def _deg(d):
    return d * np.pi / 180.0


SCENES = {
    "icra": Scene(
        name="icra", size_px=(162, 102), seed=3,
        laser=LaserModel(angle_min=-_deg(135), angle_max=_deg(135),
                         range_min=0.05, range_max=8.0, num_beams=270),
        odom_error=(0.03, 0.03, 0.05),
        n_waypoints=6, clearance_m=0.3,
    ),
    "rm": Scene(
        name="rm", size_px=(336, 574),
        laser=LaserModel(angle_min=-_deg(135), angle_max=_deg(135),
                         range_min=0.05, range_max=30.0, num_beams=270),
        odom_error=(0.03, 0.03, 0.05),
        n_waypoints=6, clearance_m=0.3,
    ),
    "willow": Scene(
        name="willow", size_px=(1165, 945),
        laser=LaserModel(angle_min=-_deg(135.125), angle_max=_deg(135.125),
                         range_min=0.05, range_max=10.0, num_beams=1081),
        odom_error=(0.02, 0.02, 0.02),
        n_waypoints=8, clearance_m=0.3,
    ),
}


class _Canvas:
    """Occupancy/free rasters drawn with axis-aligned rectangles in meters
    (row 0 = world y-min, origin at (0, 0))."""

    def __init__(self, width_px: int, height_px: int):
        self.occ = np.zeros((height_px, width_px), bool)
        self.free = np.zeros((height_px, width_px), bool)

    def _slices(self, x0, y0, x1, y1):
        c = lambda v: int(round(v / RESOLUTION))
        xa, xb = sorted((c(x0), c(x1)))
        ya, yb = sorted((c(y0), c(y1)))
        return slice(max(ya, 0), max(yb, 0)), slice(max(xa, 0), max(xb, 0))

    def floor(self, x0, y0, x1, y1):
        """Known-free floor."""
        self.free[self._slices(x0, y0, x1, y1)] = True

    def solid(self, x0, y0, x1, y1):
        """Wall or obstacle footprint."""
        sl = self._slices(x0, y0, x1, y1)
        self.occ[sl] = True
        self.free[sl] = False

    def opening(self, x0, y0, x1, y1):
        """Door or gap: clears walls back to floor."""
        sl = self._slices(x0, y0, x1, y1)
        self.occ[sl] = False
        self.free[sl] = True

    def hwall(self, x0, x1, y, t=0.1):
        self.solid(x0, y - t / 2, x1, y + t / 2)

    def vwall(self, x, y0, y1, t=0.1):
        self.solid(x - t / 2, y0, x + t / 2, y1)

    def outline(self, x0, y0, x1, y1, t=0.1):
        self.hwall(x0, x1, y0, t)
        self.hwall(x0, x1, y1, t)
        self.vwall(x0, y0, y1, t)
        self.vwall(x1, y0, y1, t)

    def to_map(self) -> GroundTruthMap:
        return GroundTruthMap(occupancy=self.occ.copy(),
                              free=self.free & ~self.occ,
                              resolution=RESOLUTION,
                              origin=np.zeros(2))


def _arena(width_px, height_px, rng, obstacles):
    """Walled arena with the given obstacle boxes ((x0, y0, x1, y1) in m),
    each jittered by up to 5 cm."""
    cv = _Canvas(width_px, height_px)
    W, H = width_px * RESOLUTION, height_px * RESOLUTION
    cv.floor(0.1, 0.1, W - 0.1, H - 0.1)
    cv.outline(0.1, 0.1, W - 0.1, H - 0.1, t=0.15)
    for box in obstacles:
        j = rng.uniform(-0.05, 0.05, 2)
        cv.solid(box[0] + j[0], box[1] + j[1], box[2] + j[0], box[3] + j[1])
    return cv


def _icra(width_px, height_px, rng):
    """The 8.1 × 5.1 m RoboMaster arena: bars and blocks around a central
    box, point-symmetric like the competition field."""
    W, H = width_px * RESOLUTION, height_px * RESOLUTION
    half = [
        (0.1, 3.75, 1.1, 4.0),          # bar off the left wall
        (1.6, 0.1, 1.85, 1.1),          # post off the bottom wall
        (1.5, 2.3, 2.3, 2.55),          # bar left of centre
        (3.3, 3.75, 3.55, 5.0),         # post off the top wall
        (3.6, 1.05, 4.6, 1.3),          # bar below centre
    ]
    boxes = [(3.8, 2.3, 4.3, 2.8)]      # central block
    for x0, y0, x1, y1 in half:
        boxes += [(x0, y0, x1, y1), (W - x1, H - y1, W - x0, H - y0)]
    return _arena(width_px, height_px, rng, boxes)


def _rm(width_px, height_px, rng):
    """A 16.8 × 28.7 m hall for a 30 m lidar: staggered walls and pillars
    at seeded positions, with a 2 m clear lane along every side."""
    W, H = width_px * RESOLUTION, height_px * RESOLUTION
    boxes = []
    for k, y in enumerate(np.arange(4.0, H - 3.0, 4.2)):
        left = k % 2 == 0
        x0 = 2.6 if left else W - 2.6 - 6.5
        boxes.append((x0, y, x0 + 6.5, y + 0.3))              # partition
        px = (W - 4.5) if left else 3.5
        boxes.append((px, y + 1.2, px + 0.6, y + 1.8))        # pillar
    for _ in range(10):                                       # crates
        x = rng.uniform(2.8, W - 3.8)
        y = rng.uniform(2.8, H - 3.8)
        boxes.append((x, y, x + 0.5, y + 0.5))
    return _arena(width_px, height_px, rng, boxes)


_WILLOW_CORRIDOR = 2.4      # m, corridor width
_WILLOW_OFFICE_DEPTH = 6.0  # m, between the shell and the ring corridor


def _willow_frame(width_px, height_px):
    """Shell (x0, y0, x1, y1), ring corridor outer edge (rx0, ry0, rx1,
    ry1) and the centre of the cross corridors (mx, my), in m."""
    W, H = width_px * RESOLUTION, height_px * RESOLUTION
    x0, y0, x1, y1 = 1.0, 1.0, W - 1.0, H - 1.0
    d = _WILLOW_OFFICE_DEPTH
    return ((x0, y0, x1, y1), (x0 + d, y0 + d, x1 - d, y1 - d),
            ((x0 + x1) / 2, (y0 + y1) / 2))


def willow_block_loop() -> np.ndarray:
    """Waypoints (m) of a 73 m corridor loop around the willow scene's
    south-west office block, starting mid-way along its south side. No
    point of it lies more than 19 m from the start, so the loop fits the
    world the reference profile derives for a 10 m lidar (50 m)."""
    _, (rx0, ry0, _, _), (mx, my) = _willow_frame(*SCENES["willow"].size_px)
    xl, yb = rx0 + _WILLOW_CORRIDOR / 2, ry0 + _WILLOW_CORRIDOR / 2
    return np.array([[(xl + mx) / 2, yb], [mx, yb], [mx, my], [xl, my],
                     [xl, yb]])


def _willow(width_px, height_px, rng):
    """A 58 × 47 m office floor: a ring corridor and a cross of corridors,
    offices with doors off both sides, furniture in the offices and pillars
    in the corridors. Outside the building is unknown."""
    cv = _Canvas(width_px, height_px)
    (x0, y0, x1, y1), (rx0, ry0, rx1, ry1), (mx, my) = \
        _willow_frame(width_px, height_px)
    cw = _WILLOW_CORRIDOR
    cv.floor(x0, y0, x1, y1)
    cv.outline(x0, y0, x1, y1, t=0.2)
    # the ring corridor's outer wall and the four inner office blocks
    cv.outline(rx0, ry0, rx1, ry1)
    inner = [(rx0 + cw, ry0 + cw, mx - cw / 2, my - cw / 2),
             (mx + cw / 2, ry0 + cw, rx1 - cw, my - cw / 2),
             (rx0 + cw, my + cw / 2, mx - cw / 2, ry1 - cw),
             (mx + cw / 2, my + cw / 2, rx1 - cw, ry1 - cw)]
    for bx0, by0, bx1, by1 in inner:
        cv.outline(bx0, by0, bx1, by1)
    # clear the corridor floors the outlines above crossed
    cv.opening(rx0 + 0.05, ry0 + 0.05, rx1 - 0.05, ry0 + cw)
    cv.opening(rx0 + 0.05, ry1 - cw, rx1 - 0.05, ry1 - 0.05)
    cv.opening(rx0 + 0.05, ry0 + 0.05, rx0 + cw, ry1 - 0.05)
    cv.opening(rx1 - cw, ry0 + 0.05, rx1 - 0.05, ry1 - 0.05)
    cv.opening(mx - cw / 2 + 0.05, ry0 + 0.05, mx + cw / 2 - 0.05, ry1 - 0.05)
    cv.opening(rx0 + 0.05, my - cw / 2 + 0.05, rx1 - 0.05, my + cw / 2 - 0.05)

    def offices(ax0, ay0, ax1, ay1, door_side):
        """Split a band into offices along its long axis; each gets a
        1.2 m door on ``door_side`` ('s','n','w','e') and a desk."""
        horiz = (ax1 - ax0) >= (ay1 - ay0)
        lo, hi = (ax0, ax1) if horiz else (ay0, ay1)
        cuts = [lo]
        while hi - cuts[-1] > 7.0:
            cuts.append(cuts[-1] + rng.uniform(3.5, 5.5))
        cuts.append(hi)
        for a, b in zip(cuts[:-1], cuts[1:]):
            if horiz:
                if a > lo:
                    cv.vwall(a, ay0, ay1)
                door = rng.uniform(a + 0.4, b - 1.6)
                wy = ay0 if door_side == "s" else ay1
                cv.opening(door, wy - 0.15, door + 1.2, wy + 0.15)
                dx = rng.uniform(a + 0.5, b - 1.7)
                dy = ay0 + (ay1 - ay0) * (0.65 if door_side == "s" else 0.2)
                cv.solid(dx, dy, dx + 1.2, dy + 0.6)
            else:
                if a > lo:
                    cv.hwall(ax0, ax1, a)
                door = rng.uniform(a + 0.4, b - 1.6)
                wx = ax0 if door_side == "w" else ax1
                cv.opening(wx - 0.15, door, wx + 0.15, door + 1.2)
                dy = rng.uniform(a + 0.5, b - 1.7)
                dx = ax0 + (ax1 - ax0) * (0.65 if door_side == "w" else 0.2)
                cv.solid(dx, dy, dx + 0.6, dy + 1.2)

    # outer offices: between the shell and the ring, doors onto the ring
    offices(x0, y0, x1, ry0, "n")
    offices(x0, ry1, x1, y1, "s")
    offices(x0, ry0, rx0, ry1, "e")
    offices(rx1, ry0, x1, ry1, "w")
    # inner offices: each inner block split in two bands, doors outward
    for bx0, by0, bx1, by1 in inner:
        cy = (by0 + by1) / 2
        cv.hwall(bx0, bx1, cy)
        offices(bx0, by0, bx1, cy, "s")
        offices(bx0, cy, bx1, by1, "n")
    # pillars against alternating walls of every corridor: without them
    # a corridor is the same scan from end to end
    for k, x in enumerate(np.arange(rx0 + 4.0, rx1 - 3.0, 5.5)):
        for ylo in (ry0, ry1 - cw, my - cw / 2):
            y = ylo + (0.05 if k % 2 == 0 else cw - 0.45)
            cv.solid(x, y, x + 0.4, y + 0.4)
    for k, y in enumerate(np.arange(ry0 + 4.0, ry1 - 3.0, 4.5)):
        for xlo in (rx0, rx1 - cw, mx - cw / 2):
            x = xlo + (0.05 if k % 2 == 0 else cw - 0.45)
            cv.solid(x, y, x + 0.4, y + 0.4)
    return cv


_GENERATORS = {"icra": _icra, "rm": _rm, "willow": _willow}


def generate_scene_map(scene: Scene, seed: int | None = None) -> GroundTruthMap:
    """The scene's ground-truth map, generated from ``seed`` (default: the
    scene's own) at the reference map's size and resolution."""
    rng = np.random.default_rng(scene.seed if seed is None else seed)
    w, h = scene.size_px
    return _GENERATORS[scene.name](w, h, rng).to_map()


def load_scene_map(scene: Scene) -> GroundTruthMap:
    return generate_scene_map(scene)
