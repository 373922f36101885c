"""roborts_slam — a 2D LiDAR SLAM engine in JAX.

A from-scratch JAX/XLA re-design with the full capability surface of
the reference RoboRTS-Edu-SLAM C++/ROS package: correlative scan matching
(Olson 2009), Gauss-Newton scan refinement, occupancy-grid map pyramid,
Karto-style pose-graph construction with loop closure, and SPA pose-graph
optimization — re-architected as pure-function pipelines over fixed-shape
arrays, batched/sharded across device meshes (one or four GPUs).
"""

from .config import SlamConfig, load_config


def __getattr__(name):
    # lazy top-level conveniences (avoid importing jax-heavy modules on
    # package import)
    if name == "SlamEngine":
        from .engine import SlamEngine

        return SlamEngine
    if name == "ScanLog":
        from .io.scan_log import ScanLog

        return ScanLog
    if name == "LaserModel":
        from .models.scan import LaserModel

        return LaserModel
    raise AttributeError(name)


__version__ = "0.1.0"
__all__ = ["SlamConfig", "load_config", "SlamEngine", "ScanLog", "LaserModel"]
