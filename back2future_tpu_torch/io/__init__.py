"""Flow file I/O and visualization (counterpart of back2future_tpu.io).

Rebuilds the capability surface of the reference `flowExtensions.lua`:
readers/writers for Middlebury .flo, Sintel .pfm, KITTI 16-bit .png and
.disp occlusion maps, HSL flow visualization, flow-aware geometric
transforms, and z-buffer occlusion derivation. The exports are those of
back2future_tpu/io/__init__.py:12-29; the `.t7` reader (io/t7.py) is not
ported (ROADMAP queue 1 item 10).
"""

from .flow_io import (
    load_flow,
    load_flo,
    write_flo,
    load_pfm,
    write_pfm,
    load_kitti_png,
    write_kitti_png,
    load_disp,
    write_disp,
)
from .viz import compute_norm, compute_angle, field2rgb, xy2rgb
from .occ import get_occ
from .transforms import rotate_flow, scale_flow

__all__ = [
    "load_flow", "load_flo", "write_flo", "load_pfm", "write_pfm",
    "load_kitti_png", "write_kitti_png", "load_disp", "write_disp",
    "compute_norm", "compute_angle", "field2rgb", "xy2rgb", "get_occ",
    "rotate_flow", "scale_flow",
]
