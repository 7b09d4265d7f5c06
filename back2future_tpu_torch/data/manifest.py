"""Dataset manifest parsing.

The reference stores datasets as text manifests, one sample per line
(donkey.lua:70-94; datasets/*.dat):

  without ground truth:  ``img_printf_pattern ref_frame [skip]``
  with ground truth:     ``img_pattern flow_pattern ref_frame [skip]``

``%d``-style printf patterns are instantiated with frame indices; a
``[PATH]`` placeholder is user-substituted with the dataset root
(README.md:76-80). The train/val split file ``<name>_split.dat`` holds one
ASCII integer per line: 1 = train, 2 = validation (donkey.lua:79-94).

The port's copy of back2future_tpu/data/manifest.py.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """One manifest line, resolved."""
    image_pattern: str            # printf pattern with one integer slot
    flow_pattern: Optional[str]   # None when the dataset has no ground truth
    ref: int                      # reference frame index (1-based file index)
    skip: int = 1                 # frame stride

    def frame_indices(self, frames: int) -> List[int]:
        """Frame file indices for a window of `frames` centered on `ref`
        (donkey.lua:202-217): start = ref - (frames-1)/2*skip for odd
        windows; 2-frame windows start at ref."""
        s = self.ref
        if frames > 2:
            s = int(self.ref - 0.5 * (frames - 1) * self.skip)
        return [s + (f - 1) * self.skip for f in range(1, frames + 1)]

    def image_paths(self, frames: int) -> List[str]:
        return [self.image_pattern % i for i in self.frame_indices(frames)]

    def flow_path(self) -> Optional[str]:
        return None if self.flow_pattern is None else self.flow_pattern % self.ref

    def occ_paths(self, frames: int) -> Tuple[Optional[str], Optional[str]]:
        """(frames-state occlusion, 3-frame occlusion) `.disp` paths derived
        from the flow path (donkey.lua:225-250). 2-frame datasets use the
        3-frame map for both slots. The extension swap is splitext-based:
        the reference's gsub('.flo', ...) is a no-op for non-.flo flow
        paths, but only this port can reach that case (it adds KITTI
        16-bit-PNG flow support) — a no-op would hand the flow file
        itself to the .disp loader."""
        fp = self.flow_path()
        if fp is None:
            return None, None
        stem = os.path.splitext(fp)[0]
        n = 3 if frames == 2 else frames
        return (f"{stem}_occ_{n}.disp", f"{stem}_occ_3.disp")


def parse_manifest_line(line: str, ground_truth: bool) -> Optional[SampleSpec]:
    """Parse one manifest line (donkey.lua:185-204). Returns None for
    blank lines."""
    parts = line.split()
    if not parts:
        return None
    if ground_truth:
        img, flow = parts[0], parts[1]
        ref = int(float(parts[2]))
        skip = int(float(parts[3])) if len(parts) >= 4 else 1
    else:
        img, flow = parts[0], None
        ref = int(float(parts[1]))
        skip = int(float(parts[2])) if len(parts) >= 3 else 1
    return SampleSpec(img, flow, ref, skip)


def load_manifest(path: str | Path, ground_truth: bool,
                  root: Optional[str] = None) -> List[SampleSpec]:
    """Load a `.dat` manifest; substitute `[PATH]` with `root` if given."""
    specs: List[SampleSpec] = []
    for line in Path(path).read_text().splitlines():
        if root is not None:
            line = line.replace("[PATH]", root)
        spec = parse_manifest_line(line, ground_truth)
        if spec is not None:
            specs.append(spec)
    return specs


def load_manifest_cached(path: str | Path, ground_truth: bool,
                         root: Optional[str] = None,
                         cache_dir: Optional[str | Path] = None
                         ) -> List[SampleSpec]:
    """load_manifest with an on-disk metadata cache (donkey.lua:27-33).

    The reference torch.save()s the constructed dataset table into
    ``opt.cache`` and reloads it on later runs, warning the user to
    delete it by hand if the data changed; here the cache is keyed by
    the manifest's (mtime, size) plus the (root, ground_truth) parse
    parameters, so staleness is detected automatically. Disable with
    ``B2F_MANIFEST_CACHE=0``. Falls back to a plain parse on any cache
    problem (a cache must never be able to fail a run)."""
    import json
    import os

    path = Path(path)
    if (cache_dir is None
            or os.environ.get("B2F_MANIFEST_CACHE", "").strip().lower()
            in ("0", "false", "no", "off")):
        return load_manifest(path, ground_truth, root)

    import hashlib

    st = path.stat()
    resolved = str(path.resolve())
    key = {"path": resolved, "mtime": st.st_mtime, "size": st.st_size,
           "root": root or "", "ground_truth": bool(ground_truth)}
    # cache filename carries a path hash so same-named manifests from
    # different datasets_dirs sharing one cache_dir don't evict each other
    tag = hashlib.md5(resolved.encode()).hexdigest()[:8]
    cache_file = Path(cache_dir) / f"{path.stem}_{tag}_manifestCache.json"
    try:
        blob = json.loads(cache_file.read_text())
        if blob["key"] == key:
            return [SampleSpec(*row) for row in blob["specs"]]
    except (OSError, ValueError, KeyError, TypeError):
        pass

    specs = load_manifest(path, ground_truth, root)
    try:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        # per-process tmp name: concurrent writers (multi-host shared FS)
        # must not interleave into one tmp file before the atomic rename
        tmp = cache_file.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps({
            "key": key,
            "specs": [[s.image_pattern, s.flow_pattern, s.ref, s.skip]
                      for s in specs]}))
        tmp.replace(cache_file)
    except OSError:
        pass
    return specs


def load_split(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    """Read `<name>_split.dat` -> (train_indices, val_indices), 0-based
    positions into the manifest list (donkey.lua:81-94: 1=train, 2=val)."""
    vals = np.array([int(tok) for tok in Path(path).read_text().split()],
                    dtype=np.int32)
    return np.nonzero(vals == 1)[0], np.nonzero(vals == 2)[0]


def write_manifest(path: str | Path, specs: Sequence[SampleSpec]) -> None:
    """Write manifests in the reference text format (for tests/tools)."""
    lines = []
    for s in specs:
        if s.flow_pattern is not None:
            lines.append(f"{s.image_pattern} {s.flow_pattern} {s.ref} {s.skip}")
        else:
            lines.append(f"{s.image_pattern} {s.ref} {s.skip}")
    Path(path).write_text("\n".join(lines) + "\n")
