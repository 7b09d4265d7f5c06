"""The endpoint-error map of the supervised criterion (counterpart of
back2future_tpu/losses/supervised.py:18; criterions/L2Criterion.lua).

Only `epe_map` is ported: the metrics (train/metrics.py) read it. The L2
criterion itself is not ported yet (ROADMAP.md queue 1 item 8;
`build_criterions` raises for it).
"""

from __future__ import annotations

import torch


def epe_map(flow: torch.Tensor, target_flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel masked endpoint error (B,H,W)."""
    diff = flow - target_flow
    return torch.sqrt(torch.sum(diff * diff, dim=-1)) * mask
