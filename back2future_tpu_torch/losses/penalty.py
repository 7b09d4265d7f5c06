"""Robust penalty functions (counterpart of back2future_tpu/losses/penalty.py,
criterions/penalty/*.lua).

Each penalty provides `apply(x)` and its derivative `der(x)`, which for
all three is the true derivative of `apply`. L1Penalty's constructor
alpha is ignored in the reference (`0.5 or alpha`,
criterions/penalty/L1_function.lua:17), so it has none here either.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuadraticPenalty:
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x * x

    def der(self, x: torch.Tensor) -> torch.Tensor:
        return 2.0 * x


@dataclasses.dataclass(frozen=True)
class L1Penalty:
    """(x^2 + 1e-6)^0.5 (criterions/penalty/L1_function.lua:15-26)."""
    eps: float = 1e-6

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(x * x + self.eps)

    def der(self, x: torch.Tensor) -> torch.Tensor:
        return x / torch.sqrt(x * x + self.eps)


@dataclasses.dataclass(frozen=True)
class LorentzianPenalty:
    """log(1 + x^2/(2 eps^2)) (criterions/penalty/Lorentzian_function.lua)."""
    eps: float = 0.05

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log1p(0.5 * x * x / (self.eps * self.eps))

    def der(self, x: torch.Tensor) -> torch.Tensor:
        return 2.0 * x / (x * x + 2.0 * self.eps * self.eps)


def make_penalty(name: str):
    """Penalty factory mirroring model.lua:185-226 option strings."""
    if name == "Quadratic":
        return QuadraticPenalty()
    if name == "L1":
        return L1Penalty()
    if name == "Lorentzian":
        return LorentzianPenalty()
    if name == "Dirac":
        # LorentzianPenalty with set_eps(0.001) (model.lua:221-223)
        return LorentzianPenalty(eps=0.001)
    raise ValueError(f"unknown penalty {name!r}")
