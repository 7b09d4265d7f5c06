"""Faults planted in the program under test, to see the check fail:
each is a context manager that patches the program's code underneath
the timed entry, and restores it on exit.

  altered      serving: the first triplet's finest flow of every forward
               is altered where the network produces it
  unchanged    training: the step returns its state unchanged (the
               optimiser's update does nothing)
  half_batch   training: the step leaves out the second half of each
               batch and takes the mean over the rest (its loss, a sum
               over the batch, scaled by 2)
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def altered():
    from back2future_tpu_torch.models import pwc, spynet

    with contextlib.ExitStack() as stack:
        for cls in (pwc.PWCNet, spynet.SPyNet):
            def forward(self, *args, _orig=cls.forward, **kwargs):
                out = _orig(self, *args, **kwargs)
                out[0]["flow"][0] = out[0]["flow"][0] * 1.5 + 1.0
                return out
            stack.enter_context(_patched(cls, "forward", forward))
        yield


@contextlib.contextmanager
def unchanged():
    from back2future_tpu_torch.train import optim

    with _patched(optim.ChainOptimizer, "step", lambda self: None):
        yield


@contextlib.contextmanager
def half_batch():
    from back2future_tpu_torch.train import step

    decode, loss = step.decode_batch, step.multiscale_loss

    def first_half(batch):
        batch = decode(batch)
        return {**batch, "images": batch["images"][:batch["images"].shape[0] // 2]}

    def mean_over_rest(*args, **kwargs):
        total, comps = loss(*args, **kwargs)
        return 2 * total, {k: 2 * v for k, v in comps.items()}

    with _patched(step, "decode_batch", first_half), \
            _patched(step, "multiscale_loss", mean_over_rest):
        yield


FAULTS = {"altered": altered, "unchanged": unchanged, "half_batch": half_batch}
