"""Training traffic: the program's train step dispatched back to back.

Set-up builds one train state and step, and drives them through their
first `checked_steps` steps on the first batches of the pool (rows that
all differ), recording what the check compares: each step's loss, the
first gradient of each parameter as the optimiser holds it after one
step (Adam's first moment over 1 - beta1), and each parameter's change
over those steps. The window then runs the same step on the same state
over the pool, with no host read inside it, and ends at a synchronise
after the last step; it reports the triplets trained over its seconds.

`correct`: the same numbers of the plain reference (float32, TF32 off,
`torch.optim.Adam` with the program's settings) from the same weights
over the same batches, in blocks of `check_block` triplets whose
gradients add up (the recipe's loss is a sum over the batch):

  loss_rel     the worst step's |loss - reference| / |reference|
  grad_gap     the median parameter's gap of first-gradient norms
  change_gap   the median parameter's gap of change norms, over the
               parameters whose reference gradient norm is at least a
               thousandth of the median parameter's (the others move by
               round-off under Adam)

each parameter's gap over the larger of the reference's norm of that
parameter and the median parameter's. The worst parameter's gaps
(`grad_worst`, `change_worst`) are read beside them and not compared:
in pwc3f the occlusion decoders' gradients are differences of the past
and the future frames' photometric errors, which cancel, and bf16's
rounding of the warped frames moves them by up to their own size from
seed to seed (PERF.md).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from b2f_bench import harness, program
from b2f_bench.counts import model as model_counts
from b2f_bench.reference import recipe
from b2f_bench.reference.common import Precision, exact_math

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
MOVED = 1e-3         # of the median gradient norm: the parameters whose change is compared


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).tolist()
    return dict(zip(names, values))


def first_moments(optimizer, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient of the first step, from Adam's state:
    exp_avg / (1 - beta1); zero where it holds none."""
    out = {}
    for name, p in params.items():
        state = optimizer.state.get(p, {})
        out[name] = (state["exp_avg"] / (1 - BETA1) if "exp_avg" in state
                     else torch.zeros_like(p))
    return out


class Runner(harness.Runner):

    spans = ("train.step",)

    def setup(self) -> None:
        opt = program.options(self.cell)
        self.lr = opt.LR if opt.LR > 0 else 1e-4
        params = self.make_params()
        start = {n: p.clone() for n, p in params.items()}
        net = program.network(self.cell, opt, params, self.device)
        self.state, self.step = program.train_step(net, opt)
        self.pool = self.make_pool()
        n_checked = self.traffic["checked_steps"]
        if n_checked > len(self.pool):
            raise ValueError("the checked steps need a batch of their own each")
        named = dict(net.named_parameters())
        losses = []
        for i in range(n_checked):
            self.iterate()
            losses.append(self.logs["loss"])
            if i == 0:
                grads = _norms(first_moments(self.state.optimizer.rule, named))
        self.program_record = {
            "losses": [float(v) for v in losses], "grads": grads,
            "changes": _norms({n: named[n].detach() - start[n] for n in named})}
        del start
        self.ops = program.record_ops(self.iterate)
        harness.synchronize(self.device)

    def iterate(self) -> None:
        from torch.autograd.profiler import record_function

        x = self.pool[self.iterations % len(self.pool)]
        with record_function("train.step"):
            self.state, self.logs = self.timed(lambda: self.step(self.state, {"images": x}))
        self.iterations += 1

    def end_to_end(self, window: dict) -> dict:
        loop = window["loop"]
        return {"train_throughput": loop["iterations"] * self.batch / loop["seconds"]}

    def per_layer_context(self, window: dict) -> dict:
        loop = window["loop"]
        t = self.traffic
        return {"kind": "train", "op_iterations": window["host_loop"]["iterations"],
                "triplets": loop["iterations"] * self.batch, "seconds": loop["seconds"],
                "flops_per_triplet": model_counts.step_flops(self.ref_options, t["height"],
                                                             t["width"]),
                "element_bytes": 2 if self.ref_options["compute_dtype"] == "bfloat16" else 4,
                "ops_per_iteration": self.ops, "enqueue_s": self.enqueue_s,
                **window["trace"]}

    def attempted(self) -> int:
        return self.iterations * self.batch

    def free_program(self) -> None:
        del self.state, self.step, self.logs
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_record(self, precision: str) -> dict:
        """The reference's losses, first gradients and changes over the
        checked steps, at `precision`."""
        start = self.make_params()
        params = {n: p.clone().requires_grad_(True) for n, p in start.items()}
        adam = torch.optim.Adam(list(params.values()), lr=self.lr, betas=(BETA1, BETA2),
                                eps=EPS)
        q = Precision(precision)
        losses: List[float] = []
        with exact_math():
            for i in range(self.traffic["checked_steps"]):
                adam.zero_grad(set_to_none=True)
                total = 0.0
                for x in self.pool[i].split(self.traffic["check_block"]):
                    out = self.reference.forward(params, x, self.ref_options, True, q)
                    loss = recipe.loss(out, x, self.ref_options)
                    loss.backward()
                    total += loss.item()
                adam.step()
                losses.append(total)
                if i == 0:
                    grads = _norms(first_moments(adam, params))
        changes = _norms({n: params[n].detach() - start[n] for n in params})
        return {"losses": losses, "grads": grads, "changes": changes}

    def readings(self, control: bool = False) -> dict:
        """The compared numbers of the program's record (the control's,
        the reference in float8 in the program's place, with `control`)."""
        want = self.reference_record("f32")
        got = self.reference_record("fp8") if control else self.program_record
        median = statistics.median(want["grads"].values())
        moved = [n for n, g in want["grads"].items() if g >= MOVED * median]
        grads = harness.leaf_gaps(got["grads"], want["grads"])
        changes = harness.leaf_gaps(got["changes"], want["changes"], moved)
        return {
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
            "grad_gap": statistics.median(grads), "change_gap": statistics.median(changes),
            "grad_worst": max(grads), "change_worst": max(changes),
        }
