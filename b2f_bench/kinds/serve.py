"""Serving traffic: a closed loop of one client with one batch in flight.

Each iteration submits the next batch of the pool (already on the
device) to the entry a serving process runs, the network's forward
with no image warps under `torch.inference_mode()`, and waits until its
finest flow and occlusion are complete on the device. The window
reports the triplets completed over its seconds and the 95th percentile
of the batches' times from submission to completion, timed by CUDA
events recorded before the submission and after the outputs (the
stream is empty at each submission, so the first event marks it).

`correct`: the outputs of a seeded sample of the window's iterations
(three of its first 40, and the last) against the plain reference's
float32 forward of the same batch, triplet by triplet: the relative
L2 gap of the flow and of the occlusion at the worst triplet
(`flow_rel`, `occ_rel`), and of the occlusion as the mean over the
sampled triplets (`occ_mean`); the cell's limits file names those
compared (PERF.md: why the occlusion's are not).
"""

from __future__ import annotations

import time

import torch

from b2f_bench import harness, program
from b2f_bench.counts import model as model_counts
from b2f_bench.reference.common import Precision, exact_math

SAMPLED = 3          # window iterations kept, drawn from the first SAMPLE_RANGE
SAMPLE_RANGE = 40


class Runner(harness.Runner):

    spans = ("serve.forward", "serve.wait")

    def setup(self) -> None:
        opt = program.options(self.cell)
        self.net = program.network(self.cell, opt, self.make_params(), self.device).eval()
        self.pool = self.make_pool()
        for i in range(self.traffic["warmup"]):
            self.forward(self.pool[i % len(self.pool)])
        harness.synchronize(self.device)
        self.ops = program.record_ops(lambda: self.forward(self.pool[0]))
        self.keep = set(self.rng("sample").sample(range(SAMPLE_RANGE), SAMPLED))
        self.kept = {}
        self.latency = []

    def forward(self, x):
        with torch.inference_mode():
            g = self.net(x, with_warped=False)[0]
        return g["flow"], g["occ"]

    def iterate(self) -> None:
        from torch.autograd.profiler import record_function

        i = self.iterations
        index = i % len(self.pool)
        cuda = self.device.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        with record_function("serve.forward"):
            out = self.timed(lambda: self.forward(self.pool[index]))
        with record_function("serve.wait"):
            if cuda:
                end.record()
                end.synchronize()
        # on the CPU (tests) the host clock stands in for the events
        self.latency.append((start, end) if cuda else 1e3 * (time.perf_counter() - t0))
        self.last = (index, *out)
        if i in self.keep:
            self.kept[i] = self.last
        self.iterations += 1

    def end_to_end(self, window: dict) -> dict:
        loop = window["loop"]
        ms = [x if isinstance(x, float) else x[0].elapsed_time(x[1]) for x in self.latency]
        return {"serve_throughput": loop["iterations"] * self.batch / loop["seconds"],
                "serve_batch_p95_ms": harness.p95(ms) if ms else None}

    def per_layer_context(self, window: dict) -> dict:
        loop = window["loop"]
        t = self.traffic
        return {"kind": "serve", "op_iterations": window["host_loop"]["iterations"],
                "triplets": loop["iterations"] * self.batch, "seconds": loop["seconds"],
                "flops_per_triplet": model_counts.forward_flops(self.ref_options, t["height"],
                                                                t["width"]),
                "element_bytes": 2 if self.ref_options["compute_dtype"] == "bfloat16" else 4,
                "ops_per_iteration": self.ops, "enqueue_s": self.enqueue_s,
                **window["trace"]}

    def attempted(self) -> int:
        return self.iterations * self.batch

    def free_program(self) -> None:
        self.kept[self.iterations - 1] = self.last
        del self.net, self.last
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, index: int, precision: str):
        """The reference's finest (flow, occ) for pool batch `index`, in
        blocks of `check_block` triplets."""
        params = self.make_params()
        q = Precision(precision)
        flows, occs = [], []
        with exact_math(), torch.no_grad():
            for x in self.pool[index].split(self.traffic["check_block"]):
                g = self.reference.forward(params, x, self.ref_options, False, q)[0]
                flows.append(g["flow"])
                occs.append(g["occ"])
        return torch.cat(flows), torch.cat(occs)

    def readings(self, control: bool = False) -> dict:
        """The compared numbers of the kept outputs (the control's, the
        reference in float8 in the program's place, with `control`)."""
        refs, ctrl = {}, {}
        flow_gaps, occ_gaps = [], []
        for index, flow, occ in self.kept.values():
            if index not in refs:
                refs[index] = self.reference_outputs(index, "f32")
                if control:
                    ctrl[index] = self.reference_outputs(index, "fp8")
            if control:
                flow, occ = ctrl[index]
            want_flow, want_occ = refs[index]
            flow_gaps += harness.relative_gap(flow, want_flow).tolist()
            occ_gaps += harness.relative_gap(occ, want_occ).tolist()
        return {"flow_rel": max(flow_gaps), "occ_rel": max(occ_gaps),
                "occ_mean": sum(occ_gaps) / len(occ_gaps)}
