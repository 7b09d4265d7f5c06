"""back2future_tpu_torch — the PyTorch + CUDA port of back2future_tpu.

The JAX package (`back2future_tpu`) stays the reference; every module
here mirrors its counterpart there and is tested against it on the CPU.
This package imports `torch` and never `jax`, `flax` or anything of the
JAX package: what it needs of that package's framework-free modules
(`Options`, the numpy pre/post-processing of the API, colour
normalisation, resize) it keeps as its own copies.

Layering, from the entry point down to the device:
  main, eval — the training CLI (`python -m back2future_tpu_torch.main`)
              and the eval CLI (`python -m back2future_tpu_torch.eval`)
  api       — init() / FlowEstimator: host pre/post-processing, the
              serving forward under torch.inference_mode() (on one
              device, or one replica per slot of a mesh), warmup();
              export() / load_exported(): one torch.export program per
              shape bucket, served without model code; checkpoint paths
              load through train.checkpoint
  demo, serve_bench, export_serving — the serving CLIs
  graft_entry — entry() (the flagship forward from the JAX package's
              PRNGKey(0) weights) and dryrun_multichip(n) (one train
              step over data-parallel ranks)
  models    — nn.Modules: PWCNet (multi-frame PWC + occlusion head),
              Conv/ConvUnit/Decoder, the flax-params bridge, the JAX
              package's seeded init in numpy and the hard -> soft surgery
  parallel  — process groups (NCCL, gloo) and the ranks `run` starts,
              the cross-rank resume check and DDP's reductions; a
              device mesh for serving over replicas
  train     — the epoch loop run() (one rank per device under DDP),
              checkpoints (torch files; the JAX package's msgpack pairs
              read too), the train and eval steps, metrics, multi-scale
              loss, optimiser chain, TrainState
  utils     — SymbolLogger / TeeLogger, StepTimer, maybe_profile, span
              (the layer boundaries on the profiler's clock: the train step's
              phases, the nets' pyramid, decode and levels) and its table
  data, io  — the host data pipeline and flow files
  losses    — the criteria of the hard and soft recipes, reference
              gradients as autograd Functions
  ops       — NHWC tensor ops: pyramid resampling (plain torch), the
              multi-frame cost volume, the bilinear warp and the fused
              feature stem, each `torch.library` custom ops (`b2f::*`):
              a hand-written CUDA kernel on CUDA tensors, a plain torch
              twin on CPU tensors, a fake for tracing and an autograd
              formula (`ops.plain_ops()` forces the twins)
  runtime   — nvcc build of csrc/*.cu into one shared library, loaded
              with ctypes; per-kernel launch counters
  csrc      — the CUDA C++ kernels (sm_90a)
"""

__version__ = "0.1.0"
