"""Training CLI of the port (counterpart of main.py; the reference's
`th main.lua`, main.lua:17-39).

    python -m back2future_tpu_torch.main --dataset RoamingImages \
        --datasets_dir /data/roam/datasets --data_root /data/roam/data \
        --ground_truth 1 --batchSize 8 --nEpochs 1000     # on the card
    python -m back2future_tpu_torch.main --platform cpu ...   # on the CPU

Every reference flag is exposed 1:1 (config.parse_args); stdout is teed
to `<save>/log` (myCmdLine.lua:191-221). The entry point runs only under
the `__main__` check: the loader's spawned workers import this module
again.

Data parallelism (train/loop.py): `--nGPU n` trains on n ranks that
`run` starts; a cluster is joined from the env with no new flag, as the
JAX package's CLI joins one:

    B2F_COORDINATOR=host:port B2F_NUM_PROCESSES=n B2F_PROCESS_ID=i \
        python -m back2future_tpu_torch.main ...          # one per process
    torchrun --nproc_per_node 8 -m back2future_tpu_torch.main ...

Rank r > 0 tees to `<save>/log.host{r}`.
"""

from __future__ import annotations

import sys

from back2future_tpu_torch.config import parse_args
from back2future_tpu_torch.parallel.distributed import process_index
from back2future_tpu_torch.train.loop import join_cluster, run
from back2future_tpu_torch.utils import TeeLogger


def main(argv=None) -> None:
    opt = parse_args(argv)
    join_cluster(opt)
    rank = process_index()
    with TeeLogger(f"{opt.save}/log" + (f".host{rank}" if rank else "")):
        print(opt.to_json())
        run(opt)


if __name__ == "__main__":
    main(sys.argv[1:])
