"""Run the port's HTTP server (``infer.server``) once per arm in this process:
one rank of ``parallel.launch``, so a tp serving mesh starts its ranks once
for several engine configurations.

    python -m mlx_cuda_distributed_pretraining_tpu_torch.parallel.launch \\
        --nproc-per-node 2 --device cuda --backend gloo \\
        --script scripts/serve_arms.py -- OUT_DIR '[[], ["--kv-quant"]]' \\
        --config configs/model-config-moe-8x40m.yaml --engine batch --mesh tp=2 ...

Each arm is the server's main with the common arguments and the arm's own;
a SIGTERM to the launcher ends the current arm on every rank (rank 0's
server shuts down, its engine stops the others) and the next one starts.
After each arm every rank writes ``OUT_DIR/arm<i>_rank<r>.json``: its
grouped-GEMM launches by variant and by shape, and its peak device memory.
"""

import json
import os
import sys

from mlx_cuda_distributed_pretraining_tpu_torch.infer import server
from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as gm


def main(argv) -> int:
    import torch
    import torch.distributed as dist

    out_dir, arms, common = argv[0], json.loads(argv[1]), argv[2:]
    rank = dist.get_rank() if dist.is_initialized() else 0
    for i, arm in enumerate(arms):
        gm.reset_launches()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        rc = server.main(common + arm)
        record = {"rc": rc, "rank": rank,
                  "gmm_by_variant": dict(gm.gmm.launches_by_variant),
                  "gmm_by_shape": [[list(k), n] for k, n in gm.gmm.launches_by_shape.items()],
                  "peak_device_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                         if torch.cuda.is_available() else None)}
        with open(os.path.join(out_dir, f"arm{i}_rank{rank}.json"), "w") as f:
            json.dump(record, f)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
