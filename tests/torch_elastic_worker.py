"""A rank of the port's chaos tests (``tests/test_torch_distributed.py``):
the port's counterpart of ``tests/elastic_worker.py``.

Everything comes from the environment: the world
(``LIGHTGBM_TPU_COORDINATOR`` / ``_NUM_PROCS`` / ``_RANK``, which
``python -m lightgbm_tpu_torch launch`` exports), the checkpoint
directory, the faults (``LIGHTGBM_TPU_FAULT_INJECT`` and
``LIGHTGBM_TPU_FAULT_RANK``) and the watchdog's deadline. Each rank
trains on its half of a fixed data set (``spmd.distributed_dataset``,
``tree_learner=data``, bagging); rank 0 saves the model. Every rank
prints ``INIT_RETRIES=<n>`` after joining and ``rank <r> DONE`` at the
end; a ``LightGBMError`` (a watchdog abort) prints ``WORKER ABORT:
<msg>`` and exits 13 at once, so a collective left hanging on a daemon
thread cannot hold the process.

Usage: python torch_elastic_worker.py <outdir> [num_rounds]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

outdir = sys.argv[1]
num_rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 8

from lightgbm_tpu_torch.parallel import distributed, spmd  # noqa: E402

distributed.init_distributed(device_type="cpu")

from lightgbm_tpu_torch.obs.registry import registry  # noqa: E402

print(f"INIT_RETRIES={int(registry.counter('init_retries').value)}",
      flush=True)

import numpy as np  # noqa: E402

import lightgbm_tpu_torch as lgb  # noqa: E402
from lightgbm_tpu_torch.basic import LightGBMError  # noqa: E402
from lightgbm_tpu_torch.parallel.mesh import world_rank, world_size  # noqa

rank, nproc = world_rank(), world_size()
rs = np.random.RandomState(7)
n, f = 600, 5
X = rs.randn(n, f)
y = X @ rs.randn(f) + 0.05 * rs.randn(n)
shard = n // nproc
lo, hi = rank * shard, (rank + 1) * shard
cpu = {"device_type": "cpu", "verbosity": -1}
try:
    ds = spmd.distributed_dataset(X[lo:hi], label=y[lo:hi], params=cpu)
    bst = lgb.train({"objective": "regression", "num_leaves": 7,
                     "min_data_in_leaf": 5, "tree_learner": "data",
                     "bagging_fraction": 0.7, "bagging_freq": 2, **cpu},
                    ds, num_boost_round=num_rounds)
except LightGBMError as e:
    print(f"WORKER ABORT: {e}", flush=True)
    os._exit(13)

if rank == 0:
    bst.save_model(os.path.join(outdir, "model_elastic.txt"))
print(f"rank {rank} DONE iterations={bst.current_iteration()}", flush=True)
sys.stdout.flush()
os._exit(0)
