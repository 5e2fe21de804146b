"""One rank of a gloo world of the port on the CPU, for the world tests
(``tests/test_torch_parallel*.py``, through ``_torch_world.py``).

Run as ``python torch_world_worker.py <jobs.json>`` with
``LIGHTGBM_TPU_COORDINATOR`` / ``_NUM_PROCS`` / ``_RANK`` set. Every job
of the file trains in this one world, in order:

- ``X``, ``y`` (and ``weight``): ``.npy`` paths of the whole data set;
- ``dataset``: ``replicated`` (every rank passes the whole data set; the
  engine trains its rows) or ``shard`` (``spmd.distributed_dataset`` of
  this rank's equal share);
- ``params``, ``rounds``, and ``categorical_feature``;
- ``draws``: an ``.npy`` of bagging draws, one ``[n]`` row per
  iteration (the JAX package's), put in place of the port's;
- ``expect_error``: the training must raise; its message is kept;
- ``evaluate``: record the train set's and a replicated valid set's
  metrics (``<name>.rank<r>.evals.json``);
- ``more_rounds``: continue the trained model for that many rounds
  (``init_model``).

Each rank writes ``<out>/<name>.rank<r>.txt``, the model text (or
``.err``, the error). The worker imports no JAX.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lightgbm_tpu_torch.parallel import distributed, spmd  # noqa: E402
from lightgbm_tpu_torch.parallel.mesh import world_rank, world_size  # noqa

CPU = {"device_type": "cpu", "verbosity": -1}


def main(path):
    with open(path) as f:
        spec = json.load(f)
    distributed.init_distributed(device_type="cpu")
    rank, D = world_rank(), world_size()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * D)))
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models import gbdt
    own_draw = gbdt.bagging_uniform
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        X, y = np.load(job["X"]), np.load(job["y"])
        w = np.load(job["weight"]) if job.get("weight") else None
        kw = {}
        if job.get("categorical_feature"):
            kw["categorical_feature"] = job["categorical_feature"]
        if job["dataset"] == "shard":
            per = len(y) // D
            sl = slice(rank * per, (rank + 1) * per)
            ds = spmd.distributed_dataset(
                X[sl], label=y[sl], params=CPU,
                weight=None if w is None else w[sl], **kw)
        else:
            ds = lgb.Dataset(X, label=y, weight=w, params=CPU, **kw)
        if job.get("draws"):
            draws = np.load(job["draws"])
            gbdt.bagging_uniform = \
                lambda gen, it, n, d=draws: torch.from_numpy(d[it][:n])
        else:
            gbdt.bagging_uniform = own_draw
        base = os.path.join(spec["out"], f"{job['name']}.rank{rank}")
        kw, evals = {}, {}
        if job.get("evaluate"):
            # the train set and a replicated valid set of the same rows
            vds = lgb.Dataset(X, label=y, reference=ds, params=CPU)
            kw = dict(valid_sets=[ds, vds], valid_names=["train", "valid"],
                      callbacks=[lgb.record_evaluation(evals)])
        try:
            bst = lgb.train({**job["params"], **CPU}, ds, job["rounds"],
                            **kw)
        except Exception as e:
            if not job.get("expect_error"):
                raise
            with open(base + ".err", "w") as f:
                f.write(f"{type(e).__name__}: {e}")
            continue
        if job.get("more_rounds"):
            bst = lgb.train({**job["params"], **CPU}, ds,
                            job["more_rounds"], init_model=bst)
        with open(base + ".txt", "w") as f:
            f.write(bst.model_to_string())
        if evals:
            with open(base + ".evals.json", "w") as f:
                json.dump(evals, f)
        print(f"{job['name']}: {time.perf_counter() - t0:.2f} s", flush=True)
    distributed.shutdown_distributed()
    print(f"rank {rank} DONE", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
