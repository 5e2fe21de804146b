"""A gloo world of the port's ranks on the CPU, for the world tests
(``tests/test_torch_parallel*.py``): the jobs of a test module are
collected, one world of ``size`` rank processes runs them all
(``torch_world_worker.py``), and the tests read each rank's model text.
Started once per module, it runs beside the module's JAX oracles."""

import json
import os
import subprocess
import sys

import numpy as np

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(TESTS_DIR)
CPU = {"device_type": "cpu", "verbosity": -1}


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(extra=None):
    """The test runner's environment without the variables a rank must
    not inherit, with the repository importable."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIGHTGBM_TPU_")
           and k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO_DIR
    env.update(extra or {})
    return env


class World:
    """The jobs of one world and its rank processes."""

    def __init__(self, size: int, tmp):
        self.size = size
        self.dir = str(tmp)
        self.jobs = []
        self.procs = []

    def _save(self, name, key, arr):
        path = os.path.join(self.dir, f"{name}.{key}.npy")
        np.save(path, np.asarray(arr))
        return path

    def add(self, name, X, y, params, rounds, dataset="replicated",
            weight=None, draws=None, categorical_feature=None,
            expect_error=False, **extra):
        self.jobs.append(dict(
            name=name, X=self._save(name, "X", X), y=self._save(name, "y", y),
            weight=None if weight is None else self._save(name, "w", weight),
            draws=None if draws is None else self._save(name, "draws", draws),
            params=params, rounds=rounds, dataset=dataset,
            categorical_feature=categorical_feature,
            expect_error=expect_error, **extra))

    def start(self):
        path = os.path.join(self.dir, "jobs.json")
        with open(path, "w") as f:
            json.dump({"out": self.dir, "jobs": self.jobs}, f)
        port = free_port()
        for rank in range(self.size):
            env = worker_env({"LIGHTGBM_TPU_COORDINATOR": f"127.0.0.1:{port}",
                              "LIGHTGBM_TPU_NUM_PROCS": str(self.size),
                              "LIGHTGBM_TPU_RANK": str(rank)})
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.join(TESTS_DIR,
                                              "torch_world_worker.py"),
                 path], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, start_new_session=True))
        self._done = None
        return self

    def wait(self, timeout=240):
        """Wait for every rank (once); raise with their output if one
        failed or the world outlived ``timeout``."""
        if self._done is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                self.kill()
                raise AssertionError("the world's ranks did not finish in "
                                     f"{timeout} s")
            bad = [r for r, p in enumerate(self.procs) if p.returncode]
            self._done = (bad, [o.decode(errors="replace") for o in outs])
        bad, outs = self._done
        if bad:
            raise AssertionError(f"ranks {bad} failed:\n"
                                 + "\n".join(o[-3000:] for o in outs))

    def kill(self):
        import signal
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except OSError:
                    pass
                p.wait(timeout=30)

    def texts(self, name):
        """Every rank's model text of job ``name``."""
        self.wait()
        out = []
        for r in range(self.size):
            with open(os.path.join(self.dir, f"{name}.rank{r}.txt")) as f:
                out.append(f.read())
        return out

    def error(self, name):
        """Rank 0's error text of job ``name`` (``expect_error``)."""
        self.wait()
        with open(os.path.join(self.dir, f"{name}.rank0.err")) as f:
            return f.read()

    def evals(self, name):
        """Every rank's recorded metrics of job ``name`` (``evaluate``)."""
        self.wait()
        out = []
        for r in range(self.size):
            with open(os.path.join(self.dir,
                                   f"{name}.rank{r}.evals.json")) as f:
                out.append(json.load(f))
        return out

    def booster(self, name):
        """Job ``name``'s model, checked byte-equal on every rank."""
        import lightgbm_tpu_torch as tlgb
        texts = self.texts(name)
        for r, t in enumerate(texts[1:], 1):
            assert t == texts[0], f"{name}: rank {r}'s model differs"
        return tlgb.Booster(model_str=texts[0], params=CPU)


def trees_text(text: str) -> str:
    """A model text without its parameters."""
    return text.split("\nparameters:")[0]


def trees_equal(b_world, b_ref, value_tol=2e-4):
    """``tests/test_data_parallel.py``'s ``_trees_equal``: structure
    exact, thresholds to 1e-6, leaf values to ``value_tol``."""
    assert len(b_world._models) == len(b_ref._models)
    for td, ts in zip(b_world._models, b_ref._models):
        assert td.num_leaves == ts.num_leaves
        np.testing.assert_array_equal(td.split_feature, ts.split_feature)
        np.testing.assert_array_equal(td.left_child, ts.left_child)
        np.testing.assert_array_equal(td.right_child, ts.right_child)
        np.testing.assert_allclose(td.threshold, ts.threshold,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(td.leaf_value, ts.leaf_value,
                                   rtol=value_tol, atol=value_tol)


def close_trees(a, b, rtol=1e-5, atol=1e-7, thresholds=True):
    """``tests/test_parallel_modes.py``'s ``_trees_equal``: structure
    and thresholds exact, leaf values close."""
    assert len(a._models) == len(b._models)
    for ta, tb in zip(a._models, b._models):
        assert ta.num_leaves == tb.num_leaves
        nn = ta.num_leaves - 1
        for fld in ("split_feature", "left_child", "right_child") + (
                ("threshold",) if thresholds else ()):
            np.testing.assert_array_equal(getattr(ta, fld)[:nn],
                                          getattr(tb, fld)[:nn])
        np.testing.assert_allclose(ta.leaf_value[:ta.num_leaves],
                                   tb.leaf_value[:tb.num_leaves],
                                   rtol=rtol, atol=atol)


def sparse_onehot(n, groups, per_group, seed):
    """One-hot blocks (exclusive by construction) and two dense
    features: the JAX tests' bundling fixture."""
    rs = np.random.RandomState(seed)
    cols, signal = [], np.zeros(n)
    for g in range(groups):
        pick = rs.randint(0, per_group, n)
        block = np.zeros((n, per_group))
        vals = rs.rand(per_group) * 2
        block[np.arange(n), pick] = vals[pick]
        cols.append(block)
        signal += vals[pick]
    dense = rs.randn(n, 2)
    X = np.hstack(cols + [dense])
    y = (signal + 0.5 * dense[:, 0]
         + 0.3 * rs.randn(n) > np.median(signal)).astype(float)
    return X, y
