"""The port's artifact store and model publication
(lightgbm_tpu_torch/resilience/store.py, publisher.py) held against the
JAX package's on the CPU.

Both packages run the same verbs on the same bytes: the stores' answers
and errors, the manifests (equal but for their creation time and trace
ids), the retries, backoff delays and fault events of the chaos kinds
(``publish_torn``, ``store_outage``, ``publish_poison``, with ``_sleep``
and ``_rng`` injected), pruning, rollback and ``latest_manifest``. Each
package validates the other's publications (the same manifest magic).
The models are one model text, trained by the port from a seed.
"""

import uuid

import numpy as np
import pytest

import jax

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.resilience import faults as jax_faults
from lightgbm_tpu.resilience import publisher as jax_pub
from lightgbm_tpu.resilience import store as jax_store
from lightgbm_tpu_torch.resilience import faults as port_faults
from lightgbm_tpu_torch.resilience import publisher as port_pub
from lightgbm_tpu_torch.resilience import store as port_store

CPU = {"device_type": "cpu", "verbosity": -1}
PACKAGES = {"jax": (jax_store, jax_pub, jax_faults),
            "port": (port_store, port_pub, port_faults)}


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_fault_logs(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_FAULT_INJECT", raising=False)
    for _, _, faults in PACKAGES.values():
        faults.drain_events(faults.FAULT_EVENTS)
    yield
    for _, _, faults in PACKAGES.values():
        faults.drain_events(faults.FAULT_EVENTS)


@pytest.fixture(scope="module")
def model_texts():
    """Two model texts of 2,000 x 8 rows, 15 leaves, and 64 canary rows
    with each model's raw scores."""
    rs = np.random.RandomState(7)
    X = rs.randn(2000, 8)
    out = []
    for col in (0, 1):
        y = ((X[:, col] + 0.4 * rs.randn(2000)) > 0) * 1.0
        bst = tlgb.train({"objective": "binary", "num_leaves": 15, **CPU},
                         tlgb.Dataset(X, label=y, params=CPU), 4)
        out.append((bst.model_to_string(),
                    bst.predict(X[:64], raw_score=True).tolist()))
    return out, X[:64].tolist()


def _events(faults):
    return [(e["kind"], e["iteration"], e["action"], e["detail"])
            for e in faults.drain_events(faults.FAULT_EVENTS)]


def _bare(manifest):
    return {k: v for k, v in manifest.items()
            if k not in ("created_unix", "trace")}


# ---- the store --------------------------------------------------------------

def _store_verbs(store_mod, target):
    st = store_mod.store_for(target)
    assert store_mod.store_for(st) is st
    out = [st.list_names()]
    st.put_bytes("b.txt", b"bee")
    st.put_bytes("a.txt", b"alpha")
    st.put_bytes("a.txt", b"alpha2")
    out.append(st.list_names())
    out.append(st.get_bytes("a.txt"))
    out.append(st.stat("a.txt")[1])
    out.append(st.stat("nope"))
    with pytest.raises(FileNotFoundError):
        st.get_bytes("nope")
    st.delete("b.txt")
    st.delete("b.txt")                       # idempotent
    out.append(st.list_names())
    return out


@pytest.mark.parametrize("kind", ["dir", "mem"])
def test_store_verbs_answer_like_jax(kind, tmp_path):
    got = {}
    for name, (store_mod, _, _) in PACKAGES.items():
        target = str(tmp_path / name / "sub") if kind == "dir" \
            else f"mem://{uuid.uuid4().hex}"
        got[name] = _store_verbs(store_mod, target)
    assert got["port"] == got["jax"]
    assert got["port"][0] == [] and got["port"][-1] == ["a.txt"]


def test_memory_backend_faults_like_jax():
    """Outages, torn puts and latency: the same errors, blobs and
    counters in both packages; a StoreError is an OSError."""
    got = {}
    for name, (store_mod, _, _) in PACKAGES.items():
        spec = f"mem://{uuid.uuid4().hex}"
        st = store_mod.store_for(spec)
        assert store_mod.store_for(spec).backend is st.backend
        be = st.backend
        st.put_bytes("m.txt", b"0123456789")
        be.set_outage(2)
        errs = []
        for verb in (st.list_names, lambda: st.get_bytes("m.txt")):
            with pytest.raises(store_mod.StoreError) as ei:
                verb()
            errs.append(str(ei.value))
        assert isinstance(ei.value, OSError)
        be.tear_next_put()
        with pytest.raises(store_mod.StoreError):
            st.put_bytes("t.txt", b"abcdefghi")
        be.set_outage(-1)
        with pytest.raises(store_mod.StoreError):
            st.list_names()
        be.set_outage(0)
        got[name] = (errs, st.get_bytes("t.txt"), st.list_names(),
                     be.puts, be.gets, be.faults_injected)
    assert got["port"] == got["jax"]
    assert got["port"][1] == b"abc"


# ---- publication -----------------------------------------------------------

@pytest.mark.parametrize("target", ["dir", "mem"])
def test_manifests_equal_and_each_validates_the_other(model_texts,
                                                      tmp_path, target):
    (text, scores), rows = model_texts[0][0], model_texts[1]
    canary = {"rows": rows, "scores": scores, "tol": 1e-4}
    meta = {"generation": 3, "train_auc": 0.9}
    where = {}
    manifests = {}
    for name, (_, pub, _) in PACKAGES.items():
        where[name] = str(tmp_path / name) if target == "dir" \
            else f"mem://{uuid.uuid4().hex}"
        manifests[name] = pub.publish_model(
            text, where[name], "m1.txt", metadata=meta, canary=canary)
    assert _bare(manifests["port"]) == _bare(manifests["jax"])
    assert manifests["port"]["magic"] == "lightgbm_tpu.publish.v1"
    assert set(manifests["port"]["trace"]) == {"trace_id", "span_id"}
    # a mem:// store lives in one package's process-wide registry, so
    # across packages only a directory is shared
    pairs = (("port", "jax"), ("jax", "port")) if target == "dir" \
        else (("port", "port"), ("jax", "jax"))
    for mine, other in pairs:
        _, pub, _ = PACKAGES[mine]
        store = PACKAGES[mine][0].store_for(where[other])
        got = pub.validate_artifact_in(store, "m1.txt")
        assert got == manifests[other]
        found = pub.latest_manifest(where[other])
        assert found[1] == manifests[other]
        if target == "dir":
            assert pub.validate_artifact(
                str(tmp_path / other / "m1.txt")) == manifests[other]
            assert pub.load_manifest(
                str(tmp_path / other / "m1.txt")) == manifests[other]


def test_torn_and_foreign_artifacts_fail_validation_like_jax(
        model_texts, tmp_path):
    text = model_texts[0][0][0]
    for name, (store_mod, pub, _) in PACKAGES.items():
        d = tmp_path / name
        pub.publish_model(text, str(d), "m.txt")
        st = store_mod.LocalDirStore(str(d))
        st.put_bytes("m.txt", text.encode()[:100])
        with pytest.raises(pub.PublishError, match="torn or partial"):
            pub.validate_artifact_in(st, "m.txt")
        assert pub.latest_manifest(str(d)) is None
        st.put_bytes("x.txt" + pub.MANIFEST_SUFFIX, b'{"magic": "nope"}')
        with pytest.raises(pub.PublishError, match="bad manifest magic"):
            pub.load_manifest_in(st, "x.txt")
        st.put_bytes("y.txt", b"unmanaged")
        assert pub.validate_artifact_in(st, "y.txt") is None


@pytest.mark.parametrize("spec,retries", [
    ("publish_torn@5", 5), ("store_outage@5", 5),
    ("publish_torn@5,store_outage@5", 5),
    ("store_outage@5,store_outage@5", 1)])
def test_chaos_kinds_retry_like_jax(model_texts, tmp_path, monkeypatch,
                                    spec, retries):
    """The same attempts, backoff delays, fault events, final blobs and
    (when retries run out) the same PublishError."""
    text = model_texts[0][0][0]
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", spec)
    got = {}
    for name, (store_mod, pub, faults) in PACKAGES.items():
        sleeps = []
        d = str(tmp_path / name)
        try:
            m = pub.publish_model(text, d, "g.txt", retries=retries,
                                  backoff_base_sec=0.1,
                                  fault_iteration=5,
                                  _sleep=sleeps.append, _rng=lambda: 0.25)
            err = None
        except pub.PublishError as e:
            m, err = None, str(e).replace(d, "<dir>")
        got[name] = (sleeps, _events(faults), err,
                     None if m is None else _bare(m),
                     store_mod.LocalDirStore(d).list_names())
    assert got["port"] == got["jax"]
    sleeps, events, err, _, _ = got["port"]
    # every failed attempt but an exhausted last one sleeps
    assert len(events) == len(sleeps) + (err is not None) >= 1
    assert sleeps[0] == pytest.approx(0.1 * 0.75)
    if spec.count("store_outage") == 2:
        assert err is not None and "2 attempt(s)" in err


def test_publish_poison_keeps_bytes_valid_like_jax(model_texts, tmp_path,
                                                   monkeypatch):
    (text, scores), rows = model_texts[0][0], model_texts[1]
    canary = {"rows": rows[:4], "scores": scores[:4], "tol": 1e-4}
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "publish_poison@2")
    got = {}
    for name, (_, pub, faults) in PACKAGES.items():
        d = str(tmp_path / name)
        m = pub.publish_model(text, d, "p.txt", canary=canary,
                              fault_iteration=2)
        assert pub.validate_artifact(d + "/p.txt") == m
        got[name] = (_bare(m), _events(faults))
    assert got["port"] == got["jax"]
    assert got["port"][0]["canary"]["scores"] == [s + 1e3
                                                  for s in scores[:4]]
    assert [e[0] for e in got["port"][1]] == ["publish_poison"]


def _publish_series(pub, target, texts):
    names = []
    for i, text in enumerate(texts):
        name = f"gen{i}.txt"
        pub.publish_model(text, target, name, metadata={"generation": i},
                          canary={"rows": [[0.0] * 8], "scores": [0.0]})
        names.append(name)
    return names


@pytest.mark.parametrize("target", ["dir", "mem"])
def test_prune_rollback_and_latest_agree_with_jax(model_texts, tmp_path,
                                                  target):
    (a, _), (b, _) = model_texts[0]
    texts = [a, b, a + "\n", b + "\n"]
    got = {}
    for name, (store_mod, pub, _) in PACKAGES.items():
        where = str(tmp_path / name) if target == "dir" \
            else f"mem://{uuid.uuid4().hex}"
        _publish_series(pub, where, texts)
        st = store_mod.store_for(where)
        oldest_sha = pub.load_manifest_in(st, "gen0.txt")["sha256"]
        pruned = pub.prune_publications(where, keep=2,
                                        protect_shas=(oldest_sha,))
        latest = pub.latest_manifest(where)
        rolled = pub.rollback_publication(where, "gen3.txt", "gen2.txt")
        again = pub.latest_manifest(where)
        got[name] = (pruned, latest[0].replace(where, "<t>"),
                     _bare(rolled), again[0].replace(where, "<t>"),
                     sorted(st.list_names()))
    assert got["port"] == got["jax"]
    pruned, _, rolled, again, names = got["port"]
    assert pruned == ["gen1.txt"]
    assert rolled["generation"] == 2 and rolled["rollback_of"]
    assert again.endswith(rolled["file"])
    assert "gen3.txt" not in names and "gen0.txt" in names


def test_publish_keep_prunes_after_success_like_jax(model_texts,
                                                    tmp_path):
    (a, _), (b, _) = model_texts[0]
    got = {}
    for name, (store_mod, pub, _) in PACKAGES.items():
        d = str(tmp_path / name)
        for i, text in enumerate([a, b, a + "\n"]):
            pub.publish_model(text, d, f"k{i}.txt", keep=2)
        got[name] = store_mod.LocalDirStore(d).list_names()
    assert got["port"] == got["jax"]
    assert [n for n in got["port"] if n.endswith(".txt")] == \
        ["k1.txt", "k2.txt"]


def test_publish_counters_in_the_port_registry(model_texts, tmp_path,
                                               monkeypatch):
    """One outage, one retry: the port's registry counts the publish,
    the retry and its backoff seconds."""
    from lightgbm_tpu_torch.obs.registry import registry

    def value(name):
        fam = registry.snapshot().get(name)
        return 0.0 if fam is None else sum(r["value"]
                                           for r in fam["series"])

    before = {k: value(k) for k in ("publish_total", "publish_retries",
                                    "publish_backoff_seconds")}
    monkeypatch.setenv("LIGHTGBM_TPU_FAULT_INJECT", "store_outage@1")
    port_pub.publish_model(model_texts[0][0][0], str(tmp_path), "c.txt",
                           backoff_base_sec=0.5, fault_iteration=1,
                           _sleep=lambda s: None, _rng=lambda: 0.5)
    assert value("publish_total") == before["publish_total"] + 1
    assert value("publish_retries") == before["publish_retries"] + 1
    assert value("publish_backoff_seconds") == pytest.approx(
        before["publish_backoff_seconds"] + 0.5)
