"""The port's streaming ingest (lightgbm_tpu_torch/data/, the streaming
half of basic.py) held against the JAX package on the CPU.

Mirrors tests/test_data_ingest.py and tests/test_two_round.py, without
their multi-process, fault and registry cases (ROADMAP.md Queue 1 items
20 and 21). The same seeded numpy data goes through both packages'
chunk sources; bins, mappers (``to_dict``), used features, labels,
weights and the data digest must be exactly equal to the JAX
package's streamed construct and, where the JAX test says so, to the
eager construct. The port bins every chunk on the device (here the
CPU) straight into its device bin matrix: its ``host_binned_bytes`` is
0 where the JAX package reports its host matrix.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu.data as jdata
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.data as tdata
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import grow

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "max_bin": 63}
PKG = {"jax": (jlgb, jdata, {}), "port": (tlgb, tdata, CPU)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_programs():
    """Drop the JAX programs this module compiled when it ends (the
    process-wide jit signature budgets of later tests)."""
    yield
    jax.clear_caches()


@jax.jit
def _xla_totals(full):
    return jnp.stack([jnp.sum(full[:, 0]), jnp.sum(full[:, 1])])


@pytest.fixture(autouse=True)
def jax_root_totals(monkeypatch):
    """XLA's float root totals (ROADMAP.md Queue 3)."""
    def root(full):
        v = torch.from_numpy(np.array(_xla_totals(full.numpy())))
        return v[0], v[1]
    monkeypatch.setattr(grow, "root_totals", root)


def _make(n=4000, f=8, seed=3, nan_frac=0.05):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    if nan_frac:
        X[rs.rand(n, f) < nan_frac] = np.nan
    y = (np.nansum(X[:, : max(1, f // 2)], axis=1) > 0).astype(
        np.float64)
    return X, y


def _build(pkg, make, params=PARAMS, **kw):
    """``Dataset(make(lgb, data), ...)`` of one package, constructed."""
    lgb, data, extra = PKG[pkg]
    return lgb.Dataset(make(lgb, data), params={**params, **extra},
                       **kw).construct()


def _pair(make, params=PARAMS, **kw):
    return _build("jax", make, params, **kw), _build("port", make, params,
                                                     **kw)


def _same(a, b, digest=True):
    """Equal constructs: mappers, bins (and their dtype), used features,
    labels and weights; the data digests when both streamed."""
    assert [m.to_dict() for m in a.mappers] == \
        [m.to_dict() for m in b.mappers]
    ab, bb = a.host_bins(), b.host_bins()
    assert ab.dtype == bb.dtype
    np.testing.assert_array_equal(ab, bb)
    np.testing.assert_array_equal(a.used_feature_indices(),
                                  b.used_feature_indices())
    np.testing.assert_array_equal(np.asarray(a.get_label()),
                                  np.asarray(b.get_label()))
    wa, wb = a.get_weight(), b.get_weight()
    assert (wa is None) == (wb is None)
    if wa is not None:
        np.testing.assert_array_equal(np.asarray(wa), np.asarray(wb))
    if digest:
        assert a._data_digest == b._data_digest


def _eager(pkg, X, y, params=PARAMS, **kw):
    lgb, _, extra = PKG[pkg]
    return lgb.Dataset(X, label=y, params={**params, **extra},
                       **kw).construct()


# ---- array, generator and Sequence sources ----------------------------------

@pytest.mark.parametrize("chunk", [1000, 999, 8192])
def test_array_chunks_bin_like_jax_and_eager(chunk):
    X, y = _make()
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(X, label=y,
                                                       chunk_rows=chunk))
    _same(ja, tb)
    _same(_eager("port", X, y), tb, digest=False)
    assert tb._ingest_stats["rows"] == len(y)
    assert tb._ingest_stats["chunks"] == -(-len(y) // chunk)
    assert set(tb._ingest_stats) == set(ja._ingest_stats)
    # the port's bins never exist on the host; the JAX package's do
    assert tb._ingest_stats["host_binned_bytes"] == 0
    assert ja._ingest_stats["host_binned_bytes"] == ja.host_bins().nbytes


def test_known_length_subsample_is_the_eager_draw():
    """bin_construct_sample_cnt < n on a declared length: the stream
    gathers the eager constructor's rng.choice rows."""
    X, y = _make(n=5000)
    params = dict(PARAMS, bin_construct_sample_cnt=700)
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(X, label=y,
                                                       chunk_rows=640),
                   params)
    _same(ja, tb)
    _same(_eager("port", X, y, params), tb, digest=False)


@pytest.mark.parametrize("declared", [True, False])
def test_generator_factory_of_known_and_unknown_length(declared):
    X, y = _make()

    def factory():
        for lo in range(0, len(y), 640):
            yield X[lo:lo + 640], y[lo:lo + 640]

    ja, tb = _pair(lambda lgb, d: d.GeneratorChunkSource(
        factory, num_rows=len(y) if declared else None))
    _same(ja, tb)
    _same(_eager("port", X, y), tb, digest=False)


def test_reservoir_sample_differs_from_the_eager_draw_in_both():
    """ROADMAP.md Queue 3: an unknown-length source below the sample
    budget's cover samples by a reservoir, not by the eager rng.choice,
    so its mappers differ from the eager construct's — in both packages
    alike."""
    X, y = _make(n=5000)
    params = dict(PARAMS, bin_construct_sample_cnt=700)

    def factory():
        for lo in range(0, len(y), 640):
            yield X[lo:lo + 640], y[lo:lo + 640]

    ja, tb = _pair(lambda lgb, d: d.GeneratorChunkSource(factory), params)
    _same(ja, tb)
    for pkg, ds in (("jax", ja), ("port", tb)):
        eager = _eager(pkg, X, y, params)
        assert [m.to_dict() for m in eager.mappers] != \
            [m.to_dict() for m in ds.mappers], pkg


def test_bare_callable_is_a_chunk_factory():
    X, y = _make(n=1200)

    def chunks():
        yield X[:500], y[:500]
        yield X[500:], y[500:]

    ja, tb = _pair(lambda lgb, d: chunks)
    _same(ja, tb)
    _same(_eager("port", X, y), tb, digest=False)


def _seq_class(lgb):
    class ArrSeq(lgb.Sequence):
        batch_size = 128

        def __init__(self, arr):
            self.arr = arr

        def __getitem__(self, idx):
            return self.arr[idx]

        def __len__(self):
            return len(self.arr)
    return ArrSeq


@pytest.mark.parametrize("as_list", [True, False])
def test_sequences_stream_like_jax(as_list):
    X, y = _make(n=900, f=4)

    def make(lgb, d):
        S = _seq_class(lgb)
        return [S(X[:400]), S(X[400:])] if as_list else S(X)

    ja, tb = _pair(make, label=y)
    _same(ja, tb)
    _same(_eager("port", X, y), tb, digest=False)
    assert tb._ingest_stats["source"] == "SequenceChunkSource"


# ---- text files: chunked CSV and two_round -------------------------------

def test_csv_path_streams_with_ingest_chunk_rows(tmp_path):
    X, y = _make(n=3000, f=6, nan_frac=0.0)
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.6g")
    params = dict(PARAMS, ingest_chunk_rows=700)
    ja, tb = _pair(lambda lgb, d: path, params)
    _same(ja, tb)
    assert tb._ingest_stats["source"] == "CSVChunkSource"
    _same(_build("port", lambda lgb, d: path), tb, digest=False)
    # two_round's streamed result agrees too (same sampling seed)
    _same(_build("port", lambda lgb, d: path,
                 dict(PARAMS, two_round=True)), tb, digest=False)


def test_csv_header_and_named_label_column(tmp_path):
    X, y = _make(n=800, f=4, nan_frac=0.0)
    path = str(tmp_path / "named.csv")
    with open(path, "w") as fh:
        fh.write("a,target,b,c,d\n")
        np.savetxt(fh, np.column_stack([X[:, 0], y, X[:, 1:]]),
                   delimiter=",", fmt="%.6g")
    named = dict(PARAMS, header=True, label_column="name:target")
    ja, tb = _pair(lambda lgb, d: path, dict(named, ingest_chunk_rows=300))
    _same(ja, tb)
    np.testing.assert_array_equal(tb.get_label(), y)
    assert tb.get_feature_name() == ja.get_feature_name() == \
        ["a", "b", "c", "d"]
    _same(_build("port", lambda lgb, d: path, named), tb, digest=False)


def _write_csv(path, n, f, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f)
    y = ((X @ rs.randn(f)) > 0).astype(float)
    np.savetxt(path, np.column_stack([y, X]), delimiter=",", fmt="%.6g")


def test_two_round_matches_eager_and_jax(tmp_path):
    path = str(tmp_path / "train.csv")
    _write_csv(path, 4000, 8, seed=3)
    params = dict(PARAMS, bin_construct_sample_cnt=10_000)
    ja, tb = _pair(lambda lgb, d: path, dict(params, two_round=True))
    _same(ja, tb, digest=False)
    _same(_build("port", lambda lgb, d: path, params), tb, digest=False)
    assert tb._ingest_stats is None      # two_round is not the chunk path


def test_two_round_sub_full_sample_matches_jax(tmp_path):
    """With a sample below the file's rows, both packages draw the same
    reservoir of lines (one randint per line past the budget)."""
    path = str(tmp_path / "train.csv")
    _write_csv(path, 20000, 6, seed=5)
    params = dict(PARAMS, two_round=True, bin_construct_sample_cnt=2000)
    ja, tb = _pair(lambda lgb, d: path, params)
    _same(ja, tb, digest=False)


def test_two_round_named_label_column_and_its_errors(tmp_path):
    path = str(tmp_path / "named.csv")
    rs = np.random.RandomState(5)
    X = rs.randn(1500, 4)
    y = ((X @ rs.randn(4)) > 0).astype(float)
    with open(path, "w") as fh:
        fh.write("f0,f1,f2,f3,target\n")
        np.savetxt(fh, np.column_stack([X, y]), delimiter=",", fmt="%.6g")
    params = dict(PARAMS, header=True, label_column="name:target",
                  bin_construct_sample_cnt=10_000, two_round=True)
    ja, tb = _pair(lambda lgb, d: path, params)
    _same(ja, tb, digest=False)
    np.testing.assert_allclose(tb.get_label(), y)
    plain = dict(PARAMS, two_round=True, label_column="name:target")
    for lgb, _, extra in PKG.values():
        with pytest.raises(lgb.LightGBMError, match="header"):
            lgb.Dataset(path, params={**plain, **extra}).construct()
        with pytest.raises(lgb.LightGBMError, match="linear_tree"):
            lgb.Dataset(path, params={**params, "linear_tree": True,
                                      **extra}).construct()


def test_libsvm_path_keeps_the_eager_loader(tmp_path):
    path = str(tmp_path / "train.svm")
    with open(path, "w") as fh:
        for i in range(200):
            fh.write(f"{i % 2} 0:{i * 0.1:.3f} 2:{(200 - i) * 0.5:.3f}\n")
    params = dict(PARAMS, ingest_chunk_rows=64)
    ja, tb = _pair(lambda lgb, d: path, params)
    assert tb._ingest_stats is None
    assert getattr(ja, "_ingest_stats", None) is None
    _same(ja, tb, digest=False)
    assert tb.num_data() == 200


# ---- the push API ----------------------------------------------------------

def test_push_rows_in_any_order_then_mark_finished():
    X, y = _make(n=600, f=5)
    w = np.random.RandomState(2).rand(600) + 0.5

    def build(pkg):
        lgb, _, extra = PKG[pkg]
        ds = lgb.Dataset.init_streaming(600, 5, params={**PARAMS, **extra})
        ds.push_rows(X[300:], start_row=300, label=y[300:], weight=w[300:])
        ds.push_rows(X[:300], label=y[:300], weight=w[:300])
        return ds.mark_finished()

    ja, tb = build("jax"), build("port")
    _same(ja, tb, digest=False)
    _same(_eager("port", X, y, weight=w), tb, digest=False)
    for lgb, _, extra in PKG.values():
        ds = lgb.Dataset.init_streaming(10, 2, params={**PARAMS, **extra})
        ds.push_rows(np.zeros((4, 2)))
        with pytest.raises(lgb.LightGBMError, match="unpushed"):
            ds.mark_finished()
        with pytest.raises(lgb.LightGBMError, match="beyond"):
            ds.push_rows(np.zeros((7, 2)))
        plain = lgb.Dataset(np.zeros((2, 2)), label=[0, 1])
        with pytest.raises(lgb.LightGBMError, match="init_streaming"):
            plain.push_rows(np.zeros((1, 2)))
        with pytest.raises(lgb.LightGBMError, match="init_streaming"):
            plain.mark_finished()


# ---- Arrow and parquet -----------------------------------------------------

def test_arrow_table_and_parquet_like_jax(tmp_path):
    """ROADMAP.md Queue 3: Arrow and parquet are held here on the CPU
    (the card's machine may lack pyarrow)."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    X, y = _make(n=1100, f=5, nan_frac=0.0)
    table = pa.table({"label": y,
                      **{f"f{j}": X[:, j] for j in range(X.shape[1])}})
    ja, tb = _pair(lambda lgb, d: d.ArrowChunkSource(
        table, chunk_rows=256, label_column="label"))
    _same(ja, tb)
    _same(_eager("port", X, y), tb, digest=False)
    assert tb.get_feature_name() == [f"f{j}" for j in range(5)]
    pq_path = str(tmp_path / "train.parquet")
    pq.write_table(table, pq_path, row_group_size=300)
    for params in (dict(PARAMS, ingest_chunk_rows=256,
                        label_column="name:label"),
                   dict(PARAMS, ingest_chunk_rows=256)):
        ja, tb = _pair(lambda lgb, d: pq_path, params)
        _same(ja, tb)
        _same(_eager("port", X, y), tb, digest=False)
    # an Arrow table without ingest_chunk_rows: the eager construct
    feats = pa.table({f"f{j}": X[:, j] for j in range(X.shape[1])})
    ja, tb = _pair(lambda lgb, d: feats, label=y)
    _same(ja, tb, digest=False)
    assert tb._ingest_stats is None
    assert tb.get_feature_name() == ja.get_feature_name()


# ---- valid sets, linear trees, categoricals, metadata ---------------------

def test_streamed_valid_set_binned_against_its_reference():
    X, y = _make()
    Xv, yv = _make(n=700, seed=11)
    out = {}
    for pkg, (lgb, d, extra) in PKG.items():
        tr = lgb.Dataset(d.ArrayChunkSource(X, label=y, chunk_rows=512),
                         params={**PARAMS, **extra})
        out[pkg] = tr.create_valid(d.ArrayChunkSource(
            Xv, label=yv, chunk_rows=128)).construct()
    _same(out["jax"], out["port"])
    ref = _eager("port", X, y)
    _same(ref.create_valid(Xv, label=yv).construct(), out["port"],
          digest=False)


def test_linear_tree_keeps_raw_values_like_jax():
    X, y = _make(n=1200, nan_frac=0.0)
    y = X[:, 0] * 2.0 + y
    params = dict(PARAMS, objective="regression", linear_tree=True)
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(X, label=y,
                                                       chunk_rows=500),
                   params)
    _same(ja, tb)
    np.testing.assert_array_equal(tb.raw_numeric(), ja.raw_numeric())
    np.testing.assert_array_equal(
        tb.raw_numeric(), _eager("port", X, y, params).raw_numeric())


def test_categorical_indices_and_their_precedence():
    rs = np.random.RandomState(5)
    n = 1200
    X = np.column_stack([rs.randint(0, 6, n).astype(float),
                         rs.randint(0, 6, n).astype(float), rs.randn(n)])
    y = (X[:, 2] > 0).astype(np.float64)
    # the constructor's argument wins over the params' spec
    params = dict(PARAMS, categorical_feature="1")
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(X, label=y,
                                                       chunk_rows=500),
                   params, categorical_feature=[0])
    _same(ja, tb)
    _same(_eager("port", X, y, params, categorical_feature=[0]), tb,
          digest=False)
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(X, label=y,
                                                       chunk_rows=400),
                   dict(PARAMS, categorical_feature=[1]))
    _same(ja, tb)


def test_weights_label_override_and_digests():
    X, y = _make(n=1000)
    w = np.random.RandomState(0).rand(1000) + 0.5
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(
        X, label=y, weight=w, chunk_rows=300))
    _same(ja, tb)
    # an explicit label replaces the source's, and so does its digest
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(X, label=y,
                                                       chunk_rows=300),
                   label=1.0 - y)
    _same(ja, tb)
    assert tb._data_digest == tdata.dataset_digest(1.0 - y,
                                                   tb.host_bins())
    # the streamed digest is the eager data's
    ja, tb = _pair(lambda lgb, d: d.ArrayChunkSource(X, label=y,
                                                       chunk_rows=999))
    assert tb._data_digest == jdata.dataset_digest(
        y, _eager("jax", X, y).host_bins())
    tb.set_label(1.0 - y)
    assert tb._data_digest is None


def test_custom_source_with_float32_chunks_and_labels():
    X, y = _make(n=900)

    def make(lgb, d):
        class F32Source(d.RowChunkSource):
            def num_rows(self):
                return len(y)

            def chunks(self):
                for lo in range(0, len(y), 250):
                    yield d.RowChunk(X[lo:lo + 250].astype(np.float32),
                                     y[lo:lo + 250].astype(np.float32))
        return F32Source()

    ja, tb = _pair(make)
    _same(ja, tb)
    eager = _eager("port", X.astype(np.float32), y)
    _same(eager, tb, digest=False)
    assert tb._data_digest == tdata.dataset_digest(y, eager.host_bins())


def test_trees_from_a_streamed_dataset_match_jax():
    """Five quantized rounds (exact histograms: ROADMAP.md Queue 3,
    "XLA's arithmetic") from streamed Datasets, tree for tree."""
    rs = np.random.RandomState(9)
    X = rs.randn(2500, 8).astype(np.float32)
    y = ((X @ rs.randn(8)) > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 12, "max_bin": 63,
         "min_data_in_leaf": 10, "verbosity": -1,
         "use_quantized_grad": True, "stochastic_rounding": False}
    ja = jlgb.train({**p, "hist_method": "scatter"}, jlgb.Dataset(
        jdata.ArrayChunkSource(X, label=y, chunk_rows=600),
        params={"max_bin": 63}), 5)
    tb = tlgb.train({**p, **CPU}, tlgb.Dataset(
        tdata.ArrayChunkSource(X, label=y, chunk_rows=600),
        params={"max_bin": 63, **CPU}), 5)
    assert ja.num_trees() == tb.num_trees() == 5
    for a, b in zip(ja._models, tb._models):
        for name in ("split_feature", "threshold", "decision_type",
                     "left_child", "right_child", "leaf_count",
                     "internal_count"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5)
    # and the eager Dataset's trees are the streamed one's
    te = tlgb.train({**p, **CPU}, tlgb.Dataset(
        X, label=y, params={"max_bin": 63, **CPU}), 5)
    assert te.model_to_string() == tb.model_to_string()


# ---- errors: the JAX package's cases, the same exception types -------------

def _gen_object(lgb, d):
    X, y = _make(n=500)
    return d.GeneratorChunkSource(iter([(X, y)]))


def _factory_of(*chunks):
    return lambda lgb, d: d.GeneratorChunkSource(lambda: iter(chunks))


ERRORS = {
    "generator_object": (_gen_object, None),
    "feature_width": (_factory_of((np.zeros((10, 4)), np.zeros(10)),
                                  (np.zeros((10, 5)), np.zeros(10))),
                      "features"),
    "labels": (_factory_of((np.zeros((10, 3)), np.zeros(10)),
                           (np.zeros((10, 3)),)), "labels"),
    "weights": (_factory_of((np.zeros((10, 3)), np.zeros(10), np.ones(10)),
                            (np.zeros((10, 3)), np.zeros(10))), "weights"),
    "declared": (lambda lgb, d: d.GeneratorChunkSource(
        lambda: iter([_make(n=300)]), num_rows=400), "declared"),
    "empty": (lambda lgb, d: d.GeneratorChunkSource(lambda: iter(())),
              "no rows"),
    "missing_label": (lambda lgb, d: d.ArrayChunkSource(
        _make(n=200)[0], chunk_rows=100), "Label"),
    "label_length": (lambda lgb, d: d.ArrayChunkSource(
        _make(n=100)[0], label=np.zeros(150)), "Length of label"),
    "weight_length": (lambda lgb, d: d.ArrayChunkSource(
        _make(n=100)[0], label=np.zeros(100), weight=np.ones(80)),
        "Length of weight"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_raise_like_jax(case):
    make, match = ERRORS[case]
    for pkg, (lgb, _, extra) in PKG.items():
        with pytest.raises(lgb.LightGBMError, match=match):
            _build(pkg, make)


def test_ingest_chunk_rows_validation_and_accepted_parameters():
    with pytest.raises(ValueError):
        Config.from_params({"ingest_chunk_rows": -1})
    assert Config.from_params(
        {"ingest_chunk_rows": "4096"}).ingest_chunk_rows == 4096
    assert Config.from_params({"two_round": "true"}).two_round
    assert Config.from_params(
        {"forcedbins_filename": "bins.json"}).forcedbins_filename == \
        "bins.json"


# ---- host memory -----------------------------------------------------------

def test_host_peak_stays_under_half_the_float_matrix():
    """A set 20x its chunk, made chunk by chunk by a factory: the host
    peak of the construct (tracemalloc) stays under half the float
    matrix it never builds."""
    n, f, chunk = 200_000, 20, 10_000

    def factory():
        for lo in range(0, n, chunk):
            rs = np.random.RandomState(lo)
            Xc = rs.randn(chunk, f)
            yield Xc, (Xc[:, 0] > 0).astype(np.float64)

    ds = tlgb.Dataset(tdata.GeneratorChunkSource(factory, num_rows=n),
                      params={**PARAMS, **CPU,
                              "bin_construct_sample_cnt": 20_000})
    tracemalloc.start()
    try:
        ds.construct()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert ds.num_data() == n and ds._ingest_stats["chunks"] == 20
    assert peak < n * f * 8 / 2, peak
