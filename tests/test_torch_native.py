"""The port's native host library (``ebnerd_tpu_torch/native/``) against
its numpy path and against ``ebnerd_tpu.native``, on seeded inputs: the
four functions for every dtype ``tests/data/test_native.py`` covers, then
the ``Ragged`` and ``Lookup`` methods that call them, with the edge cases
and the inputs that dispatch to numpy. Every output must be bit-equal,
with its dtype. A failed build raises; ``EBNERD_TPU_NO_NATIVE=1`` takes
the numpy path, and the call counters show which path ran."""
import re
import threading

import numpy as np
import pytest

from ebnerd_tpu import native as jax_native
from ebnerd_tpu.data.lookup import Lookup as JLookup
from ebnerd_tpu.data.ragged import Ragged as JRagged
from ebnerd_tpu_torch import native
from ebnerd_tpu_torch.data import ragged as pr
from ebnerd_tpu_torch.data.lookup import Lookup
from ebnerd_tpu_torch.data.ragged import Ragged


@pytest.fixture
def numpy_path(monkeypatch):
    """Run a block on the numpy path: ``with numpy_path(): ...``."""
    class _Opt:
        def __enter__(self):
            monkeypatch.setenv("EBNERD_TPU_NO_NATIVE", "1")

        def __exit__(self, *exc):
            monkeypatch.delenv("EBNERD_TPU_NO_NATIVE")
    monkeypatch.delenv("EBNERD_TPU_NO_NATIVE", raising=False)
    native.reset_counters()
    return _Opt


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _ragged_equal(a, b):
    _equal(a.values, b.values)
    _equal(a.offsets, b.offsets)


def _lengths(rng, n_rows, max_len):
    return rng.integers(0, max_len + 1, n_rows)


def _values(rng, n, dtype):
    return rng.integers(0, 10_000, n).astype(dtype)


def _both(values, lengths):
    return Ragged.from_lengths(values, lengths), JRagged.from_lengths(values.copy(), lengths)


# -- the four functions ------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
def test_gather_ranges_matches_numpy_and_jax(numpy_path, dtype):
    rng = np.random.default_rng(0)
    lengths = _lengths(rng, 500, 12)
    values = _values(rng, int(lengths.sum()), dtype)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    rows = rng.integers(0, 500, 300)
    starts, lens = offsets[rows], lengths[rows]
    total = int(lens.sum())
    got = native.gather_ranges(values, starts, lens, total)
    _equal(got, values[pr._ranges(starts, lens, total)])
    _equal(got, jax_native.gather_ranges(values, starts, lens, total))
    assert native.counters()["gather_ranges"] == 1


@pytest.mark.parametrize("align_right", [True, False])
def test_to_padded_matches_jax(numpy_path, align_right):
    rng = np.random.default_rng(1)
    lengths = _lengths(rng, 200, 9)
    values = _values(rng, int(lengths.sum()), np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    out, mask = native.to_padded(values, offsets, 6, -7, align_right)
    jout, jmask = jax_native.to_padded(values, offsets, 6, -7, align_right)
    _equal(out, jout)
    _equal(mask, jmask)
    assert mask.dtype == np.bool_ and native.counters()["to_padded"] == 1


@pytest.mark.parametrize("table,query", [(np.uint32, np.uint32), (np.int64, np.int64),
                                         (np.int64, np.int32), (np.int32, np.int64)])
def test_map_ids_matches_numpy_and_jax(numpy_path, table, query):
    rng = np.random.default_rng(2)
    ids = np.unique(rng.integers(0, 100_000, 5_000)).astype(table)
    q = rng.integers(0, 120_000, 20_000).astype(query)
    got = native.map_ids(ids, q)
    _equal(got, jax_native.map_ids(ids, q))
    lk = Lookup.from_values(ids, np.zeros((len(ids), 1), np.float32))
    with numpy_path():
        _equal(got, lk.map_ids(q))
    assert got.dtype == np.int32 and native.counters()["map_ids"] == 1


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_isin_per_row_matches_jax(numpy_path, dtype):
    rng = np.random.default_rng(3)
    a_len, b_len = _lengths(rng, 400, 10), _lengths(rng, 400, 2)
    a_off = np.concatenate([[0], np.cumsum(a_len)]).astype(np.int64)
    b_off = np.concatenate([[0], np.cumsum(b_len)]).astype(np.int64)
    a, b = _values(rng, a_off[-1], dtype), _values(rng, b_off[-1], dtype)
    b[: len(b) // 2] = a[: len(b) // 2]  # hits as well as misses
    got = native.isin_per_row(a, a_off, b, b_off)
    _equal(got, jax_native.isin_per_row(a, a_off, b, b_off))
    assert got.any() and not got.all()


# -- the methods that call them ------------------------------------------------

def _method_outputs(r: Ragged, other: Ragged, rows, width):
    out = {"take": r.take_rows(rows), "tail": r.tail(3)}
    for align in ("right", "left"):
        out[f"pad_{align}"] = r.to_padded(width, pad_value=-1, align=align)
    if r.values.dtype.kind in "iu":
        out["isin"] = r.isin_per_row(other)
    return out


def _outputs_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple):
            for x, y in zip(a[k], b[k]):
                _equal(x, y)
        else:
            _ragged_equal(a[k], b[k]) if hasattr(a[k], "offsets") else _equal(a[k], b[k])


_EDGES = {
    "random": lambda rng: _lengths(rng, 300, 12),
    "empty_rows": lambda rng: np.where(rng.random(300) < 0.5, 0, _lengths(rng, 300, 12)),
    "all_empty": lambda rng: np.zeros(40, np.int64),
    "zero_rows": lambda rng: np.zeros(0, np.int64),
    "longer_than_width": lambda rng: rng.integers(8, 20, 100),
}


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("edge", list(_EDGES))
def test_ragged_methods_match_numpy_path_and_jax(numpy_path, dtype, edge):
    """take_rows, tail, to_padded (both aligns) and isin_per_row: native
    against the port's numpy path and against JAX's Ragged, at empty rows,
    zero rows, rows past the width and a total of 0."""
    rng = np.random.default_rng(4)
    lengths = _EDGES[edge](rng)
    r, jr = _both(_values(rng, int(lengths.sum()), dtype), lengths)
    o_len = _lengths(rng, len(r), 3)
    pool = r.values if r.total else _values(rng, 10, dtype)
    other, jother = _both(rng.choice(pool, int(o_len.sum())), o_len)
    rows = rng.integers(0, max(len(r), 1), 200) if len(r) else np.zeros(0, np.int64)
    got = _method_outputs(r, other, rows, 6)
    if len(r) and r.total:
        assert native.counters()["gather_ranges"] >= 1
    native.reset_counters()
    with numpy_path():
        ref = _method_outputs(r, other, rows, 6)
    assert sum(native.counters().values()) == 0
    _outputs_equal(got, ref)
    _outputs_equal(got, _method_outputs(jr, jother, rows, 6))


@pytest.mark.parametrize("edge", ["random", "query_unknown", "empty_query", "ragged"])
def test_lookup_map_ids_matches_numpy_path_and_jax(numpy_path, edge):
    rng = np.random.default_rng(5)
    ids = np.unique(rng.integers(1, 50_000, 2_000)).astype(np.int64)
    vals = rng.random((len(ids), 3)).astype(np.float32)
    lk, jlk = Lookup.from_values(ids, vals), JLookup.from_values(ids, vals)
    q = {"random": rng.choice(ids, (50, 7)).astype(np.int32),
         "query_unknown": rng.integers(50_000, 60_000, 100),
         "empty_query": np.zeros(0, np.int64),
         "ragged": None}[edge]
    if q is None:
        col = Ragged.from_lengths(rng.choice(ids, 90), np.full(30, 3))
        got = lk.map_ragged(col)
        with numpy_path():
            _ragged_equal(got, lk.map_ragged(col))
        _ragged_equal(got, jlk.map_ragged(JRagged(col.values, col.offsets)))
        return
    got = lk.map_ids(q)
    assert native.counters()["map_ids"] == 1
    with numpy_path():
        _equal(got, lk.map_ids(q))
    _equal(got, jlk.map_ids(q))


def test_inputs_the_kernels_do_not_take_go_to_numpy(numpy_path):
    """A non-contiguous view, a pad value past int32, float values and
    uint64 ids take the numpy path (the counters stay 0) and give what JAX
    gives, without raising."""
    rng = np.random.default_rng(6)
    base = _values(rng, 400, np.int32)
    view = base[::2]
    assert not view.flags.c_contiguous
    lengths = np.full(20, 10)
    r, jr = Ragged(view, np.arange(21) * 10), JRagged(view, np.arange(21) * 10)
    _ragged_equal(r.take_rows([3, 1, 3]), jr.take_rows([3, 1, 3]))
    _ragged_equal(r.tail(4), jr.tail(4))
    for align in ("right", "left"):
        for x, y in zip(r.to_padded(6, align=align), jr.to_padded(6, align=align)):
            _equal(x, y)
    rc = Ragged.from_lengths(base[:200].copy(), lengths)
    for x, y in zip(rc.to_padded(6, pad_value=2**40), JRagged.from_lengths(
            base[:200].copy(), lengths).to_padded(6, pad_value=2**40)):
        _equal(x, y)
    rf = Ragged.from_lengths(base[:200].astype(np.float64), lengths)
    _equal(rf.isin_per_row(rf).astype(np.int8), np.ones(200, np.int8))
    ids = np.arange(1, 100, dtype=np.uint64)
    lk = Lookup.from_values(ids, np.zeros((99, 1)))
    _equal(lk.map_ids(np.array([5, 500], np.uint64)), np.array([5, 0], np.int32))
    assert sum(native.counters().values()) == 0


def test_take_rows_out_of_range_raises_before_the_native_gather(numpy_path):
    r = Ragged.from_lengths(np.arange(10, dtype=np.int32), np.array([4, 0, 6]))
    for bad in ([0, 3], [-1], [1, 2, 99]):
        with pytest.raises(IndexError, match="out of range"):
            r.take_rows(bad)
    assert native.counters()["gather_ranges"] == 0


def test_a_failed_build_raises_with_the_compiler_output(numpy_path, monkeypatch, tmp_path):
    """No silent fallback: a compiler that is missing, or that refuses the
    source, raises; the opt-out still takes the numpy path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    r = Ragged.from_lengths(np.arange(10, dtype=np.int32), np.array([4, 0, 6]))
    with pytest.raises(RuntimeError, match="no-such-g"):
        r.take_rows([2, 0])
    bad_src = tmp_path / "broken.cc"
    bad_src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SRC", bad_src)
    with pytest.raises(RuntimeError, match="error"):
        native.lib()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))
    with numpy_path():
        _ragged_equal(r.take_rows([2, 0]), Ragged.from_lengths(
            np.array([4, 5, 6, 7, 8, 9, 0, 1, 2, 3], np.int32), np.array([6, 4])))
    assert sum(native.counters().values()) == 0


def test_the_build_lands_in_build_under_a_hashed_name(numpy_path, monkeypatch, tmp_path):
    """A fresh build directory gets one library named by the source and
    flags' hash, and no temporary is left behind."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    so = native.build()
    assert so.parent == tmp_path and so.name.startswith("ragged_kernels-")
    assert [p.name for p in tmp_path.iterdir()] == [so.name]
    assert native.build() == so  # built once
    entry = re.compile(r"^void (\w+)\(", re.M)
    jax_src = native.SRC.parents[2] / "ebnerd_tpu" / "native" / "ragged_kernels.cc"
    assert native.SRC != jax_src  # the port's own copy, with JAX's entry points
    assert entry.findall(native.SRC.read_text()) == entry.findall(jax_src.read_text()) == [
        "gather_ranges_i32", "gather_ranges_i64", "gather_ranges_f32", "to_padded_i32",
        "map_ids_i64", "isin_per_row_i64"]


def test_threads_calling_at_once_get_the_numpy_bits(numpy_path):
    """ctypes drops the GIL during a call (the trainer's prefetch thread
    calls these beside the main thread): every thread's output stays
    bit-equal to the numpy path's."""
    rng = np.random.default_rng(7)
    lengths = _lengths(rng, 2_000, 30)
    r = Ragged.from_lengths(_values(rng, int(lengths.sum()), np.int64), lengths)
    rows = rng.integers(0, len(r), 5_000)
    with numpy_path():
        ref = r.take_rows(rows)
    results, errors = [], []

    def work():
        try:
            for _ in range(20):
                results.append(r.take_rows(rows))
        except Exception as e:  # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 80
    for got in results:
        _ragged_equal(got, ref)
    assert native.counters()["gather_ranges"] == 80
