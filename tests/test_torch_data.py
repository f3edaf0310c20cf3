"""The port's data library (``ray_tpu_torch.data``) against
``ray_tpu.data``.

Every operation of ``tests/test_data.py`` runs as one scenario through both
packages on the same seeded numpy inputs, and the two results must be
equal in value and dtype (``canon``):

- on the driver-local path, with no runtime in either package (the
  branches under ``not is_initialized()``);
- on the distributed path: the port under ``ray_tpu_torch.init(num_cpus=2)``
  against JAX under ``ray_tpu.init(num_cpus=2)``, one module-scoped
  fixture each, every stage a task.  Results are compared in order: every
  scenario consumes its plan through an ordered path (``take_all``,
  ``_blocks``, ``execute``, a seeded ``iter_batches``), where two JAX runs
  agree, except those that iterate unseeded ``iter_batches``, which yield
  blocks as they finish; those compare as multisets (``rows_multiset``).

Then files each package wrote read by the other (parquet, CSV, JSON,
TFRecord, binary, images), ``block_format="arrow"``, and
``import ray_tpu_torch.data`` with pyarrow hidden.

The functions the stages run are defined at the top level of this module:
the port's tasks import them by reference (this file imports neither
torch nor JAX at the top, since every worker imports it).
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu_torch as rtt
from ray_tpu_torch import data as td

# -- stage functions (module level: the port ships them by reference) --------


def double_id(b):
    return {"id": b["id"] * 2}


def plus_one(b):
    return {"id": b["id"] + 1}


def times_ten(b):
    return {"id": b["id"] * 10}


def reverse_x(b):
    return {"x": 99 - b["id"]}


def row_sq(r):
    return {"id": r["id"], "sq": int(r["id"]) ** 2}


def even_sq(r):
    return r["sq"] % 2 == 0


def flat_two(r):
    return [{"v": r["item"]}, {"v": r["item"] * 100}]


def centered(b):
    return {"k": b["k"], "v": b["v"] - b["v"].mean()}


def double_kv(b):
    return {"k": b["k"], "v": b["v"] * 2}


def block_module(b):
    return {"mod": np.array([type(b).__module__.split(".")[0]])}


def scaled_image(b):
    return {"image": b["image"].astype(np.float32) / 255.0,
            "path": b["path"]}


def basename(b):
    return {"name": np.asarray([os.path.basename(p) for p in b["path"]],
                               object),
            "bytes": b["bytes"]}


# -- comparison ----------------------------------------------------------------


def canon(x):
    """A comparable form that keeps dtypes, shapes and key order."""
    if isinstance(x, dict):
        return ("dict", [(k, canon(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [canon(v) for v in x])
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, canon(x.tolist())
                if x.dtype == object else x.tolist())
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.item())
    mod = type(x).__module__
    if mod.startswith("pyarrow"):
        return ("pa", str(x.schema), canon(x.to_pydict()))
    if mod.startswith("pandas"):
        return ("pd", list(x.columns), [str(t) for t in x.dtypes],
                canon(x.to_dict("list")))
    return x


def rows_multiset(batches, key):
    """Rows of a list of numpy batches, sorted by ``key``."""
    cols = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    order = np.argsort(cols[key], kind="stable")
    return {k: v[order] for k, v in cols.items()}


# -- scenarios: (rd, ctx) -> what it observed ----------------------------------
# ``rd`` is ray_tpu.data or ray_tpu_torch.data; ``ctx.pkg`` the package,
# ``ctx.dist`` whether a runtime is up, ``ctx.tmp`` a directory of its own.


def _values(n=500, seed=0):
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


def sc_range_count(rd, ctx):
    return rd.range(100, parallelism=4).count()


def sc_from_items_take(rd, ctx):
    return rd.from_items([{"a": i} for i in range(10)], parallelism=3
                         ).take(5)


def sc_map_batches(rd, ctx):
    return rd.range(10, parallelism=2).map_batches(double_id).take_all()


def sc_map_and_filter(rd, ctx):
    return rd.range(20, parallelism=2).map(row_sq).filter(even_sq
                                                          ).take_all()


def sc_fused_stage_chain(rd, ctx):
    return (rd.range(12, parallelism=3).map_batches(plus_one)
            .map_batches(times_ten).take_all())


def sc_flat_map(rd, ctx):
    return rd.from_items([1, 2], parallelism=1).flat_map(flat_two
                                                         ).take_all()


def sc_repartition(rd, ctx):
    ds = rd.range(999, parallelism=3).repartition(5).materialize()
    return ds.num_blocks(), ds.count(), ds._blocks()


def sc_random_shuffle(rd, ctx):
    a = rd.range(1000, parallelism=4).random_shuffle(seed=3).take_all()
    c = rd.range(1000, parallelism=4).random_shuffle(seed=4).take_all()
    return a, [r["id"] for r in a] != [r["id"] for r in c]


def sc_shuffle_after_map_fuses(rd, ctx):
    return (rd.range(500, parallelism=4).map_batches(double_id)
            .random_shuffle(seed=1)._blocks())


def sc_schema(rd, ctx):
    return rd.from_numpy({"x": np.zeros((5, 3), np.float32),
                          "y": np.arange(5)}).schema()


def sc_split(rd, ctx):
    shards = rd.range(90, parallelism=4).split(3)
    return [s.count() for s in shards], [s.take_all() for s in shards]


def sc_iter_batches(rd, ctx):
    ds = rd.range(70, parallelism=4)
    seeded = list(ds.iter_batches(batch_size=16, shuffle_seed=3))
    out = {"seeded": seeded}
    for drop in (False, True):
        got = list(ds.iter_batches(batch_size=16, drop_last=drop))
        out[f"sizes_drop{drop}"] = sorted(len(b["id"]) for b in got)
        out[f"rows_drop{drop}"] = rows_multiset(got, "id") if drop is False \
            else len(got)
    return out


def sc_sort(rd, ctx):
    vals = _values()
    asc = rd.from_numpy({"x": vals}, parallelism=6).sort("x")._blocks()
    desc = rd.from_numpy({"x": vals, "y": vals * 0.5}, parallelism=6
                         ).sort("x", descending=True)._blocks()
    return asc, desc


def sc_sort_after_map(rd, ctx):
    return (rd.range(100, parallelism=4).map_batches(reverse_x)
            .sort("x")._blocks())


def sc_groupby_aggregates(rd, ctx):
    n = 300
    ds = rd.from_numpy({"k": np.arange(n) % 7,
                        "v": np.random.default_rng(1).normal(size=n)},
                       parallelism=5)
    return ds.groupby("k").aggregate(
        total=("v", "sum"), n=("v", "count"), avg=("v", "mean"),
        lo=("v", "min"), hi=("v", "max"), sd=("v", "std")).take_all()


def sc_groupby_conveniences(rd, ctx):
    ds = rd.from_items(
        [{"k": "a", "v": 1.0}, {"k": "b", "v": 2.0}, {"k": "a", "v": 3.0},
         {"k": "b", "v": 4.0}, {"k": "c", "v": 5.0}], parallelism=3)
    g = ds.groupby("k")
    return [g.count().take_all(), g.sum("v").take_all(),
            g.mean("v").take_all(), g.min("v").take_all(),
            g.max("v").take_all(), g.std("v").take_all()]


def sc_map_groups(rd, ctx):
    ds = rd.from_numpy({"k": np.arange(40) % 3,
                        "v": np.arange(40, dtype=np.float64)},
                       parallelism=4)
    return ds.groupby("k").map_groups(centered)._blocks()


def sc_column_ops_and_unique(rd, ctx):
    ds = rd.from_numpy({"a": np.arange(20), "b": np.arange(20) % 4,
                        "c": np.ones(20)}, parallelism=3)
    out = [ds.select_columns(["a", "b"]).take(3),
           ds.drop_columns(["c"]).take(3),
           ds.rename_columns({"a": "x"}).take(3),
           ds.add_column("d", x_times_3_of_a).take(3), ds.unique("b")]
    with pytest.raises(Exception, match="duplicate target") as ei:
        ds.rename_columns({"a": "b"}).take(1)
    return out, "duplicate target columns ['b']" in str(ei.value)


def x_times_3_of_a(b):
    return b["a"] * 3


def sc_limit_and_union(rd, ctx):
    a = rd.range(50, parallelism=4)
    b = rd.range(10, parallelism=2)
    return a.limit(7).take_all(), a.union(b).count(), \
        a.union(b)._blocks()


def sc_from_numpy_pandas(rd, ctx):
    import pandas as pd
    cols = {"x": np.arange(11, dtype=np.int32),
            "y": np.linspace(0, 1, 11)}
    return (rd.from_numpy(cols, parallelism=3)._blocks(),
            rd.from_pandas(pd.DataFrame(cols), parallelism=2)._blocks(),
            rd.from_numpy(cols, parallelism=3).to_pandas())


def sc_arrow_interop(rd, ctx):
    import pyarrow as pa
    t = pa.table({"a": np.arange(100), "b": np.arange(100) * 2.0})
    rows = rd.from_arrow(t, parallelism=4).take_all()
    two = rd.from_arrow([pa.table({"x": [1, 2]}),
                         pa.table({"x": [3]})]).take_all()
    refs = rd.range(50, parallelism=5).map_batches(plus_one
                                                   ).to_arrow_refs()
    tables = ctx.pkg.get(refs, timeout=120) if ctx.dist else refs
    return rows, two, tables


def sc_iter_batches_formats(rd, ctx):
    ds = rd.range(40, parallelism=2)
    arrow = list(ds.iter_batches(batch_size=10, batch_format="pyarrow",
                                 shuffle_seed=0))
    pdf = list(ds.iter_batches(batch_size=10, batch_format="pandas",
                               shuffle_seed=0))
    return arrow, pdf


def sc_binary_files(rd, ctx):
    d = os.path.join(ctx.tmp, "bin")
    os.makedirs(d)
    for i in range(5):
        with open(os.path.join(d, f"f{i}.bin"), "wb") as f:
            f.write(bytes([i]) * (i + 1))
    return rd.read_binary_files(d).map_batches(basename).take_all()


def sc_images(rd, ctx):
    from PIL import Image
    d = os.path.join(ctx.tmp, "img")
    os.makedirs(d)
    for i in range(6):
        Image.fromarray(np.full((12, 10, 3), i * 10, np.uint8)).save(
            os.path.join(d, f"img{i}.png"))
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("ignored")
    ds = rd.read_images(d, size=(6, 5), mode="RGB").map_batches(
        scaled_image)
    return [b["image"] for b in ds.iter_batches(batch_size=4,
                                                shuffle_seed=0)]


def sc_tfrecord(rd, ctx):
    cols = {"idx": np.arange(50, dtype=np.int64),
            "score": np.linspace(0, 1, 50).astype(np.float32),
            "name": np.asarray([f"row-{i}" for i in range(50)], object)}
    out = os.path.join(ctx.tmp, "records")
    rd.from_numpy(cols, parallelism=3).write_tfrecord(out)
    return rd.read_tfrecord(out, verify_crc=True).take_all()


def sc_arrow_blocks(rd, ctx):
    import pyarrow as pa
    import pyarrow.parquet as pq
    fmt = ctx.data_context(rd)
    old, fmt.block_format = fmt.block_format, "arrow"
    try:
        pq.write_table(pa.table({"k": np.repeat([0, 1], 50),
                                 "v": np.arange(100, dtype=np.float64)}),
                       os.path.join(ctx.tmp, "c.parquet"))
        ds = rd.read_parquet(os.path.join(ctx.tmp, "c.parquet"))
        batches = list(ds.iter_batches(batch_size=30, shuffle_seed=1,
                                       batch_format="pyarrow"))
        means = ds.map_batches(double_kv).groupby("k").mean("v").take_all()
        mods = ds.map_batches(block_module, batch_format="block").take_all()
        cols = ds.add_column("z", kv_sum).rename_columns(
            {"v": "w"}).drop_columns(["w"]).take(3)
    finally:
        fmt.block_format = old
    return batches, means, mods, cols


def kv_sum(b):
    return b["k"] + b["v"]


SCENARIOS = [sc_range_count, sc_from_items_take, sc_map_batches,
             sc_map_and_filter, sc_fused_stage_chain, sc_flat_map,
             sc_repartition, sc_random_shuffle, sc_shuffle_after_map_fuses,
             sc_schema, sc_split, sc_iter_batches, sc_sort,
             sc_sort_after_map, sc_groupby_aggregates,
             sc_groupby_conveniences, sc_map_groups,
             sc_column_ops_and_unique, sc_limit_and_union,
             sc_from_numpy_pandas, sc_arrow_interop, sc_iter_batches_formats,
             sc_binary_files, sc_images, sc_tfrecord, sc_arrow_blocks]
IDS = [s.__name__[3:] for s in SCENARIOS]


def _ctx(pkg, dist, tmp):
    def data_context(rd):
        return sys.modules[rd.__name__ + ".context"].DataContext.get()
    return SimpleNamespace(pkg=pkg, dist=dist, tmp=str(tmp),
                           data_context=data_context)


def _both(scenario, tmp_path, dist):
    import ray_tpu
    import ray_tpu.data as jd
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = scenario(jd, _ctx(ray_tpu, dist, tmp_path / "jax"))
    got = scenario(td, _ctx(rtt, dist, tmp_path / "port"))
    assert canon(got) == canon(want)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_driver_local_matches_jax(scenario, tmp_path):
    import ray_tpu
    assert not ray_tpu.is_initialized() and not rtt.is_initialized()
    _both(scenario, tmp_path, dist=False)


def test_writers_and_readers_round_trip_across_packages(tmp_path):
    """Parquet, CSV, JSON and TFRecord files written by each package and
    read by the other give the same rows."""
    import ray_tpu.data as jd
    cols = {"x": np.arange(40), "y": np.arange(40) * 2.0}
    seen = {}
    for name, rd in (("jax", jd), ("port", td)):
        ds = rd.from_numpy(cols, parallelism=3)
        base = tmp_path / name
        files = {"parquet": ds.write_parquet(str(base / "pq")),
                 "csv": ds.write_csv(str(base / "csv")),
                 "json": ds.write_json(str(base / "js")),
                 "tfrecord": ds.write_tfrecord(str(base / "tf"))}
        assert [len(v) for v in files.values()] == [3, 3, 3, 3]
        seen[name] = files
    for writer in ("jax", "port"):
        base = tmp_path / writer
        for rd in (jd, td):
            got = (rd.read_parquet(str(base / "pq" / "*.parquet")).take_all(),
                   rd.read_csv(str(base / "csv" / "*.csv")).take_all(),
                   rd.read_tfrecord(str(base / "tf")).take_all())
            seen[(writer, rd.__name__)] = canon(got)
        rows = []
        for f in sorted(glob.glob(str(base / "js" / "*.json"))):
            with open(f) as fh:
                rows += [json.loads(line) for line in fh if line.strip()]
        seen[(writer, "json")] = rows
    ref = seen[("jax", "ray_tpu.data")]
    for key in (("jax", "ray_tpu_torch.data"), ("port", "ray_tpu.data"),
                ("port", "ray_tpu_torch.data")):
        assert seen[key] == ref, key
    assert seen[("port", "json")] == seen[("jax", "json")]
    assert [r["x"] for r in seen[("port", "json")]] == list(range(40))


def test_data_imports_without_pyarrow_or_torch():
    """``import ray_tpu_torch.data`` with pyarrow hidden: numpy pipelines
    run, and neither pyarrow nor torch is imported."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        "import ray_tpu_torch.data as rd\n"
        "ds = rd.from_numpy({'x': np.arange(10)}, parallelism=3)\n"
        "ds = ds.random_shuffle(seed=0).sort('x')\n"
        "assert [int(r['x']) for r in ds.take_all()] == list(range(10))\n"
        "assert sys.modules['pyarrow'] is None\n"
        "assert 'torch' not in sys.modules\n"
        "try:\n"
        "    rd.read_parquet('missing.parquet').take_all()\n"
        "except ImportError:\n"
        "    print('parquet needs pyarrow')\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "parquet needs pyarrow" in out.stdout


def test_backpressure_window_adapts_to_block_size():
    """JAX's ``TestBackpressure.test_window_adapts_to_block_size`` on both
    packages' ``_OpBackpressure``."""
    from ray_tpu.data import executor as jex
    from ray_tpu_torch.data import executor as tex
    for ex, ctx_mod in ((jex, "ray_tpu.data.context"),
                        (tex, "ray_tpu_torch.data.context")):
        ctx = sys.modules[ctx_mod].DataContext.get()
        bp = ex._OpBackpressure()
        assert bp.window() == ctx.initial_in_flight
        bp._ema = float(ctx.op_memory_budget_bytes)
        assert bp.window() == ctx.min_in_flight
        bp._ema = 1024.0
        assert bp.window() == ctx.max_in_flight


# -- the distributed path --------------------------------------------------------


@pytest.fixture(scope="module")
def sessions():
    import ray_tpu
    ray_tpu.init(num_cpus=2)
    port = rtt.init(num_cpus=2)
    yield port
    rtt.shutdown()
    ray_tpu.shutdown()


@pytest.mark.parametrize("scenario", SCENARIOS, ids=IDS)
def test_distributed_matches_jax(scenario, sessions, tmp_path):
    _both(scenario, tmp_path, dist=True)


def test_distributed_stages_run_as_tasks(sessions):
    """The shuffle's outputs are refs made by reduce tasks; its map parts
    are freed once the merges that read them have run; the workers'
    data metrics reach the driver under JAX's names."""
    from ray_tpu_torch import _tasks
    from ray_tpu_torch.data import executor
    from ray_tpu_torch.util import telemetry

    before = _tasks.stats().get("tasks_run", 0)
    ds = td.range(4000, parallelism=8).map_batches(plus_one
                                                   ).random_shuffle(7)
    out = executor.execute(ds)
    assert all(isinstance(b, rtt.ObjectRef) for b in out)
    rows = np.concatenate([rtt.get(b)["id"] for b in out])
    assert sorted(rows.tolist()) == list(range(1, 4001))
    # 8 map tasks (read + map + split fused) and 8 merges.
    assert _tasks.stats()["tasks_run"] - before == 16
    # Only the 8 merged blocks hold segments: the 64 parts went once
    # their merges ran.
    held = {b._fut.result()[1] for b in out if b._fut.result()[0] == "shm"}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        live = {os.path.basename(p) for p in _tasks.session_segments()}
        if live <= held:
            break
        time.sleep(0.05)
    assert live <= held
    ops = {dict(k)["operator"] for k in
           telemetry.samples("ray_tpu_data_rows_total")}
    assert {"map", "reduce"} <= ops


def test_distributed_limit_stops_early_and_frees_blocks(sessions):
    """``limit`` stops the stream after the first block; the tasks still
    in flight run to their end, and each result is freed as it
    arrives."""
    from ray_tpu_torch import _tasks
    before = _tasks.stats()
    ds = td.range(400_000, parallelism=16).map_batches(double_id)
    assert [int(r["id"]) for r in ds.limit(5).take_all()] == \
        [0, 2, 4, 6, 8]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        now = _tasks.stats()
        if now["tasks_run"] - before.get("tasks_run", 0) == \
                now["tasks_submitted"] - before["tasks_submitted"]:
            break
        time.sleep(0.02)
    assert now["tasks_submitted"] - before["tasks_submitted"] < 16
    assert _tasks.session_segments() == []


def test_distributed_lambda_refused_by_name(sessions):
    """A lambda stage cannot reach a worker: the run raises naming the
    by-reference rule (driver-local, any callable runs)."""
    ds = td.range(10, parallelism=2).map_batches(lambda b: b)
    with pytest.raises(ValueError, match="top level of a module"):
        ds.take_all()
