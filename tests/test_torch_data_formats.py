"""The port's data formats and data-library depth (``ray_tpu_torch.data``:
tensor columns, images, TFRecord, stats, parquet, CSV and JSON) on its
in-process runtime (``init()``), held to the JAX package.

- *Counterparts* of the 9 tests of ``tests/test_data_depth.py``. Each
  program takes a data package and a scratch directory and returns plain
  values; the JAX programs run once per test run on the JAX package's
  in-process runtime (``init(local_mode=True)``; ``_once``: the xdist
  workers share one pickle), and each test runs its program on the port
  and compares rows, shapes, dtypes, decoded records and the stats' fields.
- *Files across packages.* CSV, JSON, parquet (with a tensor column) and
  TFRecord files written by either package are read by both, with equal
  columns, dtypes and values (each package's numpy batch of the file).
- *The port's block.* Its deliberate differences from the pyarrow block
  (ROADMAP.md C): ``schema()``, ``to_rows()``'s cells and ``size_bytes``
  on text, each beside what the JAX block gives.
"""

import fcntl
import importlib
import os
import pickle

import numpy as np
import pytest

import ray_tpu_torch as rt

# ---------------------------------------------------------------------------
# data functions and helpers
# ---------------------------------------------------------------------------


def image_times_two(b):
    return {"image": b["image"] * 2.0}


def id_times_two(b):
    return {"id": b["id"] * 2}


def id_mod_4(r):
    return r["id"] % 4 == 0


def identity_row(r):
    return r


def _cell(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return np.asarray(v).ravel().tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def plain_rows(rows):
    return [{k: _cell(v) for k, v in r.items()} for r in rows]


def _module(d, name):
    return importlib.import_module(f"{d.__name__}.{name}")


def _stats_fields(summary):
    """(operator, tasks, blocks out) of each operator line, and whether
    the wall and latency fields are there."""
    import re
    ops = [(m.group(1), int(m.group(2)), int(m.group(3))) for m in
           re.finditer(r"Operator (\S+): (\d+) tasks, (\d+) blocks out",
                       summary)]
    return {"ops": ops, "wall": "wall" in summary,
            "latency": "task latency" in summary,
            "total": "Total (sum of operator walls)" in summary}


# ---------------------------------------------------------------------------
# the programs (tests/test_data_depth.py)
# ---------------------------------------------------------------------------


def prog_tensor_extension_ops(d, root):
    block_mod = _module(d, "block")
    imgs = np.arange(3 * 4 * 5 * 3, dtype=np.float32).reshape(3, 4, 5, 3)
    b = block_mod.block_from_numpy({"image": imgs,
                                    "label": np.array([0, 1, 2])})
    acc = block_mod.BlockAccessor
    out = acc(b).to_numpy()
    s = acc(acc(b).slice(1, 3)).to_numpy()["image"]
    c = acc(acc.concat([b, b])).to_numpy()["image"]
    return {"shape": list(out["image"].shape),
            "equal": bool(np.array_equal(out["image"], imgs)),
            "view": out["image"].base is not None,
            "slice": s.ravel().tolist(), "slice_shape": list(s.shape),
            "concat_equal": bool(np.array_equal(
                c, np.concatenate([imgs, imgs])))}


def prog_tensor_extension_survives_object_plane(d, root):
    imgs = np.random.default_rng(0).normal(
        size=(4, 8, 8, 3)).astype(np.float32)
    got = d.from_numpy(imgs, column="image").map_batches(image_times_two) \
        .take_all()
    batches = list(d.from_numpy(imgs, column="image")
                   .iter_batches(batch_size=2))
    return {"rows": plain_rows(got),
            "batch_shapes": [list(b["image"].shape) for b in batches]}


def _write_images(root, shapes):
    from PIL import Image
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for i, shape in enumerate(shapes):
        arr = rng.integers(0, 255, shape, dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"img{i}.png"))


def prog_read_images(d, root):
    _write_images(root, [(10 + i, 12, 3) for i in range(6)])
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not an image")
    ds = d.read_images(root, size=(8, 8))
    rows = ds.take_all()
    batch = next(iter(ds.iter_batches(batch_size=6)))
    native = d.read_images(root).take_all()
    return {"n": len(rows),
            "images": [_cell(r["image"]) for r in rows],
            "paths": [os.path.basename(r["path"]) for r in rows],
            "batch_shape": list(batch["image"].shape),
            "batch_dtype": str(batch["image"].dtype),
            "heights": sorted(r["height"] for r in native),
            "widths": sorted(r["width"] for r in native)}


def prog_read_images_non_square_size(d, root):
    from PIL import Image
    os.makedirs(root, exist_ok=True)
    Image.fromarray(np.zeros((10, 20, 3), dtype=np.uint8)).save(
        os.path.join(root, "wide.png"))
    ds = d.read_images(root, size=(16, 6))
    rows = ds.take_all()
    batch = next(iter(ds.iter_batches(batch_size=1)))
    return {"n": len(rows), "height": rows[0]["height"],
            "width": rows[0]["width"],
            "batch_shape": list(batch["image"].shape)}


def _decoded(ex):
    return {k: (v if isinstance(v, list) else
                (str(v.dtype), v.tolist())) for k, v in ex.items()}


def prog_tfrecord_codec_roundtrip(d, root):
    tf = _module(d, "tfrecord")
    recs = [
        {"name": b"alpha", "score": np.asarray([1.5, 2.5], np.float32),
         "count": np.asarray([7], np.int64)},
        {"name": b"beta", "score": np.asarray([-0.5], np.float32),
         "count": np.asarray([-3, 9], np.int64)},
    ]
    path = os.path.join(root, "x.tfrecords")
    encoded = [tf.encode_example(r) for r in recs]
    tf.write_tfrecord_frames(path, encoded)
    back = [tf.decode_example(f) for f in
            tf.read_tfrecord_frames(path, verify_crc=True)]
    with open(path, "rb") as f:
        raw = f.read()
    return {"decoded": [_decoded(ex) for ex in back], "file": raw}


def prog_tfrecord_decoder_against_spec_golden(d, root):
    tf = _module(d, "tfrecord")
    golden = bytes([0x0A, 0x10, 0x0A, 0x0E, 0x0A, 0x05]) + b"label" + \
        bytes([0x12, 0x05, 0x1A, 0x03, 0x0A, 0x01, 0x05])
    unpacked = bytes([0x0A, 0x0F, 0x0A, 0x0D, 0x0A, 0x05]) + b"label" + \
        bytes([0x12, 0x04, 0x1A, 0x02, 0x08, 0x05])
    return [_decoded(tf.decode_example(golden)),
            _decoded(tf.decode_example(unpacked))]


def prog_read_write_tfrecords_dataset(d, root):
    ds = d.from_items([{"uid": i, "w": float(i) / 2} for i in range(20)])
    out = os.path.join(root, "recs")
    d.write_tfrecords(ds, out)
    rows = d.read_tfrecords(out).take_all()
    return {"files": sorted(os.listdir(out)),
            "rows": plain_rows(rows)}


def prog_dataset_stats(d, root):
    ds = d.range(1000, parallelism=4).map_batches(id_times_two) \
        .filter(id_mod_4)
    ds.materialize()
    return {"stats": _stats_fields(ds.stats()), "count": ds.count()}


def prog_dataset_stats_executes_if_needed(d, root):
    ds = d.range(100, parallelism=2).map(identity_row)
    return _stats_fields(ds.stats())


PROGRAMS = {name[len("prog_"):]: fn for name, fn in sorted(globals().items())
            if name.startswith("prog_")}


# ---------------------------------------------------------------------------
# running them
# ---------------------------------------------------------------------------


def _run_all(d, root):
    out = {}
    for name, prog in PROGRAMS.items():
        where = os.path.join(root, name)
        os.makedirs(where, exist_ok=True)
        try:
            out[name] = ("value", prog(d, where))
        except Exception as e:  # noqa: BLE001
            out[name] = ("raised", type(e).__name__, str(e)[:300])
    return out


def _jax_run(root):
    import ray_tpu

    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    try:
        return _run_all(importlib.import_module("ray_tpu.data"), root)
    finally:
        ray_tpu.shutdown()


def _once(tmp_path_factory, name, compute):
    """``compute(dir)`` once for the whole run, its result shared by the
    xdist workers through a pickle under the run's temporary root (a file
    lock lets one compute while the others wait)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute(str(tmp_path_factory.mktemp(name)))
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _once(tmp_path_factory, "torch_data_formats_jax", _jax_run)


@pytest.fixture(scope="module")
def port_rt(jax_runs):
    import ray_tpu.data  # noqa: F401 - the JAX tensor type registers first
    rt.shutdown()
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


def _both(jax_runs, name, tmp_path):
    """(the port's value, the JAX value) of one program."""
    want = jax_runs[name]
    assert want[0] == "value", f"the JAX runtime raised: {want}"
    import ray_tpu_torch.data as d
    return PROGRAMS[name](d, str(tmp_path)), want[1]


# ---------------------------------------------------------------------------
# tests/test_data_depth.py
# ---------------------------------------------------------------------------


def test_tensor_extension_zero_copy_and_ops(jax_runs, tmp_path):
    got, want = _both(jax_runs, "tensor_extension_ops", tmp_path)
    assert got == want
    assert got["shape"] == [3, 4, 5, 3] and got["equal"] and got["view"]
    assert got["slice_shape"] == [2, 4, 5, 3] and got["concat_equal"]
    from ray_tpu_torch.data.block import BlockAccessor, block_from_numpy
    imgs = np.ones((3, 2, 2), np.float32)
    b = block_from_numpy({"image": imgs})
    assert np.shares_memory(BlockAccessor(b).to_numpy()["image"], imgs)


def test_tensor_extension_survives_object_plane(port_rt, jax_runs, tmp_path):
    got, want = _both(jax_runs, "tensor_extension_survives_object_plane",
                      tmp_path)
    assert got == want
    assert len(got["rows"]) == 4
    assert got["batch_shapes"][0] == [2, 8, 8, 3]


def test_read_images(port_rt, jax_runs, tmp_path):
    got, want = _both(jax_runs, "read_images", tmp_path)
    assert got == want
    assert got["n"] == 6
    # uniform size -> batches stack into one device-feedable tensor
    assert got["batch_shape"] == [6, 8, 8, 3]
    assert got["batch_dtype"] == "uint8"
    # native-size read keeps true dims
    assert got["heights"] == [10, 11, 12, 13, 14, 15]


def test_read_images_non_square_size(port_rt, jax_runs, tmp_path):
    # size follows the (height, width) convention; PIL's resize takes
    # (width, height) — a square-only test can't catch a swap.
    got, want = _both(jax_runs, "read_images_non_square_size", tmp_path)
    assert got == want
    assert got == {"n": 1, "height": 16, "width": 6,
                   "batch_shape": [1, 16, 6, 3]}


def test_tfrecord_codec_roundtrip(jax_runs, tmp_path):
    got, want = _both(jax_runs, "tfrecord_codec_roundtrip", tmp_path)
    assert got == want          # the decoded records and the file's bytes
    back = got["decoded"]
    assert back[0]["name"] == [b"alpha"]
    assert back[0]["score"] == ("float32", [1.5, 2.5])
    assert back[0]["count"] == ("int64", [7])
    assert back[1]["count"] == ("int64", [-3, 9])


def test_tfrecord_decoder_against_spec_golden(jax_runs, tmp_path):
    got, want = _both(jax_runs, "tfrecord_decoder_against_spec_golden",
                      tmp_path)
    assert got == want
    assert got[0]["label"] == ("int64", [5]) == got[1]["label"]


def test_read_write_tfrecords_dataset(port_rt, jax_runs, tmp_path):
    got, want = _both(jax_runs, "read_write_tfrecords_dataset", tmp_path)
    assert got == want
    rows = sorted(got["rows"], key=lambda r: r["uid"])
    assert len(rows) == 20
    assert rows[3]["uid"] == 3
    assert abs(rows[3]["w"] - 1.5) < 1e-6


def test_dataset_stats(port_rt, jax_runs, tmp_path):
    got, want = _both(jax_runs, "dataset_stats", tmp_path)
    assert got == want
    # all 4 blocks flowed through both operators
    assert got["stats"]["ops"] == [("map_batches", 4, 4), ("filter", 4, 4)]
    assert got["stats"]["wall"] and got["count"] == 500


def test_dataset_stats_executes_if_needed(port_rt, jax_runs, tmp_path):
    got, want = _both(jax_runs, "dataset_stats_executes_if_needed", tmp_path)
    assert got == want
    assert got["ops"] == [("map", 2, 2)]


def loop_count_rows():
    from ray_tpu_torch.air import session
    rows = list(session.get_dataset_shard("train").iter_rows())
    session.report({"ids": [r["id"] for r in rows]})


def test_in_process_trainer_takes_a_materialized_lambda_dataset(port_rt,
                                                                tmp_path):
    """On the in-process runtime a data function may be a lambda, but
    ``fit()`` pickles the trainer with its datasets (``trainer.pkl``, by
    import path, as a lambda loop): a plan that still holds the lambda
    raises TypeError naming module level there; once materialized, the
    dataset pickles as its block refs and the one-rank gang reads it."""
    import ray_tpu_torch.data as d
    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)
    ds = d.range(8, parallelism=2).map_batches(lambda b: {"id": b["id"] * 3})

    def fit(name):
        return DataParallelTrainer(
            loop_count_rows, datasets={"train": ds},
            scaling_config=ScalingConfig(use_gpu=False),
            run_config=RunConfig(storage_path=str(tmp_path),
                                 name=name)).fit()

    with pytest.raises(TypeError, match="module level"):
        fit("lazy")
    ds.materialize()
    assert "map_batches" in ds.stats()
    r = fit("materialized")
    assert r.error is None, r.error
    assert r.metrics["ids"] == [3 * i for i in range(8)]


# ---------------------------------------------------------------------------
# files across packages
# ---------------------------------------------------------------------------


def _file_rows(fmt):
    rng = np.random.default_rng(19)
    n = 12
    cols = {"i": np.arange(n, dtype=np.int64) - 3,
            "x": np.arange(n) * 0.5}
    if fmt == "tfrecords":
        cols["b"] = [f"row{i}".encode() for i in range(n)]
    else:
        cols["s"] = [f"row {i} é" for i in range(n)]
        cols["flag"] = [bool(i % 3) for i in range(n)]
    if fmt == "parquet":
        cols["t"] = rng.normal(size=(n, 2, 3)).astype(np.float32)
    return [{k: (v[i] if not isinstance(v, np.ndarray) else
                 (v[i] if v.ndim > 1 else v[i].item()))
             for k, v in cols.items()} for i in range(n)]


def _write(pkg, fmt, rows, path):
    d = importlib.import_module(f"{pkg}.data")
    if pkg == "ray_tpu" and fmt == "parquet":
        # the JAX block takes a tensor column from numpy, not from cells
        from ray_tpu.data.block import block_from_numpy
        cols = {k: np.array([r[k] for r in rows]) for k in rows[0]}
        cols["s"] = np.array([r["s"] for r in rows], dtype=object)
        ds = d.from_arrow(block_from_numpy(cols))
    else:
        ds = d.from_items(rows, parallelism=2)
    if fmt == "tfrecords":
        d.write_tfrecords(ds, path)
    else:
        getattr(ds, f"write_{fmt}")(path)


def _read(pkg, fmt, path):
    """The file as one numpy batch: {column: (dtype, shape, flat values)}."""
    d = importlib.import_module(f"{pkg}.data")
    ds = getattr(d, f"read_{fmt}")(path)
    (batch,) = list(ds.iter_batches(batch_size=1000, batch_format="numpy"))
    return {k: (str(v.dtype), list(v.shape), v.ravel().tolist())
            for k, v in batch.items()}


@pytest.mark.parametrize("writer", ["ray_tpu", "ray_tpu_torch"])
@pytest.mark.parametrize("fmt", ["csv", "json", "parquet", "tfrecords"])
def test_files_across_packages(port_rt, tmp_path, fmt, writer):
    """A file one package writes is read by both with equal columns,
    dtypes and values."""
    import ray_tpu
    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True, num_cpus=4)
    try:
        rows = _file_rows(fmt)
        path = str(tmp_path / fmt)
        _write(writer, fmt, rows, path)
        jax_view = _read("ray_tpu", fmt, path)
        port_view = _read("ray_tpu_torch", fmt, path)
    finally:
        ray_tpu.shutdown()
    assert port_view == jax_view
    assert port_view["i"] == ("int64", [12], list(range(-3, 9)))
    if fmt == "parquet":
        assert port_view["t"][:2] == ("float32", [12, 2, 3])
        np.testing.assert_array_equal(
            np.array(port_view["t"][2]),
            np.stack([r["t"] for r in rows]).ravel())
    if fmt == "tfrecords":
        assert port_view["b"][2] == [r["b"] for r in rows]
    else:
        assert port_view["s"] == ("object", [12], [r["s"] for r in rows])


def test_unregistered_tensor_column_reads_by_its_field_metadata():
    """A process that registered no tensor type reads a tensor column as
    its storage with the extension's field metadata: the port still gives
    the ``(N, *shape)`` array."""
    import pyarrow as pa

    from ray_tpu_torch.data.tensor_ext import block_from_arrow
    values = np.arange(24, dtype=np.float32)
    field = pa.field("t", pa.list_(pa.float32(), 6), metadata={
        b"ARROW:extension:name": b"ray_tpu.tensor",
        b"ARROW:extension:metadata": b'{"shape": [2, 3]}'})
    table = pa.Table.from_arrays(
        [pa.FixedSizeListArray.from_arrays(pa.array(values), 6)],
        schema=pa.schema([field]))
    got = block_from_arrow(table)["t"]
    assert got.shape == (4, 2, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got.ravel(), values)


# ---------------------------------------------------------------------------
# the port's block beside the pyarrow block
# ---------------------------------------------------------------------------


def _blocks(rows):
    """The port's and the JAX package's block of the same rows."""
    from ray_tpu.data.block import block_from_rows as jax_rows
    from ray_tpu_torch.data.block import block_from_rows
    return block_from_rows(rows), jax_rows(rows)


def _port_block(rows):
    from ray_tpu_torch.data.block import block_from_rows
    return block_from_rows(rows)


_ROWS = [{"i": k, "x": k / 4, "s": "é" * k,
          "t": np.full((2, 3), k, np.float32)} for k in range(5)]


def test_schema_maps_names_to_dtype_and_cell_shape():
    """The port's ``schema()`` is ``{name: (dtype, cell shape)}`` where
    the JAX block gives a ``pyarrow.Schema``: the same names in the same
    order, the types JAX's numpy batches have."""
    from ray_tpu.data.block import BlockAccessor as JAcc
    from ray_tpu.data.block import block_from_numpy as jax_numpy
    from ray_tpu_torch.data.block import BlockAccessor
    port = _port_block(_ROWS)
    schema = BlockAccessor(port).schema()
    assert schema == {"i": (np.dtype(np.int64), ()),
                      "x": (np.dtype(np.float64), ()),
                      "s": (np.dtype(object), ()),
                      "t": (np.dtype(np.float32), (2, 3))}
    jax_block = jax_numpy({k: BlockAccessor(port).to_numpy()[k]
                           for k in ("i", "x", "t")})
    jax_np = JAcc(jax_block).to_numpy()
    assert list(JAcc(jax_block).schema().names) == ["i", "x", "t"]
    for k in ("i", "x", "t"):
        assert (jax_np[k].dtype, jax_np[k].shape[1:]) == schema[k]


def test_to_rows_gives_scalars_and_ndarray_cells():
    """0-d cells are Python scalars in both blocks; a tensor cell is an
    ndarray of the cell's shape in the port, a flat list in JAX."""
    from ray_tpu.data.block import BlockAccessor as JAcc
    from ray_tpu.data.block import block_from_numpy as jax_numpy
    from ray_tpu_torch.data.block import BlockAccessor
    port = _port_block(_ROWS)
    rows = BlockAccessor(port).to_rows()
    jax_rows = JAcc(jax_numpy(BlockAccessor(port).to_numpy())).to_rows()
    for r, j in zip(rows, jax_rows):
        assert type(r["i"]) is int and type(r["x"]) is float
        assert type(r["s"]) is str and r["s"] == j["s"]
        assert r["i"] == j["i"] and r["x"] == j["x"]
        assert isinstance(r["t"], np.ndarray) and r["t"].shape == (2, 3)
        assert isinstance(j["t"], list)
        assert r["t"].ravel().tolist() == np.asarray(j["t"]).ravel().tolist()


def test_size_bytes_counts_text_as_arrow_lays_it_out():
    """A text column is an object array in the port; ``size_bytes`` counts
    it as pyarrow lays it out (UTF-8 bytes and 4-byte offsets), so it
    equals the JAX block's ``nbytes`` for these columns; a bool column
    counts a byte a row where Arrow packs bits."""
    from ray_tpu.data.block import BlockAccessor as JAcc
    from ray_tpu_torch.data.block import BlockAccessor
    rows = [{k: r[k] for k in ("i", "x", "s")} for r in _ROWS]
    port, jax_block = _blocks(rows)
    assert BlockAccessor(port).size_bytes() == JAcc(jax_block).size_bytes()
    assert port["s"].dtype == object
    flags, jax_flags = _blocks([{"f": bool(k % 2)} for k in range(64)])
    assert BlockAccessor(flags).size_bytes() == 64
    assert JAcc(jax_flags).size_bytes() == 8
