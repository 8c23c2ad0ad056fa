"""The port's package boundary and device rule.

``spark_tpu_torch`` (and ``chip_smoke.py``) import neither ``jax`` nor any
``spark_tpu`` module, and running the slice loads none. The session runs
on the card unless the caller asks for the CPU: the default device
raises without CUDA instead of falling back.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import sys
import spark_tpu_torch
from spark_tpu_torch.api.session import SparkSession
from spark_tpu_torch.tpch import Q1_WIDE, QUERIES, generate_tables, register_views

spark = SparkSession.builder.device("cpu").getOrCreate()
register_views(spark, generate_tables(0.002, seed=1))
for q in (QUERIES[1], Q1_WIDE):
    assert spark.sql(q).collect()
import spark_tpu_torch.graph, spark_tpu_torch.ml, spark_tpu_torch.pandas
import spark_tpu_torch.rdd
from spark_tpu_torch.ml.state import model_from_state  # noqa: F401
df = spark.createDataFrame([{"a": float(i), "b": float(i % 3), "y": float(i % 2)}
                            for i in range(40)])
tree = spark_tpu_torch.ml.DecisionTreeClassifier(["a", "b"], "y", maxDepth=2)
assert tree.fit(df).transform(df).count() == 40
g = spark_tpu_torch.graph.Graph([1, 2, 3], [1, 2], [2, 3], device="cpu")
assert g.pagerank(3).shape == (3,)
assert len(spark_tpu_torch.pandas.from_pandas(
    spark.range(5).toPandas())) == 5
assert spark.range(4).rdd.map(lambda r: r["id"]).sum() == 6
import chip_smoke  # noqa: F401  (module import only: no card here)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "spark_tpu" or m.startswith("spark_tpu."))
print("LOADED", bad)
"""


def test_slice_loads_no_jax_and_no_reference_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_or_reference():
    files = sorted((REPO / "spark_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "spark_tpu"), (path, mod)


def test_default_device_raises_without_cuda(monkeypatch):
    from spark_tpu_torch.api.session import SparkSession
    from spark_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SparkSession.builder.getOrCreate()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert SparkSession.builder.device("cpu").getOrCreate().device.type \
        == "cpu"


def test_kernel_wrappers_refuse_to_fall_back(monkeypatch):
    """On a CUDA tensor the wrapper launches its kernel or raises: with
    the build failing, the call raises instead of taking the plain
    version."""
    from spark_tpu_torch.ops import _build, seg_agg

    class FakeCuda:
        type = "cuda"

    class FakeTensor:
        device = FakeCuda()
        dtype = torch.int32
        shape = (4,)

        def dim(self):
            return 1

        def is_contiguous(self):
            return True

    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", no_nvcc)
    seg = FakeTensor()
    mask = FakeTensor()
    mask.dtype = torch.bool
    with pytest.raises(RuntimeError, match="nvcc"):
        seg_agg.seg_sum(None, seg, mask, 100, exact_int=True)


def test_other_entry_points_default_to_cuda(monkeypatch):
    """Every public entry point that places tensors takes the session's
    rule: the card by default, a raise without it."""
    from spark_tpu_torch.graph import Graph
    from spark_tpu_torch.sketch import CountMinSketch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Graph([1, 2], [1], [2])
    with pytest.raises(RuntimeError, match="cuda"):
        CountMinSketch()
    assert Graph([1, 2], [1], [2], device="cpu").device.type == "cpu"


def test_perf_kernel_table_rows_have_bound_and_library_time():
    """Each TPU kernel's row in PERF.md's table names its bound and the
    library call's time."""
    text = (REPO / "PERF.md").read_text()
    after = text[text.index("### Every TPU kernel of the repo"):]
    start = after.index("\n| ") + 1
    lines = after[start:after.index("\n\n", start)].splitlines()
    head = [c.strip() for c in lines[0].strip("|").split("|")]
    rows = [[c.strip() for c in ln.strip("|").split("|")]
            for ln in lines[2:] if ln.startswith(("| B1 ", "| B2 "))]
    assert {r[0] for r in rows} == {"B1", "B2"}
    bound = head.index("Bound ms")
    library = head.index("Library ms")
    for r in rows:
        assert len(r) == len(head), r[:4]
        assert r[bound][:1].isdigit(), (r[:4], r[bound])
        assert r[library][:1].isdigit(), (r[:4], r[library])
