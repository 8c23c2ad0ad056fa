"""The port's operators (spark_tpu_torch/physical/operators.py) against the
reference's, started from identical batches: the reference batch's host
arrays are carried across with ``from_host_arrays``.

Covers the flagship stage of ``__graft_entry__._example_plan()`` (scan ->
filter -> project -> direct aggregate -> sort), a direct-path aggregate
with 64 < K <= 1024 groups (counts and float32 min/max through the
kernel wrappers), and the sorted aggregate path (an integer key, and a
nullable float32 key holding NaNs).

Tolerances: integers, strings and float32 min/max exact; float64 sums
and averages rel 1e-12 (summation order may differ).
"""

import math

import numpy as np
import pytest

import __graft_entry__
from spark_tpu import types as RT
from spark_tpu.columnar.batch import from_numpy as ref_from_numpy
from spark_tpu.expr import expressions as RE
from spark_tpu.physical import operators as RP
from spark_tpu.physical.planner import execute as ref_execute
from spark_tpu_torch import types as PT
from spark_tpu_torch.columnar.batch import from_host_arrays
from spark_tpu_torch.expr import expressions as PE
from spark_tpu_torch.physical import operators as PP
from spark_tpu_torch.physical.planner import execute as port_execute


def _carry(ref_batch):
    """Port batch holding the reference batch's exact host arrays."""
    schema = PT.Schema(tuple(
        PT.Field(f.name, getattr(PT, type(f.dtype).__name__)()
                 if not isinstance(f.dtype, RT.DecimalType)
                 else PT.DecimalType(f.dtype.precision, f.dtype.scale),
                 f.nullable, f.dictionary)
        for f in ref_batch.schema.fields))
    datas = [np.asarray(cd.data) for cd in ref_batch.data.columns]
    valids = [None if cd.validity is None else np.asarray(cd.validity)
              for cd in ref_batch.data.columns]
    return from_host_arrays(schema, datas, valids,
                            np.asarray(ref_batch.data.row_mask), "cpu")


def _assert_rows(got, want, rel=1e-12):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            a, b = g[k], w[k]
            if isinstance(b, float) and isinstance(a, float) \
                    and not (math.isnan(a) and math.isnan(b)):
                assert a == pytest.approx(b, rel=rel), (k, a, b)
            else:
                assert a == b or (a != a and b != b), (k, a, b)


def _build(M, E, scan, kind):
    """The same plan over module sets (M operators, E expressions)."""
    if kind == "example":
        filt = M.FilterExec(E.Cmp(">", E.Col("k"), E.Literal(10)), scan)
        v2 = E.Alias(E.Arith("*", E.Col("v"), E.Literal(2.0)), "v2")
        proj = M.ProjectExec((E.Col("tag"), v2), filt)
        agg = M.HashAggregateExec(
            (E.Col("tag"),),
            (E.Col("tag"),
             E.Alias(E.Sum(E.Col("v2")), "s"),
             E.Alias(E.Count(None), "n"),
             E.Alias(E.Avg(E.Col("v2")), "a")),
            proj)
        return M.SortExec((E.SortOrder(E.Col("s"), ascending=False),), agg)
    if kind == "wide":
        filt = M.FilterExec(E.Cmp(">", E.Col("k"), E.Literal(3)), scan)
        agg = M.HashAggregateExec(
            (E.Col("tag"), E.Col("flag")),
            (E.Col("tag"), E.Col("flag"),
             E.Alias(E.Count(None), "n"),
             E.Alias(E.Count(E.Col("f")), "nf"),
             E.Alias(E.Min(E.Col("f")), "mn"),
             E.Alias(E.Max(E.Col("f")), "mx"),
             E.Alias(E.Sum(E.Col("k")), "sk")),
            filt)
        return M.SortExec((E.SortOrder(E.Col("tag")),
                           E.SortOrder(E.Col("flag"))), agg)
    if kind == "sorted_nullable":
        # sorted path over a nullable float32 key holding NaNs
        agg = M.HashAggregateExec(
            (E.Col("f"),),
            (E.Col("f"), E.Alias(E.Count(None), "n"),
             E.Alias(E.Max(E.Col("k")), "mk")),
            M.FilterExec(E.Cmp("<", E.Col("k"), E.Literal(3)), scan))
        return M.SortExec((E.SortOrder(E.Col("f")),
                           E.SortOrder(E.Col("mk"))), agg)
    # sorted path: integer grouping key
    agg = M.HashAggregateExec(
        (E.Col("k"),),
        (E.Col("k"), E.Alias(E.Count(None), "n"),
         E.Alias(E.Min(E.Col("f")), "mn"),
         E.Alias(E.Sum(E.Col("v")), "sv")),
        scan)
    return M.SortExec((E.SortOrder(E.Col("k"), ascending=False),), agg)


def _wide_batch():
    """K = 120 dictionary entries x 2 booleans + nulls: 363 packed groups
    (direct path, above MIN_ENGINE_K), nullable float32 with NaNs."""
    rng = np.random.default_rng(11)
    n = 5000
    tags = tuple(f"t{i:03d}" for i in range(120))
    schema = RT.Schema((
        RT.Field("k", RT.INT64, nullable=False),
        RT.Field("v", RT.FLOAT64, nullable=False),
        RT.Field("f", RT.FLOAT32, nullable=True),
        RT.Field("tag", RT.STRING, nullable=True, dictionary=tags),
        RT.Field("flag", RT.BOOLEAN, nullable=False),
    ))
    f = (rng.normal(size=n) * 10).astype(np.float32)
    f[rng.random(n) < 0.001] = np.nan
    return ref_from_numpy(schema, [
        rng.integers(0, 40, n),
        rng.normal(size=n),
        f,
        rng.integers(0, 100, n).astype(np.int32),  # tags >= 100 unused
        rng.random(n) < 0.5,
    ], validities=[None, None, rng.random(n) < 0.9, rng.random(n) < 0.95,
                   None])


@pytest.mark.parametrize("kind", ["example", "wide", "sorted",
                                  "sorted_nullable"])
def test_operator_tree_parity(kind):
    if kind == "example":
        _, ref_batch = __graft_entry__._example_plan()
    else:
        ref_batch = _wide_batch()
    want_plan = _build(RP, RE, RP.BatchScanExec(ref_batch), kind)
    got_plan = _build(PP, PE, PP.BatchScanExec(_carry(ref_batch)), kind)
    want = ref_execute(want_plan).to_pylist()
    got = port_execute(got_plan).to_pylist()
    assert want, "reference returned no rows"
    _assert_rows(got, want)


def test_example_plan_matches_entry():
    """The reference's own ``entry()`` step and the port agree on the
    flagship stage."""
    import jax

    from spark_tpu.columnar.batch import Batch as RBatch

    fn, (data,) = __graft_entry__.entry()
    plan, ref_batch = __graft_entry__._example_plan()
    out = jax.jit(fn)(data)
    want = RBatch(plan.schema, out).to_pylist()
    got = port_execute(_build(PP, PE, PP.BatchScanExec(_carry(ref_batch)),
                              "example")).to_pylist()
    _assert_rows(got, want)
