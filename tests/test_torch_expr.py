"""The port's expression evaluator (spark_tpu_torch/expr/compiler.py)
against the reference's, on one batch carried across with
``from_host_arrays``: decimal and integer arithmetic (division by zero
gives NULL), comparisons with dictionary strings and dates, three-valued
logic over NULLs, null tests, casts (including the reference's
decimal-to-float quirk), negation, IN lists (ints, decimals with an
off-grid literal, dates, strings; NULL items), LIKE, the string
predicates, substring, CASE (mixed dictionaries, no ELSE), COALESCE and
date parts. Values, validity, types and dictionaries must be equal
exactly; float64 results rel 1e-15."""

import datetime

import numpy as np
import pytest

from spark_tpu import types as RT
from spark_tpu.columnar.batch import from_numpy as ref_from_numpy
from spark_tpu.expr import compiler as RC
from spark_tpu.expr import expressions as RE
from spark_tpu_torch import types as PT
from spark_tpu_torch.expr import compiler as PC
from spark_tpu_torch.expr import expressions as PE
from spark_tpu_torch.physical.operators import Pipe

from test_torch_operators import _carry

N = 64


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(21)
    schema = RT.Schema((
        RT.Field("a", RT.INT64, nullable=True),
        RT.Field("z", RT.INT64, nullable=False),
        RT.Field("x", RT.FLOAT64, nullable=False),
        RT.Field("m", RT.DecimalType(12, 2), nullable=True),
        RT.Field("n", RT.DecimalType(12, 2), nullable=False),
        RT.Field("s", RT.STRING, nullable=True,
                 dictionary=("1994-05-06", "42", "apple", "pear")),
        RT.Field("t", RT.STRING, nullable=False,
                 dictionary=("apple", "fig", "zucchini")),
        RT.Field("d", RT.DATE, nullable=False),
        RT.Field("p", RT.BOOLEAN, nullable=True),
        RT.Field("q", RT.BOOLEAN, nullable=True),
    ))
    valid = [rng.random(N) < 0.8 for _ in range(4)]
    ref = ref_from_numpy(schema, [
        rng.integers(-20, 20, N),
        rng.integers(-2, 3, N),
        rng.normal(size=N) * 10,
        rng.integers(-10 ** 6, 10 ** 6, N),
        rng.integers(-500, 500, N),
        rng.integers(0, 4, N).astype(np.int32),
        rng.integers(0, 3, N).astype(np.int32),
        rng.integers(8500, 10500, N).astype(np.int32),
        rng.random(N) < 0.5,
        rng.random(N) < 0.5,
    ], validities=[valid[0], None, None, valid[1], None, valid[2], None,
                   None, valid[3], valid[0]], capacity=N)
    return ref, _carry(ref)


def _cases(E, T):
    C, L = E.Col, E.Literal
    return {
        "int_arith": E.Arith("+", E.Arith("*", C("a"), L(3)), C("z")),
        "int_div_zero": E.Arith("/", C("a"), C("z")),
        "int_mod": E.Arith("%", C("a"), C("z")),
        "float_arith": E.Arith("-", E.Arith("*", C("x"), L(2.5)), C("a")),
        "dec_add": E.Arith("+", C("m"), C("n")),
        "dec_sub_int": E.Arith("-", L(1), C("n")),
        "dec_mul": E.Arith("*", C("m"), E.Arith("-", L(1), C("n"))),
        "dec_div": E.Arith("/", C("m"), C("n")),
        "dec_mod": E.Arith("%", C("m"), C("n")),
        "neg": E.Neg(C("m")),
        "cmp_dec": E.Cmp("<=", C("m"), L(12.5)),
        "cmp_mixed": E.Cmp(">", C("x"), C("a")),
        "cmp_str_lit": E.Cmp(">=", C("t"), L("b")),
        "cmp_str_col": E.Cmp("<", C("s"), C("t")),
        "cmp_date_lit": E.Cmp("<=", C("d"), L(datetime.date(1996, 1, 4))),
        "cmp_date_str": E.Cmp(">", C("d"), C("s")),
        "and": E.And(C("p"), C("q")),
        "or": E.Or(C("p"), E.Not(C("q"))),
        "is_null": E.IsNull(C("m")),
        "cast_dec_float": E.Cast(C("m"), T.FLOAT32),
        "cast_dec_double": E.Cast(C("n"), T.FLOAT64),
        "cast_dec_rescale": E.Cast(C("m"), T.DecimalType(12, 1)),
        "cast_int_dec": E.Cast(C("a"), T.DecimalType(10, 2)),
        "cast_float_dec": E.Cast(C("x"), T.DecimalType(10, 1)),
        "cast_int_float": E.Cast(C("a"), T.FLOAT32),
        "cast_str_date": E.Cast(L("1995-03-15"), T.DATE),
        "cast_str_int": E.Cast(L("42"), T.INT64),
        "in_int": E.In(C("a"), (1, -3, 7, None, 19)),
        "in_dec": E.In(C("m"), (7648.16, 0.0501, -8807.7, None)),
        "in_date": E.In(C("d"), (datetime.date(1993, 9, 5),
                                 datetime.date(1994, 11, 9), None)),
        "in_str": E.In(C("s"), ("apple", "nope", "42")),
        "not_in_str": E.Not(E.In(C("t"), ("fig",))),
        "like_mid": E.Like(C("s"), "%p%"),
        "like_underscore": E.Like(C("t"), "_ig"),
        "not_like": E.Not(E.Like(C("t"), "a%e")),
        "startswith": E.StringPredicate("startswith", C("s"), "ap"),
        "endswith": E.StringPredicate("endswith", C("t"), "ini"),
        "contains": E.StringPredicate("contains", C("s"), "99"),
        "substring": E.Substring(C("s"), 2, 3),
        "substring_tail": E.Substring(C("t"), 3, 1 << 30),
        "case_str_mixed": E.Case(
            ((E.Cmp(">", C("a"), L(0)), C("s")),
             (E.IsNull(C("m")), C("t"))), L("other")),
        "case_num_no_else": E.Case(((C("p"), C("a")), (C("q"), C("z"))),
                                   None),
        "case_dec": E.Case(((E.Cmp("<", C("x"), L(0.0)), C("m")),),
                           C("n")),
        "coalesce_int": E.Coalesce((C("a"), C("z"))),
        "coalesce_str": E.Coalesce((C("s"), L("zz"))),
        "year": E.ExtractDatePart("year", C("d")),
        "month": E.ExtractDatePart("month", C("d")),
        "day": E.ExtractDatePart("day", C("d")),
    }


NAMES = sorted(_cases(RE, RT))


@pytest.mark.parametrize("name", NAMES)
def test_expression_parity(batches, name):
    ref, port = batches
    want = RC.evaluate(_cases(RE, RT)[name], RC.Env.from_batch(ref))
    got = PC.evaluate(_cases(PE, PT)[name], Pipe.from_batch(port).env())
    assert repr(got.dtype) == repr(want.dtype)
    assert got.dictionary == want.dictionary
    wv = (np.ones(N, bool) if want.validity is None
          else np.asarray(want.validity))
    gv = (np.ones(N, bool) if got.validity is None
          else got.validity.numpy())
    np.testing.assert_array_equal(gv, wv)
    wd = np.asarray(want.data)
    gd = got.data.numpy()
    assert gd.dtype == wd.dtype
    if wd.dtype.kind == "f":
        np.testing.assert_allclose(gd[wv], wd[wv], rtol=1e-15)
    else:
        np.testing.assert_array_equal(gd[wv], wd[wv])
