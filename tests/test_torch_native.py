"""The port's host string tables (spark_tpu_torch/native, C++ built with
g++ at first use) against the Python regex and ``str`` path of
``expr/compiler.py``, which serves dictionaries under
``_NATIVE_DICT_MIN`` entries: random dictionaries with multi-byte UTF-8
and empty strings, patterns with ``%`` and ``_``. Exact. A failed build
raises with the compiler's output; nothing falls back."""

import random
import string

import numpy as np
import pytest

from spark_tpu_torch import native
from spark_tpu_torch.expr import compiler as PC
from spark_tpu_torch.ops import _build

from test_torch_threads import one_torch_thread  # noqa: F401

WORDS = ["special", "requests", "green", "BRASS", "yellow metallic",
         "über", "naïve", "日本語テキスト", "", "%literal", "a_b", "ends%",
         "x" * 300, "Customer", "Complaints"]


def _random_dict(n: int, seed: int):
    rng = random.Random(seed)
    out = set()
    while len(out) < n:
        parts = rng.choices(WORDS + list(string.ascii_lowercase), k=3)
        out.add(rng.choice(["", " "]).join(parts))
    return tuple(sorted(out))


def _regex_like(dictionary, pattern):
    rx = PC._like_to_regex(pattern)
    return PC._dict_table(dictionary, lambda s: rx.match(s) is not None)


@pytest.mark.parametrize("pattern", [
    "%special%requests%", "green%", "%BRASS", "a_b", "_", "%", "",
    "%über%", "日本語%", "____", "%metallic", "x%x", "%a%b%c%",
    "%Customer%Complaints%", "_a%", "%_",
])
def test_like_table_matches_regex_path(pattern):
    d = _random_dict(600, seed=len(pattern))
    want = _regex_like(d, pattern)
    got = native.like_table(d, pattern)
    assert got.dtype == bool and got.shape == (len(d),)
    np.testing.assert_array_equal(got, want)


def test_like_underscore_counts_codepoints():
    d = ("über", "uber", "ber", "übe", "日本", "日本語", "")
    np.testing.assert_array_equal(native.like_table(d, "____"),
                                  _regex_like(d, "____"))
    np.testing.assert_array_equal(
        native.like_table(d, "__"),
        np.array([False, False, False, False, True, False, False]))


@pytest.mark.parametrize("op", ["startswith", "endswith", "contains"])
@pytest.mark.parametrize("needle", ["", "re", "über", "日本", "x" * 301])
def test_predicate_table_matches_str_path(op, needle):
    d = _random_dict(600, seed=7)
    fn = {"startswith": str.startswith, "endswith": str.endswith,
          "contains": lambda s, x: x in s}[op]
    want = PC._dict_table(d, lambda s: fn(s, needle))
    np.testing.assert_array_equal(native.predicate_table(d, op, needle),
                                  want)


def test_large_dictionaries_take_the_native_tables(monkeypatch):
    """At ``_NATIVE_DICT_MIN`` entries and above the compiler's tables
    come from the C++ kernels, below from the regex path; both agree."""
    calls = []
    real_like, real_pred = native.like_table, native.predicate_table
    monkeypatch.setattr(native, "like_table", lambda *a: (
        calls.append("like"), real_like(*a))[1])
    monkeypatch.setattr(native, "predicate_table", lambda *a: (
        calls.append("pred"), real_pred(*a))[1])
    small = _random_dict(PC._NATIVE_DICT_MIN - 1, seed=1)
    large = _random_dict(PC._NATIVE_DICT_MIN, seed=2)
    for d in (small, large):
        np.testing.assert_array_equal(PC.like_table(d, "%re%s%"),
                                      _regex_like(d, "%re%s%"))
        np.testing.assert_array_equal(
            PC.predicate_table(d, "endswith", "s"),
            np.array([s.endswith("s") for s in d]))
    assert calls == ["like", "pred"]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*broken.cpp"):
        _build.host_library("broken", bad)
    assert "broken" not in _build._loaded
