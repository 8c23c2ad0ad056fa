"""The port's history reader (``spark_tpu_torch/history.py``) and live
status server (``ui.py``) on the inputs of tests/test_history.py and
tests/test_ui.py.

Held against the reference: ``summarize`` and ``chrome_trace`` of the
same JSONL log, and the HTML and text renderings. Held against the port
itself: a query's log rolls up, ``python -m spark_tpu_torch.history``
writes HTML and Perfetto JSON, and the UI serves the live ring at every
endpoint (those of tiers still to come answer as the reference's do
without them). The UI is off by default and gated on
``spark.ui.enabled``.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from spark_tpu import history as RH
from spark_tpu_torch import conf as CF
from spark_tpu_torch import history, metrics, ui
from spark_tpu_torch.api.session import SparkSession

from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(180)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """Two queries through the port with the event log on: the log
    directory and the session."""
    d = tmp_path_factory.mktemp("events")
    s = SparkSession(device="cpu", conf={"spark.eventLog.dir": str(d)})
    df = s.createDataFrame([{"k": i % 3, "v": float(i)} for i in range(64)])
    df.groupBy("k").sum("v").collect()
    df.filter("v > 10").count()
    metrics.flush_log()
    s.conf.unset("spark.eventLog.dir")
    return str(d), s


def test_history_summarize_and_render(logged):
    logdir, _ = logged
    queries = history.summarize(logdir)
    assert len(queries) >= 2 and any(q["stages"] for q in queries)
    assert "total ms" in history.render_text(queries)
    html = history.render_html(queries)
    assert html.startswith("<html>") and "details" in html


def test_rollups_match_reference_on_the_same_log(logged):
    """Both packages fold the same JSONL log to the same queries and the
    same Chrome trace."""
    logdir, _ = logged
    assert history.summarize(logdir) == RH.summarize(logdir)
    qs = history.summarize(logdir)
    assert history.render_text(qs) == RH.render_text(qs)
    # the page's title names the package
    assert history.render_html(qs).replace("spark_tpu_torch", "spark_tpu") \
        == RH.render_html(qs)
    evs = list(history._iter_events(logdir))
    tid = next(e["trace_id"] for e in evs if e["kind"] == "span")
    assert history.chrome_trace(evs, tid) == RH.chrome_trace(evs, tid)
    assert history.chrome_trace(evs) == RH.chrome_trace(evs)


def test_chrome_trace_lanes_and_markers():
    evs = [{"kind": "span", "name": "query.execute", "t0": 1.0, "ms": 5.0,
            "tid": 3, "trace_id": "t", "span_id": "a", "parent_id": None},
           {"kind": "span", "name": "stage.run", "t0": 1.001, "ms": 2.0,
            "tid": 3, "trace_id": "t", "span_id": "b", "parent_id": "a",
            "replica": "r1"},
           {"kind": "fault_injected", "ts": 1.002, "trace_id": "t",
            "point": "execute.device"}]
    doc = history.chrome_trace(evs, "t")
    assert doc == RH.chrome_trace(evs, "t")
    phs = sorted(e["ph"] for e in doc["traceEvents"])
    assert phs == ["M", "M", "X", "X", "i"]


def test_history_cli_html_and_perfetto(logged, tmp_path):
    logdir, _ = logged
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = tmp_path / "report.html"
    rc = subprocess.run([sys.executable, "-m", "spark_tpu_torch.history",
                         logdir, "--html", str(out)],
                        capture_output=True, text=True, timeout=120, env=env)
    assert rc.returncode == 0, rc.stderr
    assert out.read_text().startswith("<html>")
    pf = tmp_path / "trace.json"
    rc = subprocess.run([sys.executable, "-m", "spark_tpu_torch.history",
                         logdir, "--perfetto", str(pf)],
                        capture_output=True, text=True, timeout=120, env=env)
    assert rc.returncode == 0, rc.stderr
    assert json.loads(pf.read_text())["traceEvents"]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def test_live_ui_serves_active_session():
    s = SparkSession(device="cpu", conf={"spark.ui.enabled": True,
                                         "spark.ui.port": 0})
    try:
        assert s.uiWebUrl and s.uiWebUrl.startswith("http://127.0.0.1:")
        metrics.reset()
        s.createDataFrame([{"k": i % 3, "v": i} for i in range(100)]) \
            .createOrReplaceTempView("uit")
        assert len(s.sql("select k, sum(v) as s from uit group by k "
                         "order by k").collect()) == 3
        url = s.uiWebUrl
        code, body = _get(url + "/")
        assert code == 200 and b"<html" in body.lower()
        assert json.loads(_get(url + "/api/v1/queries")[1])
        st = json.loads(_get(url + "/api/v1/status")[1])
        assert st["app"] == s.app_name and st["events"] > 0
        assert st["active_query"] is not None
        assert st["storage"]["memory"]["budget_bytes"] > 0
        assert 0 < len(json.loads(_get(url + "/api/v1/events?n=50")[1])) <= 50
        sto = json.loads(_get(url + "/api/v1/storage")[1])
        assert "entries" in sto and "store" in sto
        ex = json.loads(_get(url + "/api/v1/exchange")[1])
        assert "profile" in ex and "gauges" in ex
        assert json.loads(_get(url + "/api/v1/lint")[1])["profile"]
        agg = json.loads(_get(url + "/api/v1/agg")[1])
        assert set(agg) == {"profile", "counters", "gauges"}
        comp = json.loads(_get(url + "/api/v1/compile")[1])
        assert comp["service"] is None  # no compile tier yet
        assert json.loads(_get(url + "/api/v1/serve")[1])["profile"]
        assert json.loads(_get(url + "/api/v1/mview")[1])["views"] == []
        tr = json.loads(_get(url + "/api/v1/trace")[1])
        assert tr["traces"] >= 1 and tr["slowest"]
        tid = tr["slowest"][0]["trace_id"]
        doc = json.loads(_get(url + f"/trace/{tid}")[1])
        assert any(e.get("ph") == "X" for e in doc["traceEvents"])
        for bad in ("/trace/nosuchtrace", "/nosuch"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(url + bad)
            assert ei.value.code == 404
    finally:
        s.stop()
    assert s.uiWebUrl is None


def test_ui_conf_gated():
    assert CF.RuntimeConf().get(ui.UI_ENABLED) is False
    assert SparkSession(device="cpu").uiWebUrl is None
    srv = ui.StatusServer(None, port=0)
    try:
        assert _get(srv.url + "/api/v1/status")[0] == 200
    finally:
        srv.stop()
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _get(srv.url + "/api/v1/status")
