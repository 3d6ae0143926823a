"""The port's fleet fan-in (``telemetry/fleet.py``) against the JAX
package's, and ``supervise --fleet-port`` with a CPU child.

  * over the same recorded child scrapes (statuses and metric values from
    aggregators fed seeded event streams, one child unreachable, one a
    serving replica), ``straggler_table``, ``active_alarms``,
    ``fleet_postmortems``, ``profile_windows``, ``fleet_status`` and
    ``render_fleet_metrics`` equal the JAX functions' (exact: the same
    host arithmetic), and ``write_fleet_sd`` writes the same file;
  * a ``FleetServer`` over two live port aggregators serves
    ``/fleet/metrics``, ``/fleet/status`` and ``/fleet/profile`` as the
    JAX fan-in does over the same endpoints, and a dead target is reported
    unreachable, never hung on;
  * ``Supervisor(fleet_port=0)`` with one ``train_cli`` child on the CPU
    (``MGWFBP_METRICS_PORT=0``): ``/fleet/status`` lists the child as
    reachable with its live step, ``/fleet/metrics`` carries its series
    under ``process="0"``, and ``/fleet/profile?steps=1`` arms its window.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

from mgwfbp_tpu.telemetry import fleet as jax_fleet
from mgwfbp_tpu.telemetry.serve import MetricsAggregator as JaxAggregator
from mgwfbp_tpu.telemetry.serve import TelemetryServer as JaxServer
from mgwfbp_tpu_torch.runtime.supervisor import Supervisor, default_train_cmd
from mgwfbp_tpu_torch.telemetry import export, fleet
from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator, TelemetryServer

from test_torch_metrics import seeded_events


def _scrapes(mod, seeds=(0, 1, 2)) -> list:
    """One ChildScrape per seed (a training child, then a serving replica),
    plus an unreachable child, of ``mod``'s dataclass."""
    out = []
    for i, seed in enumerate(seeds):
        agg = MetricsAggregator()
        agg.enable_profile()
        for ev, fields in seeded_events(seed):
            agg.observe(ev, dict(fields))
        status = agg.status()
        status["uptime_s"] = 1.0
        key = i if i < len(seeds) - 1 else f"serve{i}"
        out.append(mod.ChildScrape(process=key, host="127.0.0.1",
                                   port=9000 + i, status=status,
                                   values=agg.values()))
    out.append(mod.ChildScrape(process=9, host="127.0.0.1", port=9999,
                               error="/status: connection refused"))
    return out


def test_fan_in_functions_match_jax(tmp_path):
    ours, theirs = _scrapes(fleet), _scrapes(jax_fleet)
    assert fleet.straggler_table(ours) == jax_fleet.straggler_table(theirs)
    assert fleet.active_alarms(ours) == jax_fleet.active_alarms(theirs)
    assert fleet.fleet_postmortems(ours) == jax_fleet.fleet_postmortems(
        theirs)
    assert fleet.profile_windows(ours) == jax_fleet.profile_windows(theirs)
    meta = {"incarnation": 2, "processes_configured": 2}
    doc = fleet.fleet_status(ours, meta=meta)
    assert doc == jax_fleet.fleet_status(theirs, meta=meta)
    assert doc["reachable"] == 3 and not doc["healthy"]
    assert doc["unreachable"][0]["process"] == 9
    text = fleet.render_fleet_metrics(ours)
    assert text == jax_fleet.render_fleet_metrics(theirs)
    assert 'mgwfbp_steps_total{process="0"}' in text
    assert "mgwfbp_fleet_unreachable 1" in text
    targets = {0: ("127.0.0.1", 9000), "serve1": ("127.0.0.1", 9100)}
    roles = {"serve1": "serve"}
    fleet.write_fleet_sd(str(tmp_path / "a.json"), targets, roles=roles)
    jax_fleet.write_fleet_sd(str(tmp_path / "b.json"), targets, roles=roles)
    assert (tmp_path / "a.json").read_text() == (
        tmp_path / "b.json").read_text()


def _http(port: int, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=15) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _strip_uptimes(doc: dict) -> dict:
    for st in doc.get("processes", {}).values():
        st.pop("uptime_s", None)
    return doc


def test_fleet_server_matches_the_jax_fan_in():
    servers, aggs = [], []
    for seed in (3, 4):
        agg = MetricsAggregator(run={"seed": seed})
        agg.enable_profile()
        for ev, fields in seeded_events(seed):
            agg.observe(ev, dict(fields))
        aggs.append(agg)
        servers.append(TelemetryServer(agg, 0))
    targets = {i: ("127.0.0.1", s.port) for i, s in enumerate(servers)}
    dead = {**targets, 2: ("127.0.0.1", 1)}  # nothing listens on port 1
    ours = fleet.FleetServer(lambda: dead, 0, scrape_timeout_s=2.0)
    theirs = jax_fleet.FleetServer(lambda: dead, 0, scrape_timeout_s=2.0)
    try:
        got = {path: _http(ours.port, path) for path in (
            "/fleet/metrics", "/fleet/status", "/fleet/profile", "/nope",
            "/fleet/profile?steps=x")}
        want = {path: _http(theirs.port, path) for path in got}
        assert got["/fleet/metrics"] == want["/fleet/metrics"]
        assert _strip_uptimes(json.loads(got["/fleet/status"][1])) == (
            _strip_uptimes(json.loads(want["/fleet/status"][1])))
        assert json.loads(got["/fleet/status"][1])["unreachable"][0][
            "process"] == 2
        for path in ("/fleet/profile", "/nope", "/fleet/profile?steps=x"):
            assert got[path] == want[path]
        assert got["/fleet/profile?steps=x"][0] == 400
        code, body = _http(ours.port, "/fleet/profile?steps=3")
        doc = json.loads(body)
        assert code == 200 and doc["armed"] == 2 and doc["steps"] == 3
        assert doc["processes"]["2"]["armed"] is False
        assert all(a.profile_status()["state"] == "armed" for a in aggs)
        # the JAX plane's per-process server answers the same fan-in
        jagg = JaxAggregator()
        jserver = JaxServer(jagg, 0)
        try:
            one = fleet.scrape_child(0, "127.0.0.1", jserver.port)
            assert one.reachable and one.values == jagg.values()
        finally:
            jserver.close()
    finally:
        ours.close()
        theirs.close()
        for s in servers:
            s.close()


def test_supervise_fleet_port_with_a_cpu_child(tmp_path):
    env = dict(os.environ, MGWFBP_METRICS_PORT="0",
               MGWFBP_FAULT_PLAN="stall@secs=6,step=3",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), OMP_NUM_THREADS="1")
    sup = Supervisor(
        default_train_cmd([
            "--dnn", "lenet", "--synthetic", "--device", "cpu",
            "--batch-size", "4", "--num-batches-per-epoch", "4",
            "--epochs", "1", "--no-profile-backward",
            "--logdir", str(tmp_path / "logs")]),
        1, log_dir=str(tmp_path / "sup"), env=env, fleet_port=0,
        max_restarts=0, heal=False)
    rc: list = []
    th = threading.Thread(target=lambda: rc.append(sup.run()), daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 120
        status = None
        while time.monotonic() < deadline:
            if sup.fleet_server is not None:
                code, body = _http(sup.fleet_server.port, "/fleet/status")
                doc = json.loads(body)
                if code == 200 and doc["reachable"] == 1 and (
                        doc["processes"]["0"]["step"] or 0) >= 2:
                    status = doc
                    break
            time.sleep(0.5)
        assert status is not None, "the child never answered the fan-in"
        assert status["unreachable"] == [] and status["healthy"]
        assert status["processes_configured"] == 1
        assert status["processes"]["0"]["run"]["model"] == "lenet"
        code, text = _http(sup.fleet_server.port, "/fleet/metrics")
        assert code == 200
        assert 'mgwfbp_steps_total{process="0"}' in text
        assert "mgwfbp_fleet_processes 1" in text
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name = line.split("{")[0].split()[0]
                assert name in {n for n, _, _ in export.METRICS}, line
        code, body = _http(sup.fleet_server.port, "/fleet/profile?steps=1")
        assert code == 200 and json.loads(body)["armed"] == 1
        assert os.path.exists(tmp_path / "sup" / "fleet.json")
        th.join(150)
        assert not th.is_alive() and rc == [0]
    finally:
        if th.is_alive():
            for p in list(getattr(sup, "_procs", []) or []):
                p.kill()
        if sup.fleet_server is not None:
            sup.fleet_server.close()
