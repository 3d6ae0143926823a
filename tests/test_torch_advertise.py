"""The advertised endpoint of a wildcard metrics bind, against the JAX
package: a server bound at 0.0.0.0 (or ::, or "") writes into its port file
the routable address the JAX package's ``advertised_host`` resolves on the
same machine, and a concrete bind advertises itself. The supervisor arms
the routable bind (``MGWFBP_METRICS_HOST=0.0.0.0``) for its training
children and serving replicas exactly when the JAX supervisor does: with
the fleet plane armed (a fan-in port, or a fleet.json the caller named),
an operator's value winning; a plain supervised run keeps loopback."""

import json
import sys

import pytest

from mgwfbp_tpu.runtime.supervisor import Supervisor as JaxSupervisor
from mgwfbp_tpu.telemetry import serve as jax_serve
from mgwfbp_tpu_torch.runtime.supervisor import Supervisor
from mgwfbp_tpu_torch.telemetry import serve


class _Bound:
    """What ``write_port_file`` reads of a ``TelemetryServer``."""

    def __init__(self, host: str, port: int = 4242):
        self.host, self.port = host, port


def _port_doc(tmp_path, host: str) -> dict:
    path = str(tmp_path / "metrics_port.p0.json")
    serve.write_port_file(path, _Bound(host), 0)
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("wildcard", ["0.0.0.0", "::", ""])
def test_wildcard_bind_advertises_the_jax_routable_host(tmp_path, wildcard):
    doc = _port_doc(tmp_path, wildcard)
    want = jax_serve.advertised_host(wildcard)
    assert doc["host"] == want
    assert doc["host"] not in ("", "0.0.0.0", "::")
    assert doc["bound_host"] == wildcard and doc["port"] == 4242
    assert serve.advertised_host(wildcard) == want
    assert serve.routable_host() == jax_serve.routable_host()


@pytest.mark.parametrize("host", ["127.0.0.1", "10.1.2.3", "node7.example"])
def test_an_explicit_host_wins(tmp_path, host):
    doc = _port_doc(tmp_path, host)
    assert doc["host"] == host == jax_serve.advertised_host(host)
    assert doc["bound_host"] == host


def _envs(cls, tmp_path, env: dict, **kw) -> tuple[dict, dict]:
    sup = cls([sys.executable, "-c", "pass"], 2, env=env,
              log_dir=str(tmp_path / cls.__module__), **kw)
    return sup._child_env(1, 12345), sup._serve_env(0)


ARMINGS = [
    pytest.param({}, id="plain"),
    pytest.param({"fleet_port": 0}, id="fleet-port"),
    pytest.param({"fleet_file": "f.json"}, id="fleet-file"),
]


@pytest.mark.parametrize("armed", ARMINGS)
@pytest.mark.parametrize("operator", [None, "127.0.0.1"])
def test_supervisor_arms_the_routable_bind_as_the_jax_one(tmp_path, armed,
                                                         operator):
    env = {"MGWFBP_METRICS_PORT": "0"}
    if operator is not None:
        env["MGWFBP_METRICS_HOST"] = operator
    kw = dict(armed)
    if "fleet_file" in kw:
        kw["fleet_file"] = str(tmp_path / kw["fleet_file"])
    got = _envs(Supervisor, tmp_path, env, **kw)
    want = _envs(JaxSupervisor, tmp_path, env, **kw)
    for g, w in zip(got, want):
        assert g.get("MGWFBP_METRICS_HOST") == w.get("MGWFBP_METRICS_HOST")
    expect = operator or ("0.0.0.0" if armed else None)
    assert got[0].get("MGWFBP_METRICS_HOST") == expect
    assert got[1].get("MGWFBP_METRICS_HOST") == expect
