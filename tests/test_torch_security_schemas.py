"""The port's security providers and response schemas against the JAX
package's (counterparts of ``tests/test_security_schemas.py``).

The role table, every provider's verdicts and the schema checker's verdicts
are compared with the JAX package's on the same inputs; a secured app built
by the port's ``main.build_app`` on the CPU (three goals, small windows)
answers 401/403/200 as the reference's role structure says, its live bodies
pass both packages' schema checkers, and the port's CLI authenticates
against it.  The SPNEGO provider loads its ticket validator by class path
(``cruise_control_tpu_torch.testing.fake_gss.FakeGssValidator``).
"""

import base64
import json
import os
import tempfile
import time
import urllib.error
import urllib.request

import pytest

from cruise_control_tpu.servlet import schemas as jschemas
from cruise_control_tpu.servlet import security as jsec
from cruise_control_tpu.servlet.server import GET_ENDPOINTS, POST_ENDPOINTS
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
from cruise_control_tpu_torch.main import _security_provider, build_app
from cruise_control_tpu_torch.servlet import schemas
from cruise_control_tpu_torch.servlet.schemas import ENDPOINT_SCHEMAS, SchemaViolation, validate
from cruise_control_tpu_torch.servlet.security import (
    BasicSecurityProvider,
    JwtSecurityProvider,
    Principal,
    Role,
    SpnegoSecurityProvider,
    TrustedProxySecurityProvider,
    make_jwt,
    permits,
    required_role,
)

GOALS = "RackAwareGoal,ReplicaCapacityGoal,ReplicaDistributionGoal"


def _basic(user, password):
    return {"Authorization": "Basic " + base64.b64encode(f"{user}:{password}".encode()).decode()}


def _verdict(principal):
    return None if principal is None else (principal.name, principal.role.value)


def test_role_table_equals_jax():
    """DefaultRoleSecurityProvider.java:50-62, for every endpoint and verb."""
    for method, endpoints in (("GET", GET_ENDPOINTS), ("POST", POST_ENDPOINTS)):
        for ep in sorted(endpoints) + ["nonsense"]:
            assert required_role(method, ep).value == jsec.required_role(method, ep).value
    for granted in Role:
        for need in Role:
            assert permits(granted, need) == jsec.permits(jsec.Role(granted.value),
                                                          jsec.Role(need.value))
    assert required_role("GET", "state") is Role.USER
    assert required_role("POST", "rebalance") is Role.ADMIN


def test_basic_jwt_and_proxy_providers_equal_jax(tmp_path):
    creds = tmp_path / "realm.properties"
    creds.write_text("admin: secret,ADMIN\nviewer: look,VIEWER\n# comment\nplain: pw\n")
    pairs = [(BasicSecurityProvider(credentials_file=str(creds)),
              jsec.BasicSecurityProvider(credentials_file=str(creds)))]
    pairs.append((JwtSecurityProvider("s3cret", clock=lambda: 1000.0),
                  jsec.JwtSecurityProvider("s3cret", clock=lambda: 1000.0)))
    pairs.append((TrustedProxySecurityProvider(["10.0.0.1"]),
                  jsec.TrustedProxySecurityProvider(["10.0.0.1"])))
    tokens = [make_jwt({"sub": "alice", "role": "USER", "exp": 2000}, "s3cret"),
              make_jwt({"sub": "alice", "role": "USER", "exp": 10}, "s3cret"),
              make_jwt({"sub": "alice", "role": "ADMIN"}, "other-secret"),
              make_jwt({"sub": "bob", "exp": "soon"}, "s3cret"), "a.b", "x.y.z"]
    assert tokens[0] == jsec.make_jwt({"sub": "alice", "role": "USER", "exp": 2000}, "s3cret")
    requests = ([(_basic(u, p), "1.2.3.4") for u, p in
                 (("admin", "secret"), ("viewer", "look"), ("plain", "pw"),
                  ("admin", "wrong"), ("ghost", "x"))]
                + [({"Authorization": f"Bearer {t}"}, "1.2.3.4") for t in tokens]
                + [({"X-Forwarded-User": "bob"}, ip) for ip in ("10.0.0.1", "10.0.0.2")]
                + [({}, "10.0.0.1"), ({"authorization": "Basic !!!"}, "x")])
    for provider, jprovider in pairs:
        for headers, ip in requests:
            assert _verdict(provider.authenticate(headers, ip)) == \
                _verdict(jprovider.authenticate(headers, ip)), (type(provider), headers)
        assert provider.challenge() == jprovider.challenge()
    assert pairs[0][0].authenticate(_basic("admin", "secret"), "x") == \
        Principal("admin", Role.ADMIN)


def test_spnego_provider_equals_jax(tmp_path):
    store = tmp_path / "realm.properties"
    store.write_text("alice: x, ADMIN\nbob: x, VIEWER\n")

    def validator(token: bytes):
        if token == b"good-alice":
            return "alice/host.example.com@EXAMPLE.COM", b"mutual-tok"
        if token == b"good-bob":
            return "bob@EXAMPLE.COM"
        if token == b"stranger":
            return "mallory@EXAMPLE.COM"
        raise ValueError("bad ticket")

    def hdr(tok):
        return {"Authorization": "Negotiate " + base64.b64encode(tok).decode()}

    for default in (None, Role.USER):
        p = SpnegoSecurityProvider(validator, credentials_file=str(store), default_role=default)
        jp = jsec.SpnegoSecurityProvider(validator, credentials_file=str(store),
                                         default_role=None if default is None
                                         else jsec.Role(default.value))
        for headers in (hdr(b"good-alice"), hdr(b"good-bob"), hdr(b"stranger"),
                        hdr(b"forged"), {}, {"Authorization": "Negotiate !!!"}):
            assert _verdict(p.authenticate(headers, "1.2.3.4")) == \
                _verdict(jp.authenticate(headers, "1.2.3.4")), headers
            assert p.mutual_auth_header() == jp.mutual_auth_header()
        assert p.challenge() == jp.challenge() == {"WWW-Authenticate": "Negotiate"}


def test_spnego_provider_from_config(tmp_path):
    """``_security_provider`` resolves the validator class path in the
    port's own namespace; a missing validator or user store is refused."""
    store = tmp_path / "realm.properties"
    store.write_text("carol: x, ADMIN\n")
    validator = "cruise_control_tpu_torch.testing.fake_gss.FakeGssValidator"
    provider = _security_provider(CruiseControlConfig({
        "webserver.security.enable": "true", "webserver.security.provider": "spnego",
        "webserver.auth.credentials.file": str(store),
        "webserver.auth.spnego.validator.class": validator}))
    assert isinstance(provider, SpnegoSecurityProvider)
    assert type(provider.ticket_validator).__module__ == "cruise_control_tpu_torch.testing.fake_gss"

    def hdr(principal: bytes):
        return {"Authorization": "Negotiate "
                + base64.b64encode(b"principal:" + principal).decode()}

    assert provider.authenticate(hdr(b"carol"), "1.2.3.4") == Principal("carol", Role.ADMIN)
    assert provider.authenticate(hdr(b"mallory"), "1.2.3.4") is None
    with pytest.raises(ValueError, match="validator.class required"):
        _security_provider(CruiseControlConfig({
            "webserver.security.enable": "true", "webserver.security.provider": "spnego",
            "webserver.auth.credentials.file": str(store)}))
    with pytest.raises(ValueError, match="credentials.file required"):
        _security_provider(CruiseControlConfig({
            "webserver.security.enable": "true", "webserver.security.provider": "spnego",
            "webserver.auth.spnego.validator.class": validator}))
    with pytest.raises(ValueError, match="unknown webserver.security.provider"):
        _security_provider(CruiseControlConfig({
            "webserver.security.enable": "true", "webserver.security.provider": "ldap"}))
    assert _security_provider(CruiseControlConfig({})) is None


SCHEMA_PROBES = [
    ({"type": "object", "required": ["a"],
      "properties": {"a": {"type": "integer"}, "b": {"type": "array", "items": {"type": "string"}}}},
     [{"a": 1, "b": ["x"]}, {"b": []}, {"a": "nope"}, {"a": 1, "b": [2]}, {"a": True},
      {"a": 1.0}, [], None]),
    ({"type": ["number", "null"], "enum": [1, 2.5, None]}, [1, 2.5, None, 3, "1", True]),
    ({"type": "object", "additionalProperties": {"type": "boolean"}},
     [{"x": True}, {"x": 1}, {}]),
]


def test_schema_checker_verdicts_and_tables_equal_jax():
    assert ENDPOINT_SCHEMAS == jschemas.ENDPOINT_SCHEMAS
    for schema, values in SCHEMA_PROBES:
        for value in values:
            verdicts = []
            for check, err in ((validate, SchemaViolation), (jschemas.validate,
                                                              jschemas.SchemaViolation)):
                try:
                    check(value, schema)
                    verdicts.append(None)
                except err as e:
                    verdicts.append(str(e))
            assert verdicts[0] == verdicts[1], (schema, value)
    assert schemas.OPERATION_RESULT_SCHEMA == jschemas.OPERATION_RESULT_SCHEMA


# --------------------------------------------------------------- secured app


@pytest.fixture(scope="module")
def secured_app():
    fd, path = tempfile.mkstemp(suffix=".properties")
    with os.fdopen(fd, "w") as f:
        f.write("admin: pw,ADMIN\nviewer: look,VIEWER\nuser: go,USER\n")
    cfg = CruiseControlConfig({
        "metric.sampling.interval.ms": 300, "partition.metrics.window.ms": 600,
        "default.goals": GOALS, "obs.history.enabled": False, "webserver.security.enable": True,
        "webserver.auth.credentials.file": path, "compile.warmup.enabled": False})
    app = build_app(cfg, port=0, device="cpu")
    app.cc.start_up()
    app.start()
    yield app
    app.stop()
    app.cc.shutdown()
    os.unlink(path)


def _get(app, path, user=None, password=None, method="GET", headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{app.port}/kafkacruisecontrol{path}",
                                 method=method)
    for k, v in (_basic(user, password) if user else {}).items():
        req.add_header(k, v)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    return urllib.request.urlopen(req)


def test_secured_endpoints(secured_app):
    app = secured_app
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(app, "/state")
    assert e.value.code == 401 and e.value.headers.get("WWW-Authenticate")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(app, "/state", "viewer", "look")
    assert e.value.code == 403
    assert _get(app, "/state", "user", "go").status == 200
    assert _get(app, "/kafka_cluster_state", "viewer", "look").status == 200
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(app, "/rebalance?dryrun=true", "user", "go", method="POST")
    assert e.value.code == 403
    try:
        code = _get(app, "/rebalance?dryrun=true", "admin", "pw", method="POST").status
    except urllib.error.HTTPError as err:
        code = err.code
    assert code not in (401, 403), code


def test_live_responses_match_both_schema_checkers(secured_app):
    """ResponseTest pattern: each schema'd endpoint's completed body
    validates against the port's schemas and the JAX package's."""
    app = secured_app

    def fetch_done(path, method="GET"):
        deadline = time.time() + 60
        task_id = None
        while time.time() < deadline:
            try:
                r = _get(app, path, "admin", "pw", method,
                         {"User-Task-ID": task_id} if task_id else None)
            except urllib.error.HTTPError:
                time.sleep(0.3)      # windows still filling
                continue
            task_id = r.headers.get("User-Task-ID", task_id)
            body = json.load(r)
            if "progress" not in body:
                return body
            time.sleep(0.2)
        raise AssertionError(f"{path} never completed")

    for endpoint, path, method in (
        ("state", "/state", "GET"), ("load", "/load", "GET"),
        ("partition_load", "/partition_load", "GET"),
        ("kafka_cluster_state", "/kafka_cluster_state", "GET"),
        ("user_tasks", "/user_tasks", "GET"), ("proposals", "/proposals", "GET"),
        ("rebalance", "/rebalance?dryrun=true", "POST"),
        ("rebalance", "/rebalance?dryrun=true&explain=true", "POST"),
        ("health", "/health", "GET"), ("execution_progress", "/execution_progress", "GET"),
        ("solver_stats", "/solver_stats", "GET"), ("trace", "/trace", "GET"),
        ("metrics/history", "/metrics/history", "GET"),
    ):
        body = fetch_done(path, method)
        validate(body, ENDPOINT_SCHEMAS[endpoint])
        jschemas.validate(body, jschemas.ENDPOINT_SCHEMAS[endpoint])


def test_cli_auth_against_secured_server(secured_app):
    from cruise_control_tpu_torch.client.cccli import ENDPOINTS, Responder
    base = f"http://127.0.0.1:{secured_app.port}"
    assert Responder(base).request(ENDPOINTS["state"], {})["httpStatus"] == 401
    ok = Responder(base, auth_header=_basic("user", "go")["Authorization"]).request(
        ENDPOINTS["state"], {})
    assert ok["httpStatus"] == 200 and "MonitorState" in ok
