"""The port's observability endpoints and multi-group journal: ports of
tests/test_obs.py's live-server cases on reduced qwen1.5-4b (float32,
weights materialized in JAX and loaded with ``load_jax_params``), every
group a CPU DeviceGroup.

- ``ObsHTTP`` on a live two-group server: ``/metrics`` (a Prometheus
  exposition that parses back), ``/healthz``, ``/stats``, 404 for anything
  else, 500 when a handler raises, 503 (degraded) once the server closed;
  its exposition and health body equal the JAX package's ``ObsHTTP`` on the
  same server.
- Elastic drain and join visible in the decision journal, in ``health()``
  and through ``/healthz`` (the drained group ``ready: false``), with the
  drained slots' migrations journalled.
- The flight recorder writes a valid bundle when a member's segment fails
  in a multi-group server; the other member keeps serving."""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import get_model as jax_get_model
from repro.models import params as jparams
from repro_torch import configs as tconfigs
from repro_torch.core import DeviceGroup, HGuided, Static
from repro_torch.core.device import running_group
from repro_torch.core.obs import EngineObs, validate_bundle
from repro_torch.core.trace import Tracer, set_tracer
from repro_torch.models import get_model
from repro_torch.models import params as tparams
from repro_torch.serve import (
    ForceMigrate,
    InferenceServer,
    ObsHTTP,
    PagedSpec,
    ServeError,
    make_generate,
    parse_exposition,
)

PLEN = 8


@pytest.fixture(scope="module")
def model():
    """The port's (cfg, api, params) of reduced qwen1.5-4b, the weights
    materialized in JAX."""
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen1.5-4b"))
    jp = jparams.materialize(jax_get_model(jcfg).param_spec(jcfg, 1),
                             jax.random.PRNGKey(0), jnp.float32)
    cfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-4b"))
    params = tparams.load_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return cfg, get_model(cfg), params


def prompts_for(cfg, seed, n, plen=PLEN):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, plen).astype(np.int32) for _ in range(n)]


def _pair(tag):
    return [DeviceGroup(f"{tag}-a", device="cpu", power=2.0),
            DeviceGroup(f"{tag}-b", device="cpu", power=1.0)]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_http_endpoints_live(model):
    cfg, api, params = model
    with InferenceServer(cfg, api, params, groups=_pair("http"), scheduler=HGuided(),
                         group_batches=True, buckets=(PLEN,), max_batch=4, seg_len=2,
                         max_new_cap=6, max_wait_ms=2.0, obs=EngineObs(enabled=True)) as srv:
        http = ObsHTTP(srv, port=0)
        jhttp = jserve.ObsHTTP(srv, port=0)  # the JAX package's, on the same server
        try:
            handles = [srv.submit(p, 4) for p in prompts_for(cfg, 31, 4)]
            for h in handles:
                h.result(timeout=300)
            code, ctype, body = _get(http.url("/metrics"))
            assert code == 200 and "text/plain" in ctype
            fams = parse_exposition(body.decode())
            assert "enginecl_coexec_efficiency" in fams
            assert set(fams) == set(parse_exposition(_get(jhttp.url("/metrics"))[2].decode()))
            code, ctype, body = _get(http.url("/healthz"))
            doc = json.loads(body)
            assert code == 200 and ctype == "application/json"
            assert doc["status"] == "ok" and doc["accepting"]
            assert set(doc["groups"]) == {"http-a", "http-b"}
            assert doc == json.loads(_get(jhttp.url("/healthz"))[2])
            stats = json.loads(_get(http.url("/stats?pretty=1"))[2])
            assert stats["decisions"]["total"] >= 1
            assert stats["placement"]["member_slots"] == {"http-a": 2, "http-b": 2}
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(http.url("/nope"), timeout=30)
            assert ei.value.code == 404
        finally:
            http.close()
            jhttp.close()
        http.close()  # idempotent
    # after server close the handler still answers — degraded, not dead
    http2 = ObsHTTP(srv, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(http2.url("/healthz"), timeout=30)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "degraded"
    finally:
        http2.close()


def test_http_handler_failure_is_500():
    """A handler that raises answers 500 with the error, and the endpoint
    thread keeps serving."""
    class Broken:
        def stats(self):
            raise RuntimeError("stats exploded")

        def health(self):
            return 200, {"status": "ok"}

    http = ObsHTTP(Broken(), port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(http.url("/stats"), timeout=30)
        assert ei.value.code == 500
        assert "stats exploded" in json.loads(ei.value.read())["error"]
        assert _get(http.url("/healthz"))[0] == 200
    finally:
        http.close()


def test_elastic_drain_join_visible_in_obs(model):
    cfg, api, params = model
    prompts = prompts_for(cfg, 21, 6)
    with InferenceServer(cfg, api, params, groups=_pair("eobs"), scheduler=HGuided(),
                         group_batches=True, buckets=(PLEN,), max_batch=4, seg_len=2,
                         max_new_cap=10, max_wait_ms=2.0, paged=PagedSpec(block_len=4),
                         obs=EngineObs(enabled=True)) as srv:
        http = ObsHTTP(srv, port=0)
        try:
            handles = [srv.submit(p, 8) for p in prompts]
            deadline = time.monotonic() + 120
            while srv.stats()["segments"] < 1:
                assert time.monotonic() < deadline, "decode never started"
                time.sleep(0.005)
            srv.drain_group("eobs-b")
            code, body = srv.health()
            assert code == 200  # one healthy member still serves
            assert body["groups"]["eobs-b"]["draining"]
            assert not body["groups"]["eobs-b"]["ready"]
            assert body["groups"]["eobs-a"]["ready"]
            assert "pool" in body  # paged mode exposes block pressure
            code, _, raw = _get(http.url("/healthz"))
            assert code == 200 and json.loads(raw)["groups"]["eobs-b"]["ready"] is False
            for h in handles:
                h.result(timeout=300)
            # draining members are excluded from the efficiency reduction
            # and nothing goes NaN while the member set shrinks
            eff = srv.metrics()["efficiency"]
            assert eff["groups"]["eobs-b"]["draining"]
            assert "eobs-b" not in eff["members"]
            assert eff["efficiency"] is None or eff["efficiency"] == eff["efficiency"]
            srv.join_group(DeviceGroup("eobs-c", device="cpu"))
            h2 = [srv.submit(p, 4) for p in prompts[:2]]
            for h in h2:
                h.result(timeout=300)
            eff = srv.metrics()["efficiency"]
            assert eff["efficiency"] is None or 0.0 < eff["efficiency"] <= 1.0
            stats = json.loads(_get(http.url("/stats"))[2])
        finally:
            http.close()
    kinds = stats["decisions"]["counts"]
    assert kinds.get("elastic", 0) >= 2  # drain + join
    recent = stats["decisions"]["recent"]
    acts = [r.get("action") for r in recent if r["kind"] == "elastic"]
    assert "drain" in acts and "join" in acts
    assert "eobs-c" in stats["placement"]["member_slots"]
    # every slot the drain moved is journalled with its reason
    drained = [r for r in recent if r["kind"] == "migration" and r.get("reason") == "drain"]
    assert all(r["src"] == "eobs-b" and r["dst"] != "eobs-b" for r in drained)
    per = stats["placement"]["per_group"]
    assert per["eobs-b"]["migrations_out"] >= len(drained)


def test_migrations_journalled_with_their_inputs(model):
    """Under ForceMigrate each applied move is one "migration" decision
    with its policy, outcome and placement weights, and the journal counts
    what the server counted."""
    cfg, api, params = model
    prompts = prompts_for(cfg, 23, 4)
    gens = [9, 3, 9, 3]
    gen = make_generate(cfg, api)
    prev = set_tracer(Tracer(enabled=True))  # the journal follows the tracer
    try:
        with InferenceServer(cfg, api, params, groups=_pair("jmig"), scheduler=Static(),
                             group_batches=True, migration=ForceMigrate(), buckets=(PLEN,),
                             max_batch=4, seg_len=2, max_new_cap=10, max_wait_ms=2.0) as srv:
            assert srv.obs.enabled
            # short streams free the slots that migrations need
            handles = [srv.submit(p, n) for p, n in zip(prompts, gens)]
            results = [h.result(timeout=300) for h in handles]
            s = srv.stats()
    finally:
        set_tracer(prev)
    for p, n, r in zip(prompts, gens, results):
        np.testing.assert_array_equal(
            r, gen(params, {"tokens": torch.from_numpy(p[None])}, n)[0].numpy())
    moves = [r for r in s["decisions"]["recent"] if r["kind"] == "migration"]
    moved = [r for r in moves if r["outcome"] == "moved"]
    assert len(moved) == s["slot_migrations"] >= 1
    assert all(r["reason"] == "ForceMigrate" and set(r["weights"]) == {"jmig-a", "jmig-b"}
               for r in moves)
    assert s["decisions"]["counts"].get("placement", 0) >= 1


def test_flight_recorder_on_member_failure(model, tmp_path):
    """A segment kernel that fails on one member of a two-group server:
    the flight recorder writes a valid bundle naming the fault, the failed
    member's requests fail, and the other member's streams are bitwise
    one-shot generate's."""
    cfg, api, params = model
    crash_dir = str(tmp_path / "crashes")
    srv = InferenceServer(cfg, api, params, groups=_pair("fr"), scheduler=Static(),
                          group_batches=True, buckets=(PLEN,), max_batch=4, seg_len=2,
                          max_new_cap=6, max_wait_ms=50.0,
                          obs=EngineObs(enabled=True, crash_dir=crash_dir))
    build = srv.kernels.segment_kernel

    def segment_kernel(*a, **k):
        fn = build(*a, **k)

        def seg(offset, *rest):
            if running_group().name == "fr-b":
                raise RuntimeError("injected fault")
            return fn(offset, *rest)

        return seg

    srv.kernels.segment_kernel = segment_kernel
    prompts = prompts_for(cfg, 41, 4)
    gen = make_generate(cfg, api)
    with srv:
        handles = [srv.submit(p, 4) for p in prompts]
        ok = failed = 0
        for p, h in zip(prompts, handles):
            try:
                got = h.result(timeout=300)
            except ServeError as exc:
                assert "injected fault" in str(exc)
                failed += 1
                continue
            np.testing.assert_array_equal(
                got, gen(params, {"tokens": torch.from_numpy(p[None])}, 4)[0].numpy())
            ok += 1
    assert failed >= 1 and ok >= 1
    path = srv.obs.recorder.last_path
    assert path is not None and path.startswith(crash_dir)
    doc = json.loads(open(path).read())
    assert validate_bundle(doc) == []
    assert "injected fault" in json.dumps(doc["context"])
    assert doc["reason"] == "segment_failed"
    assert doc["stats"]["placement"]["member_slots"] == {"fr-a": 2, "fr-b": 2}
    assert isinstance(doc["decisions"]["recent"], list)
