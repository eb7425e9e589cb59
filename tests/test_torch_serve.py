"""Port parity: `repro_torch.launch.serve.ServeEngine` against the JAX
package's engine, both in this process, on the same weights (carried
across with `convert.lm_params_from_numpy`) and the same prompts.  The
scenarios are those of tests/test_serve.py and of tests/test_lifecycle.py
(fused egress tracking epochs; revoking one of four co-resident tenants).
Every step's results, the generated tokens, HWPIDs, KV page spans,
abort/fault outcomes and the cache and view statistics must be
identical."""
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.launch.serve import ServeEngine as JEngine
from repro.models import registry as jreg
from repro_torch import convert
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch.serve import ServeEngine, main


@pytest.fixture(scope="module")
def factories():
    """(JAX engine factory, port engine factory) over one set of weights:
    qwen1.5-0.5b at smoke width, 2 layers."""
    jcfg = replace(jsmoke(JARCHS["qwen1.5-0.5b"]), n_layers=2)
    cfg = replace(smoke_config(ARCHS["qwen1.5-0.5b"]), n_layers=2)
    jp = jreg.init_params(jcfg, jax.random.key(0))
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                          device="cpu")

    def jax_engine(batch=2, cap=24, **kw):
        return JEngine(jcfg, jp, batch=batch, cap=cap, **kw)

    def port_engine(batch=2, cap=24, **kw):
        return ServeEngine(cfg, params, batch=batch, cap=cap, device="cpu",
                           **kw)

    return jax_engine, port_engine


def _state(engine) -> dict:
    """Everything the two engines must agree on."""
    return {
        "tenants": {n: (t.hwpid, t.host_id, t.kv_start_page, t.kv_n_pages,
                        t.revoked, t.last_fault, len(t.queue),
                        len(t.aborted),
                        [(list(map(int, p)), list(map(int, g)))
                         for p, g in t.done])
                    for n, t in engine.tenants.items()},
        "faults": engine.faults, "steps": engine.steps,
        "cache": engine.cache_stats(), "views": engine.view_stats(),
        "bisnp": engine.bisnp_events, "epoch": engine.fm.epoch,
    }


def _run_both(factories, scenario, **kw):
    records = []
    for make in factories:
        log = []
        scenario(make(**kw), np.random.default_rng(0), log)
        records.append(log)
    assert records[0] == records[1]
    return records[1]


def _prompts(engine, rng, name, n, plen=10):
    for _ in range(n):
        engine.submit(name, rng.integers(3, engine.cfg.vocab - 1, plen))


def test_serve_scenario(factories):
    """tests/test_serve.py: batched decode, disjoint KV ranges, revocation
    aborts b while a keeps serving."""
    def scenario(e, rng, log):
        e.add_tenant("a", host_id=0)
        e.add_tenant("b", host_id=1)
        _prompts(e, rng, "a", 3, plen=12)
        log.append(e.run_tenant("a", gen=4))
        log.append(_state(e))
        _prompts(e, rng, "b", 1, plen=12)
        e.revoke("b")
        log.append(e.run_tenant("b", gen=4))
        _prompts(e, rng, "a", 1, plen=12)
        log.append(e.run_tenant("a", gen=2))
        log.append(_state(e))

    log = _run_both(factories, scenario)
    assert log[0]["served"] == 3 and log[2]["aborted"]
    assert log[2]["fault"] > 0 and not log[3]["aborted"]


def test_fused_egress_path_tracks_epochs(factories):
    def scenario(e, rng, log):
        e.add_tenant("a", host_id=0)
        e.add_tenant("b", host_id=1)
        _prompts(e, rng, "a", 1)
        _prompts(e, rng, "b", 1)
        log.append(e.run(gen=3, max_steps=50))
        log.append(_state(e))
        e.revoke("b")
        _prompts(e, rng, "b", 1)
        log.append(e.run_tenant("b", gen=3))
        _prompts(e, rng, "a", 1)
        log.append(e.run_tenant("a", gen=3))
        log.append(_state(e))

    log = _run_both(factories, scenario, fused_egress=True)
    assert log[1]["views"]["reuses"] > 0 and log[2]["aborted"]
    assert log[4]["views"]["rebuilds"] > log[1]["views"]["rebuilds"]


def test_multi_tenant_host_revocation_isolates_coresidents(factories):
    def scenario(e, rng, log):
        names = [f"mt{i}" for i in range(4)]
        for n in names:
            e.add_tenant(n, host_id=0)
            _prompts(e, rng, n, 1)
        for _ in range(2):
            log.append(e.step(gen=4))
        e.revoke(names[1])
        log.append(e.step(gen=4))
        log.append(e.step(gen=4))
        log.append(_state(e))
        log.append(e.run(gen=4, max_steps=100))
        log.append(_state(e))

    log = _run_both(factories, scenario, fused_egress=True)
    assert log[2]["mt1"]["aborted"] and log[2]["mt1"]["fault"] > 0
    assert all(not log[3][n]["aborted"] for n in ("mt0", "mt2", "mt3"))
    assert log[-2] == {"mt0": {"served": 1, "aborted": 0},
                       "mt1": {"served": 0, "aborted": 1},
                       "mt2": {"served": 1, "aborted": 0},
                       "mt3": {"served": 1, "aborted": 0}}


def test_evict_and_readmit_reuse_pages(factories):
    """tests/test_lifecycle.py's churn: evicting an in-flight tenant aborts
    its request in one commit, and the next admission reuses its span."""
    def scenario(e, rng, log):
        e.add_tenant("a", host_id=0)
        e.add_tenant("b", host_id=0)
        _prompts(e, rng, "b", 1)
        log.append(e.step(gen=3))
        ev = e.evict_tenant("b")
        log.append((ev.kv_start_page, ev.kv_n_pages, len(ev.aborted)))
        c = e.add_tenant("c", host_id=0)
        log.append((c.kv_start_page, c.kv_n_pages))
        _prompts(e, rng, "c", 1)
        log.append(e.run_tenant("c", gen=3))
        log.append(_state(e))

    log = _run_both(factories, scenario)
    assert log[1][:2] == log[2] and log[1][2] == 1


def test_cli_runs_on_the_cpu(capsys):
    main(["--device", "cpu", "--requests", "4", "--prompt-len", "8",
          "--gen", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "replacement tenant served" in out and "'aborted': True" in out
