"""The serving cell on the CPU, at the widths and sizes of its workload
file's ``cpu`` entry (the port's plain versions in place of its kernels):
correct against the plain reference, its controls and planted faults of
the timed path not correct, and the frozen work counts against
hand-worked values."""
import time

import pytest
import torch

from scbench import harness
from scbench.roofline import moe

CELL = "granite-h-small-decode"


def run(seconds=0.3, **kw):
    return harness.run_cell(CELL, seed=2**31 + 11, seconds=seconds,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(),
                            log=lambda m: None, **{"trace": False, **kw})


def test_tiny_run_is_correct():
    record, line = run()
    assert record.correct, record.checks
    assert line["failed"] == 0 and line["attempted"] >= 4 * 4
    assert set(line["metrics"]) == {"egress_words_per_s.churn", "setup_s"}
    assert record.counters["words"] == record.counters["ticks"] * 4 * 2
    assert record.counters["judged"] == 4
    assert record.counters["picks_judged"] == 2 * 4 * 2
    assert record.checks["logit_max_abs_err"][0] < 1e-6
    assert record.checks["token_mismatches"] == (0, 0)


def test_the_cpu_entry_sets_the_sizes_on_the_cpu():
    """The workload file's ``cpu`` entry, and not the published widths,
    is what a CPU run builds: 2 x 4 tenants' lanes a tick, 3 layers."""
    from repro_torch.launch import serve
    seen = []
    init = serve.ServeEngine.__init__

    def keep(self, cfg, *a, **kw):
        seen.append((cfg.d_model, cfg.n_layers, kw["batch"], kw["n_hosts"]))
        init(self, cfg, *a, **kw)
    serve.ServeEngine.__init__ = keep
    try:
        run()
    finally:
        serve.ServeEngine.__init__ = init
    assert seen == [(64, 3, 2, 2)]


def test_tiny_traced_run_reports_the_serving_metrics():
    """A window past the traced part: the port's spans are on after the
    profiler stops.  On the CPU no kernel runs: the kernel's roofline reads
    nothing."""
    record, line = run(seconds=harness.TRACE_SECONDS + 0.5, trace=True)
    assert record.correct, record.checks
    assert set(line["metrics"]) == {"serve.decode_roofline_pct",
                                    "serve.tenant_decode_host_ms",
                                    "device.idle_pct.serve"}
    assert record.spans["serve.decode"] and record.spans["serve.step"]
    assert 0 < line["metrics"]["serve.decode_roofline_pct"]["value"] < 100


def misroute(monkeypatch):
    """A planted fault: every token's last expert swapped for another."""
    from repro_torch.layers import moe_dropless
    route = moe_dropless.route

    def wrong(xt, router, top_k):
        probs, vals, idx = route(xt, router, top_k)
        idx = idx.clone()
        e = router.shape[1]
        idx[:, -1] = (idx[:, -1] + 1) % e
        clash = (idx[:, :-1] == idx[:, -1:]).any(-1)
        idx[clash, -1] = (idx[clash, -1] + 1) % e
        return probs, vals, idx
    monkeypatch.setattr(moe_dropless, "route", wrong)


def test_a_routing_fault_is_not_correct(monkeypatch):
    """The routing comparison sees the planted fault at its first token,
    where the margin is no tie."""
    misroute(monkeypatch)
    record, line = run()
    assert line["correct"] is False
    assert record.checks["routing_mismatches"][0] > 0


def test_candidates_with_a_routing_tie_are_passed_over(monkeypatch):
    """With every margin counted as a tie, the planted fault's candidates
    are all passed over: none is judged, and the run is not correct."""
    from scbench.drivers import serve
    misroute(monkeypatch)
    monkeypatch.setattr(serve, "TIE_MARGIN", float("inf"))
    record, line = run()
    assert line["correct"] is False
    assert record.counters["judged"] == 0 and record.counters["tied"] > 0
    assert record.checks["samples_missing"] == (4, 0)
    assert record.checks["routing_mismatches"] == (0, 0)


def test_first_split_finds_the_earliest_token_over_layers():
    from scbench.drivers.serve import first_split
    k = torch.tensor
    # two layers, batch 2, prefill of 3 tokens then one decode call
    rec = [[k([[[0, 1], [2, 3], [4, 5]], [[0, 1], [1, 2], [2, 3]]]),
            k([[[6, 7]], [[3, 4]]])],
           [k([[[1, 0], [3, 2], [5, 4]], [[9, 9], [9, 9], [9, 9]]]),
            k([[[7, 6]], [[9, 9]]])]]
    same = [k([[1, 0], [3, 2], [5, 4], [7, 6]])] * 2
    assert first_split(rec, same, 0) is None
    other = [k([[0, 1], [2, 3], [4, 5], [6, 8]]),
             k([[0, 1], [2, 4], [4, 5], [6, 7]])]
    assert first_split(rec, other, 0) == (1, 1)
    assert first_split(rec, [same[0][:2], same[0][:2]], 0) is None


def test_a_loader_fault_is_not_correct(monkeypatch):
    """The weights are drawn by the benchmark and loaded by the program:
    a planted fault of its loader (keys and values swapped) shows in the
    logits."""
    from repro_torch.models import hybrid_moe
    monkeypatch.setitem(hybrid_moe._ATTENTION, "wk", "v")
    monkeypatch.setitem(hybrid_moe._ATTENTION, "wv", "k")
    record, line = run()
    assert line["correct"] is False
    assert record.checks["logit_max_abs_err"][0] > \
        record.checks["logit_max_abs_err"][1]


@pytest.mark.parametrize("control", ["drops", "bf16", "range"])
def test_controls_are_not_correct(control):
    record, line = run(control=control)
    assert line["correct"] is False
    assert record.checks["logit_max_rel_err"][0] > \
        record.checks["logit_max_rel_err"][1]


def test_a_token_that_is_not_the_greedy_pick_is_not_correct():
    """A planted fault of the tick's answer: one sequence's reported token
    replaced by the next id, every tick.  The engine decodes on as before,
    so the logits of every sample still agree with the reference."""
    def next_id(step):
        def f(n, active):
            tokens, faults = step(n, active)
            tokens = tokens.clone()
            tokens[-1, -1] = (tokens[-1, -1] + 1) % 256
            return tokens, faults
        return f
    record, line = run(wrap_step=next_id)
    assert line["correct"] is False and line["failed"] > 0
    assert record.checks["token_mismatches"][0] == 2
    assert record.checks["logit_max_abs_err"][0] < 1e-6


def test_altered_logits_are_not_correct(monkeypatch):
    from repro_torch.launch import serve
    step = serve.ServeEngine.step

    def altered(self, **kw):
        out = step(self, **kw)
        for t in self.tenants.values():
            if t.logits is not None:
                t.logits = t.logits + 1e-2
        return out
    monkeypatch.setattr(serve.ServeEngine, "step", altered)
    record, line = run()
    assert line["correct"] is False and line["failed"] > 0


def test_stale_cache_is_not_correct(monkeypatch):
    """A planted fault: decode hands back the cache it was given, so the
    Mamba2 state never moves past the prompt."""
    from repro_torch.models import registry
    decode = registry.decode_step

    def stale(cfg, params, cache, tokens, pos):
        logits, _ = decode(cfg, params, cache, tokens, pos)
        return logits, cache
    monkeypatch.setattr(registry, "decode_step", stale)
    record, line = run()
    assert line["correct"] is False


def test_a_denied_lane_is_not_correct():
    def revoke_once(step):
        def f(n, active):
            if n == 3:
                from repro_torch.launch import serve
                eng = serve.LAST_ENGINE
                eng.revoke(next(iter(eng.tenants)))
            return step(n, active)
        return f
    from repro_torch.launch import serve
    init = serve.ServeEngine.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        serve.LAST_ENGINE = self
    serve.ServeEngine.__init__ = keep
    try:
        record, line = run(wrap_step=revoke_once)
    finally:
        serve.ServeEngine.__init__ = init
        del serve.LAST_ENGINE
    assert line["correct"] is False
    assert record.checks["egress_fault_lanes"][0] > 0


def test_grouped_ffn_work_by_hand():
    # 5 slots over 2 experts hit, D 8, F 4: weights 2 x 3 x 8 x 4 x 4 B,
    # rows 5 x 8 x 4 B in and out; 6 x 8 x 4 operations a slot
    assert moe.grouped_ffn_work(5, 2, 8, 4) == (768 + 320, 960)
    assert moe.expert_bytes(4096, 768) == 37_748_736
    assert moe.f32_flops_per_s(132, 1980.0) == pytest.approx(6.690816e13)


def test_decode_bytes_by_hand():
    pub = {"hidden_size": 8, "vocab_size": 10, "num_local_experts": 2,
           "shared_intermediate_size": 3, "mamba_expand": 2,
           "mamba_n_groups": 1, "mamba_d_state": 2, "mamba_n_heads": 4,
           "mamba_d_head": 4, "mamba_d_conv": 4, "num_attention_heads": 2,
           "num_key_value_heads": 1, "head_dim": 4,
           "layer_types": ["mamba", "attention", "mamba"],
           "num_hidden_layers": 2}
    # per layer: norms 16, router 16, shared 72
    # mamba: weights 8 x (32 + 4 + 4) + 5 x 20 + 12 + 16 + 128 = 576,
    #   state of 2 rows read and written: 2 x 2 x (32 + 3 x 20) = 368
    # attention: weights 8 x 4 x 4 + 8 x 8 = 192, keys and values of 2
    #   rows at pos 5: 2 x 1 x 4 x 2 x 7 = 112
    # head 80 + 8, rows 16, logits 20
    n = 2 * (16 + 16 + 72) + 576 + 368 + 192 + 112 + 80 + 8 + 16 + 20
    assert moe.decode_bytes(pub, 2, 5) == 4 * n
