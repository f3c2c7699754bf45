"""The granite-4.0-h configuration's pieces of the benchmark on the CPU:
the plain reference's SSD against the sequential recurrence, the port's
engine against the reference on a tiny Mamba-2 + attention + MoE stack
(weights the reference draws), the SSM layer's three readers on made-up
spans and trace tuples, the scan's work function, and the open loop.

Tolerances: the reference's chunked SSD and the recurrence are the same
float32 sums in another order (2e-5 of the largest value here; 1e-4
allowed). The engine against the reference: the log-probability of each
served token differs by float32 rounding and the prefill attention's
bf16 rounding of q, k, v and probabilities (4.8e-7 at most over these
prompts; the bound is 1e-5, twenty times that), and every served token
is the reference's best; a state not carried from one chunk to the next
moves the log-probabilities by twelve times the bound. The fp8 control ranks
another token first at some positions (its largest gap 1.2e-3 here).
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check as chk
from perfbench.harness import Bench, port_config, reference
from perfbench.loops import open as open_loop
from perfbench.metrics import _program as P
from perfbench.metrics import _ssm_work as W
from perfbench.metrics import _yardstick as Y
from perfbench.profile import Trace
from perfbench.reference import hybrid_moe as H
from repro_torch.core.telemetry import Tracer

HERE = Path(__file__).resolve().parent
LAYERS = ["mamba", "mamba", "attention", "mamba"]
HYBRID = {
    "name": "tiny-hybrid",
    "num_hidden_layers": 4, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 32,
    "shared_intermediate_size": 48, "num_local_experts": 8,
    "num_experts_per_tok": 2, "vocab_size": 512, "layer_types": LAYERS,
    "mamba_d_state": 16, "mamba_d_head": 16, "mamba_n_heads": 8,
    "mamba_expand": 2, "mamba_n_groups": 1, "mamba_chunk_size": 16,
    "mamba_d_conv": 4, "rms_norm_eps": 1e-05, "attention_bias": False,
    "tie_word_embeddings": True, "embedding_multiplier": 12,
    "residual_multiplier": 0.22, "attention_multiplier": 0.0078125,
    "logits_scaling": 16, "position_embedding_type": "nope",
    "capacity_factor": 4.0, "max_position_embeddings": 256,
    "torch_dtype": "float32", "reference": "hybrid_moe",
    "port": {"arch_id": "granite-4.0-h-small",
             "replace": {"num_layers": 4, "layer_types": LAYERS,
                         "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
                         "head_dim": 16, "vocab_size": 512,
                         "max_seq_len": 256, "num_experts": 8,
                         "moe_top_k": 2, "moe_d_ff": 32, "shared_d_ff": 48,
                         "capacity_factor": 4.0, "ssm_state": 16,
                         "ssm_head_dim": 16, "ssm_chunk": 16,
                         "dtype": "float32"},
             "equal": {"num_layers": "num_hidden_layers",
                       "d_model": "hidden_size",
                       "ssm_heads": "mamba_n_heads",
                       "moe_d_ff": "intermediate_size",
                       "shared_d_ff": "shared_intermediate_size",
                       "attn_scale": "attention_multiplier",
                       "embedding_multiplier": "embedding_multiplier",
                       "residual_multiplier": "residual_multiplier",
                       "logits_scaling": "logits_scaling",
                       "dtype": "torch_dtype"}},
    "engine": {"num_pages": 96, "page_size": 8, "max_slots": 4,
               "max_tokens_per_iter": 64, "chunk_policy": "decode_first",
               "enable_prefix_cache": False},
    "check": {"limits": {"max_logit_gap": 0.05}, "sample_tokens": 48},
}


def _recurrence(x, a, b, c):
    """The SSD one token at a time from a zero state: S = S exp(a) + x
    b^T, y = S c. x (T, H, P); a (T, H); b, c (T, G, N)."""
    t, h, p = x.shape
    rep = h // b.shape[1]
    b, c = b.repeat_interleave(rep, 1), c.repeat_interleave(rep, 1)
    s = torch.zeros(h, p, b.shape[-1], dtype=torch.float64)
    ys = []
    for i in range(t):
        s = s * torch.exp(a[i])[:, None, None] \
            + x[i][:, :, None] * b[i][:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", s, c[i]))
    return torch.stack(ys).float(), s.float()


@pytest.mark.parametrize("t,g,chunk", [(77, 1, 16), (64, 2, 32), (5, 1, 8)])
def test_reference_ssd_matches_the_recurrence(t, g, chunk):
    """Lengths no multiple of the chunk (a padded last chunk), two groups,
    and a sequence shorter than one chunk."""
    gen = torch.Generator().manual_seed(t)
    h, p, n = 4, 8, 16
    x = torch.randn(t, h, p, generator=gen, dtype=torch.float64)
    a = -torch.rand(t, h, generator=gen, dtype=torch.float64)
    b = torch.randn(t, g, n, generator=gen, dtype=torch.float64)
    c = torch.randn(t, g, n, generator=gen, dtype=torch.float64)
    y, s = H.ssd(*(z.float() for z in (x, a, b, c)), chunk)
    yr, sr = _recurrence(x, a, b, c)
    assert y.shape == (t, h, p)
    assert float((y - yr).abs().max()) <= 1e-4 * float(yr.abs().max())
    assert float((s - sr).abs().max()) <= 1e-4 * float(sr.abs().max())


def test_engine_matches_the_reference():
    """Prompts of 5, 37, 70 and 13 tokens, the 70 over two chunks of the
    64-token budget, 20 greedy tokens each: every served token's
    log-probability within 1e-5 of the reference's, its gap 0; the fp8
    control's first-ranked tokens fall short of the reference's best."""
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    conf = HYBRID
    cfg = port_config(conf)
    ref = reference(conf)
    w = ref.make_weights(conf, 7, cfg.torch_dtype, "cpu")
    eng = PagedEngine(cfg, w, EngineConfig(**conf["engine"], seed=0),
                      device="cpu")
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 512, (n,), generator=g).tolist()
               for n in (5, 37, 70, 13)]
    outs = LLMService(eng).generate(prompts, SamplingParams(max_new_tokens=20))
    assert eng.ssm_carried_chunks >= 1
    reqs = [types.SimpleNamespace(rid=i, prompt=p, out=o.token_ids,
                                  lps=o.samples[0].token_logprobs)
            for i, (p, o) in enumerate(zip(prompts, outs))]
    seqs = [r.prompt + r.out[:-1] for r in reqs]
    firsts = [len(r.prompt) - 1 for r in reqs]
    logits = ref.logits(conf, w, seqs, firsts)
    lp = torch.log_softmax(logits, -1)
    served = torch.tensor([t for r in reqs for t in r.out])
    want = lp.gather(1, served[:, None])[:, 0]
    got = torch.tensor([x for r in reqs for x in r.lps])
    assert float((want - got).abs().max()) < 1e-5
    gaps = chk.gaps(ref, conf, w, reqs, control=True)
    assert max(gaps["served"]) < 1e-5
    assert max(gaps["control"]) > 1e-4


def test_ssd_work_at_mamba2_prefill():
    """The kernel header's numbers: 112,197,888 B and 21.5 GFLOP at
    mamba2's 4 x 1024 tokens, H 64, P 64, N 128, chunk 256, bf16."""
    ops, nbytes = W.ssd_scan_work(4, 1024, 64, 64, 128, 1, 256, False, 2)
    assert nbytes == 112_197_888
    assert abs(ops / 1e9 - 21.5) < 0.05
    # a carried state is read once more; a short chunk counts its tokens
    assert W.ssd_scan_work(4, 1024, 64, 64, 128, 1, 256, True, 2)[1] == \
        nbytes + 4 * 64 * 64 * 128 * 4
    assert W.ssd_scan_work(1, 300, 8, 64, 128, 1, 256, False, 2)[0] == \
        W.ssd_scan_work(1, 256, 8, 64, 128, 1, 256, False, 2)[0] \
        + W.ssd_scan_work(1, 44, 8, 64, 128, 1, 44, False, 2)[0]


# -- the readers, on made-up spans ----------------------------------------------

T0 = 1000.0  # the program's clock; the trace's is 999 s behind
SCAN = dict(tokens=256, heads=8, head_dim=64, state=128, groups=1,
            chunk=256, carried=1)
CONF = {"hidden_size": 256, "mamba_expand": 2, "mamba_n_groups": 1,
        "mamba_d_state": 128, "mamba_n_heads": 8, "mamba_d_head": 64,
        "mamba_d_conv": 4, "torch_dtype": "bfloat16"}


def _steps(ssm=True):
    """A chunk step whose SSM layer scans, and a decode step whose SSM
    layer steps 2 of 4 rows: (name, +1 enter / -1 exit with args, time
    after ``T0``)."""
    inner = [("ssm.mixer", 1, .14, None), ("ssm.scan", 1, .15, None),
             ("", -1, .20, SCAN), ("", -1, .22, dict(phase="chunk",
                                                       tokens=256))]
    dec = [("ssm.mixer", 1, .54, None), ("ssm.update", 1, .55, None),
           ("", -1, .60, dict(rows=4, active=2)),
           ("", -1, .62, dict(phase="decode", rows=4))]
    script = [("iteration", 1, .10, None), ("chunk.layers", 1, .13, None)] \
        + (inner if ssm else []) + [
        ("", -1, .30, None), ("", -1, .40, None),
        ("iteration", 1, .50, None), ("decode.layers", 1, .53, None)] \
        + (dec if ssm else []) + [("", -1, .70, None), ("", -1, .85, None)]
    times = iter([T0 + t for _, _, t, _ in script])
    tr = Tracer(clock=lambda: next(times))
    for name, kind, _, args in script:
        if kind == 1:
            tr.enter("engine", name, root=name == "iteration")
        else:
            tr.exit(**(args or {}))
    return tr.events()


# the scan's kernel 1.152-1.200 (launched in ssm.scan), a projection
# 1.141-1.149 (in ssm.mixer), the decode's update 1.551-1.590 (in
# ssm.update), an expert product 1.63-1.68 (outside the mixer)
OPS = [("in_proj", 1.141, 1.149, 1.1405), ("ssd_scan", 1.152, 1.200, 1.151),
       ("update", 1.551, 1.590, 1.552), ("moe", 1.63, 1.68, 1.625)]


def _run(monkeypatch, ssm=True):
    events = _steps(ssm)
    monkeypatch.setattr(P, "kept_events", lambda: events)
    spans = [("pb.window", 1.0, 2.0), ("pb.engine.step", 1.10, 1.405),
             ("pb.engine.step", 1.50, 1.855)]
    return types.SimpleNamespace(trace=Trace(OPS, spans, 1.0, 2.0, 2),
                                 conf=CONF)


def _read(name, run):
    return Bench(HERE.parent).reader(name)(run)


def test_ssm_readers_on_made_up_spans(monkeypatch):
    run = _run(monkeypatch)
    ms = _read("ssm.device_ms_per_iter", run)
    assert ms == pytest.approx(1e3 * (0.008 + 0.048 + 0.039) / 2)
    bound = Y.bound_s(*W.ssd_scan_work(1, 256, 8, 64, 128, 1, 256, True, 2))
    assert _read("ssd_scan_roofline", run) == \
        pytest.approx(100 * bound / 0.048)
    nbytes = W.ssm_update_bytes(2, 8, 64, 128, 4, 2 * 256 + 2 * 128, 2)
    assert _read("ssm.update_roofline", run) == \
        pytest.approx(100 * nbytes / Y.HBM_BYTES_PER_S / 0.039)
    for name in ("ssd_scan_roofline", "ssm.update_roofline"):
        assert 0 < _read(name, run) <= 100


@pytest.mark.parametrize("name", ["ssm.device_ms_per_iter",
                                  "ssd_scan_roofline",
                                  "ssm.update_roofline"])
def test_ssm_readers_give_nothing_without_spans(monkeypatch, name):
    """No SSM spans (a program that records none, as the parent's), no
    program spans at all, and no trace: None, and nothing raised."""
    assert _read(name, _run(monkeypatch, ssm=False)) is None
    run = _run(monkeypatch)
    monkeypatch.setattr(P, "kept_events", lambda: None)
    assert _read(name, run) is None
    assert _read(name, types.SimpleNamespace(trace=None, conf=CONF)) is None


# -- the open loop ------------------------------------------------------------------

SPEC = {"loop": "open", "rate_rps": 2.5, "horizon_s": 400.0,
        "prompt": {"median": 1400, "sigma": 0.15, "min": 1024, "max": 1760},
        "output": {"median": 96, "sigma": 0.6, "min": 16, "max": 256},
        "strata": 32}


def test_open_loop_schedule():
    """The same seed gives the same schedule (another seed another one);
    over a long horizon the arrivals' mean rate is the file's, within
    four standard errors of a Poisson count; every length within its
    clip; no request follows a reply."""
    a = open_loop.Loop(SPEC, 2**41 + 17, 50272).start(3.0)
    b = open_loop.Loop(SPEC, 2**41 + 17, 50272).start(3.0)
    c = open_loop.Loop(SPEC, 2**41 + 18, 50272).start(3.0)
    key = [(s.at, s.prompt, s.max_new_tokens) for s in a]
    assert key == [(s.at, s.prompt, s.max_new_tokens) for s in b]
    assert key != [(s.at, s.prompt, s.max_new_tokens) for s in c]
    expect = SPEC["rate_rps"] * SPEC["horizon_s"]
    assert abs(len(a) - expect) <= 4 * expect ** 0.5
    assert all(3.0 <= s.at < 3.0 + SPEC["horizon_s"] for s in a)
    assert [s.at for s in a] == sorted(s.at for s in a)
    assert all(1024 <= len(s.prompt) <= 1760 for s in a)
    assert all(16 <= s.max_new_tokens <= 256 for s in a)
    assert np.median([len(s.prompt) for s in a]) == pytest.approx(1400,
                                                                  rel=0.02)
    assert len({s.session for s in a}) == len(a)
    assert open_loop.Loop(SPEC, 1, 50272).on_reply(0, 9.0) == []


def test_open_loop_arrivals_are_poisson():
    """The gaps are independent exponential draws, not smoothed: over many
    10 s windows the arrival count's variance is its mean's (a Poisson
    count's index of dispersion 1, within what 200 windows allow), and the
    gaps' distribution passes a Kolmogorov-Smirnov test against the
    exponential of the file's rate."""
    spec = dict(SPEC, horizon_s=2000.0)
    at = np.array([s.at for s in open_loop.Loop(spec, 2**33 + 5,
                                                50272).start(0.0)])
    counts = np.histogram(at, bins=200, range=(0.0, 2000.0))[0]
    # the index of dispersion over n windows has a standard error of
    # about sqrt(2 / n) = 0.1 at n = 200; four of them
    assert abs(counts.var(ddof=1) / counts.mean() - 1.0) < 0.4
    gaps = np.sort(np.diff(at))
    cdf = 1.0 - np.exp(-SPEC["rate_rps"] * gaps)
    n = len(gaps)
    ks = max(np.max(np.arange(1, n + 1) / n - cdf),
             np.max(cdf - np.arange(n) / n))
    assert ks < 1.63 / n ** 0.5  # the 1% critical value


def test_longdoc_traffic_file_fits_the_loop():
    """The cell's traffic names the open loop, and its horizon covers the
    warm-up and the benchmark's window."""
    bench = Bench(HERE.parent)
    spec = bench.traffic("longdoc")
    assert spec["loop"] == "open" and spec["rate_rps"] > 0
    assert spec["horizon_s"] >= spec["warmup_s"] + \
        bench.doc["run_seconds"] + 30
