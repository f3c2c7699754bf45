"""The port's serving engine (chunked prefill into the paged KV, decode
through it, greedy sampling) held to the plain float32 references at a
small width on the CPU, for a dense GQA stack with biases and for an MLA
plus MoE stack, on weights the references draw.

The engine's ``blockwise_attention`` rounds q, k, v and the probabilities
to bf16 even in float32 (as the JAX package does), so the log-probability
of each served token may differ from the reference's by rounding: 3e-4 at
most on the dense stack and 4e-3 on MLA + MoE over these prompts; the
bounds below are ten times that. A missing bias, rotation or expert moves
them by orders of magnitude more.
"""

import types

import pytest
import torch

from perfbench import check as chk
from perfbench import tiny
from perfbench.harness import port_config, reference

TOL = {"tiny-dense": 3e-3, "tiny-mla": 4e-2}


def _serve(conf, seed=7):
    from repro_torch.serving.api import LLMService, SamplingParams
    from repro_torch.serving.engine import EngineConfig, PagedEngine
    cfg = port_config(conf)
    ref = reference(conf)
    w = ref.make_weights(conf, seed, cfg.torch_dtype, "cpu")
    eng = PagedEngine(cfg, w, EngineConfig(**conf["engine"], seed=0),
                      device="cpu")
    g = torch.Generator().manual_seed(1)
    # 70 tokens span two chunks of the 64-token budget
    prompts = [torch.randint(0, conf["vocab_size"], (n,), generator=g)
               .tolist() for n in (5, 37, 70, 13)]
    outs = LLMService(eng).generate(prompts, SamplingParams(max_new_tokens=20))
    reqs = [types.SimpleNamespace(rid=i, prompt=p, out=o.token_ids,
                                  lps=o.samples[0].token_logprobs)
            for i, (p, o) in enumerate(zip(prompts, outs))]
    return ref, w, reqs


@pytest.mark.parametrize("conf", [tiny.DENSE, tiny.MLA],
                         ids=lambda c: c["name"])
def test_engine_logprobs_match_the_reference(conf):
    ref, w, reqs = _serve(conf)
    assert all(len(r.out) == 20 for r in reqs)
    seqs = [r.prompt + r.out[:-1] for r in reqs]
    firsts = [len(r.prompt) - 1 for r in reqs]
    lp = torch.log_softmax(ref.logits(conf, w, seqs, firsts), -1)
    served = torch.tensor([t for r in reqs for t in r.out])
    want = lp.gather(1, served[:, None])[:, 0]
    got = torch.tensor([x for r in reqs for x in r.lps])
    assert float((want - got).abs().max()) < TOL[conf["name"]]
    # greedy: every served token is the reference's best, to rounding
    assert max(chk.gaps(ref, conf, w, reqs)["served"]) < TOL[conf["name"]]


@pytest.mark.parametrize("conf", [tiny.DENSE, tiny.MLA],
                         ids=lambda c: c["name"])
def test_weights_follow_the_seed(conf):
    ref = reference(conf)
    a = ref.make_weights(conf, 2 ** 31 + 3, torch.float32, "cpu")
    b = ref.make_weights(conf, 2 ** 31 + 3, torch.float32, "cpu")
    c = ref.make_weights(conf, 2 ** 31 + 4, torch.float32, "cpu")
    ta, tb, tc = (x["embed"]["table"] for x in (a, b, c))
    assert torch.equal(ta, tb) and not torch.equal(ta, tc)
    seg = a["segments"][0]
    # biases and norm scales are drawn, not zero and one
    if conf.get("enable_bias"):
        assert seg["attn"]["wq"]["b"].abs().sum() > 0
    assert not torch.equal(seg["ln1"]["scale"],
                           torch.ones_like(seg["ln1"]["scale"]))


def test_moe_reference_drops_no_token():
    """Every token's routed output is its own top-k experts', however many
    tokens pick one expert: a batch of copies of one token gives each copy
    the single token's output."""
    from perfbench.reference import mla_moe
    conf = tiny.MLA
    w = mla_moe.make_weights(conf, 11, torch.float32, "cpu")
    x = torch.randn(1, conf["hidden_size"])
    one = mla_moe._moe(conf, w["segments"][1]["mlp"], 0, x, None)
    many = mla_moe._moe(conf, w["segments"][1]["mlp"], 0, x.repeat(50, 1),
                        None)
    torch.testing.assert_close(many, one.repeat(50, 1))
