"""The whole step's share of the card's bf16 peak, in percent: the model
FLOPs (``_yardstick.model_flops``) of every token the window's iterations
processed (prefill chunk tokens and the decode steps' active rows, each
over its causal context, the unembedding of delivered tokens only),
over the wall seconds of those polls, times 989e12. The polls of the
profiled stretch are left out."""

from perfbench.metrics import _yardstick as Y


def read(run):
    conf = run.conf
    window = conf.get("sliding_window")
    tokens = ctx = sampled = 0
    secs = 0.0
    for p in run.window_polls():
        secs += p.t1 - p.t0
        sampled += p.delivered
        for w in p.work:
            if w[0] == "chunk":
                tokens += w[2]
                ctx += Y.causal_pairs(w[1], w[2], window)
            else:
                lens = [int(x) for x in w[1] if x > 0]
                tokens += len(lens)
                ctx += sum(min(x, window) if window else x for x in lens)
    if not tokens:
        return None
    return Y.mfu_pct(Y.model_flops(conf, tokens, ctx, sampled), secs)
