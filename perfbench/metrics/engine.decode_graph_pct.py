"""Share, in percent, of the profiled stretch's decode steps that replayed
the engine's piecewise CUDA graphs: the program's ``decode.layers`` spans
that start inside the stretch and carry ``graphed`` 1, over all of them.
A program whose spans carry no ``graphed`` gives nothing."""

from perfbench.metrics import _program as P


def read(run):
    prog = P.program(run)
    if prog is None:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    inside = {sid for name, s, _, sid in prog.spans
              if name == "decode.layers" and lo <= s < hi}
    flags = [e.args.get("graphed") for e in P.kept_events()
             if e.ph == "X" and e.name == "decode.layers"
             and e.args["span"] in inside]
    if not flags or None in flags:
        return None
    return 100.0 * sum(flags) / len(flags)
