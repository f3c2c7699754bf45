"""The benchmark's spans around the program's layers, for traced runs.

Each span is a ``torch.profiler.record_function`` range named ``pb.<what>``
and is put around a call from outside: the engine module's model
functions (``moe_forward``, ``paged_attention``, ``prefill_attention_paged``
and the plain attention pieces), and an engine's ``step``,
``_prefill_chunk``, ``_decode``, ``_sample_rows`` and its scheduler's
``schedule``. While :attr:`Spans.recording` is set, the kernels' calls keep
their arguments for the rooflines (shapes and the context lengths as they
were passed, read after the window, with no synchronise inside it), and
the engine's chunks and decode steps keep what the FLOP count needs.
Nothing is wrapped in an untraced run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from torch.profiler import record_function

MODULE_FUNCS = ("moe_forward", "paged_attention", "prefill_attention_paged",
                "blockwise_attention", "attention_partial",
                "merge_partials_tree")
ENGINE_METHODS = (("step", "engine.step"), ("_prefill_chunk", "prefill_chunk"),
                  ("_decode", "decode"), ("_sample_rows", "sample"))


class Spans:
    def __init__(self):
        self.recording = False
        self.calls: Dict[str, List[dict]] = {"paged_attention": [],
                                             "prefill_attention_paged": []}
        # per engine call, while the window runs: ("chunk", start, length)
        # and ("decode", context lengths)
        self.work: List[tuple] = []
        self._undo: List[tuple] = []

    def _record_call(self, name, args, kwargs):
        if name == "paged_attention":
            q, kp = args[0], args[1]
            self.calls[name].append(dict(
                heads=q.shape[1], kv_heads=kp.shape[2], head_dim=q.shape[2],
                elem=q.element_size(), lens=args[4],
                window=kwargs.get("window")))
        elif name == "prefill_attention_paged":
            q, kp = args[0], args[1]
            self.calls[name].append(dict(
                heads=q.shape[2], kv_heads=kp.shape[2], head_dim=q.shape[3],
                elem=q.element_size(), start=int(kwargs.get("q_offset", 0)),
                length=q.shape[1], window=kwargs.get("window")))

    def install(self, engine_mod, engine):
        """Wrap the module's functions and the engine's methods."""
        for name in MODULE_FUNCS:
            fn = getattr(engine_mod, name)

            def spanned(*args, _fn=fn, _name=name, **kwargs):
                if self.recording and _name in self.calls:
                    self._record_call(_name, args, kwargs)
                with record_function(f"pb.{_name}"):
                    return _fn(*args, **kwargs)
            setattr(engine_mod, name, spanned)
            self._undo.append((engine_mod, name, fn))
        for attr, span in ENGINE_METHODS:
            fn = getattr(engine, attr)

            def method(*args, _fn=fn, _attr=attr, _span=span, **kwargs):
                if _attr == "_prefill_chunk":
                    self.work.append(("chunk", int(args[2]), len(args[0])))
                elif _attr == "_decode":
                    self.work.append(("decode", np.array(args[3])))
                with record_function(f"pb.{_span}"):
                    return _fn(*args, **kwargs)
            setattr(engine, attr, method)
            self._undo.append((engine, attr, None))
        fn = engine.scheduler.schedule

        def schedule(*args, _fn=fn, **kwargs):
            with record_function("pb.schedule"):
                return _fn(*args, **kwargs)
        engine.scheduler.schedule = schedule
        self._undo.append((engine.scheduler, "schedule", None))

    def uninstall(self):
        for obj, name, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, name)  # the instance attribute hid the method
            else:
                setattr(obj, name, fn)
        self._undo.clear()

    def take_work(self) -> List[tuple]:
        out, self.work = self.work, []
        return out
