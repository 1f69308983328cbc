"""JG008 — mutable default arguments (counterpart of
``bigdl_tpu/analysis/rules/mutable_defaults.py``, unchanged)."""

from __future__ import annotations

from typing import Iterator

from bigdl_tpu_torch.analysis.core import (FileContext, Finding, Rule,
                                           is_mutable_default, register)


@register
class MutableDefaultRule(Rule):
    """A mutable default (``def __init__(self, layers=[])``) is created
    ONCE and shared by every call — two ``nn`` modules built with the
    default then share one hyper-parameter list, and mutating one
    silently rewires the other. In a framework whose module constructors
    are the public API this is a correctness landmine: default to
    ``None`` and materialize inside the body.
    """

    code = "JG008"
    summary = ("mutable default argument ([]/{}/list()) is shared across "
               "calls; default to None and materialize in the body")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        idx = ctx.capture_index
        for fn in idx.functions:
            a = fn.args
            defaults = list(zip(
                (list(getattr(a, "posonlyargs", [])) + list(a.args))[
                    len(getattr(a, "posonlyargs", []) or []) + len(a.args)
                    - len(a.defaults):],
                a.defaults))
            defaults += [(arg, d) for arg, d in zip(a.kwonlyargs,
                                                    a.kw_defaults)
                         if d is not None]
            for arg, default in defaults:
                # ctor calls count WITH or without arguments —
                # dict(momentum=0.9) is created once and shared exactly
                # like {}
                if is_mutable_default(default):
                    yield self.finding(
                        ctx, default,
                        f"parameter '{arg.arg}' of "
                        f"'{idx.qualname(fn)}' has a mutable default — it "
                        f"is created once and shared by every call; use "
                        f"None and materialize in the body")
