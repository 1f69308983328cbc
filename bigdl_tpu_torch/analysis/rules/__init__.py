"""graftlint rule catalogue for the port (counterpart of
``bigdl_tpu/analysis/rules/``) — importing this package registers every
rule.

Each module holds rule classes decorated with
:func:`bigdl_tpu_torch.analysis.core.register`. Add a rule by dropping a
module here that defines a ``Rule`` subclass with a unique ``JG0xx`` code
and importing it below; see ``bigdl_tpu_torch/analysis/README.md``.
"""

from bigdl_tpu_torch.analysis.rules import (  # noqa: F401
    compile_cache,
    concurrency,
    donation,
    host_sync,
    jit_in_loop,
    mutable_defaults,
    prng,
    shapeaware,
    sharding,
    side_effects,
    static_args,
    tracer_branch,
)
