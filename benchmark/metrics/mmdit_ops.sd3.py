"""mmdit_ops.sd3: in the profiled request, the mean count of outermost host
operators (``cpu_op`` events, nested ones counted once) inside each
``mmdit.forward`` span: the eager dispatches of one CFG forward."""

from benchmark.harness.spans import ops_per_span


def read(ctx):
    return ops_per_span(ctx.profile, "mmdit.forward")
