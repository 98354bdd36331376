"""The median host milliseconds a round inside `Prepared.step`, by the
benchmark's own clock around the call in the untraced window (it holds
any wait the step itself causes)."""
import statistics


def read(ctx):
    if not ctx.step_host_s:
        return None
    return 1e3 * statistics.median(ctx.step_host_s)
