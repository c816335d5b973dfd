"""mfu.forward: the FP32 operations of the traced window's
secular-lane work (harness/roofline.py) over the window times the
H100's 67 TFLOP/s FP32 peak, in percent: the whole call's share of the
peak."""

from harness.roofline import FP32_OPS_PER_S


def read(ctx):
    if ctx.trace is None or ctx.roofline is None:
        return None
    return 100.0 * ctx.roofline[0] / (ctx.trace.window_s * FP32_OPS_PER_S)
