"""setup_s: process start to the start of the window (host clock):
imports, the CUDA context, the kernel library (built on a checkout's
first run), the inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s
