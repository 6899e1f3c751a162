"""Process start to the first timed scan: imports, the traffic's
generation, CUDA and kernel-library load (nvcc in a checkout's first
run), front-end construction and the warm-up."""


def read(ctx):
    return ctx.setup_s
