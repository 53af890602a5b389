"""setup_s: process start to the first timed item (imports, CUDA
context, weights, inputs, kernel builds or loads, warm-up), host clock."""


def read(run):
    return run.setup_s
