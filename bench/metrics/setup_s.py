"""Set-up seconds: process start to the first arrival (imports, weights
drawn on the card, engines built, kernels loaded or built, warm-up)."""


def read(run):
    return run.setup_s
