"""Set-up: from the start of the loop's set-up (inputs made from the seed,
the kernels loaded or built, warm-up, graph capture, the check's first
steps) to the start of the window, on the host's clock."""


def read(run):
    return run.setup_s
