"""Set-up: process start to the first timed step (imports, the kernel
libraries, the scene, the check steps and warm-up)."""


def read(run):
    return run.setup_s
