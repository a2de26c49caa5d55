"""Set-up: process start to the first timed call (CUDA start-up, the
kernels built or loaded, the inputs made, the Cutout built and staged,
one warm call of each kind); host clock."""


def read(run):
    return run.setup_s
