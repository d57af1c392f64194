"""Set-up time: from the process's start to the window's opening
(imports, the kernel build where it is not cached, weights, the engine
or the training object, warm-up). Host clock."""


def read(run):
    return run.setup_s
