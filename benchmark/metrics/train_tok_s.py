"""Tokens (after the shift) of the training steps run in the window,
over the window, which ends with its last step. Host clock."""


def read(run):
    return sum(n for _, _, n in run.steps) / run.window_s
