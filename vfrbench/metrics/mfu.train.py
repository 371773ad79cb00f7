"""mfu.train: a step's operations (forward and backward, f32, at the plain
f32 peak) over the traced window's time per step."""

from vfrbench.metrics_common import train_mfu

UNIT = "%"
TRACED = True


def read(rec):
    return train_mfu(rec)
