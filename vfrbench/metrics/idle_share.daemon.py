"""idle_share.daemon: the share of the traced window in which no operation
ran on the card: 1 - (the union of the device intervals / the window)."""

from vfrbench.metrics_common import idle_share

UNIT = "%"
TRACED = True


def read(rec):
    return idle_share(rec, "daemon")
