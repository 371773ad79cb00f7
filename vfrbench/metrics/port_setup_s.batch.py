"""port_setup_s.batch: the seconds of ``setup_s`` the port owns: the union
of its recorder's top-level set-up spans in the run (kernel libraries
loaded and built, graph captures with their eager warm-ups, the index
operands and query weights prepared)."""

from vfrbench.port_trace import port_setup_s

UNIT = "s"
TRACED = True


def read(rec):
    return port_setup_s(rec)
