"""The share of the traced train window in which the device ran nothing
while the host was inside a ``embedding.*`` span of the program (the
innermost span open then; ``harness/span_idle.py``), in %.  The layers'
shares add up to ``device_idle_share.train``, less the idle time with
no span open."""

from harness import span_idle


def read(run):
    return span_idle.share(run, "train", "embedding")
