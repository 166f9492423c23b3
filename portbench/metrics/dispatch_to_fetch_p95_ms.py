"""Stream: the 95th percentile of ``VidStream.timer.wall["depth"]``, each
frame's span from its program's dispatch to its copy on the host."""

from portbench.stats import percentile


def read(rec, metric):
    wall = rec.out.stream_wall
    return percentile(wall, 95) * 1e3 if wall else None
