"""Share of the pose net's calls on the card that the traced requests ran
as a replay of the net's captured CUDA graph: the program's `pose_graph`
counter over it plus `pose_eager` (calls on a card tensor that ran the
module eagerly), in percent."""

from benchmark import program_spans as ps


def read(run):
    p = ps.program(run)
    if p is None:
        return None
    graph, eager = p.counts.get("pose_graph", 0), p.counts.get("pose_eager", 0)
    if graph + eager == 0:
        return None
    return 100.0 * graph / (graph + eager)
