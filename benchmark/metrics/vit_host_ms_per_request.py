"""Host milliseconds a traced request spends inside the ViT's forward: self
time of the program's `pose.vit.embed`, `pose.vit.blocks` and
`pose.vit.head` spans (inside `pose.net`).

Where the card paces the cell, as in vitpose_l.resident_chunks, the host
fills the launch queue and then blocks in each launch until a slot frees,
so this reads the launch queue's wait (close to the card's own time a
request), not the cost of dispatch: a faster dispatch leaves it where it
is, a faster card lowers it.  The trace keeps no launch call's duration,
so the wait cannot be taken out here."""

from benchmark import program_spans as ps

VIT = ("pose.vit.embed", "pose.vit.blocks", "pose.vit.head")


def read(run):
    p = ps.program(run)
    if p is None or not any(s.name in VIT for s in p.spans):
        return None
    return p.host_ms(VIT) / len(run.traced)
