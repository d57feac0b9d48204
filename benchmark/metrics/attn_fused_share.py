"""Share of the ViT's attention calls that the traced requests sent to a
fused scaled-dot-product kernel: the program's `attn_fused` counter over it
plus `attn_plain` (attentions computed in torch ops on a card tensor), in
percent."""

from benchmark import program_spans as ps


def read(run):
    p = ps.program(run)
    if p is None:
        return None
    fused, plain = p.counts.get("attn_fused", 0), p.counts.get("attn_plain", 0)
    if fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
