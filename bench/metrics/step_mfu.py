"""The whole step's share (%) of the card's bf16 peak over the traced
slice: model FLOPs of every token the engines processed in it (prefill
quanta and decode lanes, counted by the configuration's model module) over
the slice's wall seconds x 989e12."""


def read(run):
    t, sp = run.trace, run.spans
    if not t or sp is None or not t["window_s"]:
        return None
    m, c = run.model, run.sizes
    flops = sum(m.prefill_flops(c, S, P, lo, hi, logits)
                for S, P, lo, hi, logits in sp.quanta)
    flops += sum(m.decode_flops(c, n) for lanes in sp.decodes for n in lanes)
    if not flops:
        return None
    return 100.0 * flops / (t["window_s"] * run.peaks["flops"])
