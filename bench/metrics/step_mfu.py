"""The whole step's share (%) of the card's bf16 peak over the traced
slice: model FLOPs of every token the engines processed in it (prefill
quanta and decode lanes, `model_flops`) over the slice's wall seconds x
989e12."""
import model_flops as mf


def read(run):
    t, sp = run.trace, run.spans
    if not t or sp is None or not t["window_s"]:
        return None
    c = run.sizes
    flops = sum(mf.prefill_flops(c, S, P, layers, logits)
                for S, P, layers, logits in sp.quanta)
    flops += sum(mf.decode_flops(c, n) for lanes in sp.decodes for n in lanes)
    if not flops:
        return None
    return 100.0 * flops / (t["window_s"] * run.peaks["flops"])
