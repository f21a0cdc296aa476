"""B1's share (%) of its roofline over the traced slice: the least time the
chip could take for the prefill attention the slice's prefill quanta needed
(FLOPs and bytes from each layer's shape, `kernels/flash_attention.py`),
over the device time of B1's kernels in the slice."""
from kernels import flash_attention as fa


def read(run):
    t = run.trace
    if not t or run.spans is None:
        return None
    spent = sum(s for n, s in t["by_op"].items()
                if any(k in n for k in fa.KERNEL_NAMES))
    if not spent or not run.spans.quanta:
        return None
    layers = run.sizes["layers"]
    least = sum(fa.roofline_s(*fa.work(layer, S, P, run.elt_bytes), run.peaks)
                for S, P, lo, hi, _ in run.spans.quanta
                for layer in layers[lo:hi])
    return 100.0 * least / spent
