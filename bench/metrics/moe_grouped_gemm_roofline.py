"""B4's share (%) of its roofline over the traced slice: the least time the
chip could take for the experts' grouped GEMMs the slice's prefill quanta
and decode iterations needed (`kernels/moe_grouped_gemm.py`), over the
device time of B4's kernels in the slice.  Every layer is a moe layer.

FLOPs are exact from the traced shapes: the rows of a prefill quantum are
its S tokens x K per layer of [lo, hi), those of a decode its active lanes
x K per layer.  The bytes hold the weights of the experts each run reads,
and the slice does not record its routing: the experts a run reads are the
window's mean for its kind (``moe_experts_touched`` over
``moe_layer_runs``: prefill, or decode at that count of active lanes).
None where the program keeps no such counters or ran no B4 kernel."""
from kernels import flash_attention as fa
from kernels import moe_grouped_gemm as mg


def read(run):
    t, sp, st = run.trace, run.spans, run.stats
    if not t or sp is None:
        return None
    spent = sum(s for n, s in t["by_op"].items()
                if any(k in n for k in mg.KERNEL_NAMES))
    if not spent:
        return None

    def experts(kind):
        n = st.get("moe_layer_runs." + kind, 0)
        return st.get("moe_experts_touched." + kind, 0) / n if n else None
    c = run.sizes
    K, L = c["experts_per_token"], c["num_layers"]
    least = 0.0
    for S, _, lo, hi, _ in sp.quanta:
        e = experts("prefill")
        if e is None:
            return None
        least += (hi - lo) * fa.roofline_s(
            *mg.work(c, S * K, e, run.elt_bytes), run.peaks)
    for lanes in sp.decodes:
        e = experts(f"decode_{len(lanes)}")
        if e is None:
            return None
        least += L * fa.roofline_s(
            *mg.work(c, len(lanes) * K, e, run.elt_bytes), run.peaks)
    return 100.0 * least / spent if least else None
