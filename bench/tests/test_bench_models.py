"""Each configuration's model module holds the numbers the harness had when
every model was dense: recorded on the CPU from the harness before the model
kind became a module of its own (``golden_models.json``), and held exactly.

* each weight tensor's float64 sum and sum of squares at the rehearsal's
  size, from one seed;
* the sizes dict, at the published and at the rehearsal's size;
* the prefill quanta's model FLOPs and B1 work (summed over each quantum's
  layers, bf16) and the decode FLOPs at the published sizes: a whole stack,
  one layer at ``lo`` > 0, cached tokens before, and more tokens than
  phi3_14b's 2047-token window;
* the reference's logits on one seeded prompt at the rehearsal's size: the
  argmax exactly, the sums and a row to 1e-5 (float32's rounding, with
  room), since the CPU's float32 products sum in an order that follows the
  process's thread count and the CPU (at 1 thread, as a test worker may run,
  the sum moved in its 16th digit); a change to the model moves them by far
  more.
"""
import json
from pathlib import Path

import pytest
import torch

import check
import models
from kernels import flash_attention as fa

BENCH = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((BENCH / "tests" / "golden_models.json").read_text())
#: the configurations whose numbers were recorded; one added later brings
#: its own tests and leaves this file and its record as they are
CONFIGS = sorted(GOLDEN)


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def checksums(t):
    t = t.double()
    return [float(t.sum()), float((t ** 2).sum())]


@pytest.mark.parametrize("name", CONFIGS)
def test_sizes_are_the_parents(name):
    cf, g = config(name), GOLDEN[name]
    m = models.load(cf["model"])
    for rehearse, want in ((False, g["sizes"]), (True, g["rehearsal_sizes"])):
        c = m.sizes(cf, rehearse)
        assert {k: c[k] for k in want} == want
        # every recorded configuration is dense: one shape for every layer
        assert c["layers"] == [(c["num_heads"], c["num_kv_heads"],
                                c["head_dim"], c["sliding_window"])
                               ] * c["num_layers"]


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_the_parents(name):
    cf, g = config(name), GOLDEN[name]
    m = models.load(cf["model"])
    c = m.sizes(cf, True)
    w = m.draw(c, g["seed"], torch.device("cpu"), torch.float32)
    assert {k: checksums(t) for k, t in w.items()} == g["weights"]


@pytest.mark.parametrize("name", CONFIGS)
def test_work_counts_are_the_parents(name):
    cf, g = config(name), GOLDEN[name]
    m = models.load(cf["model"])
    c = m.sizes(cf, False)
    for q in g["quanta"]:
        S, P, lo, hi = q["S"], q["P"], q["lo"], q["hi"]
        assert m.prefill_flops(c, S, P, lo, hi, q["logits"]) == \
            q["prefill_flops"], q
        work = [fa.work(layer, S, P, 2) for layer in c["layers"][lo:hi]]
        assert sum(f for f, _ in work) == q["b1_flops"], q
        assert sum(b for _, b in work) == q["b1_bytes"], q
    for d in g["decode"]:
        assert m.decode_flops(c, d["cached"]) == d["decode_flops"], d


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_are_the_parents(name):
    cf, g = config(name), GOLDEN[name]
    m = models.load(cf["model"])
    c = m.sizes(cf, True)
    w = m.draw(c, g["seed"], torch.device("cpu"), torch.float32)
    gen = torch.Generator().manual_seed(g["seed"])
    want = g["logits"]
    n = want["prompt_len"]
    prompt = torch.randint(0, c["vocab_size"], (n,), generator=gen)
    ref = check.load_reference(cf)(c, m.reference_layout(w))
    lg = ref.logits([prompt], [n])[0]
    assert lg.argmax(-1).tolist() == want["argmax"]
    assert checksums(lg) == pytest.approx([want["sum"], want["sumsq"]],
                                          rel=1e-5)
    assert lg[-1, :8].tolist() == pytest.approx(want["last_row_head"],
                                                rel=1e-5, abs=1e-5)
