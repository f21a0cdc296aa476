"""A configuration's model kind.  Each ``configs/<name>.json`` names its
module under ``"model"``, and ``models/<model>.py`` supplies all the harness
knows of the architecture:

- ``sizes(cf, rehearse)``: the run's sizes from the configuration file, under
  the port's names, with at least ``vocab_size``, ``max_len`` and ``dtype``
  (a ``torch`` dtype's name) and ``layers``, one ``(H, KV, hd, window)``
  tuple per layer (query heads, KV heads, head width, window of keys counting
  the query itself, 0 for none); ``rehearse`` gives the CPU tests' tiny
  float32 size.
- ``port_config(cf, c)``: the port's ``ModelConfig`` at those sizes.
- ``draw(c, seed, device, dtype)``: every weight, drawn from the seed on the
  device; ``port_layout(w)`` hands them to the port, ``reference_layout(w)``
  to the configuration's ``reference`` file, whose ``Reference(c, weights,
  precision="f32")`` has ``logits(seqs, last)``.
- ``prefill_flops(c, S, P, lo, hi, logits)``: the model FLOPs of a prefill
  quantum over layers ``[lo, hi)``, S new tokens after P cached ones, and the
  head on the last token when ``logits``; ``decode_flops(c, cached)``: one
  decode token through every layer and the head.

A configuration of a new kind brings its module, its reference and its
files; nothing else in the harness names a kind.
"""
import importlib


def load(name: str):
    """The model module ``models/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")
