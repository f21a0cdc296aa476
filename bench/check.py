"""The check that decides ``correct``: the tokens the timed path served,
held against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the run seed, is run through the
reference (the configuration's ``reference`` file) as prompt + served
tokens.  The number compared is the widest gap by which a served token's
reference logit lies below the reference's best at that position: 0 where
the program served the reference's own greedy token.  The sample always
holds the longest request, the long preempted most often among those, so a
prefill resumed at a quantum boundary is in it; every short in it had its
KV migrated to the decode engine.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from traffic import seed_rng

BENCH = Path(__file__).resolve().parent


def load_reference(cfg_file: Dict):
    path = BENCH / cfg_file["reference"]
    spec = importlib.util.spec_from_file_location(
        "reference_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Dense


def sample(done: Sequence, n_served: Dict[int, int], tokens: int,
           prompt_len, seed: int) -> List:
    """The longest request (most preempted first), then requests in an
    order drawn from the seed until `tokens` served tokens are covered."""
    if not done:
        return []
    head = max(done, key=lambda r: (prompt_len(r) + n_served[r.rid],
                                    r.n_preemptions, -r.rid))
    rest = [r for r in done if r is not head]
    order = seed_rng(seed, 0x636B).permutation(len(rest))
    out, got = [head], n_served[head.rid]
    for i in order:
        if got >= tokens:
            break
        out.append(rest[i])
        got += n_served[rest[i].rid]
    return out


def gaps(ref, prompts: Sequence[np.ndarray], served: Sequence[List[int]],
         device, control=None) -> Dict[str, float]:
    """The widest gap under `ref` of the tokens judged: the served ones, or,
    with `control` (the reference in a lower precision) in the program's
    place, the ones the control puts first at the same positions; then the
    served tokens' own gap is kept as ``program_gap``."""
    seqs = [torch.as_tensor(np.concatenate([p, np.asarray(s[:-1], np.int64)]),
                            dtype=torch.long, device=device)
            for p, s in zip(prompts, served)]
    last = [len(s) for s in served]
    logits = ref.logits(seqs, last)
    picks = [torch.as_tensor(s, device=lg.device)
             for lg, s in zip(logits, served)]
    out = {"tokens": int(sum(last))}
    if control is not None:
        out["program_gap"] = widest_gap(logits, picks)
        picks = [lo.argmax(-1).to(lg.device)
                 for lg, lo in zip(logits, control.logits(seqs, last))]
    out["served_gap"] = widest_gap(logits, picks)
    return out


def widest_gap(logits: Sequence[torch.Tensor],
               picks: Sequence[torch.Tensor]) -> float:
    """The widest gap by which a picked token's logit lies below the best
    logit at its position."""
    return max(float((lg.amax(-1) - lg.gather(-1, tok[:, None])[:, 0]).max())
               for lg, tok in zip(logits, picks))
