"""The port's hand CUDA kernels against their plain PyTorch versions, on
the card (marker `cuda`; they skip on a host without one).  This file
imports neither JAX nor the reference, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in f32 (sums in another order), 2e-2 in bf16 (one bf16
rounding of the output plus reordered f32 sums).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention, torch_attention
from repro_torch.kernels.flash_decode import flash_decode, torch_decode


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    for b, h, kv, sq, sk, d, causal, win, qo in [(2, 8, 2, 100, 160, 64, True,
                                                  0, 60),
                                                 (2, 8, 2, 96, 96, 128, True,
                                                  17, 0)]:
        q, k, v = rn(b, h, sq, d), rn(b, kv, sk, d), rn(b, kv, sk, d)
        kvl = torch.tensor([sk, sk - 5], dtype=torch.int32, device=cuda)
        kw = dict(causal=causal, sliding_window=win, q_offset=qo, kv_len=kvl)
        torch.testing.assert_close(flash_attention(q, k, v, **kw).float(),
                                   torch_attention(q, k, v, **kw).float(),
                                   atol=tol, rtol=tol)
    q, k, v = rn(4, 32, 128), rn(4, 8, 300, 128), rn(4, 8, 300, 128)
    cl = torch.tensor([1, 77, 200, 300], dtype=torch.int32, device=cuda)
    for win in (0, 64):
        torch.testing.assert_close(
            flash_decode(q, k, v, cl, sliding_window=win).float(),
            torch_decode(q, k, v, cl, sliding_window=win).float(),
            atol=tol, rtol=tol)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """A reduced f32 model through the engine on the card (both kernels)
    and on the CPU (plain versions): prefill logits to 1e-4 and the same
    greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ReplicaEngine
    cfg = dataclasses.replace(reduced_config(get_config("mistral_7b")),
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(3))
    out = []
    before = flash_attention.launches, flash_decode.launches
    for dev in ("cpu", cuda):
        eng = ReplicaEngine(cfg, _to(params, dev), max_len=64, device=dev)
        st = eng.start_prefill(0, prompt)
        done = False
        while not done:
            st, done = eng.prefill_quantum(st)
        logits = eng.prefill_logits(st).cpu()
        slot = eng.admit(0, st)
        toks = [int(logits[0].argmax())]
        for _ in range(4):
            toks.append(eng.decode_iteration({slot: toks[-1]})[slot])
        out.append((logits, toks))
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-4, rtol=1e-4)
    assert out[1][1] == out[0][1]
    assert flash_attention.launches > before[0]
    assert flash_decode.launches > before[1]
