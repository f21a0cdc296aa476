"""The port's hand CUDA kernels against their plain PyTorch versions, on
the card (marker `cuda`; they skip on a host without one).  This file
imports neither JAX nor the reference, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in f32 (sums in another order), 2e-2 in bf16 (one bf16
rounding of the output plus reordered f32 sums).  B1 is also held to a
relative norm per (batch, head), ||got - want|| / ||want|| against the
plain version in f32: 2e-5 in f32 and 5e-3 in bf16, where the bf16
roundings of P and of the output read ~2e-3 and a dropped 128-key tile
reads 2e-2 or more.  B3 in bf16 is held to the same 5e-3 on y and the
state by `repro_torch.kernels.checks` (shared with chip_smoke.py), where a
CPU emulation of its bf16 operands reads ~1.7e-3 (y) and a dropped
64-token u-tile, a state passing cut to the previous chunk or a dropped
entering state 0.05 or more (tests/test_torch_ssd.py).
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels.checks import (cross_edge_checks, rel_err, ssd_check,
                                        ssd_edge_cases, ssd_inputs)
from repro_torch.kernels.flash_attention import flash_attention, torch_attention
from repro_torch.kernels.flash_decode import flash_decode, split_plan, torch_decode
from repro_torch.kernels.ssd_kernel import ssd_scan, torch_ssd_scan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run "
                    "only on the card")
    # the plain versions' f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_at_head_dim_80(cuda, dtype, tol):
    """B1 and B2 at the hybrid's attention width: D 80, MHA (n_rep 1)."""
    g = torch.Generator(device=cuda).manual_seed(1)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    q, k, v = rn(2, 4, 130, 80), rn(2, 4, 130, 80), rn(2, 4, 130, 80)
    kvl = torch.tensor([130, 101], dtype=torch.int32, device=cuda)
    for kw in (dict(causal=True), dict(causal=True, sliding_window=33, kv_len=kvl)):
        torch.testing.assert_close(flash_attention(q, k, v, **kw).float(),
                                   torch_attention(q, k, v, **kw).float(),
                                   atol=tol, rtol=tol)
    q, k, v = rn(3, 4, 80), rn(3, 4, 300, 80), rn(3, 4, 300, 80)
    cl = torch.tensor([1, 177, 300], dtype=torch.int32, device=cuda)
    for win in (0, 64):
        torch.testing.assert_close(
            flash_decode(q, k, v, cl, sliding_window=win).float(),
            torch_decode(q, k, v, cl, sliding_window=win).float(),
            atol=tol, rtol=tol)


B1_EDGE_CASES = [
    # b, sq, sk, causal, win, q_offset, kv_len (None: sk)
    (2, 100, 160, True, 0, 60, (160, 155)),      # ragged tiles, Sq < Sk at an offset
    (1, 200, 200, True, 70, 0, None),            # window across 64-key tile edges
    (2, 130, 130, False, 0, 0, (130, 37)),       # not causal, ragged kv_len
    (2, 64, 64, True, 17, 0, (64, 0)),           # a sequence with no key at all
    (1, 40, 96, True, 0, -8, None),              # rows 0-7 see no key
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_attention_edges_match_plain(cuda, dtype, tol, d, n_rep):
    """B1 on both kernels (bf16 D 64/80/128: tensor cores; f32: CUDA
    cores) against `torch_attention`: ragged Sq/Sk, q_offset with Sq < Sk,
    windows across tile edges, ragged kv_len, rows with no visible key
    (output 0 and LSE -inf where the plain version has them), and a
    bit-equal repeat of the same call; elementwise and in relative norm
    against the plain version in f32 on the same inputs.  q is a
    transposed (B, S, H, D) view, as `attention_block` passes it."""
    rel_tol = 5e-3 if dtype == torch.bfloat16 else 2e-5
    g = torch.Generator(device=cuda).manual_seed(d + n_rep)
    kvh = 2
    h = kvh * n_rep
    for b, sq, sk, causal, win, qo, kvl in B1_EDGE_CASES:
        q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype).transpose(1, 2)
        k = torch.randn((b, kvh, sk, d), generator=g, device=cuda).to(dtype)
        v = torch.randn((b, kvh, sk, d), generator=g, device=cuda).to(dtype)
        kv_len = (torch.tensor(kvl, dtype=torch.int32, device=cuda)
                  if kvl is not None else None)
        kw = dict(causal=causal, sliding_window=win, q_offset=qo, kv_len=kv_len,
                  return_lse=True)
        out, lse = flash_attention(q, k, v, **kw)
        want32, want_lse = torch_attention(q.float(), k.float(), v.float(), **kw)
        want = want32.to(dtype)              # = torch_attention(q, k, v)
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
        assert rel_err(out, want32) < rel_tol
        empty = torch.isneginf(want_lse)
        assert torch.equal(torch.isneginf(lse), empty)
        assert (out.float()[empty] == 0).all()
        torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=tol, rtol=tol)
        again, again_lse = flash_attention(q, k, v, **kw)
        assert torch.equal(again, out) and torch.equal(again_lse, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_edges_match_plain(cuda, dtype):
    """`checks.cross_edge_checks`: B1 with one query row (the decoder's BOS
    prefill) causal and across to 1024 encoder frames with ragged kv_len,
    B1 unmasked over 1024 frames, and B2 over a full 1024-key cross cache,
    at D 64 with 16 MHA heads; each to its plain version, repeats
    bit-equal."""
    before = flash_attention.launches, flash_decode.launches
    out = cross_edge_checks(generator=torch.Generator(device=cuda).manual_seed(9),
                            device=cuda, dtype=dtype)
    assert len(out) == 5
    assert flash_attention.launches == before[0] + 8
    assert flash_decode.launches == before[1] + 2


@pytest.mark.cuda
def test_engine_f32_shapes_match_plain(cuda):
    """`checks.engine_f32_checks`: B1 and B2 in f32 at the evaluation path's
    engine shapes (4 query / 2 KV heads of 64, a 128-token context, 8 decode
    slots) to 2e-5, repeats bit-equal, each dropped-keys fault above the
    limit."""
    from repro_torch.kernels.checks import (ENGINE_F32_ATTENTION, ENGINE_F32_DECODE,
                                            engine_f32_checks)
    before = flash_attention.launches, flash_decode.launches
    out = engine_f32_checks(generator=torch.Generator(device=cuda).manual_seed(16),
                            device=cuda)
    assert len(out) == len(ENGINE_F32_ATTENTION) + len(ENGINE_F32_DECODE)
    assert flash_attention.launches == before[0] + 2 * len(ENGINE_F32_ATTENTION)
    assert flash_decode.launches == before[1] + 2 * len(ENGINE_F32_DECODE)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,n_rep", [(64, 4), (80, 1), (128, 3), (128, 4), (128, 5),
                                     (128, 8)])
def test_decode_split_edges_match_plain(cuda, dtype, tol, d, n_rep):
    """B2's split key axis against `torch_decode`: cache_len 0, 1, less
    than one split, exactly a split boundary, one past it, and S; windows
    that cross a split boundary; the merge is deterministic."""
    g = torch.Generator(device=cuda).manual_seed(d * n_rep)
    b, kvh, s = 8, 2, 1024
    h = kvh * n_rep
    n_split, chunk = split_plan(b, kvh, s, fd_mod._n_sms(0))
    assert n_split > 1
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, kvh, s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kvh, s, d), generator=g, device=cuda).to(dtype)
    cl = torch.tensor([0, 1, chunk // 3, chunk, chunk + 1, s, 2 * chunk - 5, s - 1],
                      dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    for win in (0, 7, chunk // 2 + 3):
        got = flash_decode(q, k, v, cl, sliding_window=win)
        want = torch_decode(q, k, v, cl, sliding_window=win)
        # cache_len 0 gives 0, as the TPU kernel; the reference's windowed
        # XLA path (and so torch_decode) averages the cache there instead
        assert (got[0].float() == 0).all()
        torch.testing.assert_close(got[1:].float(), want[1:].float(), atol=tol, rtol=tol)
        assert torch.equal(flash_decode(q, k, v, cl, sliding_window=win), got)
    assert flash_decode.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("chunk,s,nh,hd,ns,init", [(64, 200, 4, 64, 64, True),
                                                   (256, 300, 3, 32, 128, True),
                                                   (256, 70, 2, 64, 16, False),
                                                   (64, 64, 5, 16, 32, False)])
def test_ssd_kernel_matches_plain(cuda, dtype, tol, chunk, s, nh, hd, ns, init):
    """B3 against `torch_ssd_scan` at the caller's chunk (the kernel tiles
    in its own 64), ragged lengths, an entering state, and x, B, C as
    strided views of one conv output, as the model passes them.

    dt is drawn in the range Mamba2 initialises it to (~0.02-0.05).  With
    dt ~0.2 the plain version's own f32 rounding at chunk 256 reaches
    ~5e-5 on y: its log-decay within the chunk grows to ~100, and one ulp
    of that enters every decay factor (an H100 run showed 4 of 57,600
    elements past 2e-5); the kernel's 64-token tiles keep it 4x smaller."""
    g = torch.Generator(device=cuda).manual_seed(s)
    b = 2
    xbc = torch.randn((b, s, nh * hd + 2 * ns), generator=g, device=cuda).to(dtype)
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    B, C = xbc[..., nh * hd:nh * hd + ns], xbc[..., nh * hd + ns:]
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), generator=g, device=cuda) - 4)
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device=cuda)
    D = torch.randn((nh,), generator=g, device=cuda)
    h0 = (torch.randn((b, nh, hd, ns), generator=g, device=cuda) * 0.1
          if init else None)
    before = ssd_scan.launches
    y, h = ssd_scan(x, dt, A, B, C, D, chunk=chunk, init_state=h0,
                    return_state=True)
    wy, wh = torch_ssd_scan(x, dt, A, B, C, D, chunk=chunk, init_state=h0,
                            return_state=True)
    assert ssd_scan.launches == before + 1
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, wh, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("ns,nh", [(64, 5), (128, 3)])
@pytest.mark.parametrize("b", [1, 2])
def test_ssd_bf16_tile_and_chunk_edges(cuda, ns, nh, b):
    """B3's tensor-core kernels on `checks.ssd_edge_cases`: the edges of
    their 64-token tiles and of their chunk (L 128 at ns 64, 256 at ns 128),
    and a slow decay that carries the state across 17 chunks.  2e-2 against
    `torch_ssd_scan` and SSD_REL_TOL per (batch, head) against it in f32,
    on y and the state; a dropped 64-token u-tile, emulated in the plain
    version, reads above that limit, and at the slow decay so do a state
    passing cut to the previous chunk and a dropped entering state; two
    identical calls are bit-equal and each counts one launch."""
    g = torch.Generator(device=cuda).manual_seed(ns * b)
    for s, init, slow in ssd_edge_cases(ns, b):
        _, x, dt, A, B, C, D, h0 = ssd_inputs(b, s, nh, 64, ns, init=init,
                                              generator=g, device=cuda, slow=slow)
        ssd_check(f"s {s}", x, dt, A, B, C, D, chunk=64, init_state=h0,
                  carry=slow)


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("mamba2_130m", 2), ("zamba2_2_7b", 4)])
def test_ssm_models_on_card_match_cpu(cuda, arch, layers):
    """Reduced f32 ssm and hybrid models on the card (B3, and B1/B2 in the
    hybrid's shared block) against the CPU (plain versions): forward
    logits, prefill and 4 decode steps to 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as mdl
    cfg = dataclasses.replace(reduced_config(get_config(arch), layers=layers),
                              dtype="float32")
    params = mdl.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 70),
                           generator=torch.Generator().manual_seed(4))
    runs = []
    before = ssd_scan.launches, flash_attention.launches, flash_decode.launches
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        tokens = prompt.to(dev)
        logits, _ = mdl.forward(cfg, p, {"tokens": tokens})
        lg, cache = mdl.prefill(cfg, p, {"tokens": tokens},
                                mdl.init_cache(cfg, 2, 80, device=dev))
        steps = [lg]
        tok = prompt[:, -1].to(dev)
        for i in range(4):
            lg, cache = mdl.decode_step(cfg, p, cache, (tok + i) % cfg.vocab_size)
            steps.append(lg)
        runs.append([logits.cpu()] + [t.cpu() for t in steps]
                    + [cache["ssm"].ssm.cpu()])
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert ssd_scan.launches == before[0] + 2 * layers      # forward + prefill
    if cfg.family == "hybrid":
        assert flash_attention.launches > before[1]
        assert flash_decode.launches > before[2]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "seamless_m4t_large_v2",
                                  "internvl2_76b"])
def test_family_models_on_card_match_cpu(cuda, arch):
    """Reduced f32 moe, audio and vlm models on the card (B1 and B2,
    including the cross attention) against the CPU (plain versions):
    forward logits, prefill and 4 decode steps to 1e-4, on the inputs
    quickstart draws."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import quickstart
    from repro_torch.models import model as mdl
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    params = mdl.init_params(cfg, seed=0, device="cpu")
    batch = quickstart.make_batch(cfg, 2, 70, seed=4)
    runs = []
    before = flash_attention.launches, flash_decode.launches
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = mdl.forward(cfg, p, b)
        lg, cache = quickstart.start(cfg, p, b, 4)
        steps = [lg]
        for i in range(4):
            lg, cache = mdl.decode_step(cfg, p, cache,
                                        (batch["tokens"][:, -1].to(dev) + i) % cfg.vocab_size)
            steps.append(lg)
        runs.append([logits.cpu()] + [t.cpu() for t in steps]
                    + [cache["k"].cpu()] + ([cache["cross_k"].cpu()]
                                            if "cross_k" in cache else []))
    for got, want in zip(runs[1], runs[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    per_pass = cfg.num_layers * (3 if cfg.family == "audio" else 1)
    assert flash_attention.launches == before[0] + 2 * per_pass   # forward + prefill
    assert flash_decode.launches == before[1] + 4 * (
        2 * cfg.num_layers if cfg.family == "audio" else cfg.num_layers)
